"""The whole update's share of the card's byte bound: the least time for
the bytes of all of an update's windows (the frozen ``window_cost`` at the
cell's shapes, whatever kernels implement them), at the card's published
HBM bandwidth, over the traced window's wall time an update."""
from tunebench.costs.fleet_tick import HBM_BYTES_S, window_cost


def read(trace):
    if trace.updates <= 0 or trace.window_s <= 0:
        return None
    s = trace.shapes
    nbytes, _ = window_cost(s["T"], s["S"], s["K"], s["N"], s["fmult"])
    bound_s = s["steps"] * nbytes / HBM_BYTES_S
    return 100.0 * bound_s / (trace.window_s / trace.updates)
