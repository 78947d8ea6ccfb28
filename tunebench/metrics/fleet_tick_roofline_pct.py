"""The window kernel's share of its byte bound: the bytes one window must
move at the launched shapes (the frozen ``window_cost``), at the card's
published HBM bandwidth, over the kernel's mean device time."""
from tunebench.costs.fleet_tick import HBM_BYTES_S, window_cost

KERNEL = "fleet_tick"


def read(trace):
    times = [d for name, _, d in trace.device if KERNEL in name]
    if not times:
        return None
    s = trace.shapes
    nbytes, _ = window_cost(s["T"], s["S"], s["K"], s["N"], s["fmult"])
    return 100.0 * (nbytes / HBM_BYTES_S) / (sum(times) / len(times) / 1e9)
