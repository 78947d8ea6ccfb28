"""Device time an update of everything but the window kernel: the episode
body's elementwise, index, scatter and copy work, and the policy update."""

WINDOW_KERNEL = "fleet_tick"


def read(trace):
    body = [d for name, _, d in trace.device if WINDOW_KERNEL not in name]
    if not body:
        return None
    return sum(body) / 1e6 / trace.updates
