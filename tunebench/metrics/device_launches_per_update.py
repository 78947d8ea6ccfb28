"""Device activities (kernels, copies, sets) an update, a replayed graph's
kernels each counted: the episode body's and the update's launch count."""


def read(trace):
    if not trace.device:
        return None
    return len(trace.device) / trace.updates
