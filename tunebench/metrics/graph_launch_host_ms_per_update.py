"""Host time an update of the captured programs' replays (the program's
``rt.replay#<index>`` spans, which hold each ``cudaGraphLaunch``)."""
from tunebench.harness.spans import REPLAY, host_ms


def read(trace):
    ms = host_ms(trace, lambda name: name.startswith(REPLAY))
    return None if ms is None else ms / trace.updates
