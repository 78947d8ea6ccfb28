"""Host time a chunk of the epoch's boundary: the program's spans around
loading the carry (``_load_fresh``), adopting the final state and the
update (``_adopt``, ``adopt_update``) and the summary (``_epoch_summary``,
or ``_epoch_full``)."""
from tunebench.harness.spans import BOUNDARY, host_ms


def read(trace):
    ms = host_ms(trace, BOUNDARY.__contains__)
    return None if ms is None else ms / trace.chunks
