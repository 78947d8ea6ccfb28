"""The traced window: chunks timed untraced, then as many under
``torch.profiler``, read into a ``Trace``
that the per-layer metric readers (``tunebench/metrics/<name>.py``) take
their numbers from, and the breakdown of the run's result line.

Spans: every chunk is a ``tunebench.chunk`` span, and the host work at the
epoch's boundary (the outer iteration's ``_load_fresh``, ``_adopt`` and
``_epoch_summary``, where the program has them) is wrapped by the benchmark
in ``tunebench.epoch_boundary`` spans. The device side is the profiler's CUDA rows:
every kernel, copy and set, a replayed graph's kernels each on its own.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch

SPAN_PREFIX = "tunebench."
CHUNK_SPAN = SPAN_PREFIX + "chunk"


@dataclass
class Trace:
    #: (name, start_ns, duration_ns) of every device activity (kernels,
    #: copies, sets; not the device timeline's copies of host spans)
    device: list
    #: (name, start_ns, duration_ns) of every host event
    host: list
    #: the traced window on the profiler's clock, ns
    start_ns: int
    end_ns: int
    #: policy updates and chunks in the window
    updates: int
    chunks: int
    #: the cell's launch shapes: T, S, K, N, fmult, steps
    shapes: dict = field(default_factory=dict)
    #: host wall time of as many chunks run just before, untraced: the
    #: profiler slows every graph launch, and the run logs by how much
    untraced_s: float = 0.0

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def busy_intervals(self) -> np.ndarray:
        """The union of the device activities inside the window, as sorted
        disjoint (start, end) ns rows."""
        if not self.device:
            return np.zeros((0, 2), np.int64)
        iv = np.array([(s, s + d) for _, s, d in self.device], np.int64)
        iv[:, 0] = np.clip(iv[:, 0], self.start_ns, self.end_ns)
        iv[:, 1] = np.clip(iv[:, 1], self.start_ns, self.end_ns)
        iv = iv[np.argsort(iv[:, 0], kind="stable")]
        out = []
        cs, ce = iv[0]
        for s, e in iv[1:]:
            if s > ce:
                out.append((cs, ce))
                cs, ce = s, e
            elif e > ce:
                ce = e
        out.append((cs, ce))
        return np.array(out, np.int64)

    def busy_s(self) -> float:
        iv = self.busy_intervals()
        return float((iv[:, 1] - iv[:, 0]).sum()) / 1e9


def _wrap(obj, attr: str, span: str) -> None:
    """Put a span named ``span`` around ``obj.attr`` when it exists."""
    fn = getattr(obj, attr, None)
    if fn is None:
        return

    def wrapped(*a, **kw):
        with torch.profiler.record_function(span):
            return fn(*a, **kw)

    setattr(obj, attr, wrapped)


@contextlib.contextmanager
def layer_spans(cfgr):
    """Spans around the program's layers for the traced window (instance
    attributes, removed afterwards); a layer the program does not have is
    left out."""
    runner = getattr(cfgr, "_runner", None)
    wrapped = []
    if runner is not None:
        for attr, span in (("_epoch_summary", "tunebench.epoch_boundary"),
                           ("_load_fresh", "tunebench.epoch_boundary"),
                           ("_adopt", "tunebench.epoch_boundary")):
            if hasattr(runner, attr):
                _wrap(runner, attr, span)
                wrapped.append((runner, attr))
    try:
        yield
    finally:
        for obj, attr in wrapped:
            obj.__dict__.pop(attr, None)


def profile_chunks(chunk, n_chunks: int, updates_per_chunk: int,
                   shapes: dict, cfgr=None, device="cuda") -> Trace:
    """``chunk()`` ``n_chunks`` times untraced, then ``n_chunks`` times
    under the profiler (each chunk ends with its summary on the host)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    sync()
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        chunk()
    sync()
    untraced = time.perf_counter() - t0
    with layer_spans(cfgr) if cfgr is not None else contextlib.nullcontext():
        with profile(activities=activities) as prof:
            for _ in range(n_chunks):
                with torch.profiler.record_function(CHUNK_SPAN):
                    chunk()
            sync()
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        row = (e.name(), int(e.start_ns()), int(e.duration_ns()))
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            host.append(row)
        elif not (e.is_user_annotation() or row[0].startswith(SPAN_PREFIX)):
            # the device timeline's copy of a span is no device work
            device.append(row)
    spans = [r for r in host if r[0] == CHUNK_SPAN]
    if len(spans) != n_chunks:
        raise RuntimeError(f"the trace holds {len(spans)} chunk spans, "
                           f"expected {n_chunks}")
    start = min(s for _, s, _ in spans)
    end = max(s + d for _, s, d in spans)
    return Trace(device=device, host=host, start_ns=start, end_ns=end,
                 updates=n_chunks * updates_per_chunk, chunks=n_chunks,
                 shapes=shapes, untraced_s=untraced)


def breakdown(tr: Trace, top: int = 10, gaps: int = 500) -> dict:
    """The device operations that took most time, and the longest idle
    gaps by the innermost host event that spans their middle."""
    by_name: dict = {}
    for name, _, d in tr.device:
        by_name[name] = by_name.get(name, 0) + d
    ops = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:top]
    iv = tr.busy_intervals()
    edges = np.concatenate([[tr.start_ns], iv.ravel(), [tr.end_ns]])
    g = edges.reshape(-1, 2)
    g = g[g[:, 1] > g[:, 0]]
    g = g[np.argsort(g[:, 0] - g[:, 1], kind="stable")][:gaps]
    h = np.array([(s, s + d) for _, s, d in tr.host], np.int64).reshape(-1, 2)
    names = [n for n, _, _ in tr.host]
    idle: dict = {}
    for s, e in g:
        mid = (s + e) // 2
        hit = np.nonzero((h[:, 0] <= mid) & (h[:, 1] >= mid))[0]
        name = names[hit[np.argmax(h[hit, 0])]] if hit.size else "(no host event)"
        idle[name] = idle.get(name, 0) + int(e - s)
    idle_top = sorted(idle.items(), key=lambda kv: kv[1], reverse=True)[:top]
    return {"device_ops": [[n[:120], v / 1e9] for n, v in ops],
            "idle_gaps": [[n[:120], v / 1e9] for n, v in idle_top]}
