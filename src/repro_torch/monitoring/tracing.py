"""Program spans: one primitive, ``span(name)``, that names the port's work
in a ``torch.profiler`` trace, and the table that names the rows a
captured graph replays.

``span(name)`` is a context manager:

* while a profiler of ``torch.autograd`` is active (``torch.profiler``'s
  ``profile``, whoever opened it), it is
  ``torch.profiler.record_function(name)``: the span lands in the
  profiler's trace, on the clock of its device rows;
* while a ``repro_torch.core.graphs.Program`` captures a CUDA graph
  (``recording``), it also records in the program's ``SpanTable`` the
  span's name, its parent and the graph's device nodes at entry and at
  exit;
* otherwise it is one shared null context: no allocation, no record.

There is no switch: the profiler's presence is the switch.

**Replayed graphs.** A replay runs no Python, so its device rows carry no
span. One stream orders a captured program, so a replay's device rows come
in the order of the graph's nodes, and node ``j`` belongs to the innermost
span whose ``[enter, exit)`` holds it, or to the program's root span
(``rt.program#<index>``) where none does. Only kernel, memcpy and memset
nodes are counted: the kinds a replay turns into device rows. The count
comes from the CUDA driver (``cuStreamGetCaptureInfo`` on the capture
stream, ``cuGraphGetNodes``, ``cuGraphNodeGetType``) and costs host time at
capture only; the graph is the same whether a profiler ever reads it.
``TABLES`` keeps each captured program's table under its index; the
program's replay span, ``rt.replay#<index>``, holds the
``cudaGraphLaunch`` of that graph, so a reader of a trace can expand each
launch into its rows (``tunebench/harness/spans.py``).

Span names begin with ``rt.``. None contains ``LaunchKernel``,
``GraphLaunch`` or ``fleet_tick``, which readers of a trace match in the
profiler's own row names.
"""
from __future__ import annotations

import contextlib
import ctypes
import itertools
from dataclasses import dataclass
from typing import Callable, Optional

import torch

#: program index -> the ``SpanTable`` recorded at its capture
TABLES: dict = {}

_NULL = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled
_programs = itertools.count()
#: the capture being recorded, or None
_recording: Optional["_Recorder"] = None


def span(name: str):
    """A span named ``name`` around the ``with`` block (see the module
    docstring)."""
    if _recording is not None:
        return _RecordedSpan(_recording, name)
    if _profiling():
        return torch.profiler.record_function(name)
    return _NULL


def program_index() -> int:
    """A new program's index, the key of its table in ``TABLES``."""
    return next(_programs)


@dataclass(frozen=True)
class SpanTable:
    """The spans of one captured program, in the order they were entered
    (a parent before its children); entry 0 is the program's root span,
    which holds every node of the graph."""
    program: int
    names: tuple
    parents: tuple      # index of each span's parent; -1 for the root
    enter: tuple        # device nodes in the graph at the span's entry
    exit: tuple         # ... and at its exit

    @property
    def nodes(self) -> int:
        """The graph's device nodes: the rows one replay makes."""
        return self.exit[0]

    def node_spans(self) -> list:
        """The innermost span of each device node, in node order."""
        owner = [0] * self.nodes
        for i in range(1, len(self.names)):
            owner[self.enter[i]:self.exit[i]] = \
                [i] * (self.exit[i] - self.enter[i])
        return owner

    def path(self, i: int) -> tuple:
        """The names from span ``i`` up to the root."""
        out = []
        while i >= 0:
            out.append(self.names[i])
            i = self.parents[i]
        return tuple(out)


class _Recorder:
    def __init__(self, program: int, count: Callable[[], int]):
        self.program = program
        self.count = count
        self.rows = [[f"rt.program#{program}", -1, 0, None]]
        self.stack = [0]

    def table(self) -> SpanTable:
        self.rows[0][3] = self.count()
        names, parents, enter, exit_ = zip(*self.rows)
        return SpanTable(self.program, names, parents, enter, exit_)


class _RecordedSpan:
    """A span inside a capture: the node counts at entry and exit, and the
    profiler's span when one is active."""
    __slots__ = ("rec", "name", "row", "prof")

    def __init__(self, rec: _Recorder, name: str):
        self.rec, self.name = rec, name
        self.prof = torch.profiler.record_function(name) \
            if _profiling() else None

    def __enter__(self):
        rec = self.rec
        if self.prof is not None:
            self.prof.__enter__()
        self.row = len(rec.rows)
        rec.rows.append([self.name, rec.stack[-1], rec.count(), None])
        rec.stack.append(self.row)

    def __exit__(self, *exc):
        rec = self.rec
        rec.stack.pop()
        rec.rows[self.row][3] = rec.count()
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False


@contextlib.contextmanager
def recording(program: int, count: Callable[[], int]):
    """Record the spans entered inside the block into ``TABLES[program]``;
    ``count()`` gives the device nodes of the graph under capture
    (``capture_node_counter``; a test passes its own). The table is kept
    when the block ends without an exception."""
    global _recording
    if _recording is not None:
        raise RuntimeError("a capture is being recorded already")
    rec = _recording = _Recorder(program, count)
    try:
        yield rec
    finally:
        _recording = None
    TABLES[program] = rec.table()


# ------------------------------------------------------------ driver calls
#: CUgraphNodeType values of the nodes a replay turns into device rows
_KERNEL, _MEMCPY, _MEMSET = 0, 1, 2
_DRIVER = None


def _driver():
    global _DRIVER
    if _DRIVER is None:
        lib = ctypes.CDLL("libcuda.so.1")
        vp, sz = ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)
        info = lib.cuStreamGetCaptureInfo_v2
        info.argtypes = [vp, ctypes.POINTER(ctypes.c_int),
                         ctypes.POINTER(ctypes.c_uint64),
                         ctypes.POINTER(vp), ctypes.POINTER(vp), sz]
        nodes = lib.cuGraphGetNodes
        nodes.argtypes = [vp, vp, sz]
        kind = lib.cuGraphNodeGetType
        kind.argtypes = [vp, ctypes.POINTER(ctypes.c_int)]
        for fn in (info, nodes, kind):
            fn.restype = ctypes.c_int
        _DRIVER = (info, nodes, kind)
    return _DRIVER


def _check(rc: int, call: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{call}: CUDA driver error {rc}")


def capture_node_counter() -> Callable[[], int]:
    """A function that counts the kernel, memcpy and memset nodes of the
    graph the current CUDA stream is capturing (call it inside the
    capture)."""
    info, get_nodes, get_kind = _driver()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    rows: dict = {}          # node handle -> 1 if it makes a device row

    def count() -> int:
        status, cid = ctypes.c_int(), ctypes.c_uint64()
        graph, deps = ctypes.c_void_p(), ctypes.c_void_p()
        ndeps, n = ctypes.c_size_t(), ctypes.c_size_t()
        _check(info(stream, status, cid, graph, deps, ndeps),
               "cuStreamGetCaptureInfo")
        if status.value != 1:           # CU_STREAM_CAPTURE_STATUS_ACTIVE
            raise RuntimeError("capture_node_counter: the stream is not "
                               "capturing")
        _check(get_nodes(graph, None, n), "cuGraphGetNodes")
        handles = (ctypes.c_void_p * n.value)()
        _check(get_nodes(graph, handles, n), "cuGraphGetNodes")
        total = 0
        for h in handles:
            r = rows.get(h)
            if r is None:
                kind = ctypes.c_int()
                _check(get_kind(ctypes.c_void_p(h), kind),
                       "cuGraphNodeGetType")
                r = rows[h] = int(kind.value in (_KERNEL, _MEMCPY, _MEMSET))
            total += r
        return total

    return count
