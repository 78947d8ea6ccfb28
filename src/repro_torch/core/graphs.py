"""Captured programs: the port's counterpart of the reference's jitted
programs for the fused tuning loop (DESIGN.md §10, §14, §15).

The reference compiles one episode batch, one policy update and one epoch of
K updates into one XLA program each, and replays it while its static shape
bundle holds. Eager PyTorch launches every op from the host instead (~3800
launches a tuning update at N=1024), so the port captures the same
computations as CUDA graphs and replays them.

A ``Program`` wraps a function ``fn()`` that reads and writes only tensors
that outlive it (the fixed addresses a graph bakes in) and returns its
outputs. On the CPU every call runs ``fn()`` eagerly, on the same buffers.
On a CUDA device:

* the first call runs ``fn()`` eagerly on a side stream: the warm-up the
  PyTorch CUDA-graphs notes ask for before a capture (lazy library loads,
  cuBLAS handles, the autograd engine), and a real call all the same;
* the second call captures ``fn()`` into a graph, registering the draw
  sources it reads (``PhiloxDraws.register``), then replays it;
* every later call replays the graph. The outputs live in the graph's
  memory and are overwritten by the next replay: callers copy what they
  keep.

A failed capture raises; there is no eager fallback on the card. The
``fleet_tick`` and ``fleet_scan`` launches a graph records are added to
each kernel's ``LAUNCHES`` at each replay, so a path's launch count reads
the same whether it ran eagerly or from graphs; so are the fleet mesh's
collectives to ``repro_torch.distribution.sharding.COLLECTIVES``.

**On a fleet mesh (DESIGN.md §11).** NCCL collectives can be captured: a
program on an NCCL mesh captures as above (its first, eager call creates
the communicator), in the ``thread_local`` capture mode, so the process
group's watchdog thread polling its events cannot invalidate the capture.
gloo's collectives run on the host and cannot be captured: a program on a
gloo mesh is built with ``eager=<reason>`` and runs ``fn()`` eagerly at
every call, on the card too. The choice follows the backend, never a
caught failure.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.distribution import sharding as _sh
from repro_torch.kernels import fleet_scan as _fs
from repro_torch.kernels import fleet_tick as _ft

#: the window kernels a captured program may hold
_KERNELS = (_ft, _fs)

#: program key -> captures made under it (the twin of the reference's
#: ``TRACE_COUNTS``; on the CPU, programs built): outer iterations at a
#: steady shape never grow it
CAPTURE_COUNTS: dict = {}


class Program:
    """One captured computation; see the module docstring. ``draws`` are the
    draw sources ``fn`` reads (registered with the graph at capture).
    ``eager`` (a reason) runs every call eagerly on the card too;
    ``collectives`` captures in the ``thread_local`` mode."""

    def __init__(self, key: tuple, fn, device: torch.device, draws=(), *,
                 eager: Optional[str] = None, collectives: bool = False):
        self.key = key
        self.fn = fn
        self.device = torch.device(device)
        self.draws = tuple(draws)
        self.eager = eager
        self.capture_mode = "thread_local" if collectives else "global"
        self.calls = 0
        self.graph = None
        self.out = None
        #: fleet_tick launches the graph holds (added at every replay)
        self.launches = 0
        #: fleet_scan launches the graph holds (added at every replay)
        self.scan_launches = 0
        #: fleet-mesh collectives the graph holds (added at every replay)
        self.collectives = 0
        if self.device.type != "cuda" or eager is not None:
            CAPTURE_COUNTS[key] = CAPTURE_COUNTS.get(key, 0) + 1

    def __call__(self):
        self.calls += 1
        if self.device.type != "cuda" or self.eager is not None:
            return self.fn()
        if self.calls == 1:
            return self._warm_up()
        if self.graph is None:
            self._capture()
        self.graph.replay()
        _ft.LAUNCHES += self.launches
        _fs.LAUNCHES += self.scan_launches
        _sh.COLLECTIVES += self.collectives
        return self.out

    def _warm_up(self):
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self.fn()
        cur.wait_stream(side)
        return out

    def _capture(self) -> None:
        for d in self.draws:
            if not hasattr(d, "register"):
                raise TypeError(
                    f"{type(d).__name__} cannot be captured into a CUDA "
                    "graph (it draws on the host); use PhiloxDraws on the "
                    "card")
        graph = torch.cuda.CUDAGraph()
        for d in self.draws:
            d.register(graph)
        n0 = [k.CAPTURED for k in _KERNELS]
        c0 = _sh.CAPTURED
        with torch.cuda.graph(graph, capture_error_mode=self.capture_mode):
            out = self.fn()
        self.launches, self.scan_launches = (
            k.CAPTURED - n for k, n in zip(_KERNELS, n0))
        self.collectives = _sh.CAPTURED - c0
        self.graph, self.out = graph, out
        CAPTURE_COUNTS[self.key] = CAPTURE_COUNTS.get(self.key, 0) + 1
