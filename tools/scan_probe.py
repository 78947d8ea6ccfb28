"""Where the fleet_scan kernel's time goes.

    python3 tools/scan_probe.py

Needs one CUDA card and nvcc (see src/repro_torch/kernels/build.py). At
chip_smoke.py phase 15's shapes N=1024 with T=48 (the main path's window)
and T=768, it builds variants of csrc/fleet_scan.cu and times each launch
by device time (a CUDA graph of 100 launches), in alternating order:

* ``kernel``: the source as it stands (UNROLL = 4 ticks a thread holds,
  the next 4 loaded ahead);
* ``u4-noprefetch``: 4 ticks loaded at the start of each group of 4, the
  chain waiting on them (this kernel's first design);
* ``u8-prefetch``, ``u16-prefetch``: 8 or 16 ticks, the next 8 or 16
  loaded ahead;
* ``chain``: the first group's grids reused for every tick (no load after
  the first): the state-coupled chain and the stores alone.

Every variant but ``chain`` must be bitwise equal to the plain version. It
prints ns a tick of each, ptxas's registers and spills, and the card's name
and power limit.
"""
from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import _probe  # noqa: E402
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import fleet_scan as fs  # noqa: E402

UNROLL = ("constexpr int UNROLL = ", ";  // ticks")
PREFETCH = ("constexpr bool PREFETCH = ", ";  // load")
RELOAD = ("constexpr bool RELOAD = ", ";  // (tools")
ARGTYPES = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 2
            + [ctypes.c_float] * 5 + [ctypes.c_void_p])


def _variant(src: str, unroll=None, prefetch=None, reload=None) -> str:
    for (start, end), value in ((UNROLL, unroll), (PREFETCH, prefetch),
                                (RELOAD, reload)):
        if value is not None:
            src = _probe.cut(src, start, end, start + value)
    return src


def main() -> int:
    if not torch.cuda.is_available():
        print("scan_probe: no CUDA device", file=sys.stderr)
        return 2
    facts = cs._gpu_facts()
    src = (fs.kbuild.CSRC / fs.SOURCE).read_text()
    variants = {"kernel": src,
                "u4-noprefetch": _variant(src, "4", "false"),
                "u8-prefetch": _variant(src, "8", "true"),
                "u16-prefetch": _variant(src, "16", "true"),
                "chain": _variant(src, reload="false")}
    libs = _probe.build_variants(variants, fs.NVCC_FLAGS,
                                 "fleet_scan_launch", ARGTYPES, "fleet_scan")
    for name, (_, log) in libs.items():
        for line in cs._ptxas_summary(log):
            print(f"  {name}: {line}")
    dev = torch.device("cuda")
    for N, T in ((1024, 48), (1024, 768)):
        args, kw = cs._scan_inputs(N, T, seed=N + T, dev=dev, fmult=True)
        want = fs.tick_scan_ref(*args, **kw)
        outs = {}

        def call(fn, out):
            ptr = lambda x: None if x is None else x.data_ptr()
            rc = fn(*[ptr(x) for x in args], ptr(out[0]), ptr(out[1]), N, T,
                    kw["noise"], kw["retention_s"], kw["straggler_prob"],
                    kw["slo"], kw["shi"] - kw["slo"],
                    torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"launch failed: CUDA error {rc}")

        calls = {}
        for name, (fn, _) in libs.items():
            out = (torch.empty((2, N), device=dev),
                   torch.empty((7, T, N), device=dev))
            call(fn, out)
            torch.cuda.synchronize()
            exact = all(torch.equal(a, b) for a, b in zip(out, want))
            if name != "chain" and not exact:
                raise AssertionError(f"{name} differs from the plain version "
                                     f"at N={N} T={T}")
            outs[name] = exact
            calls[name] = (lambda fn=fn, out=out: call(fn, out))
        times = _probe.alternate_ms(calls, rounds=2)
        for name, ts in times.items():
            ms = float(np.median(ts))
            print(f"  N={N} T={T} {name:14s} device {ms * 1e3:9.3f} us, "
                  f"{ms * 1e6 / T:7.1f} ns a tick (replays "
                  f"{', '.join(f'{t * 1e3:.3f}' for t in ts)} us), bitwise "
                  f"{outs[name]} [{facts}]")
    print(facts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
