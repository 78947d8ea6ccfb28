"""What the kernel probes (``tools/*_probe.py``) share: build edited copies
of a kernel's source side by side, and time them in alternating order.

Needs nvcc (see src/repro_torch/kernels/build.py) and, to time, one CUDA
card. The probes put the repo's ``src`` and root on ``sys.path`` before they
import this module.
"""
from __future__ import annotations

import ctypes
import subprocess
from concurrent.futures import ThreadPoolExecutor

import chip_smoke as cs
from repro_torch.kernels import build as kbuild


def cut(src: str, start: str, end: str, keep: str = "") -> str:
    """``src`` with the text from ``start`` up to ``end`` replaced by
    ``keep``; raises if either anchor is missing or out of order, so a probe
    notices when the source it edits has moved on."""
    a = src.find(start)
    b = src.find(end, a + 1) if a >= 0 else -1
    if a < 0 or b < 0:
        raise RuntimeError(f"the source no longer has the text a probe edits "
                           f"({start.strip()!r} ... {end.strip()!r}); "
                           "update the probe")
    return src[:a] + keep + src[b:]


def build_variants(variants: dict, flags: tuple, symbol: str,
                   argtypes: list, prefix: str) -> dict:
    """{name: source text} -> {name: (launch function, nvcc log)}: one nvcc
    per variant, all started together, into ``build/kernels/probe/``; each
    library's ``symbol`` gets ``argtypes`` (the real wrapper's) and an int
    result."""
    out_dir = kbuild.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)

    def build(item):
        name, text = item
        cu = out_dir / f"{prefix}-{name}.cu"
        so = out_dir / f"lib{prefix}-{name}.so"
        cu.write_text(text)
        proc = subprocess.run([kbuild.nvcc(), *flags, "-o", str(so), str(cu)],
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        fn = getattr(ctypes.CDLL(str(so)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return name, (fn, log)

    with ThreadPoolExecutor(len(variants)) as ex:
        return dict(ex.map(build, variants.items()))


def alternate_ms(calls: dict, rounds: int = 1, reps: int = 100) -> dict:
    """{name: call} -> {name: [device ms a call]}: each call timed by a CUDA
    graph of ``reps`` calls (chip_smoke's ``_graph_ms``), in the order of
    the names, then reversed, ``rounds`` times over, so that a drift of the
    card's clock falls on every variant alike."""
    names = list(calls)
    times = {n: [] for n in names}
    for name in (names + names[::-1]) * rounds:
        times[name].append(cs._graph_ms(calls[name], reps=reps))
    return times
