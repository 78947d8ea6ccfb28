"""Where the bf16 wkv kernel's time goes.

    python3 tools/wkv_probe.py

Needs one CUDA card and nvcc (see src/repro_torch/kernels/build.py). It
builds variants of csrc/rwkv6_wkv.cu and times each by device time (a CUDA
graph of 20 launches, as chip_smoke.py's phase 8), in alternating order, at
the rwkv6-7b train shape (B=4, H=64, S=4096, hd=64, bf16 r/k/v, logw over
the model's clip range):

* ``kernel``: the source as it stands;
* ``no-diagonal``: the diagonal scores (phase A.2) cut out;
* ``no-scans``: the decay scans (phase A.1) cut out;
* ``no-sub-chunks``: the tensor-core sub-chunk steps (phase B) cut out;
* ``staging-only``: all three cut out, so each block only stages its
  chunks: the time of the kernel's loads in its own tiling.

Cut variants compute wrong values and are not checked; ``kernel`` is held
to chip_smoke.py's bf16 tolerance against the plain chunked version. It
prints ptxas's registers and spills of each variant's hd-64 kernel and the
card's name and power limit.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import _probe  # noqa: E402
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import rwkv6_wkv as wkv  # noqa: E402
from repro_torch.models.layers import wkv6_chunked  # noqa: E402

#: (first line of a phase, the line that follows it)
PHASES = {
    "scans": ("    // (A.1) one (direction, sub-chunk, key channel) a thread",
              "    // (A.2) the diagonal blocks"),
    "diagonal": ("    // (A.2) the diagonal blocks",
                 "    __syncthreads();  // (A) done"),
    "sub-chunks": ("    // (B) the sub-chunks in order",
                   "  float* sb = sfin"),
}


def _cut(src: str, phase: str) -> str:
    # the sub-chunk steps end the chunk loop: keep its closing brace
    return _probe.cut(src, *PHASES[phase],
                      keep="  }\n\n" if phase == "sub-chunks" else "")


def _variants(src: str) -> dict:
    staging = src
    for phase in PHASES:
        staging = _cut(staging, phase)
    return {"kernel": src,
            "no-diagonal": _cut(src, "diagonal"),
            "no-scans": _cut(src, "scans"),
            "no-sub-chunks": _cut(src, "sub-chunks"),
            "staging-only": staging}


def _hd64(log: str) -> str:
    """ptxas's registers and spills of the hd-64 bf16 kernel."""
    hd64 = [x for x in cs._ptxas_summary(log)
            if "wkv_kernel_mmaILi64ELi64ELi8E" in x]
    return hd64[0].split(": ", 1)[1] if hd64 else "?"


def main() -> int:
    if not torch.cuda.is_available():
        print("wkv_probe: no CUDA device", file=sys.stderr)
        return 2
    facts = cs._gpu_facts()
    src = (kbuild.CSRC / wkv.SOURCE).read_text()
    built = _probe.build_variants(
        _variants(src), wkv.NVCC_FLAGS, "rwkv6_wkv_launch",
        wkv._library().rwkv6_wkv_launch.argtypes, "wkv")
    print(f"[{facts}]")
    for name, (_, log) in built.items():
        print(f"  {name}: {_hd64(log)}")
    dev = torch.device("cuda")
    B, H, S, hd = 4, 64, 4096, 64
    r, k, v, lw, u = cs._wkv_inputs(B, H, S, hd, torch.bfloat16, dev, 0)
    bhsd = [x.transpose(1, 2) for x in (r, k, v, lw)]
    strides = wkv._launch_layout(*bhsd)
    want, _ = wkv6_chunked(r, k, v, lw, u, chunk=32)
    want = want.transpose(1, 2).to(torch.bfloat16)
    smem = wkv.mma_smem_bytes(hd, hd)

    def call(fn):
        o = torch.empty((B, H, S, hd), dtype=torch.bfloat16, device=dev)
        sfin = torch.empty((B, H, hd, hd), device=dev)
        rc = fn(*(x.data_ptr() for x in bhsd), u.data_ptr(), o.data_ptr(),
                sfin.data_ptr(), 1, B, H, S, hd, 32, *strides, smem,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return o

    err, scale = cs._scaled_err(call(built["kernel"][0]), want)
    if err / scale > cs.WKV_TOL[torch.bfloat16]:
        raise AssertionError(f"kernel: scaled error {err / scale}")
    print(f"  kernel: o scaled max_abs {err / scale:.3e} against wkv6_chunked")
    times = _probe.alternate_ms(
        {n: (lambda fn=fn: call(fn)) for n, (fn, _) in built.items()},
        reps=20)
    print(f"  B={B} H={H} S={S} hd={hd} bf16, device ms per launch:")
    for name, t in times.items():
        print(f"    {name}: " + ", ".join(f"{x:.4f}" for x in t))
    return 0


if __name__ == "__main__":
    sys.exit(main())
