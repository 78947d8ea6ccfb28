"""Where the SSD kernel's time goes.

    python3 tools/ssd_probe.py

Needs one CUDA card and nvcc (see src/repro_torch/kernels/build.py). It
builds variants of csrc/mamba2_ssd.cu and times each by device time (a CUDA
graph of 20 launches, as chip_smoke.py's phase 10), in alternating order,
at zamba2-2.7b's mixer shape (B=4, nh=80, S=4096, hd=64, ns=64), in f32 and
in bf16, with loga drawn as chip_smoke.py draws it:

* ``kernel``: the source as it stands;
* ``no-scores``: the products of the scores C B^T cut out;
* ``no-inter``: the products of the inter-chunk term h C^T cut out;
* ``no-intra``: the products of the intra-chunk term x^T G^T cut out;
* ``no-update``: the products of the state update cut out;
* ``no-splits``: every f32 operand taken as its own hi part (Veltkamp's
  split cut out, the mma passes kept): the price of the splitting;
* ``two-blocks``: ``__launch_bounds__`` asking for 2 blocks an SM, not 3
  (more registers a thread, fewer warps, a second wave);
* ``staging-only``: each sub-chunk's work cut out, so each block only
  stages its chunks and scans its decays: the time of the kernel's loads
  in its own tiling.

Cut variants compute wrong values and are not checked; ``kernel`` is held
to chip_smoke.py's tolerance against the plain chunked version. It prints
ptxas's registers and spills of each variant's hd-64, ns-64 kernels and the
card's name and power limit.

Then the rate of ``mma.sync`` alone on this card, the yardstick of the
kernel's tensor work: a block of 4 warps issues 8 independent chains of
m16n8k8 TF32 (or m16n8k16 bf16) mma, 3 blocks on every SM (3 warps a
sub-partition, as on the kernel's busiest SMs); it prints TFLOP/s and the
ns an mma takes on one of an SM's four sub-partitions.
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
from repro_torch.kernels import mamba2_ssd as ssd  # noqa: E402

#: (first text cut, the text that follows it) of each cut
CUTS = {
    "scores": ("        mma3<EX, EX>(ga, gc, ge",
               "      }\n      add(gc, ge)"),
    "inter": ("        mma3<false, EX>(yacc[0]",
              "      }\n      // the inter term reads"),
    "intra": ("          mma3<EX, false>(yacc[tt]", "        }\n      }\n"
              "#pragma unroll\n      for (int tt = 0; tt < 2; ++tt) {\n"
              "        add(yacc"),
    "update": ("          mma3<false, EX>(u, uc", "        }\n        float(&h)"),
    "splits": ("EXACT ? v : tf32_hi(v)", ";\n  hi = __float_as_uint(h);"),
    "blocks": ("MIN_BLOCKS = (NS <= 64 ? 3", " : 2) * 4 / W;"),
    "sub-chunks": ("      // x at (s, i) in the pair order",
                   "    }\n  }\n}\n\ntemplate <typename T, int HD, int NS>"),
}


def _variants(src: str) -> dict:
    out = {"kernel": src}
    for name, (start, end) in CUTS.items():
        label = {"sub-chunks": "staging-only", "blocks": "two-blocks"}.get(
            name, f"no-{name}")
        keep = {"splits": "EXACT ? v : v",
                "blocks": "MIN_BLOCKS = (NS <= 64 ? 2"}.get(name, "")
        out[label] = _probe.cut(src, start, end, keep)
    return out


MMA_RATE_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// 8 independent accumulators a thread, ITERS rounds of 8 mma each
template <bool BF16>
__global__ void __launch_bounds__(128, 3) mma_rate(float* out, int iters) {
  float d[8][4] = {};
  const uint32_t v = 0x3f800000u + threadIdx.x;  // ~1.0, bf16 pairs ~1.9
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (BF16)
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%4,%4,%4}, {%4,%4}, {%0,%1,%2,%3};\n"
            : "+f"(d[k][0]), "+f"(d[k][1]), "+f"(d[k][2]), "+f"(d[k][3])
            : "r"(v));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%4,%4,%4}, {%4,%4}, {%0,%1,%2,%3};\n"
            : "+f"(d[k][0]), "+f"(d[k][1]), "+f"(d[k][2]), "+f"(d[k][3])
            : "r"(v));
    }
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) s += d[k][0] + d[k][1] + d[k][2] + d[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_rate_launch(int bf16, float* out, int blocks, int iters,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) mma_rate<true><<<blocks, 128, 0, s>>>(out, iters);
  else mma_rate<false><<<blocks, 128, 0, s>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def _mma_rate(facts: str) -> None:
    """TFLOP/s of mma.sync alone, TF32 m16n8k8 and bf16 m16n8k16, 3 blocks
    of 4 warps on every SM."""
    import ctypes

    fn = _probe.build_variants(
        {"rate": MMA_RATE_SRC}, ssd.NVCC_FLAGS, "mma_rate_launch",
        [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p], "mma")["rate"][0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = 3 * sms, 4096
    out = torch.empty(blocks * 128, device="cuda")
    for bf16, (name, flops) in enumerate((("tf32 m16n8k8", 2048),
                                          ("bf16 m16n8k16", 4096))):
        call = lambda bf16=bf16: fn(bf16, out.data_ptr(), blocks, iters,
                                    torch.cuda.current_stream().cuda_stream)
        ms = cs._time_ms(call, reps=5, warmup=2)
        n = blocks * 4 * iters * 8  # mma over all warps
        print(f"  mma.sync {name}: {n * flops / ms / 1e9:.1f} TFLOP/s, "
              f"{ms * 1e6 / (n / (sms * 4)):.3f} ns an mma on a "
              f"sub-partition [{facts}]")


def _hd64(log: str, tag: str) -> str:
    """ptxas's registers and spills of the hd-64, ns-64 kernel of a dtype."""
    lines = [x for x in cs._ptxas_summary(log)
             if f"ssd_kernel{tag}64ELi64E" in x]
    return lines[0].split(": ", 1)[1] if lines else "?"


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_probe: no CUDA device", file=sys.stderr)
        return 2
    facts = cs._gpu_facts()
    src = (kbuild.CSRC / ssd.SOURCE).read_text()
    built = _probe.build_variants(
        _variants(src), ssd.NVCC_FLAGS, "mamba2_ssd_launch",
        ssd._library().mamba2_ssd_launch.argtypes, "ssd")
    print(f"[{facts}]")
    for name, (_, log) in built.items():
        print(f"  {name}: f32 {_hd64(log, 'IfLi')}; bf16 "
              f"{_hd64(log, 'I13__nv_bfloat16Li')}")
    dev = torch.device("cuda")
    B, nh, S, hd, ns = 4, 80, 4096, 64, 64
    for dt in (torch.float32, torch.bfloat16):
        x, bm, cm, la = cs._ssd_inputs(B, nh, S, hd, ns, dt, dev, seed=0)
        strides = ssd._launch_layout(x, bm, cm, la)
        smem = ssd.smem_bytes(hd, ns, x.element_size())
        want = ssd.mamba2_ssd_chunked(x, bm, cm, la)

        def call(fn, x=x, bm=bm, cm=cm, la=la, strides=strides, smem=smem):
            y = torch.empty_like(x)
            rc = fn(x.data_ptr(), bm.data_ptr(), cm.data_ptr(), la.data_ptr(),
                    y.data_ptr(), kbuild.DTYPE_CODES[x.dtype], B, nh, S, hd,
                    ns, *strides, smem,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")
            return y

        err, scale = cs._scaled_err(call(built["kernel"][0]), want)
        if err / scale > cs.SSD_TOL[dt]:
            raise AssertionError(f"kernel: scaled error {err / scale}")
        name = str(dt).removeprefix("torch.")
        print(f"  {name} kernel: y scaled max_abs {err / scale:.3e} against "
              f"mamba2_ssd_chunked")
        times = _probe.alternate_ms(
            {n: (lambda fn=fn: call(fn)) for n, (fn, _) in built.items()},
            reps=20)
        print(f"  B={B} nh={nh} S={S} hd={hd} ns={ns} {name}, device ms per "
              f"launch:")
        for label, t in times.items():
            print(f"    {label}: " + ", ".join(f"{v:.4f}" for v in t))
        del x, bm, cm, la, want
    _mma_rate(facts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
