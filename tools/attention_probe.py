"""What holds the bf16 flash-attention kernel back, and what its design
choices are worth.

    python3 tools/attention_probe.py

Needs one CUDA card and nvcc (see src/repro_torch/kernels/build.py). It
builds variants of csrc/flash_attention.cu and times each by device time (a
CUDA graph of 100 launches, as chip_smoke.py's phase 6), in alternating
order, at the Qwen2-7B serve shape (B=32, Hq=28, Hkv=4, S=64, hd=128, bf16,
causal), at Sq=1 decode over 512 keys and at causal S=2048:

* ``kernel``: the source as it stands;
* ``whole-tiles``: the softmax over whole 64-key tiles (KN = 64) with three
  blocks an SM (MMA_MIN_BLOCKS = 3);
* ``qk-skips``: 8-key tiles of Q.K^T at or past the block's key limit
  skipped as well (the kernel skips only 16-key steps of P.V);
* ``loads-stores`` (serve shape only): every step between a tile's arrival
  and the epilogue cut out, so each block only stages Q, K and V and stores
  its (zero) output: the time of the kernel's memory traffic in its own
  tiling, with no compute to hide;

beside ``torch`` copies of the serve shape's bytes (o from q, and k and v)
and ``scaled_dot_product_attention(is_causal=True, enable_gqa=True)``. It
prints ptxas's registers and spills of each variant at hd 128 and the
card's name and power limit, and checks each variant's output against the
plain version (the loads-stores variant writes zeros and is not checked).
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

#: the text that opens a tile's compute and the text that follows it
COMPUTE_FROM = "    // the tile in steps of KN keys"
COMPUTE_TO = "    if (t + 2 < ntiles) {"
#: the head of the Q.K^T loop over 8-key tiles
QK_TILE = ("        for (int n = 0; n < KN / 8; ++n) {\n"
           "          uint32_t kf[4];")
QK_SKIP = "          if (k0 + kh + n * 8 >= kend) break;\n"
#: (label, B, Hq, Hkv, Sq, Skv, hd, q_offset)
SHAPES = [("serve", 32, 28, 4, 64, 64, 128, 0),
          ("decode", 4, 28, 4, 1, 512, 128, 511),
          ("long", 1, 28, 4, 2048, 2048, 128, 0)]


def _variants(src: str) -> dict:
    a, b = src.find(COMPUTE_FROM), src.find(COMPUTE_TO)
    swaps = [("constexpr int KN = 32;", "constexpr int KN = 64;"),
             ("constexpr int MMA_MIN_BLOCKS = 4;",
              "constexpr int MMA_MIN_BLOCKS = 3;")]
    if a < 0 or b < a or QK_TILE not in src or \
            any(old not in src for old, _ in swaps):
        raise RuntimeError("flash_attention.cu no longer has the text this "
                           "probe edits; update the probe")
    whole = src
    for old, new in swaps:
        whole = whole.replace(old, new)
    head = QK_TILE.split("\n")[0] + "\n"
    idle = ("    if (t + 1 < ntiles) cp_async_wait<2>(); "
            "else cp_async_wait<0>();\n    __syncthreads();\n")
    return {"kernel": src, "whole-tiles": whole,
            "qk-skips": src.replace(head, head + QK_SKIP),
            "loads-stores": src[:a] + idle + src[b:]}


def _build(name: str, text: str):
    out_dir = kbuild.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
    cu.write_text(text)
    proc = subprocess.run([kbuild.nvcc(), *fa.NVCC_FLAGS, "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{log}")
    fn = ctypes.CDLL(str(so)).flash_attention_launch
    fn.argtypes = fa._launcher().argtypes
    fn.restype = ctypes.c_int
    # ptxas reports the bf16 kernels first, hd 128 before 64 and 32
    regs = re.findall(r"Used (\d+) registers", log)[0]
    spills = re.findall(r"(\d+) bytes spill stores", log)[0]
    return name, fn, regs, spills


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_probe: no CUDA device", file=sys.stderr)
        return 2
    facts = cs._gpu_facts()
    src = (kbuild.CSRC / fa.SOURCE).read_text()
    fa._launcher()
    variants = _variants(src)
    with ThreadPoolExecutor(len(variants)) as ex:
        built = {n: (fn, r, s) for n, fn, r, s in
                 ex.map(lambda kv: _build(*kv), variants.items())}
    dev = torch.device("cuda")
    print(f"[{facts}]")
    for name, (_, regs, spills) in built.items():
        print(f"  {name}: hd 128 {regs} registers, {spills} bytes spilled")
    for label, B, Hq, Hkv, Sq, Skv, hd, off in SHAPES:
        q, k, v = cs._attn_inputs(B, Hq, Hkv, Sq, Skv, hd, torch.bfloat16,
                                  dev, 0)
        strides = fa._launch_layout(q, k, v, off)
        want = fa.flash_attention_bhsd_ref(q, k, v, q_offset=off)

        def call(fn):
            o = torch.empty(q.shape, dtype=q.dtype, device=dev)
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1,
                    B, Hq, Hkv, Sq, Skv, hd, *strides, 1, off, hd ** -0.5,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")
            return o

        names = [n for n in built if label == "serve" or n != "loads-stores"]
        for name in names:
            err = float((call(built[name][0]).float() - want.float())
                        .abs().max())
            if name != "loads-stores" and err > cs.ATTN_TOL[torch.bfloat16]:
                raise AssertionError(f"{name} at {label}: max abs {err}")
        times = {n: [] for n in names}
        for name in (names + names[::-1]) * 2:
            times[name].append(cs._graph_ms(lambda: call(built[name][0]))
                               * 1e3)
        print(f"  {label}: B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} Skv={Skv} hd={hd} "
              f"q_offset={off}, bf16, causal; device us per launch:")
        for name, t in times.items():
            print(f"    {name}: " + ", ".join(f"{x:.3f}" for x in t))
        if label != "serve":
            continue
        o, kv = torch.empty_like(q), torch.empty_like(k)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        extra = {
            "torch copy o <- q (29.4 MB moved)": lambda: o.copy_(q),
            "torch copies o <- q, k, v (37.7 MB moved)":
                lambda: (o.copy_(q), kv.copy_(k), kv.copy_(v)),
            "scaled_dot_product_attention": lambda: sdpa(
                q, k, v, is_causal=True, enable_gqa=True),
        }
        for name, fn in extra.items():
            print(f"    {name}: {cs._graph_ms(fn) * 1e3:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
