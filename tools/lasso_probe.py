"""Where the lasso_cd kernel's time goes.

    python3 tools/lasso_probe.py

Needs one CUDA card and nvcc (see src/repro_torch/kernels/build.py). At the
tuner's shape, chip_smoke.py phase 11's planted matrix (1200 rows, 109
levers and their squares: p = 218, A in shared memory; 60 lambdas x up to
60 epochs), it builds variants of csrc/lasso_cd.cu and times each launch by
device time (a CUDA graph of 2 launches), in alternating order:

* ``kernel``: the source as it stands, held bitwise to its CPU mirror;
* ``every-epoch``: the exact epoch skip cut out, so every lambda runs all
  60 epochs (the same moves: a skipped epoch moves nothing, and costs a
  round a chunk);
* ``no-carry``: the row update c -= delta A[j] cut out (the moving lane's
  own c takes delta times 0, so the shuffle stays on the chain) and c
  formed at the first lambda only, held bitwise to the mirror with
  ``carry=False``, which also counts its rounds.

Then the bare chain: a warp that runs only a round's threshold, division,
ballot, shuffle and multiply-subtract, on registers, with no read of A, as
many rounds as the kernel ran, once with the division and once without it.
The first is the chain bound of the kernel's path. It prints the mirror's
epochs run, updates, moves and rounds of each variant, ns a round and an
update, ptxas's registers and spills of each, and the card's name and power
limit.
"""
from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import _probe  # noqa: E402
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import lasso_cd as lc  # noqa: E402

#: (first text cut, the text that follows it) of each cut
SKIP = ("      if (!moved) break;", "  // a fixed point")
CARRY = ("          // carry: c_k -= delta A[j, k]",
         "          // end of the carry")
#: the lambdas' refresh of c, which the no-carry variant keeps at the first
REFRESH = "    refresh_c(c, w, A, xty, p, lane);\n"

CHAIN_SRC = r"""
#include <cuda_runtime.h>
#include <math.h>
// one warp, `rounds` rounds of lasso_cd's chain and nothing else: every lane
// forms its update, the first mover's delta is broadcast and carried; c, w,
// diag(A) and the row value stay in registers
template <bool DIVIDE>
__global__ void __launch_bounds__(32, 1)
chain_kernel(const float* __restrict__ init, float* __restrict__ out,
             int rounds, float nl) {
  const int lane = threadIdx.x;
  float c = init[lane], w = 0.0f;
  const float d = init[32 + lane], a = init[64 + lane];
  for (int u = 0; u < rounds; ++u) {
    const float r = c + d * w;
    const float sg = (r > 0.0f) ? 1.0f : ((r < 0.0f) ? -1.0f : 0.0f);
    float wj = sg * fmaxf(fabsf(r) - nl, 0.0f);
    if (DIVIDE && wj != 0.0f) wj = wj / fmaxf(d, 1e-12f);
    const float delta = wj - w;
    const unsigned movers = __ballot_sync(0xffffffffu, delta != 0.0f);
    const int o = movers ? __ffs(movers) - 1 : 32;
    if (lane <= o) w = wj;
    const float dl = __shfl_sync(0xffffffffu, delta, o & 31);
    c = c - dl * a;
  }
  out[lane] = c + w;
}
extern "C" int lasso_chain_launch(int divide, const float* init, float* out,
                                  int rounds, float nl, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (divide) chain_kernel<true><<<1, 32, 0, s>>>(init, out, rounds, nl);
  else chain_kernel<false><<<1, 32, 0, s>>>(init, out, rounds, nl);
  return (int)cudaGetLastError();
}
"""


def _variants(src: str) -> dict:
    every = _probe.cut(src, *SKIP)
    nocarry = _probe.cut(src, *CARRY, "          c[q] = c[q] - dl * 0.0f;\n")
    assert nocarry.count(REFRESH) == 1
    nocarry = nocarry.replace(REFRESH, "    if (l == 0) " + REFRESH.lstrip())
    return {"kernel": src, "every-epoch": every, "no-carry": nocarry}


def main() -> int:
    if not torch.cuda.is_available():
        print("lasso_probe: no CUDA device", file=sys.stderr)
        return 2
    facts = cs._gpu_facts()
    src = (kbuild.CSRC / lc.SOURCE).read_text()
    built = _probe.build_variants(_variants(src), lc.NVCC_FLAGS,
                                  "lasso_cd_launch", lc.ARGTYPES, "lasso")
    chain = _probe.build_variants(
        {"chain": CHAIN_SRC}, lc.NVCC_FLAGS, "lasso_chain_launch",
        [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_float, ctypes.c_void_p], "lasso-chain")["chain"]
    dev = torch.device("cuda")
    R, y = cs._planted_levers(1200, 109, seed=0)
    A, b, lams = cs._lasso_design(R, y, dev)
    p, n_lam, epochs, n = A.shape[0], len(lams), 60, 1200.0
    in_smem = lc.a_in_smem(p)
    print(f"[{facts}]")
    tag = f"lasso_cd_kernelILi{-(-p // 32)}ELb{int(in_smem)}E"
    for name, (_, log) in {**built, "bare chain": chain}.items():
        lines = [x for x in cs._ptxas_summary(log)
                 if tag in x or "chain" in x]
        print(f"  {name}: " + (lines[0].split(": ", 1)[1] if lines else "?"))
    smem = lc.smem_bytes(p, in_smem)
    w0 = torch.zeros(p, device=dev)
    lt = torch.as_tensor(lams, dtype=torch.float32, device=dev)
    mirror, cnt = lc.lasso_cd_mirror(A, b, w0, lt, n, epochs=epochs)
    nocarry, cnt_nc = lc.lasso_cd_mirror(A, b, w0, lt, n, epochs=epochs,
                                         carry=False)
    nq = -(-p // 32)
    skipped = n_lam * epochs - cnt["epochs"]
    rounds = {"kernel": cnt["rounds"],
              "every-epoch": cnt["rounds"] + skipped * nq,
              "no-carry": cnt_nc["rounds"]}
    updates = {"kernel": cnt["updates"],
               "every-epoch": lc.chain_updates(p, n_lam, epochs),
               "no-carry": cnt_nc["updates"]}

    def call(fn):
        out = torch.empty((n_lam, p), device=dev)
        rc = fn(A.data_ptr(), b.data_ptr(), w0.data_ptr(), lt.data_ptr(),
                out.data_ptr(), p, n_lam, epochs, n, int(in_smem), smem,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return out

    for name, want in (("kernel", mirror), ("no-carry", nocarry)):
        if not torch.equal(call(built[name][0]), want):
            raise AssertionError(f"{name}: not bitwise equal to its mirror")
    # c = b, diag(A) 0.5 (w grows by 2c a round with the division and
    # settles without it, so every round moves and nothing overflows), a 0
    init = torch.cat([b[:32], torch.full((32,), 0.5, device=dev),
                      torch.zeros(32, device=dev)]).contiguous()
    out = torch.empty(32, device=dev)
    bare = lambda divide: (lambda: chain[0](
        divide, init.data_ptr(), out.data_ptr(), cnt["rounds"], 0.0,
        torch.cuda.current_stream().cuda_stream))
    calls = {name: (lambda fn=fn: call(fn)) for name, (fn, _) in built.items()}
    calls["bare chain"] = bare(1)
    calls["bare chain without the division"] = bare(0)
    times = _probe.alternate_ms(calls, rounds=2, reps=2)
    print(f"  p={p} ({'shared' if in_smem else 'global'} A) n_lam={n_lam} "
          f"epochs<={epochs}: the mirror ran {cnt['epochs']} epochs of "
          f"{n_lam * epochs}, {cnt['updates']} updates, {cnt['moves']} moved, "
          f"{cnt['rounds']} rounds; without the carry {cnt_nc['epochs']} "
          f"epochs, {cnt_nc['moves']} moved, {cnt_nc['rounds']} rounds")
    med = {}
    for name, t in times.items():
        med[name] = sorted(t)[len(t) // 2]
        nr = rounds.get(name, cnt["rounds"])
        per = f"; {med[name] * 1e6 / nr:.1f} ns a round over {nr}"
        if name in updates:
            per += (f", {med[name] * 1e6 / updates[name]:.1f} ns an update "
                    f"over {updates[name]}")
        print(f"    {name}: device ms " + ", ".join(f"{v:.3f}" for v in t)
              + per)
    print(f"  the chain bound (the bare chain over the kernel's "
          f"{cnt['rounds']} rounds) {med['bare chain']:.3f} ms, the kernel "
          f"{med['kernel']:.3f} ms at {med['bare chain'] / med['kernel']:.3f} "
          f"of it [{facts}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
