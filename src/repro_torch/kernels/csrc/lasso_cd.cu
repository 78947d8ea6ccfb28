// The Lasso path's cyclic coordinate descent (paper §2.3): warm-started
// solutions of  min_w 1/(2n) ||y - Xw||^2 + lam ||w||_1  along a lambda
// grid, on the normal-equations form.
//
// Replaces the reference's `repro.core.lasso._cd_epoch` (a jitted
// fori_loop over the p coordinates, one XLA program an epoch) and the host
// loop around it in `lasso_path`: one launch runs every lambda of the grid
// and `epochs` cycles at each, and writes the (n_lam, p) coefficients after
// each lambda. For coordinate j of a cycle, with A = X'X and b = X'y:
//     r_j = b_j - A_j . w + A_jj w_j
//     w_j <- sign(r_j) max(|r_j| - n lam, 0) / max(A_jj, 1e-12)
// every coordinate reading the w its predecessors just wrote (Gauss-Seidel
// order), exactly as the reference does. A, b, w0 and the lambdas are f32;
// n lam is one f32 product, as in the reference.
//
// Bound on an H100 at the tuner's shape (p = 218: 109 levers and their
// squares; 60 lambdas x 60 epochs): A read once and the coefficients
// written once are 0.24 MB, ~0.07 us at 3.35 TB/s; the 2 p^2 flops of an
// epoch over 3600 epochs are 0.34 GFLOP, ~5 us at the 67 TFLOP/s of f32.
// Neither is what holds the kernel: the 785k coordinate updates form one
// dependency chain (each reads the w the previous one wrote), and each
// update is a dot of length p, a 5-step warp shuffle reduction, the soft
// threshold, a division and a write with two warp barriers. At a few
// hundred cycles an update that is tens of ms (PERF.md).
//
// Design: a single warp. The chain allows no more parallelism than one
// dot at a time, and a warp reduces it with shuffles and no block barrier.
// A sits in shared memory when it fits beside w, b and diag(A) (p <= 239
// in the 227 KB a block may take; A alone is 190,096 B at p = 218); past
// that its rows are read from global memory through L1/L2. w, b and
// diag(A) always sit in shared memory. Lane l sums A_jk w_k over k = l, l + 32, ...; the
// xor-butterfly leaves the same total in every lane, so every lane computes
// the same w_j and lane 0 writes it between two __syncwarp()s. Built with
// -fmad=false, so the update's scalar arithmetic is the plain version's f32
// operations in its order; only the dot sums in another order.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(32, 1)
lasso_cd_kernel(const float* __restrict__ xtx, const float* __restrict__ xty,
                const float* __restrict__ w0, const float* __restrict__ lams,
                float* __restrict__ coefs, int p, int n_lam, int epochs,
                float n, int a_in_smem) {
  extern __shared__ float sm[];
  float* w = sm;
  float* b = sm + p;
  float* dg = sm + 2 * p;
  float* a_sm = sm + 3 * p;
  const int lane = threadIdx.x;
  for (int k = lane; k < p; k += 32) {
    w[k] = w0[k];
    b[k] = xty[k];
    dg[k] = xtx[(size_t)k * p + k];
  }
  if (a_in_smem) {
    const size_t pp = (size_t)p * p;
    for (size_t e = lane; e < pp; e += 32) a_sm[e] = xtx[e];
  }
  __syncwarp();
  const float* A = a_in_smem ? a_sm : xtx;
  for (int l = 0; l < n_lam; ++l) {
    const float nl = n * lams[l];
    for (int e = 0; e < epochs; ++e) {
      for (int j = 0; j < p; ++j) {
        const float* row = A + (size_t)j * p;
        float s = 0.0f;
#pragma unroll 8
        for (int k = lane; k < p; k += 32) s += row[k] * w[k];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(FULL, s, off);
        const float djj = dg[j];
        const float r = (b[j] - s) + djj * w[j];
        const float sg = (r > 0.0f) ? 1.0f : ((r < 0.0f) ? -1.0f : 0.0f);
        const float wj = sg * fmaxf(fabsf(r) - nl, 0.0f) / fmaxf(djj, 1e-12f);
        __syncwarp();  // every lane has read w before it changes
        if (lane == 0) w[j] = wj;
        __syncwarp();
      }
    }
    for (int k = lane; k < p; k += 32) coefs[(size_t)l * p + k] = w[k];
  }
}

}  // namespace

// Dynamic shared memory of a launch: w, b and diag(A), plus A when
// `a_in_smem`.
extern "C" int lasso_cd_smem(int p, int a_in_smem) {
  long long floats = 3LL * p + (a_in_smem ? (long long)p * p : 0LL);
  return (int)(floats * (long long)sizeof(float));
}

// One launch: the whole path (n_lam lambdas x epochs cycles) from w0.
// coefs (n_lam, p) receives w after each lambda. `smem` must be
// lasso_cd_smem(p, a_in_smem). Returns a cudaError_t.
extern "C" int lasso_cd_launch(const float* xtx, const float* xty,
                               const float* w0, const float* lams,
                               float* coefs, int p, int n_lam, int epochs,
                               float n, int a_in_smem, int smem,
                               void* stream) {
  if (p <= 0 || n_lam < 0 || epochs < 0) return (int)cudaErrorInvalidValue;
  if (smem != lasso_cd_smem(p, a_in_smem)) return (int)cudaErrorInvalidValue;
  if (n_lam == 0) return 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lasso_cd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  lasso_cd_kernel<<<1, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      xtx, xty, w0, lams, coefs, p, n_lam, epochs, n, a_in_smem);
  return (int)cudaGetLastError();
}
