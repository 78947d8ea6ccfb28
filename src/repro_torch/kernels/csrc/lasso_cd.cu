// The Lasso path's cyclic coordinate descent (paper §2.3): warm-started
// solutions of  min_w 1/(2n) ||y - Xw||^2 + lam ||w||_1  along a lambda
// grid, on the normal-equations form.
//
// Replaces the reference's `repro.core.lasso._cd_epoch` (a jitted
// fori_loop over the p coordinates, one XLA program an epoch) and the host
// loop around it in `lasso_path`: one launch runs every lambda of the grid
// and up to `epochs` cycles at each, and writes the (n_lam, p) coefficients
// after each lambda. For coordinate j of a cycle, with A = X'X and b = X'y,
// the reference computes
//     r_j = b_j - A_j . w + A_jj w_j
//     w_j <- sign(r_j) max(|r_j| - n lam, 0) / max(A_jj, 1e-12)
// every coordinate reading the w its predecessors just wrote (Gauss-Seidel
// order). A, b, w0 and the lambdas are f32; n lam is one f32 product.
//
// What bounds it on an H100: not the roofline (at the tuner's shape, p =
// 218 with 60 lambdas x 60 epochs, A is 0.19 MB and the arithmetic a few
// microseconds at the f32 peak) but the chain of updates: each reads the w
// the one before it wrote. So the design makes an update's chain short.
//
// * A carried gradient. c = b - A w is formed afresh at the start of each
//   lambda, from the w it starts from (w0 at the first): one shuffle
//   broadcasts each w_m, and a zero w_m adds nothing and is skipped, so w0
//   = 0 gives c = b exactly. An update then reads r_j = c_j + A_jj w_j, and
//   only when it moves w_j by delta != 0 does every lane apply c_k -= delta
//   A[j, k] to its own k: row j of A, which is column j since A is
//   symmetric, read contiguously across the lanes. No dot, no reduction:
//   one shuffle broadcasts delta. Every step is elementwise, so the kernel
//   is bitwise equal to a CPU mirror of its order (kernels/lasso_cd.py:
//   lasso_cd_mirror). The refresh keeps the carry's rounding from piling up
//   over the path: carried from the launch start alone, c drifted from b -
//   A w by enough to move the coefficients by 3.5e-4 of their scale on a
//   16-row design of 24 features (more features than rows), against 1.5e-5
//   refreshed a lambda; it costs p products a nonzero w_m a lambda.
// * One warp; lane l owns the coordinates k = l + 32 q: their c_k, w_k and
//   A_kk. Up to p = 256 (8 chunks) they sit in registers: the chunk count
//   is a template constant and every loop over q unrolls, so q is a
//   compile-time index. Past that they sit in shared memory, still owned
//   lane by lane, so no lane reads another's and no barrier is needed.
// * Rounds, not single updates. Most updates move nothing (60 % on the
//   tuner's matrix), and an update that moves nothing changes no c. So the
//   32 coordinates of a chunk are updated together: every live lane forms
//   its update from c as it stands, which is exact up to and including the
//   first that moves; a ballot finds that one, the lanes up to it keep
//   their results, one shuffle broadcasts its delta for the carry, and the
//   next round starts after it. A chunk takes one round per move, plus one
//   when its last coordinate does not move; each c_k still receives its
//   carries in Gauss-Seidel order. A lane divides only a nonzero numerator
//   (0 / den is that 0; a zero dividend would take the IEEE division's
//   slow path).
// * The exact epoch skip: an epoch that moves no w leaves c and w as it
//   found them, so every later epoch at that lambda would repeat it; the
//   kernel goes on to the next lambda. The flag is warp-uniform (it comes
//   from the ballot).
// * A sits in shared memory when it fits beside the space reserved for c,
//   w and diag(A) (p <= 239 in the 227 KB a block may take); past that its
//   rows are read from global memory through L1/L2.
//
// Built with -fmad=false, so each update's arithmetic is the reference's
// f32 operations in its order (and c -= delta A[j, k] a multiply, then a
// subtraction), with IEEE division.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
// chunks of 32 coordinates held in registers (p <= 256)
constexpr int MAX_REG_CHUNKS = 8;

// The values of the coordinates a lane owns, k = lane + 32 q: in registers
// when the chunk count NQ is a template constant, in shared memory (indexed
// by k) when NQ is 0.
template <int NQ>
struct Owned {
  float v[NQ];
  __device__ __forceinline__ float& operator[](int q) { return v[q]; }
};
template <>
struct Owned<0> {
  float* v;
  __device__ __forceinline__ float& operator[](int q) {
    return v[32 * q + threadIdx.x];
  }
};

// A[row, 32 q + lane], 0 past the end of the row (only the last chunk can
// reach it)
__device__ __forceinline__ float row_at(const float* A, int row, int q,
                                        int nq, int p, int lane) {
  const int k = 32 * q + lane;
  return (q < nq - 1 || k < p) ? A[(size_t)row * p + k] : 0.0f;
}

// c = b - A w, for w as it stands: coordinate k sums A[m, k] w_m over the
// nonzero w_m in order of m, each w_m broadcast from the lane that owns it
template <int NQ>
__device__ __forceinline__ void refresh_c(Owned<NQ>& c, Owned<NQ>& w,
                                          const float* A,
                                          const float* __restrict__ xty,
                                          int p, int lane) {
  const int nq = NQ > 0 ? NQ : (p + 31) / 32;
#pragma unroll
  for (int q = 0; q < nq; ++q) c[q] = 0.0f;
#pragma unroll
  for (int qm = 0; qm < nq; ++qm) {
    const int end = min(32, p - 32 * qm);
    const float wq = w[qm];
    for (int s = 0; s < end; ++s) {
      const float wm = __shfl_sync(FULL, wq, s);
      if (wm == 0.0f) continue;  // warp-uniform: every lane got this wm
      const int m = 32 * qm + s;
#pragma unroll
      for (int q = 0; q < nq; ++q)
        c[q] = c[q] + row_at(A, m, q, nq, p, lane) * wm;
    }
  }
#pragma unroll
  for (int q = 0; q < nq; ++q) {
    const int k = 32 * q + lane;
    c[q] = k < p ? xty[k] - c[q] : 0.0f;
  }
}

template <int NQ, bool A_SMEM>
__global__ void __launch_bounds__(32, 1)
lasso_cd_kernel(const float* __restrict__ xtx, const float* __restrict__ xty,
                const float* __restrict__ w0, const float* __restrict__ lams,
                float* __restrict__ coefs, int p, int n_lam, int epochs,
                float n) {
  extern __shared__ float sm[];
  const int lane = threadIdx.x;
  const int nq = NQ > 0 ? NQ : (p + 31) / 32;
  const int pad = 32 * nq;
  Owned<NQ> c, w, d;
  if constexpr (NQ == 0) {
    c.v = sm;
    w.v = sm + pad;
    d.v = sm + 2 * pad;
  }
  const float* A = xtx;
  if constexpr (A_SMEM) {
    float* a_sm = sm + 3 * pad;
    const size_t pp = (size_t)p * p;
    for (size_t e = lane; e < pp; e += 32) a_sm[e] = xtx[e];
    __syncwarp();
    A = a_sm;
  }

#pragma unroll
  for (int q = 0; q < nq; ++q) {
    const int k = 32 * q + lane;
    w[q] = k < p ? w0[k] : 0.0f;
    d[q] = k < p ? A[(size_t)k * p + k] : 0.0f;
  }

  for (int l = 0; l < n_lam; ++l) {
    const float nl = n * lams[l];
    refresh_c(c, w, A, xty, p, lane);
    for (int e = 0; e < epochs; ++e) {
      bool moved = false;
#pragma unroll
      for (int q = 0; q < nq; ++q) {
        // the coordinates 32 q + lane, lane < end, in rounds from lane o0
        const int end = min(32, p - 32 * q);
        for (int o0 = 0; o0 < end;) {
          // every live lane's update, as if none before it in the chunk
          // moved: true up to and including the first one that moves
          const float cq = c[q], wq = w[q], dq = d[q];
          const float r = cq + dq * wq;
          const float sg = (r > 0.0f) ? 1.0f : ((r < 0.0f) ? -1.0f : 0.0f);
          float wj = sg * fmaxf(fabsf(r) - nl, 0.0f);
          const bool live = lane >= o0 && lane < end;
          // 0 / den is that 0 (den > 0), and a zero dividend would send
          // the IEEE division down its slow path
          if (live && wj != 0.0f) wj = wj / fmaxf(dq, 1e-12f);
          const float delta = wj - wq;
          const unsigned movers = __ballot_sync(FULL, live && delta != 0.0f);
          const int o = movers ? __ffs(movers) - 1 : end;
          if (live && lane <= o) w[q] = wj;
          if (movers == 0u) break;
          moved = true;
          const float dl = __shfl_sync(FULL, delta, o);
          const int j = 32 * q + o;
          // carry: c_k -= delta A[j, k] at every lane's coordinates
#pragma unroll
          for (int t = 0; t < nq; ++t)
            c[t] = c[t] - dl * row_at(A, j, t, nq, p, lane);
          // end of the carry
          o0 = o + 1;
        }
      }
      if (!moved) break;  // a fixed point: the rest of this lambda repeats it
    }
#pragma unroll
    for (int q = 0; q < nq; ++q) {
      const int k = 32 * q + lane;
      if (k < p) coefs[(size_t)l * p + k] = w[q];
    }
  }
}

using Kernel = void (*)(const float*, const float*, const float*,
                        const float*, float*, int, int, int, float);

// The instance for p: its chunks in registers up to p = 256, else in shared
// memory; A in shared memory or read from global memory.
template <int NQ>
Kernel pick(int nq, int a_in_smem) {
  if constexpr (NQ == 0) {
    return nullptr;
  } else {
    if (nq == NQ)
      return a_in_smem ? lasso_cd_kernel<NQ, true> : lasso_cd_kernel<NQ, false>;
    return pick<NQ - 1>(nq, a_in_smem);
  }
}

Kernel kernel_for(int p, int a_in_smem) {
  const int nq = (p + 31) / 32;
  if (nq > MAX_REG_CHUNKS)
    return a_in_smem ? nullptr : lasso_cd_kernel<0, false>;
  return pick<MAX_REG_CHUNKS>(nq, a_in_smem);
}

}  // namespace

// Dynamic shared memory of a launch: c, w and diag(A) at 32 ceil(p / 32)
// floats each (used when they do not fit in registers, reserved at every p
// so that where A sits depends on p alone), plus A when `a_in_smem`.
extern "C" int lasso_cd_smem(int p, int a_in_smem) {
  const long long pad = 32LL * ((p + 31) / 32);
  long long floats = 3LL * pad + (a_in_smem ? (long long)p * p : 0LL);
  return (int)(floats * (long long)sizeof(float));
}

// One launch: the whole path (n_lam lambdas x up to `epochs` cycles) from
// w0. coefs (n_lam, p) receives w after each lambda. `smem` must be
// lasso_cd_smem(p, a_in_smem). Returns a cudaError_t.
extern "C" int lasso_cd_launch(const float* xtx, const float* xty,
                               const float* w0, const float* lams,
                               float* coefs, int p, int n_lam, int epochs,
                               float n, int a_in_smem, int smem,
                               void* stream) {
  if (p <= 0 || n_lam < 0 || epochs < 0) return (int)cudaErrorInvalidValue;
  if (smem != lasso_cd_smem(p, a_in_smem)) return (int)cudaErrorInvalidValue;
  const Kernel kernel = kernel_for(p, a_in_smem);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  if (n_lam == 0) return 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<1, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      xtx, xty, w0, lams, coefs, p, n_lam, epochs, n);
  return (int)cudaGetLastError();
}
