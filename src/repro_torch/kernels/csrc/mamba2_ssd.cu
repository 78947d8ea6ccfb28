// The Mamba2 SSD scan over full sequences, without the D term: the scan
// behind `ops.mamba2_ssd`.
//
// Replaces the TPU kernel `repro.kernels.mamba2_ssd.mamba2_ssd`
// (pl.pallas_call of `_ssd_kernel`). Per (batch, head), with the state
// h (hd x ns) in f32 starting at zero:
//     h_t = exp(loga_t) h_{t-1} + x_t (x) B_t        y_t = h_t . C_t
// (the output reads the state after the step's own decay: the inclusive
// decay of the chunked form). x (B, nh, S, hd) in f32 or bf16, B/C
// (B, S, ns) in x's dtype and shared by all heads, loga (B, nh, S) f32
// (<= 0); y (B, nh, S, hd) in x's dtype, rounded once to nearest even.
//
// Bound on an H100 at zamba2-2.7b's mixer shape (B=4, nh=80, S=4096,
// hd=64, ns=64, f32 x): 0.69 GB moved, ~0.20 ms at 3.35 TB/s; the scan
// needs ~4 hd ns flops per token and head, 21.5 GFLOP, ~0.32 ms at the
// 67 TFLOP/s of f32 outside the tensor cores, so arithmetic bounds it.
//
// Design. The TPU kernel works chunk by chunk in the parallel form (the
// inter-chunk C h_in e^cum, the intra-chunk (C B^T (.) L) x with its C x C
// decay matrix, the state update) because that feeds the MXU. On CUDA
// cores the recurrence itself does the least arithmetic and one exp per
// (token, head), with no padded steps and no masked exponents. One block
// of 4 hd threads per (b, head); four lanes of a warp (q = 0..3, 8 lanes
// apart) own row i of h, a quarter of its ns columns each (ns/4 floats in
// registers), so y_t[i] = sum_n h[i][n] C_t[n] is a partial sum per lane
// and two shuffles. The block stages `ch` tokens at a time (the chunk) in
// shared memory as f32: x, B, C and exp(loga); the lanes then read their
// quarter of B_t and C_t as broadcasts (float4: the 8 lanes of a quarter
// read the same words) and x_t[i]. The inputs may be strided (only the
// last axis of x, B and C must be contiguous); the output is contiguous.
//
// Why 4 lanes a row: with one thread a row a block is 2 warps, too few to
// hide the per-token chain (3.59 against 2.38 ms a launch at chunk 128 at
// the zamba2 shape; chip_smoke.py, H100 80GB HBM3, 700 W). The chunk sets
// the shared memory a block takes (99 KB at 128: 2 blocks an SM and 1.2
// waves of 320 blocks; 49 KB at 64: one wave, 1.86 ms).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int SPLIT = 4;            // lanes sharing one row of h
constexpr int ROWS = 32 / SPLIT;    // rows of h per warp

struct Params {
  int nh, S, ch;
  long long x_sb, x_sh, x_ss, b_sb, b_ss, c_sb, c_ss, a_sb, a_sh, a_ss;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

template <typename T, int HD, int NS>
__global__ void __launch_bounds__(HD * SPLIT)
ssd_kernel(const T* __restrict__ x, const T* __restrict__ bm,
           const T* __restrict__ cm, const float* __restrict__ loga,
           T* __restrict__ y, Params p) {
  extern __shared__ float4 smem4[];
  float* bs = reinterpret_cast<float*>(smem4);  // [ch][NS]
  float* cs = bs + p.ch * NS;                   // [ch][NS]
  float* xs = cs + p.ch * NS;                   // [ch][HD]
  float* as = xs + p.ch * HD;                   // [ch] exp(loga)

  constexpr int NQ = NS / SPLIT;  // columns of h per lane
  constexpr int NT = HD * SPLIT;  // threads
  const int hh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int i = (tid >> 5) * ROWS + lane % ROWS;  // the head-dim row
  const int q = lane / ROWS;                      // which quarter of it
  const T* xb = x + b * p.x_sb + hh * p.x_sh;
  const T* bb = bm + b * p.b_sb;
  const T* cb = cm + b * p.c_sb;
  const float* ab = loga + b * p.a_sb + hh * p.a_sh;
  T* yb = y + ((long long)b * p.nh + hh) * p.S * HD + i;

  float st[NQ];  // h[i][q NQ + n], n = 0..NQ-1
#pragma unroll
  for (int n = 0; n < NQ; ++n) st[n] = 0.f;

  for (int t0 = 0; t0 < p.S; t0 += p.ch) {
    const int m = min(p.ch, p.S - t0);
    __syncthreads();  // the previous tile is no longer read
    // consecutive threads stage consecutive elements: coalesced
    for (int idx = tid; idx < m * HD; idx += NT) {
      const int t = idx / HD, c = idx % HD;
      xs[idx] = to_f32(xb[(long long)(t0 + t) * p.x_ss + c]);
    }
    for (int idx = tid; idx < m * NS; idx += NT) {
      const int t = idx / NS, n = idx % NS;
      const long long tt = t0 + t;
      bs[idx] = to_f32(bb[tt * p.b_ss + n]);
      cs[idx] = to_f32(cb[tt * p.c_ss + n]);
    }
    for (int t = tid; t < m; t += NT) as[t] = expf(ab[(long long)(t0 + t) * p.a_ss]);
    __syncthreads();
    for (int t = 0; t < m; ++t) {
      const float a = as[t], xi = xs[t * HD + i];
      const float4* b4 = reinterpret_cast<const float4*>(bs + t * NS + q * NQ);
      const float4* c4 = reinterpret_cast<const float4*>(cs + t * NS + q * NQ);
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int n4 = 0; n4 < NQ / 4; ++n4) {
        const float4 bv = b4[n4], cv = c4[n4];
        const int n = 4 * n4;
        st[n] = fmaf(st[n], a, xi * bv.x);
        st[n + 1] = fmaf(st[n + 1], a, xi * bv.y);
        st[n + 2] = fmaf(st[n + 2], a, xi * bv.z);
        st[n + 3] = fmaf(st[n + 3], a, xi * bv.w);
        a0 = fmaf(st[n], cv.x, a0);
        a1 = fmaf(st[n + 1], cv.y, a1);
        a2 = fmaf(st[n + 2], cv.z, a2);
        a3 = fmaf(st[n + 3], cv.w, a3);
      }
      float yt = (a0 + a1) + (a2 + a3);
#pragma unroll
      for (int off = ROWS; off < 32; off <<= 1)
        yt += __shfl_xor_sync(0xffffffffu, yt, off);
      if (q == 0) yb[(long long)(t0 + t) * HD] = from_f32<T>(yt);
    }
  }
}

// dynamic shared memory for a tile of ch tokens (the wrapper's smem_bytes)
size_t smem_bytes(int ch, int hd, int ns) {
  return sizeof(float) * ((size_t)ch * (2 * ns + hd) + ch);
}

template <typename T, int HD, int NS>
int launch_shape(const void* x, const void* bm, const void* cm,
                 const float* loga, void* y, int B, const Params& p,
                 cudaStream_t stream) {
  auto kern = ssd_kernel<T, HD, NS>;
  const size_t smem = smem_bytes(p.ch, HD, NS);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(p.nh, B), HD * SPLIT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bm),
      static_cast<const T*>(cm), loga, static_cast<T*>(y), p);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_hd(const void* x, const void* bm, const void* cm,
              const float* loga, void* y, int B, int ns, const Params& p,
              cudaStream_t s) {
  switch (ns) {
    case 16: return launch_shape<T, HD, 16>(x, bm, cm, loga, y, B, p, s);
    case 32: return launch_shape<T, HD, 32>(x, bm, cm, loga, y, B, p, s);
    case 64: return launch_shape<T, HD, 64>(x, bm, cm, loga, y, B, p, s);
    case 128: return launch_shape<T, HD, 128>(x, bm, cm, loga, y, B, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_typed(const void* x, const void* bm, const void* cm,
                 const float* loga, void* y, int B, int hd, int ns,
                 const Params& p, cudaStream_t s) {
  switch (hd) {
    case 32: return launch_hd<T, 32>(x, bm, cm, loga, y, B, ns, p, s);
    case 64: return launch_hd<T, 64>(x, bm, cm, loga, y, B, ns, p, s);
    case 128: return launch_hd<T, 128>(x, bm, cm, loga, y, B, ns, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype of x/B/C/y: 0 = float32, 1 = bfloat16; loga is f32. Strides are in
// elements; the last axis of x, B and C is contiguous. Returns a
// cudaError_t (0 on success), launch errors included.
extern "C" int mamba2_ssd_launch(
    const void* x, const void* bm, const void* cm, const void* loga, void* y,
    int dtype, int B, int nh, int S, int hd, int ns, int ch, long long x_sb,
    long long x_sh, long long x_ss, long long b_sb, long long b_ss,
    long long c_sb, long long c_ss, long long a_sb, long long a_sh,
    long long a_ss, void* stream) {
  if (B < 0 || nh <= 0 || S < 0 || ch <= 0 || nh > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  Params p{nh, S, ch, x_sb, x_sh, x_ss, b_sb, b_ss, c_sb, c_ss,
           a_sb, a_sh, a_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* la = static_cast<const float*>(loga);
  if (dtype == 0)
    return launch_typed<float>(x, bm, cm, la, y, B, hd, ns, p, s);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(x, bm, cm, la, y, B, hd, ns, p, s);
  return (int)cudaErrorInvalidValue;
}
