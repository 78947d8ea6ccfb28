// The RWKV-6 (Finch) wkv recurrence over full sequences: the time mix of
// every rwkv6 layer when the layer asks for the kernel.
//
// Replaces the TPU kernel `repro.kernels.rwkv6_wkv.rwkv6_wkv`
// (pl.pallas_call of `_wkv_kernel`). Per (batch, head), with the state
// S (hd_k x hd_v) in f32 starting at zero:
//     o_t = r_t . (S_{t-1} + diag(u) k_t^T v_t)
//     S_t = diag(exp(logw_t)) S_{t-1} + k_t^T v_t
// r/k/v (B, H, S, hd) in f32 or bf16, logw (B, H, S, hd) f32 (<= 0), u
// (H, hd) f32; o (B, H, S, hd) in r's dtype (rounded once, to nearest
// even), S_fin (B, H, hd, hd) f32.
//
// Bound on an H100 at the rwkv6-7b train shape (B=4, H=64, S=4096, hd=64,
// bf16 r/k/v, f32 logw): 0.81 GB moved, ~0.24 ms at 3.35 TB/s; the
// recurrence needs ~4 hd^2 flops per token and head, 17.2 GFLOP, ~0.26 ms
// at the 67 TFLOP/s of f32 outside the tensor cores, so arithmetic bounds
// it, narrowly.
//
// Design. The TPU kernel works chunk by chunk in the parallel form (an
// inter-chunk product with S, an intra-chunk C x C x hd decay tensor, a
// state update) because that feeds the MXU. Without tensor cores that form
// costs more than the recurrence itself: ~C hd / 2 extra multiply-adds and
// as many exps per token. This kernel runs the recurrence token by token,
// which does exactly the bound's arithmetic and one exp per (token, key
// channel), and which has no padded steps, no masked exponents and no
// inclusive/exclusive decay to get wrong. One block of 4 hd threads per
// (b, head); four lanes of a warp (q = 0..3, 8 lanes apart) own column j
// of S, a quarter of its rows each (hd/4 floats in registers), so
// o_t[j] = sum_c r_t[c] S[c][j] + (r_t . (u (.) k_t)) v_t[j] is a partial
// sum per lane and two shuffles; the 8 lanes of one quarter read the same
// shared-memory words (a broadcast, no bank conflict). The block stages `ch` tokens at a time
// (the chunk) in shared memory as f32: r, k, exp(logw) and v, plus the
// bonus scalar r_t . (u (.) k_t) per token (a warp-wide dot); the lanes
// then read their quarter of r_t, k_t, w_t as broadcasts (float4) and
// v_t[j]. The inputs may be strided views (the model's (B, S, H, hd)
// tensors seen as (B, H, S, hd)); only hd must be contiguous. The output
// is contiguous.
//
// Why 4 lanes a column: with one thread a column a block is 2 warps and an
// SM holds ~4 at the rwkv6-7b shape, too few to hide the per-token chain
// (1.98 ms a launch against 1.62 ms split; chip_smoke.py, H100 80GB HBM3,
// 700 W). What bounds it now is instruction count: staging costs about
// half the recurrence's instructions again, and the recurrence takes 3
// FP32 instructions per state element where the bound counts 2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int SPLIT = 4;            // lanes sharing one column of S
constexpr int COLS = 32 / SPLIT;    // columns of S per warp

struct Params {
  int H, S, ch;
  long long r_sb, r_sh, r_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long w_sb, w_sh, w_ss;
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

template <typename T, int HD>
__global__ void __launch_bounds__(HD * SPLIT)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ logw,
           const float* __restrict__ u, T* __restrict__ o,
           float* __restrict__ sfin, Params p) {
  extern __shared__ float4 smem4[];
  float* rs = reinterpret_cast<float*>(smem4);  // [ch][HD]
  float* ks = rs + p.ch * HD;                   // [ch][HD]
  float* ws = ks + p.ch * HD;                   // [ch][HD] exp(logw)
  float* vs = ws + p.ch * HD;                   // [ch][HD]
  float* us = vs + p.ch * HD;                   // [HD]
  float* bonus = us + HD;                       // [ch]

  constexpr int CQ = HD / SPLIT;  // rows of S per lane
  constexpr int NT = HD * SPLIT;  // threads
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int j = warp * COLS + lane % COLS;  // the value channel (column)
  const int q = lane / COLS;                // which quarter of its rows
  const T* rb = r + b * p.r_sb + h * p.r_sh;
  const T* kb = k + b * p.k_sb + h * p.k_sh;
  const T* vb = v + b * p.v_sb + h * p.v_sh;
  const float* wb = logw + b * p.w_sb + h * p.w_sh;
  T* ob = o + ((long long)b * p.H + h) * p.S * HD + j;
  if (tid < HD) us[tid] = u[h * HD + tid];

  float st[CQ];  // S[q CQ + c][j], c = 0..CQ-1
#pragma unroll
  for (int c = 0; c < CQ; ++c) st[c] = 0.f;

  for (int t0 = 0; t0 < p.S; t0 += p.ch) {
    const int n = min(p.ch, p.S - t0);
    __syncthreads();  // the previous tile is no longer read
    // consecutive threads stage consecutive channels: coalesced
    for (int idx = tid; idx < n * HD; idx += NT) {
      const int t = idx / HD, c = idx % HD;
      const long long tt = t0 + t;
      rs[idx] = to_f32(rb[tt * p.r_ss + c]);
      ks[idx] = to_f32(kb[tt * p.k_ss + c]);
      vs[idx] = to_f32(vb[tt * p.v_ss + c]);
      ws[idx] = expf(wb[tt * p.w_ss + c]);
    }
    __syncthreads();
    // bonus_t = r_t . (u (.) k_t), one warp per token
    for (int t = warp; t < n; t += NT / 32) {
      float s = 0.f;
#pragma unroll
      for (int c = lane; c < HD; c += 32)
        s = fmaf(rs[t * HD + c] * us[c], ks[t * HD + c], s);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) bonus[t] = s;
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float vj = vs[t * HD + j];
      const int row = t * HD + q * CQ;
      const float4* r4 = reinterpret_cast<const float4*>(rs + row);
      const float4* k4 = reinterpret_cast<const float4*>(ks + row);
      const float4* w4 = reinterpret_cast<const float4*>(ws + row);
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int c4 = 0; c4 < CQ / 4; ++c4) {
        const float4 rr = r4[c4], kk = k4[c4], ww = w4[c4];
        const int c = 4 * c4;
        a0 = fmaf(rr.x, st[c], a0);
        a1 = fmaf(rr.y, st[c + 1], a1);
        a2 = fmaf(rr.z, st[c + 2], a2);
        a3 = fmaf(rr.w, st[c + 3], a3);
        st[c] = fmaf(st[c], ww.x, kk.x * vj);
        st[c + 1] = fmaf(st[c + 1], ww.y, kk.y * vj);
        st[c + 2] = fmaf(st[c + 2], ww.z, kk.z * vj);
        st[c + 3] = fmaf(st[c + 3], ww.w, kk.w * vj);
      }
      float a = (a0 + a1) + (a2 + a3);
#pragma unroll
      for (int off = COLS; off < 32; off <<= 1)
        a += __shfl_xor_sync(0xffffffffu, a, off);
      if (q == 0)
        ob[(long long)(t0 + t) * HD] = from_f32<T>(a + bonus[t] * vj);
    }
  }

  float* sb = sfin + ((long long)b * p.H + h) * HD * HD + q * CQ * HD + j;
#pragma unroll
  for (int c = 0; c < CQ; ++c) sb[c * HD] = st[c];
}

// dynamic shared memory for a tile of ch tokens (the wrapper's smem_bytes)
size_t smem_bytes(int ch, int hd) {
  return sizeof(float) * (4 * (size_t)ch * hd + hd + ch);
}

template <typename T, int HD>
int launch_hd(const void* r, const void* k, const void* v, const float* logw,
              const float* u, void* o, float* sfin, int B, const Params& p,
              cudaStream_t stream) {
  auto kern = wkv_kernel<T, HD>;
  const size_t smem = smem_bytes(p.ch, HD);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(p.H, B), HD * SPLIT, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), logw, u, static_cast<T*>(o), sfin, p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_typed(const void* r, const void* k, const void* v,
                 const float* logw, const float* u, void* o, float* sfin,
                 int B, int hd, const Params& p, cudaStream_t s) {
  switch (hd) {
    case 32: return launch_hd<T, 32>(r, k, v, logw, u, o, sfin, B, p, s);
    case 64: return launch_hd<T, 64>(r, k, v, logw, u, o, sfin, B, p, s);
    case 128: return launch_hd<T, 128>(r, k, v, logw, u, o, sfin, B, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype of r/k/v/o: 0 = float32, 1 = bfloat16; logw, u and S_fin are f32.
// Strides are in elements; hd is contiguous. Returns a cudaError_t (0 on
// success), launch errors included.
extern "C" int rwkv6_wkv_launch(
    const void* r, const void* k, const void* v, const void* logw,
    const void* u, void* o, void* sfin, int dtype, int B, int H, int S,
    int hd, int ch, long long r_sb, long long r_sh, long long r_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long w_sb, long long w_sh,
    long long w_ss, void* stream) {
  if (B < 0 || H <= 0 || S < 0 || ch <= 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Params p{H, S, ch, r_sb, r_sh, r_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
           w_sb, w_sh, w_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lw = static_cast<const float*>(logw);
  const float* uu = static_cast<const float*>(u);
  float* sf = static_cast<float*>(sfin);
  if (dtype == 0)
    return launch_typed<float>(r, k, v, lw, uu, o, sf, B, hd, p, s);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(r, k, v, lw, uu, o, sf, B, hd, p, s);
  return (int)cudaErrorInvalidValue;
}
