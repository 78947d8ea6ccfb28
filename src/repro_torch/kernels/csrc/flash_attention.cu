// Flash attention, GQA, causal or full, with an online softmax: the LM
// engine's attention for every layer of a micro-batch prefill.
//
// Replaces the TPU kernel `repro.kernels.flash_attention.flash_attention_bhsd`
// (pl.pallas_call of `_attn_kernel`): q (B, Hq, Sq, hd) and k/v
// (B, Hkv, Skv, hd), kv head = q head / (Hq / Hkv), q scaled by
// sm_scale = 1/sqrt(hd), the mask `kv_pos < Skv` and, when causal,
// `q_pos + q_offset >= kv_pos`; running max (from NEG_INF = -1e30), running
// denominator and accumulator in f32; masked scores contribute p = 0, so no
// NaN appears; out = acc / max(l, 1e-30) in q's dtype (f32 or bf16).
//
// Bound on an H100 at the serve shape (B=32, Hq=28, Hkv=4, S=64, hd=128,
// bf16, causal): q, k, v and o move 14.7 + 2.1 + 2.1 + 14.7 = 33.6 MB, ~10 us
// at 3.35 TB/s; the ~0.95 GFLOP of causal work is ~1 us at the bf16 tensor
// rate, so memory bounds it.
//
// Design (simple first, no tensor cores): one block of 4 warps per
// (b, q head, tile of 16 query rows); each warp owns 4 of the rows and keeps
// their q (pre-scaled), accumulators, max and denominator in registers, its
// 32 lanes splitting hd (lane l holds dims l, l+32, ...; hd/32 each). The
// block stages K and V in tiles of 32 keys in shared memory, converted to
// f32 (32 KB at hd=128); every key of a tile is read from shared memory once
// per warp and used for all 4 of its rows: a partial dot per lane, a
// butterfly shuffle sum, then the online-softmax update. Tiles wholly above
// the block's last query row are never loaded (causal). The inputs may be
// strided views (the model's (B, S, H, hd) tensors seen as (B, H, S, hd));
// only hd must be contiguous. The output is contiguous (B, Hq, Sq, hd).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BLOCK_Q = 16;
constexpr int ROWS = BLOCK_Q / WARPS;  // query rows per warp
constexpr int BLOCK_K = 32;
constexpr float NEG_INF = -1e30f;

struct Params {
  int Hq, group, Sq, Skv, causal, q_offset;
  float sm_scale;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
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
__global__ void __launch_bounds__(THREADS)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ o, Params p) {
  constexpr int EPL = HD / 32;  // hd elements per lane
  __shared__ float ks[BLOCK_K][HD];
  __shared__ float vs[BLOCK_K][HD];

  const int q0 = blockIdx.x * BLOCK_Q;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.group;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  float qr[ROWS][EPL], acc[ROWS][EPL], m[ROWS], l[ROWS];
  int qrow[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    qrow[r] = q0 + warp + r * WARPS;
    const T* qp = q + b * p.q_sb + h * p.q_sh + (long long)qrow[r] * p.q_ss;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      qr[r][e] = qrow[r] < p.Sq ? to_f32(qp[lane + 32 * e]) * p.sm_scale : 0.f;
      acc[r][e] = 0.f;
    }
    m[r] = NEG_INF;
    l[r] = 0.f;
  }

  // keys past the block's last query position are masked for every row
  const int q_last = min(q0 + BLOCK_Q, p.Sq) - 1 + p.q_offset;
  const int kend = p.causal ? min(p.Skv, q_last + 1) : p.Skv;
  const T* kb = k + b * p.k_sb + hk * p.k_sh;
  const T* vb = v + b * p.v_sb + hk * p.v_sh;

  for (int k0 = 0; k0 < kend; k0 += BLOCK_K) {
    const int jn = min(BLOCK_K, kend - k0);
    __syncthreads();  // the previous tile is no longer read
    for (int idx = threadIdx.x; idx < BLOCK_K * HD; idx += THREADS) {
      const int j = idx / HD, d = idx % HD;
      const bool in = j < jn;
      ks[j][d] = in ? to_f32(kb[(long long)(k0 + j) * p.k_ss + d]) : 0.f;
      vs[j][d] = in ? to_f32(vb[(long long)(k0 + j) * p.v_ss + d]) : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < jn; ++j) {
      const int kv = k0 + j;
      float kk[EPL], vv[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        kk[e] = ks[j][lane + 32 * e];
        vv[e] = vs[j][lane + 32 * e];
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) s = fmaf(qr[r][e], kk[e], s);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        // warp-uniform: the row belongs to the whole warp
        const bool valid = qrow[r] < p.Sq &&
                           (!p.causal || qrow[r] + p.q_offset >= kv);
        if (!valid) continue;
        float pj;
        if (s > m[r]) {
          const float corr = expf(m[r] - s);
          l[r] *= corr;
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[r][e] *= corr;
          m[r] = s;
          pj = 1.f;
        } else {
          pj = expf(s - m[r]);
        }
        l[r] += pj;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][e] = fmaf(pj, vv[e], acc[r][e]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (qrow[r] >= p.Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* op = o + (((long long)b * p.Hq + h) * p.Sq + qrow[r]) * HD;
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      op[lane + 32 * e] = from_f32<T>(acc[r][e] * inv);
  }
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, void* o, int B,
                 int hd, const Params& p, cudaStream_t stream) {
  const dim3 grid((p.Sq + BLOCK_Q - 1) / BLOCK_Q, p.Hq, B);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  switch (hd) {
    case 32: attn_kernel<T, 32><<<grid, THREADS, 0, stream>>>(qt, kt, vt, ot, p); break;
    case 64: attn_kernel<T, 64><<<grid, THREADS, 0, stream>>>(qt, kt, vt, ot, p); break;
    case 128: attn_kernel<T, 128><<<grid, THREADS, 0, stream>>>(qt, kt, vt, ot, p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; hd is
// contiguous. Returns a cudaError_t (0 on success), launch errors included.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Hq, int Hkv, int Sq, int Skv, int hd, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, int causal, int q_offset,
    float sm_scale, void* stream) {
  if (B < 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq < 0 || Skv < 0 ||
      q_offset < 0 || Hq > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return 0;
  Params p{Hq, Hq / Hkv, Sq, Skv, causal, q_offset, sm_scale,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_typed<float>(q, k, v, o, B, hd, p, s);
  if (dtype == 1) return launch_typed<__nv_bfloat16>(q, k, v, o, B, hd, p, s);
  return (int)cudaErrorInvalidValue;
}
