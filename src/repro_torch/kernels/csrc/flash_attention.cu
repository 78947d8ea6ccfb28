// Flash attention, GQA, causal or full, with an online softmax: the LM
// engine's attention for every layer of a micro-batch prefill.
//
// Replaces the TPU kernel `repro.kernels.flash_attention.flash_attention_bhsd`
// (pl.pallas_call of `_attn_kernel`): q (B, Hq, Sq, hd) and k/v
// (B, Hkv, Skv, hd), kv head = q head / (Hq / Hkv), scores scaled by
// sm_scale = 1/sqrt(hd), the mask `kv_pos < Skv` and, when causal,
// `q_pos + q_offset >= kv_pos`; running max (from NEG_INF = -1e30), running
// denominator and accumulator in f32; masked scores contribute p = 0, so no
// NaN appears; p is rounded to v's dtype before p.v (as the Pallas body's
// `p.astype(v.dtype)`); out = acc / max(l, 1e-30) in q's dtype.
//
// Bound on an H100 at the serve shape (B=32, Hq=28, Hkv=4, S=64, hd=128,
// bf16, causal): q, k, v and o move 14.7 + 2.1 + 2.1 + 14.7 = 33.6 MB, ~10 us
// at 3.35 TB/s; the ~0.95 GFLOP of causal work is ~1 us at the bf16 tensor
// rate, so memory bounds it. The kernel has to read each of those bytes
// about once and spend few instructions per byte.
//
// bf16 design (`attn_kernel_bf16_mma`), each part against what it addresses:
// - Packed GQA rows. One block of 4 warps per (b, kv head hk, tile of
//   BLOCK_M = 64 packed rows); packed row m = pos * group + j stands for q
//   head hk * group + j at position pos. K/V of the kv head are read once
//   per tile, not once per q head. Rows are position-major, so a tile covers
//   a contiguous range of positions: the causal key limit of the tile,
//   kend = min(Skv, last_pos + q_offset + 1), is exact, and in the model
//   layout a position's group of heads is one contiguous run.
// - Tensor cores. S = Q.K^T and O += P.V are
//   mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 on each warp's 16 rows. Q's
//   A fragments and K come through ldmatrix, V through ldmatrix.trans. Q is
//   read from shared memory at each k-step rather than held in registers
//   for the whole key loop: that would take 32 more registers a thread at
//   hd 128 and hold an SM to two blocks, while a single-tile launch (the
//   serve shape) reads Q once either way. Scores are scaled in f32 by
//   sm_scale * log2(e) and exponentiated with exp2f. The masks (kv >= kend,
//   causal, padded packed rows m >= group * Sq) are applied on the fragment
//   as -inf, so p = exp2(-inf - m) = 0 whatever the running max is. A
//   64-key tile goes through the softmax in two steps of KN = 32 keys, so
//   that the scores take 16 registers a thread, not 32: at 128 registers
//   four blocks fit an SM, against three with whole tiles, and the serve
//   shape runs faster so (PERF.md). Steps, and 16-key steps of P.V, at or
//   past kend are skipped (skipping 8-key tiles of Q.K^T too measured
//   slower: the branches break up the unrolled ldmatrix/mma stream). The
//   row max is reduced over the 4 threads of a quad once per step; each
//   thread keeps a partial row sum, reduced over the quad once at the end
//   (the quad shares one max, so partial sums rescale alike). P is rounded
//   to bf16 and reused from the S accumulator registers as the A fragment
//   of P.V: the m16n8k16 accumulator of two adjacent key tiles is exactly
//   the A layout of one 16-key step.
// - Staging. 16-byte cp.async copies of the Q tile and of K/V tiles of
//   BLOCK_N = 64 keys, kept in bf16. K and V go in separate commit groups,
//   so that Q.K^T and the softmax run while V arrives. K/V are
//   double-buffered when a block has more than one key tile; the shared
//   memory is sized per launch, so a single-tile launch such as the serve
//   shape keeps one buffer and fits more blocks per SM. Rows are padded by
//   8 elements (16 bytes), so the 8 row addresses of each ldmatrix phase
//   fall in 8 different 16-byte bank groups at hd 32, 64 and 128. Key rows
//   at or past kend are zero-filled without being read (every row of the
//   tile masks them), so a causal tile reads only the keys it needs. Each
//   row's source address must be 16-byte aligned: the wrapper checks base
//   pointers and strides and raises.
// - Epilogue. acc / max(l, 1e-30) is rounded once to bf16 into the warp's
//   own rows of the Q tile's shared memory, then stored with 16-byte stores
//   into the contiguous (B, Hq, Sq, hd) output.
//
// f32 design (`attn_kernel_f32`, CUDA cores): one block of 4 warps per
// (b, q head, tile of 16 query rows); each warp owns 4 of the rows, its 32
// lanes splitting hd, K/V tiles of 32 keys staged in shared memory, one key
// at a time through the online softmax. f32 stays off the tensor cores: an
// f32 product there is TF32, which keeps about 3 decimal digits and would
// miss the f32 tolerance (2e-5) of the kernel against its plain version.
//
// The inputs may be strided views (the model's (B, S, H, hd) tensors seen as
// (B, H, S, hd)); only hd must be contiguous.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  int Hq, group, Sq, Skv, causal, q_offset;
  float sm_scale;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
};

// ---------------------------------------------------------------------------
// bf16: packed GQA rows on the tensor cores

constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = MMA_WARPS * 32;
constexpr int BLOCK_M = MMA_WARPS * 16;  // packed rows per block
constexpr int BLOCK_N = 64;              // keys per staged tile
constexpr int KN = 32;                   // keys per softmax step
constexpr int PAD = 8;                   // elements of padding per smem row
// blocks an SM must hold at once (at most 128 registers a thread): a block
// at the serve shape waits on one round of loads, which only other resident
// blocks can hide
constexpr int MMA_MIN_BLOCKS = 4;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a.b on a 16x8x16 tile: a 16x16 bf16 (row), b 16x8 bf16 (col), d f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> bf16x2, round to nearest even; lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int HD>
__host__ __device__ constexpr int mma_smem_bytes(int stages) {
  return (BLOCK_M + stages * 2 * BLOCK_N) * (HD + PAD) *
         (int)sizeof(__nv_bfloat16);
}

template <int HD>
__global__ void __launch_bounds__(MMA_THREADS, MMA_MIN_BLOCKS)
attn_kernel_bf16_mma(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, Params p) {
  constexpr int LD = HD + PAD;    // smem row, elements
  constexpr int CPR = HD / 8;     // 16-byte chunks per row
  constexpr int KSTEPS = HD / 16; // k-steps of Q.K^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* kvs = qs + BLOCK_M * LD;  // per stage: K tile, then V tile

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int M = p.group * p.Sq;  // packed rows of this (b, hk)
  const int m0 = blockIdx.x * BLOCK_M;

  const int last_pos = (min(m0 + BLOCK_M, M) - 1) / p.group;
  const int kend = p.causal ? min(p.Skv, last_pos + p.q_offset + 1) : p.Skv;
  const int ntiles = (kend + BLOCK_N - 1) / BLOCK_N;

  const __nv_bfloat16* kb = k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vb = v + b * p.v_sb + hk * p.v_sh;

  // K or V rows [k0, k0 + BLOCK_N) of this kv head; rows at or past kend
  // are zero-filled without a read
  auto load_tile = [&](__nv_bfloat16* dst, const __nv_bfloat16* src,
                       long long ss, int k0) {
    for (int i = tid; i < BLOCK_N * CPR; i += MMA_THREADS) {
      const int r = i / CPR, c = i % CPR, kv = k0 + r;
      const bool in = kv < kend;
      cp_async16(smem_addr(dst + r * LD + c * 8),
                 in ? src + kv * ss + c * 8 : src, in);
    }
  };
  auto k_tile = [&](int buf) { return kvs + buf * 2 * BLOCK_N * LD; };
  // commit groups, in order: Q with K_0, V_0, then K_t, V_t of each later
  // tile, so that S = Q.K^T starts while V is still in flight
  if (ntiles > 0) {
    // the Q tile: packed row m is q head hk * group + m % group at
    // position m / group
    for (int i = tid; i < BLOCK_M * CPR; i += MMA_THREADS) {
      const int r = i / CPR, c = i % CPR, m = m0 + r;
      const bool in = m < M;
      const __nv_bfloat16* src = q;
      if (in) {
        const int pos = m / p.group, h = hk * p.group + m % p.group;
        src = q + b * p.q_sb + h * p.q_sh + pos * p.q_ss + c * 8;
      }
      cp_async16(smem_addr(qs + r * LD + c * 8), src, in);
    }
    load_tile(k_tile(0), kb, p.k_ss, 0);
    cp_async_commit();
    load_tile(k_tile(0) + BLOCK_N * LD, vb, p.v_ss, 0);
    cp_async_commit();
  }
  if (ntiles > 1) {
    load_tile(k_tile(1), kb, p.k_ss, BLOCK_N);
    cp_async_commit();
    load_tile(k_tile(1) + BLOCK_N * LD, vb, p.v_ss, BLOCK_N);
    cp_async_commit();
  }

  // thread's rows: g and g + 8 of the warp's 16; its key columns 2c, 2c + 1
  const int g = lane >> 2, c = lane & 3;
  int lim[2];  // the last key each row may see (-1: a padded row)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + warp * 16 + g + 8 * h;
    const int pos = m / p.group;
    lim[h] = m >= M ? -1
             : p.causal ? min(kend - 1, pos + p.q_offset)
                        : kend - 1;
  }
  const float scale = p.sm_scale * LOG2E;
  float mrow[2] = {NEG_INF, NEG_INF}, lrow[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
    acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  const int qrow = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  for (int t = 0; t < ntiles; ++t) {
    const __nv_bfloat16* ks = k_tile(t & 1);
    const __nv_bfloat16* vs = ks + BLOCK_N * LD;
    const int k0 = t * BLOCK_N;
    if (t + 1 < ntiles) cp_async_wait<3>(); else cp_async_wait<1>();
    __syncthreads();  // K_t (and Q) are in shared memory

    // the tile in steps of KN keys: S = Q.K^T, the online softmax, O += P.V
#pragma unroll
    for (int kh = 0; kh < BLOCK_N; kh += KN) {
      if (k0 + kh >= kend) break;  // block-uniform: keys every row masks
      float s[KN / 8][4];
#pragma unroll
      for (int n = 0; n < KN / 8; ++n)
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; kk += 2) {
        uint32_t qa[4], qb[4];
        ldsm_x4(qa, smem_addr(qs + qrow * LD + kk * 16 + (lane >> 4) * 8));
        ldsm_x4(qb, smem_addr(qs + qrow * LD + (kk + 1) * 16 +
                              (lane >> 4) * 8));
#pragma unroll
        for (int n = 0; n < KN / 8; ++n) {
          uint32_t kf[4];  // b0, b1 of k-step kk, then of kk + 1
          ldsm_x4(kf, smem_addr(ks + (kh + n * 8 + (lane & 7)) * LD +
                                kk * 16 + (lane >> 3) * 8));
          mma_bf16(s[n], qa, kf[0], kf[1]);
          mma_bf16(s[n], qb, kf[2], kf[3]);
        }
      }

      // online softmax on the fragment: s[n][e] is row g + 8 (e / 2), key
      // k0 + kh + 8 n + 2 c + e % 2
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < KN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kv = k0 + kh + n * 8 + 2 * c + (e & 1);
          const float x = kv <= lim[e >> 1] ? s[n][e] * scale : -INFINITY;
          s[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float mnew = fmaxf(mrow[h], mx[h]);
        corr[h] = exp2f(mrow[h] - mnew);
        mrow[h] = mnew;
        lrow[h] *= corr[h];
      }
#pragma unroll
      for (int d = 0; d < HD / 8; ++d) {
        acc[d][0] *= corr[0];
        acc[d][1] *= corr[0];
        acc[d][2] *= corr[1];
        acc[d][3] *= corr[1];
      }
#pragma unroll
      for (int n = 0; n < KN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = exp2f(s[n][e] - mrow[e >> 1]);  // 0 where masked
          s[n][e] = pe;
          lrow[e >> 1] += pe;
        }

      if (kh == 0) {
        if (t + 1 < ntiles) cp_async_wait<2>(); else cp_async_wait<0>();
        __syncthreads();  // V_t is in shared memory
      }

      // O += P.V: the S accumulators of key tiles 2j, 2j + 1 are the A
      // fragment of key step j
#pragma unroll
      for (int j = 0; j < KN / 16; ++j) {
        if (k0 + kh + j * 16 >= kend) break;  // p = 0 for every row
        const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                                pack_bf16(s[2 * j][2], s[2 * j][3]),
                                pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                                pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
        const int row = kh + j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int d = 0; d < HD / 8; d += 2) {
          uint32_t vf[4];  // b0, b1 of hd tile d, then of d + 1
          ldsm_x4_trans(vf, smem_addr(vs + row * LD + d * 8 +
                                      (lane >> 4) * 8));
          mma_bf16(acc[d], pa, vf[0], vf[1]);
          mma_bf16(acc[d + 1], pa, vf[2], vf[3]);
        }
      }
    }

    if (t + 2 < ntiles) {
      __syncthreads();  // buffer t & 1 is no longer read
      load_tile(k_tile(t & 1), kb, p.k_ss, (t + 2) * BLOCK_N);
      cp_async_commit();
      load_tile(k_tile(t & 1) + BLOCK_N * LD, vb, p.v_ss, (t + 2) * BLOCK_N);
      cp_async_commit();
    }
  }

  // epilogue: full row sums, one rounding, the warp's own rows of the Q
  // tile as the staging buffer, then 16-byte stores
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lrow[h] += __shfl_xor_sync(0xffffffffu, lrow[h], 1);
    lrow[h] += __shfl_xor_sync(0xffffffffu, lrow[h], 2);
    inv[h] = 1.f / fmaxf(lrow[h], 1e-30f);
  }
  __nv_bfloat16* os = qs + warp * 16 * LD;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    *reinterpret_cast<uint32_t*>(os + g * LD + d * 8 + 2 * c) =
        pack_bf16(acc[d][0] * inv[0], acc[d][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(os + (g + 8) * LD + d * 8 + 2 * c) =
        pack_bf16(acc[d][2] * inv[1], acc[d][3] * inv[1]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * CPR; i += 32) {
    const int r = i / CPR, cc = i % CPR, m = m0 + warp * 16 + r;
    if (m >= M) continue;
    const int pos = m / p.group, h = hk * p.group + m % p.group;
    __nv_bfloat16* dst = o + (((long long)b * p.Hq + h) * p.Sq + pos) * HD;
    *reinterpret_cast<uint4*>(dst + cc * 8) =
        *reinterpret_cast<const uint4*>(os + r * LD + cc * 8);
  }
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int Hkv, const Params& p, cudaStream_t stream) {
  const int M = p.group * p.Sq;
  // the most key tiles any block walks: two buffers only if some block
  // walks more than one tile
  const int kend = p.causal ? min(p.Skv, p.Sq + p.q_offset) : p.Skv;
  const int stages = kend > BLOCK_N ? 2 : 1;
  const int smem = mma_smem_bytes<HD>(stages);
  static int smem_set = 48 * 1024;  // the default opt-in limit
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_kernel_bf16_mma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        mma_smem_bytes<HD>(2));
    if (err != cudaSuccess) return (int)err;
    smem_set = mma_smem_bytes<HD>(2);
  }
  const dim3 grid((M + BLOCK_M - 1) / BLOCK_M, Hkv, B);
  attn_kernel_bf16_mma<HD><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, one key at a time

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BLOCK_Q = 16;
constexpr int ROWS = BLOCK_Q / WARPS;  // query rows per warp
constexpr int BLOCK_K = 32;

template <int HD>
__global__ void __launch_bounds__(THREADS)
attn_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, Params p) {
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
    const float* qp = q + b * p.q_sb + h * p.q_sh + (long long)qrow[r] * p.q_ss;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      qr[r][e] = qrow[r] < p.Sq ? qp[lane + 32 * e] * p.sm_scale : 0.f;
      acc[r][e] = 0.f;
    }
    m[r] = NEG_INF;
    l[r] = 0.f;
  }

  // keys past the block's last query position are masked for every row
  const int q_last = min(q0 + BLOCK_Q, p.Sq) - 1 + p.q_offset;
  const int kend = p.causal ? min(p.Skv, q_last + 1) : p.Skv;
  const float* kb = k + b * p.k_sb + hk * p.k_sh;
  const float* vb = v + b * p.v_sb + hk * p.v_sh;

  for (int k0 = 0; k0 < kend; k0 += BLOCK_K) {
    const int jn = min(BLOCK_K, kend - k0);
    __syncthreads();  // the previous tile is no longer read
    for (int idx = threadIdx.x; idx < BLOCK_K * HD; idx += THREADS) {
      const int j = idx / HD, d = idx % HD;
      const bool in = j < jn;
      ks[j][d] = in ? kb[(long long)(k0 + j) * p.k_ss + d] : 0.f;
      vs[j][d] = in ? vb[(long long)(k0 + j) * p.v_ss + d] : 0.f;
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
    float* op = o + (((long long)b * p.Hq + h) * p.Sq + qrow[r]) * HD;
#pragma unroll
    for (int e = 0; e < EPL; ++e) op[lane + 32 * e] = acc[r][e] * inv;
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               const Params& p, cudaStream_t stream) {
  const dim3 grid((p.Sq + BLOCK_Q - 1) / BLOCK_Q, p.Hq, B);
  attn_kernel_f32<HD><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores). Strides are
// in elements; hd is contiguous; for bf16 every row start must be 16-byte
// aligned. Returns a cudaError_t (0 on success), launch errors included.
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
  if (dtype == 0) {
    switch (hd) {
      case 32: return launch_f32<32>(q, k, v, o, B, p, s);
      case 64: return launch_f32<64>(q, k, v, o, B, p, s);
      case 128: return launch_f32<128>(q, k, v, o, B, p, s);
    }
  } else if (dtype == 1) {
    switch (hd) {
      case 32: return launch_bf16<32>(q, k, v, o, B, Hkv, p, s);
      case 64: return launch_bf16<64>(q, k, v, o, B, Hkv, p, s);
      case 128: return launch_bf16<128>(q, k, v, o, B, Hkv, p, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}
