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
// hd=64, ns=64): 0.685 GB moved in f32 (0.345 GB in bf16), 0.2044 ms at
// 3.35 TB/s (0.1030 ms); the recurrence's ~4 hd ns flops per token and
// head (21.5 GFLOP) take 0.043 ms at the 495 TFLOP/s of TF32 on the tensor
// cores (0.32 ms at the 67 TFLOP/s of f32 outside them), so on the tensor
// cores memory bounds it. The kernel's own tensor work is larger: the
// chunked form and the hi/lo passes make ~120 mma.sync m16n8k8 a warp and
// sub-chunk in f32 (~76 in bf16); at the ~3.7 ns an mma takes on a busy
// sub-partition (tools/ssd_probe.py on an H100 80GB HBM3, 700 W) that is
// ~0.34 ms at this shape. Issue, not memory or the tensor pipe, holds the
// kernel near 0.83 ms there: ~1100 instructions a warp and sub-chunk, 3
// warps a sub-partition (PERF.md).
//
// Design: the chunked form of the Pallas body on mma.sync m16n8k8 TF32
// tiles, with sub-chunks of SUB = 16 tokens. With cum_t the inclusive sum
// of loga from the sub-chunk's start, tot its last value, and h the state
// before the sub-chunk:
//     y_t = e^{cum_t} (C_t . h)                                  (inter)
//           + sum_{s<=t} G[t][s] x_s                             (intra)
//     G[t][s] = (C_t . B_s) e^{cum_t - cum_s}, s <= t            (scores)
//     h  <- e^{tot} h + sum_s (x_s e^{tot - cum_s}) (x) B_s      (update)
// - Decay. Every factor is the exponent of a difference that is <= 0:
//   e^{cum_t}, e^{tot - cum_s}, and e^{cum_t - cum_s} with the exponent
//   masked to -inf for s > t before exp, so each lies in [0, 1] for any
//   loga <= 0 (a step of -80 underflows, never overflows). cum starts at
//   each sub-chunk, so a large cum does not eat the differences near the
//   diagonal. e^{cum_t} scales the inter term's output, not C, and the
//   update's factor goes on x: C and B stay as given.
// - Precision. Every product runs on TF32 with its f32 operands split into
//   hi + lo (hi rounded to TF32's 11 bits by Veltkamp's split, lo = v - hi,
//   of which the mma reads the top 11 bits) and takes hi.hi + hi.lo +
//   lo.hi: each term keeps ~2^-21 of its value (lo's truncation and the
//   dropped lo.lo). bf16 x, B and C are exact in TF32 and are not split:
//   C.B^T takes one pass, the other products two (the state h, the decayed
//   scores and the decayed x are f32 values and are split). Sums stay in
//   f32 accumulators, each pass in its own (shorter chains of dependent
//   mma); the state's update is summed in fresh accumulators each
//   sub-chunk and folded into h by an f32 fma, since hundreds of sub-chunks
//   of adds inside one accumulator lost ~10x the precision at loga = 0.
//   Decays and exps are f32 on the CUDA cores. A bf16 split keeps only
//   ~2^-17 a term, which misses the f32 path's elementwise 2e-4 against the
//   sequential oracle (tests/test_torch_ssd.py holds a mirror of each split
//   to the oracle).
// - Work split. One block of W = DV / 16 warps per (b, head, DV rows of
//   hd; DV = min(hd, 64): rows are independent, h[i] reads only x[:, i]),
//   so the zamba2 shape runs 320 blocks of 4 warps, 3 an SM
//   (__launch_bounds__ and shared memory): one wave. The block stages CH =
//   32 tokens at a time with cp.async (16 bytes for x, B and C, 4 for
//   loga) into one of two buffers, the next chunk's loads in flight while
//   the current one runs. Per chunk: (A.1) one warp scans cum, e^{cum} and
//   e^{tot - cum} (a lane a token) while all threads split the staged f32
//   C into hi (in place) and lo, once for all warps; (A.2) each warp
//   computes one 16 x 8 tile of the scores G of a sub-chunk, masks and
//   decays it and stores it as hi and lo; (B) each warp walks the two
//   sub-chunks alone (no barrier) on its own 16 rows of h: the inter term
//   y^T (rows i x tokens t) = h C^T with h the A operand straight from its
//   f32 accumulators (the k index in the accumulator's pair order: slot q
//   <-> 2q, q + 4 <-> 2q + 1, so the reuse is a register rename), the
//   intra term x^T G^T with G read from shared memory, the store, then
//   the update. Past S the staged rows are zero-filled (loga = 0, x = B =
//   C = 0: no decay, no input).
// - Layout. The inputs may be strided (the last axis contiguous); every
//   row start of x, B and C must be 16-byte aligned, which the wrapper
//   checks (`_launch_layout`). y is contiguous.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int SUB = 16;          // tokens a sub-chunk (the mma tiles' 16)
constexpr int CH = 32;           // tokens staged at a time (a lane each)
constexpr int NSUB = CH / SUB;   // sub-chunks a staged chunk
static_assert(CH == 32, "one lane a staged token");

typedef __nv_bfloat16 bf16;

struct Params {
  int nh, S;
  long long x_sb, x_sh, x_ss, b_sb, b_ss, c_sb, c_ss, a_sb, a_sh, a_ss;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; pred false writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
// 4 bytes global -> shared (loga, whatever its stride); pred as above
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// the TF32 part of v (its top 11 significant bits, rounded to nearest):
// Veltkamp's split on the FMA pipe (cvt.rna.tf32 runs on the slower
// conversion pipe); the _rn intrinsics keep nvcc from fusing it into an fma
__device__ __forceinline__ float tf32_hi(float v) {
  const float g = __fmul_rn(v, 8193.f);  // 2^13 + 1
  return __fadd_rn(g, __fsub_rn(v, g));
}
// d += a.b on a 16x8x8 tile: a 16x8 TF32 (row), b 8x8 TF32 (col), d f32
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An mma operand fragment of N registers: hi and lo TF32 parts of f32
// values, or (EXACT: bf16 inputs, exact in TF32) the values alone
template <int N>
struct Frag {
  uint32_t hi[N], lo[N];
};
// v as hi + lo: lo = v - hi is exact, and the mma reads its top 11 bits
template <bool EXACT>
__device__ __forceinline__ void part(float v, uint32_t& hi, uint32_t& lo) {
  const float h = EXACT ? v : tf32_hi(v);
  hi = __float_as_uint(h);
  lo = EXACT ? 0u : __float_as_uint(__fsub_rn(v, h));
}
template <bool EXACT>
__device__ __forceinline__ Frag<2> frag(float a, float b) {
  Frag<2> f;
  part<EXACT>(a, f.hi[0], f.lo[0]);
  part<EXACT>(b, f.hi[1], f.lo[1]);
  return f;
}
template <bool EXACT>
__device__ __forceinline__ Frag<4> frag(float a, float b, float c, float d) {
  Frag<4> f;
  part<EXACT>(a, f.hi[0], f.lo[0]);
  part<EXACT>(b, f.hi[1], f.lo[1]);
  part<EXACT>(c, f.hi[2], f.lo[2]);
  part<EXACT>(d, f.hi[3], f.lo[3]);
  return f;
}
// d += a.b as hi.hi + hi.lo + lo.hi, without the passes an exact side
// (AX, BX) does not need: hi.hi into d, lo.hi into c and hi.lo into e
// (shorter chains of dependent mma; c and e may be one accumulator, and
// the caller adds them to d)
template <bool AX, bool BX>
__device__ __forceinline__ void mma3(float (&d)[4], float (&c)[4],
                                     float (&e)[4], const Frag<4>& a,
                                     const Frag<2>& b) {
  if (!AX) mma(c, a.lo, b.hi);
  if (!BX) mma(e, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}
__device__ __forceinline__ void zero(float (&d)[4]) {
  d[0] = d[1] = d[2] = d[3] = 0.f;
}
__device__ __forceinline__ void add(float (&d)[4], const float (&c)[4]) {
  d[0] += c[0], d[1] += c[1], d[2] += c[2], d[3] += c[3];
}

__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
// C's values at (row, column 2q and 2q + 1) as an operand pair: bf16
// exact, f32 as the hi parts staged in place and the lo parts beside them
__device__ __forceinline__ Frag<2> cpair(const bf16* c, const float*) {
  const float2 v = ld2(c);
  return {{__float_as_uint(v.x), __float_as_uint(v.y)}, {0u, 0u}};
}
__device__ __forceinline__ Frag<2> cpair(const float* c, const float* lo) {
  const float2 h = ld2(c), l = ld2(lo);
  return {{__float_as_uint(h.x), __float_as_uint(h.y)},
          {__float_as_uint(l.x), __float_as_uint(l.y)}};
}
__device__ __forceinline__ void st1(float* p, float v) { *p = v; }
__device__ __forceinline__ void st1(bf16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// shared-memory geometry and work split of one block: DV rows of h, NS
// state columns, W warps (16 rows each). Rows padded so that a warp's
// fragment loads hit 32 distinct banks: B and C rows by 8 elements (float2
// or bf16x2 pairs at row g, column 2q), x rows by 16 bytes (x[2q][g]).
template <typename T, int DV, int NS>
struct Geo {
  static constexpr int W = DV / 16;
  static constexpr int THREADS = 32 * W;
  static constexpr int LDX = DV + 16 / (int)sizeof(T);
  static constexpr int LDB = NS + 8;
  // one stage: x [CH][LDX], B and C [CH][LDB] (T), loga [CH] (f32)
  static constexpr int XS = 0;
  static constexpr int BS = XS + CH * LDX * (int)sizeof(T);
  static constexpr int CS = BS + CH * LDB * (int)sizeof(T);
  static constexpr int AS = CS + CH * LDB * (int)sizeof(T);
  static constexpr int STAGE = AS + CH * 4;
  // two stages, then cum, e^cum and e^(tot - cum) [CH] (f32) each, then
  // the scores of the staged sub-chunks as TF32 hi and lo (f32)
  // [NSUB * SUB][LDG], rows padded by 8 (float2 at row g, column 2q); then
  // (f32 x/B/C only) the lo parts of the staged C [CH][LDB] (f32), its hi
  // parts in place
  static constexpr int LDG = SUB + 8;
  static constexpr int CUM = 2 * STAGE;
  static constexpr int GS = CUM + 3 * CH * 4;
  static constexpr int CLO = GS + 2 * NSUB * SUB * LDG * 4;
  static constexpr int BYTES = CLO + (sizeof(T) == 4 ? CH * LDB * 4 : 0);
  // blocks an SM the registers must allow (one wave at the zamba2 shape)
  static constexpr int MIN_BLOCKS = (NS <= 64 ? 3 : 2) * 4 / W;
  static_assert(DV % 16 == 0 && NS % 16 == 0 && STAGE % 16 == 0, "tiles");
};

template <typename T, int HD, int NS>
__global__ void __launch_bounds__(Geo<T, (HD < 64 ? HD : 64), NS>::THREADS,
                                  Geo<T, (HD < 64 ? HD : 64), NS>::MIN_BLOCKS)
ssd_kernel(const T* __restrict__ x, const T* __restrict__ bm,
           const T* __restrict__ cm, const float* __restrict__ loga,
           T* __restrict__ y, Params p) {
  constexpr int DV = HD < 64 ? HD : 64;
  using G = Geo<T, DV, NS>;
  constexpr int LDX = G::LDX, LDB = G::LDB, THREADS = G::THREADS;
  constexpr bool EX = sizeof(T) == 2;  // bf16 x, B, C: exact in TF32
  extern __shared__ __align__(16) unsigned char smem[];
  float* cum = reinterpret_cast<float*>(smem + G::CUM);
  float* ecum = cum + CH;  // e^{cum_t}
  float* dec = ecum + CH;  // e^{tot - cum_t}
  float* gsm = reinterpret_cast<float*>(smem + G::GS);  // scores, hi then lo
  float* clo = reinterpret_cast<float*>(smem + G::CLO);  // C's lo parts

  const int cs = blockIdx.x, hh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const T* xb = x + b * p.x_sb + hh * p.x_sh + cs * DV;
  const T* bb = bm + b * p.b_sb;
  const T* cb = cm + b * p.c_sb;
  const float* ab = loga + b * p.a_sb + hh * p.a_sh;
  T* yb = y + ((long long)b * p.nh + hh) * p.S * HD + cs * DV + warp * 16;

  // chunk n into stage n & 1: x's DV columns, B and C rows, loga; rows at
  // or past S are zero-filled without a read. A thread's 16-byte pieces
  // keep their column and step ROWS rows at a time: their sources are
  // pointers advanced by a stride, not recomputed from (row, column)
  constexpr int EPV = 16 / (int)sizeof(T);  // elements a 16-byte piece
  constexpr int XV = DV / EPV, BV = NS / EPV;  // pieces a row
  constexpr int XROWS = THREADS / XV, BROWS = THREADS / BV;
  static_assert(THREADS % XV == 0 && THREADS % BV == 0, "pieces");
  const int xt = tid / XV, xc = tid % XV * EPV;
  const int bt = tid / BV, bc = tid % BV * EPV;
  const T* xsrc = xb + xt * p.x_ss + xc;
  const T* bsrc = bb + bt * p.b_ss + bc;
  const T* csrc = cb + bt * p.c_ss + bc;
  auto stage = [&](int n) {
    unsigned char* st = smem + (n & 1) * G::STAGE;
    T* xs = reinterpret_cast<T*>(st + G::XS) + xt * LDX + xc;
    T* bs = reinterpret_cast<T*>(st + G::BS) + bt * LDB + bc;
    T* csm = reinterpret_cast<T*>(st + G::CS) + bt * LDB + bc;
    float* as = reinterpret_cast<float*>(st + G::AS);
    const int t0 = n * CH;
#pragma unroll
    for (int t = 0; t < CH; t += XROWS) {
      const bool in = xt + t < CH && t0 + xt + t < p.S;
      if (xt + t < CH)
        cp_async16(xs + t * LDX, in ? xsrc + (t0 + t) * p.x_ss : xb, in);
    }
#pragma unroll
    for (int t = 0; t < CH; t += BROWS) {
      const bool in = bt + t < CH && t0 + bt + t < p.S;
      if (bt + t < CH) {
        cp_async16(bs + t * LDB, in ? bsrc + (t0 + t) * p.b_ss : bb, in);
        cp_async16(csm + t * LDB, in ? csrc + (t0 + t) * p.c_ss : cb, in);
      }
    }
    for (int t = tid; t < CH; t += THREADS) {
      const bool in = t0 + t < p.S;
      cp_async4(as + t, ab + (in ? t0 + t : 0) * p.a_ss, in);
    }
    cp_async_commit();
  };

  // this warp's 16 rows of h: NS / 8 n-tiles of f32 accumulators, from the
  // first token to the last
  float hacc[NS / 8][4];
#pragma unroll
  for (int nt = 0; nt < NS / 8; ++nt)
    hacc[nt][0] = hacc[nt][1] = hacc[nt][2] = hacc[nt][3] = 0.f;

  const int nch = (p.S + CH - 1) / CH;
  stage(0);
  for (int n = 0; n < nch; ++n) {
    cp_async_wait_all();
    __syncthreads();  // chunk n is staged; chunk n - 1's steps are done
    if (n + 1 < nch) stage(n + 1);
    const unsigned char* st = smem + (n & 1) * G::STAGE;
    const T* xs = reinterpret_cast<const T*>(st + G::XS) + warp * 16;
    const T* bs = reinterpret_cast<const T*>(st + G::BS);
    const T* csm = reinterpret_cast<const T*>(st + G::CS);
    const float* as = reinterpret_cast<const float*>(st + G::AS);

    // (A.1) a lane a token: cum from its sub-chunk's start (inclusive),
    // then e^{cum} and e^{tot - cum}, each in [0, 1]
    if (warp == 0) {
      float c = as[lane];
#pragma unroll
      for (int off = 1; off < SUB; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, c, off);
        if ((lane & (SUB - 1)) >= off) c += o;
      }
      const float tot = __shfl_sync(0xffffffffu, c, lane | (SUB - 1));
      cum[lane] = c;
      ecum[lane] = expf(c);
      dec[lane] = expf(tot - c);
    }
    if (!EX) {  // f32 C: its hi parts in place, its lo parts in clo
      float* cw =
          reinterpret_cast<float*>(smem + (n & 1) * G::STAGE + G::CS);
      for (int i = tid; i < CH * NS / 4; i += THREADS) {
        const int o = i / (NS / 4) * LDB + i % (NS / 4) * 4;
        float4 v = *reinterpret_cast<float4*>(cw + o), h;
        h.x = tf32_hi(v.x), h.y = tf32_hi(v.y), h.z = tf32_hi(v.z);
        h.w = tf32_hi(v.w);
        *reinterpret_cast<float4*>(cw + o) = h;
        *reinterpret_cast<float4*>(clo + o) = make_float4(
            __fsub_rn(v.x, h.x), __fsub_rn(v.y, h.y), __fsub_rn(v.z, h.z),
            __fsub_rn(v.w, h.w));
      }
    }
    __syncthreads();  // the decays and C's parts are set

    // (A.2) the decayed scores G[t][s] = (C_t . B_s) e^{cum_t - cum_s} of
    // each sub-chunk, the exponent masked for s > t before exp; a warp an
    // 8-column tile (sub-chunk j, columns st 8 ..), stored as hi and lo
    for (int it = warp; it < 2 * NSUB; it += G::W) {
      const int j = it >> 1, st0 = (it & 1) * 8, r0 = j * SUB;
      float ga[4], gc[4], ge[4];
      zero(ga), zero(gc), zero(ge);
#pragma unroll
      for (int kk = 0; kk < NS / 8; ++kk) {
        const int c = kk * 8 + 2 * q;
        const Frag<2> c0 =
            cpair(csm + (r0 + g) * LDB + c, clo + (r0 + g) * LDB + c);
        const Frag<2> c1 = cpair(csm + (r0 + g + 8) * LDB + c,
                                 clo + (r0 + g + 8) * LDB + c);
        const float2 b0 = ld2(bs + (r0 + st0 + g) * LDB + c);
        // C as the A operand (rows t = g, g + 8), in the pair order
        const Frag<4> ca = {{c0.hi[0], c1.hi[0], c0.hi[1], c1.hi[1]},
                            {c0.lo[0], c1.lo[0], c0.lo[1], c1.lo[1]}};
        mma3<EX, EX>(ga, gc, ge, ca, frag<EX>(b0.x, b0.y));
      }
      add(gc, ge), add(ga, gc);
      const int s = st0 + 2 * q;
      const float cg0 = cum[r0 + g], cg1 = cum[r0 + g + 8];
      const float cs0 = cum[r0 + s], cs1 = cum[r0 + s + 1];
      ga[0] *= __expf(s <= g ? cg0 - cs0 : -INFINITY);
      ga[1] *= __expf(s + 1 <= g ? cg0 - cs1 : -INFINITY);
      ga[2] *= __expf(s <= g + 8 ? cg1 - cs0 : -INFINITY);
      ga[3] *= __expf(s + 1 <= g + 8 ? cg1 - cs1 : -INFINITY);
      const Frag<4> gf = frag<false>(ga[0], ga[1], ga[2], ga[3]);
      float* gh = gsm + (r0 + g) * G::LDG + s;
      float* gl = gh + NSUB * SUB * G::LDG;
      *reinterpret_cast<float2*>(gh) =
          make_float2(__uint_as_float(gf.hi[0]), __uint_as_float(gf.hi[1]));
      *reinterpret_cast<float2*>(gl) =
          make_float2(__uint_as_float(gf.lo[0]), __uint_as_float(gf.lo[1]));
      *reinterpret_cast<float2*>(gh + 8 * G::LDG) =
          make_float2(__uint_as_float(gf.hi[2]), __uint_as_float(gf.hi[3]));
      *reinterpret_cast<float2*>(gl + 8 * G::LDG) =
          make_float2(__uint_as_float(gf.lo[2]), __uint_as_float(gf.lo[3]));
    }
    __syncthreads();  // the scores are set

    // (B) the sub-chunks in order, each warp on its own rows
#pragma unroll
    for (int j = 0; j < NSUB; ++j) {
      const int r0 = j * SUB, t0 = n * CH + r0;
      if (t0 >= p.S) break;  // block-uniform

      // x at (s, i) in the pair order: k-step ks, slots q and q + 4 hold
      // tokens ks 8 + 2q and + 1; rows g and g + 8
      float xv[2][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const T* xr = xs + (r0 + ks * 8 + 2 * q) * LDX + g;
        xv[ks][0] = ld1(xr), xv[ks][1] = ld1(xr + 8);
        xv[ks][2] = ld1(xr + LDX), xv[ks][3] = ld1(xr + LDX + 8);
      }

      // y^T = h C^T (rows i x tokens t) over the state's columns, 8 (one
      // k-step) at a time, each pass in its own accumulators
      float yacc[2][4], yc[2][4], ye[2][4];
#pragma unroll
      for (int tt = 0; tt < 2; ++tt)
        zero(yacc[tt]), zero(yc[tt]), zero(ye[tt]);
#pragma unroll
      for (int kk = 0; kk < NS / 8; ++kk) {
        const int c = kk * 8 + 2 * q;
        // C as the B operand (columns t = g, g + 8), h's n-tile kk as A
        const Frag<4> ha =
            frag<false>(hacc[kk][0], hacc[kk][2], hacc[kk][1], hacc[kk][3]);
        mma3<false, EX>(yacc[0], yc[0], ye[0], ha,
                        cpair(csm + (r0 + g) * LDB + c,
                              clo + (r0 + g) * LDB + c));
        mma3<false, EX>(yacc[1], yc[1], ye[1], ha,
                        cpair(csm + (r0 + g + 8) * LDB + c,
                              clo + (r0 + g + 8) * LDB + c));
      }
      // the inter term reads the state after each token's own decay
#pragma unroll
      for (int tt = 0; tt < 2; ++tt) {
        const float e0 = ecum[r0 + tt * 8 + 2 * q];
        const float e1 = ecum[r0 + tt * 8 + 2 * q + 1];
        float(&v)[4] = yacc[tt];
        add(yc[tt], ye[tt]), add(v, yc[tt]), zero(yc[tt]);
        v[0] *= e0, v[1] *= e1, v[2] *= e0, v[3] *= e1;
      }
      // y^T += x^T G^T, G from shared memory as the B operand
      const float* gh = gsm + r0 * G::LDG + 2 * q;
      const float* gl = gh + NSUB * SUB * G::LDG;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const Frag<4> xa =
            frag<EX>(xv[ks][0], xv[ks][1], xv[ks][2], xv[ks][3]);
#pragma unroll
        for (int tt = 0; tt < 2; ++tt) {
          const int o = (tt * 8 + g) * G::LDG + ks * 8;
          const float2 h2 = *reinterpret_cast<const float2*>(gh + o);
          const float2 l2 = *reinterpret_cast<const float2*>(gl + o);
          const Frag<2> gb = {{__float_as_uint(h2.x), __float_as_uint(h2.y)},
                              {__float_as_uint(l2.x), __float_as_uint(l2.y)}};
          mma3<EX, false>(yacc[tt], yc[tt], yc[tt], xa, gb);
        }
      }
#pragma unroll
      for (int tt = 0; tt < 2; ++tt) {
        add(yacc[tt], yc[tt]);
        const int t = t0 + tt * 8 + 2 * q;
        T* yr = yb + (long long)t * HD + g;
        if (t < p.S) st1(yr, yacc[tt][0]), st1(yr + 8, yacc[tt][2]);
        if (t + 1 < p.S)
          st1(yr + HD, yacc[tt][1]), st1(yr + HD + 8, yacc[tt][3]);
      }

      // the state: h = e^{tot} h + (x e^{tot - cum_s})^T B, the sub-chunk's
      // sum taken in fresh accumulators and folded into h by an f32 fma (a
      // long run of adds inside the mma accumulators would round each one)
      const float et = ecum[r0 + SUB - 1];
      Frag<4> xd[2];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const float d0 = dec[r0 + ks * 8 + 2 * q];
        const float d1 = dec[r0 + ks * 8 + 2 * q + 1];
        xd[ks] = frag<false>(xv[ks][0] * d0, xv[ks][1] * d0,
                             xv[ks][2] * d1, xv[ks][3] * d1);
      }
#pragma unroll
      for (int nt = 0; nt < NS / 8; ++nt) {
        float u[4], uc[4];
        zero(u), zero(uc);
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const T* br = bs + (r0 + ks * 8 + 2 * q) * LDB + nt * 8 + g;
          mma3<false, EX>(u, uc, uc, xd[ks],
                          frag<EX>(ld1(br), ld1(br + LDB)));
        }
        float(&h)[4] = hacc[nt];
#pragma unroll
        for (int e = 0; e < 4; ++e) h[e] = fmaf(h[e], et, u[e] + uc[e]);
      }
    }
  }
}

template <typename T, int HD, int NS>
struct Kernel {
  static constexpr int DV = HD < 64 ? HD : 64;
  using G = Geo<T, DV, NS>;
  // the dynamic shared-memory limit, set once per device
  static int prepare() {
    static unsigned done = 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 32 && (done >> dev & 1u)) return 0;
    err = cudaFuncSetAttribute(ssd_kernel<T, HD, NS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               G::BYTES);
    if (err != cudaSuccess) return (int)err;
    if (dev < 32) done |= 1u << dev;
    return 0;
  }
  static int launch(const void* x, const void* bm, const void* cm,
                    const float* loga, void* y, int B, const Params& p,
                    int smem, cudaStream_t stream) {
    if (smem != G::BYTES) return (int)cudaErrorInvalidValue;
    const int err = prepare();
    if (err != 0) return err;
    ssd_kernel<T, HD, NS><<<dim3(HD / DV, p.nh, B), G::THREADS, G::BYTES,
                            stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(bm),
        static_cast<const T*>(cm), loga, static_cast<T*>(y), p);
    return (int)cudaGetLastError();
  }
  // {threads, dynamic shared memory, blocks an SM, registers, local bytes}
  static int geometry(int* out) {
    const int err = prepare();
    if (err != 0) return err;
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, ssd_kernel<T, HD, NS>);
    if (e != cudaSuccess) return (int)e;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, ssd_kernel<T, HD, NS>, G::THREADS, G::BYTES);
    if (e != cudaSuccess) return (int)e;
    out[0] = G::THREADS, out[1] = G::BYTES, out[2] = blocks;
    out[3] = attr.numRegs, out[4] = (int)attr.localSizeBytes;
    return 0;
  }
};

// one call of F on the instantiation for (dtype, hd, ns)
template <typename T, int HD, typename F>
int with_ns(int ns, F f) {
  switch (ns) {
    case 16: return f(Kernel<T, HD, 16>());
    case 32: return f(Kernel<T, HD, 32>());
    case 64: return f(Kernel<T, HD, 64>());
    case 128: return f(Kernel<T, HD, 128>());
  }
  return (int)cudaErrorInvalidValue;
}
template <typename T, typename F>
int with_hd(int hd, int ns, F f) {
  switch (hd) {
    case 32: return with_ns<T, 32>(ns, f);
    case 64: return with_ns<T, 64>(ns, f);
    case 128: return with_ns<T, 128>(ns, f);
  }
  return (int)cudaErrorInvalidValue;
}
template <typename F>
int dispatch(int dtype, int hd, int ns, F f) {
  if (dtype == 0) return with_hd<float>(hd, ns, f);
  if (dtype == 1) return with_hd<bf16>(hd, ns, f);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype of x/B/C/y: 0 = float32, 1 = bfloat16; loga is f32. Strides are in
// elements; the last axis of x, B and C is contiguous and their row starts
// 16-byte aligned. smem is the dynamic shared memory the wrapper computed
// (`smem_bytes`); one that is not the kernel's own returns
// cudaErrorInvalidValue. Returns a cudaError_t (0 on success), launch
// errors included.
extern "C" int mamba2_ssd_launch(
    const void* x, const void* bm, const void* cm, const void* loga, void* y,
    int dtype, int B, int nh, int S, int hd, int ns, long long x_sb,
    long long x_sh, long long x_ss, long long b_sb, long long b_ss,
    long long c_sb, long long c_ss, long long a_sb, long long a_sh,
    long long a_ss, int smem, void* stream) {
  if (B < 0 || nh <= 0 || S < 0 || nh > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  const Params p{nh, S, x_sb, x_sh, x_ss, b_sb, b_ss, c_sb, c_ss,
                 a_sb, a_sh, a_ss};
  const float* la = static_cast<const float*>(loga);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, hd, ns, [&](auto k) {
    return decltype(k)::launch(x, bm, cm, la, y, B, p, smem, s);
  });
}

// out[5] = {threads a block, dynamic shared memory, blocks an SM (the
// occupancy calculator), registers a thread, local memory a thread} of the
// instantiation for (dtype, hd, ns). Returns a cudaError_t.
extern "C" int mamba2_ssd_geometry(int dtype, int hd, int ns, int* out) {
  return dispatch(dtype, hd, ns,
                  [&](auto k) { return decltype(k)::geometry(out); });
}
