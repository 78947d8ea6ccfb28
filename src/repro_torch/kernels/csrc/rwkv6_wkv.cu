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
// bf16 r/k/v, f32 logw): 0.81 GB moved, ~0.24 ms at 3.35 TB/s. The
// recurrence's ~4 hd^2 flops per token and head (17.2 GFLOP) take ~0.017 ms
// on the bf16 tensor cores (989 TFLOP/s), ~0.26 ms at the 67 TFLOP/s of f32
// outside them, so on the tensor cores memory bounds it.
//
// bf16 design (`wkv_kernel_mma`): the chunked form of the Pallas body on
// mma.sync m16n8k16 tiles, with sub-chunks of SUB = 16 tokens. With w =
// exp(logw), b the first token of t's sub-chunk and S_b the state before b:
//     o_t     = (r_t (.) prod_{b<=q<t} w_q) . S_b
//               + sum_{b<=s<t} [sum_c r_tc k_sc prod_{s<q<t} w_qc] v_s
//               + (r_t . (u (.) k_t)) v_t
//     S_next  = diag(prod_{sub-chunk} w) S_b
//               + sum_s (k_s (.) prod_{s<q<=end} w_q)^T v_s
// - Decay factors. Every factor is a running product of w inside one
//   sub-chunk (forward for r, backward for k), so each lies in [0, 1] for
//   any logw <= 0: no factor overflows, a fully decayed one underflows to 0,
//   and exp is taken once per (token, channel), not once per pair. The
//   intra-sub-chunk scores (the 120 pairs s < t of a 16 x 16 block and the
//   bonus on its diagonal) run on the CUDA cores with the same running
//   product; the three products above run on the tensor cores.
// - Precision. bf16 r, k, v are exact; the decayed r and k, the scores and
//   the state are f32 values, each split into bf16 hi + lo (x - hi), and
//   each product takes hi.hi + hi.lo + lo.hi (v exact), so every term keeps
//   ~2^-16 of its value. The state stays in f32 mma accumulators from the
//   first token to S_fin. Dropping the lo terms of o's products would save
//   a third of the mma, but o would then differ from the plain version by
//   about its own rounding, and the model's depth check (32 layers, bf16)
//   already sits near its limit with them.
// - Work split. One block of W = DV / 8 warps per (b, head, DV value
//   columns; DV = hd, or 64 at hd 128: value columns are independent, the
//   decay acts on key rows), so the rwkv6-7b shape runs 256 blocks of 8
//   warps, two an SM. It stages CH = 32 tokens at a time with 16-byte
//   cp.async: r, k and logw whole, v's DV columns; the next chunk's loads
//   are in flight while the current one's sub-chunks run. Per chunk:
//   (A.0) w = exp(logw) in place; (A.1) a thread per (direction, sub-chunk,
//   key channel) scans the decayed r (forward, with the sub-chunk's total
//   decay) or k (backward) into hi/lo bf16; (A.2) a thread per (sub-chunk,
//   row pair, channel group) takes rows rp and 15 - rp of a diagonal block
//   (15 pairs in all, the same unrolled steps for every thread) on hd / CG
//   channels, and the 17 partial sums of a row pair are summed over its CG
//   lanes (16 with 8 warps) by a reduce-scatter (15 shuffles, not 68); the
//   scores go to shared memory as hi/lo bf16; (B) per sub-chunk, each warp
//   computes o for 16 tokens x 8 columns from the state's hi/lo copy in
//   shared memory (ldmatrix fragments), while updating its own tiles of the
//   f32 state in registers and writing their hi/lo copy to the other of two
//   buffers; one barrier per sub-chunk. Padding past S is zero-filled
//   (w = 1, k = v = 0). tools/wkv_probe.py times the kernel with each
//   phase cut out.
// - Layout. Inputs may be strided views (the model's (B, S, H, hd) tensors
//   seen as (B, H, S, hd)); hd must be contiguous and every row start
//   16-byte aligned, which the wrapper checks (`_launch_layout`).
//
// f32 design (`wkv_kernel_f32`, CUDA cores): the recurrence token by token.
// On the tensor cores an f32 product would need v split as well and keeps
// ~2^-16, which the f32 path's elementwise 1e-3 against its plain version
// does not leave room for at near-zero outputs. One block of 4 hd threads
// per (b, head); four lanes of a warp (q = 0..3, 8 lanes apart) own column
// j of S, a quarter of its rows each (hd/4 floats in registers), so
// o_t[j] = sum_c r_t[c] S[c][j] + (r_t . (u (.) k_t)) v_t[j] is a partial
// sum per lane and two shuffles. The block stages `ch` tokens at a time
// (the chunk) in shared memory: r, k, exp(logw) and v, plus the bonus
// scalar r_t . (u (.) k_t) per token; the chunk does not change the
// result. Instruction count bounds it: staging costs about half the
// recurrence's instructions again, and the recurrence takes 3 FP32
// instructions per state element where the bound counts 2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Params {
  int H, S, ch;
  long long r_sb, r_sh, r_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long w_sb, w_sh, w_ss;
};

// ---------------------------------------------------------------------------
// bf16: the chunked form on the tensor cores

constexpr int SUB = 16;           // tokens per sub-chunk (one mma tile)
constexpr int NSUB = 2;           // sub-chunks per staged chunk
constexpr int CH = SUB * NSUB;    // tokens staged at a time
constexpr int PAD = 8;            // bf16 elements of padding per smem row
constexpr int LDP = SUB + PAD;    // bf16 row of the diagonal scores

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; pred false writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p))
      : "memory");
}
// d += a.b on a 16x8x16 tile: a 16x16 bf16 (row), b 16x8 bf16 (col), d f32
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// (a, b) -> bf16x2 hi = round(a, b) and lo = round((a, b) - hi), a in the
// low half: hi + lo keeps ~2^-16 of each value
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
__device__ __forceinline__ void split1(float x, bf16* hi, bf16* lo) {
  const bf16 h = __float2bfloat16(x);
  *hi = h;
  *lo = __float2bfloat16(x - __bfloat162float(h));
}
// shared-memory geometry and work split of one block: HD key channels, DV
// value columns, W warps (8 value columns of o each)
template <int HD, int DV, int W>
struct Geo {
  static constexpr int THREADS = W * 32;
  static constexpr int LDX = HD + PAD;  // decayed r and k rows (bf16)
  static constexpr int LDV = DV + PAD;  // v and state rows (bf16)
  static constexpr int MT = HD / 16;    // m-tiles (key rows) of the state
  static constexpr int NTS = DV / 8;    // n-tiles (value columns)
  static constexpr int WGM = MT >= W ? W : MT;  // warps along the rows
  static constexpr int WM = MT / WGM;           // m-tiles a warp
  static constexpr int WN = NTS / (W / WGM);    // n-tiles a warp
  // the diagonal scores: (sub-chunk, row pair, channel group) a thread
  static constexpr int CG = THREADS / (NSUB * 8);  // channel groups
  static constexpr int CGLOG = CG == 16 ? 4 : 3;    // log2(CG)
  static constexpr int CPT = HD / CG;              // channels a thread
  static constexpr int SBUF = 2 * HD * LDV;  // one state copy: hi, lo
  // byte offsets: raw r, k (bf16) and logw, then w (f32) [CH][HD]; v
  // (bf16) two buffers [CH][LDV]; decayed r, k hi/lo (bf16)
  // [CH][LDX]; state hi/lo (bf16) two buffers [HD][LDV]; diagonal scores
  // hi/lo (bf16) [CH][LDP]; sub-chunk decays (f32) [NSUB][HD]; u (f32) [HD]
  static constexpr int R_RAW = 0;
  static constexpr int K_RAW = R_RAW + CH * HD * 2;
  static constexpr int WS = K_RAW + CH * HD * 2;
  static constexpr int VS = WS + CH * HD * 4;
  static constexpr int XH = VS + 2 * CH * LDV * 2;
  static constexpr int XL = XH + CH * LDX * 2;
  static constexpr int KH = XL + CH * LDX * 2;
  static constexpr int KL = KH + CH * LDX * 2;
  static constexpr int SS = KL + CH * LDX * 2;
  static constexpr int PD = SS + 2 * SBUF * 2;
  static constexpr int WSUM = PD + 2 * CH * LDP * 2;
  static constexpr int US = WSUM + NSUB * HD * 4;
  static constexpr int BYTES = US + HD * 4;
  static_assert(DV == 8 * W, "one 8-column n-tile of o a warp");
  static_assert(WN % 2 == 0 && WM * WGM == MT, "state tiles");
  static_assert(CG * NSUB * 8 == THREADS && CPT % 4 == 0 &&
                    1 << CGLOG == CG && SUB % CG == 0,
                "diagonal items");
};

template <int HD, int DV, int W>
__global__ void __launch_bounds__(W * 32, 2)
wkv_kernel_mma(const bf16* __restrict__ r, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const float* __restrict__ logw,
               const float* __restrict__ u, bf16* __restrict__ o,
               float* __restrict__ sfin, Params p) {
  using G = Geo<HD, DV, W>;
  constexpr int THREADS = G::THREADS, LDX = G::LDX, LDV = G::LDV;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* rraw = reinterpret_cast<bf16*>(smem + G::R_RAW);
  bf16* kraw = reinterpret_cast<bf16*>(smem + G::K_RAW);
  float* ws = reinterpret_cast<float*>(smem + G::WS);  // logw, then w
  bf16* vs = reinterpret_cast<bf16*>(smem + G::VS);
  bf16* xh = reinterpret_cast<bf16*>(smem + G::XH);
  bf16* xl = reinterpret_cast<bf16*>(smem + G::XL);
  bf16* kh = reinterpret_cast<bf16*>(smem + G::KH);
  bf16* kl = reinterpret_cast<bf16*>(smem + G::KL);
  bf16* ss = reinterpret_cast<bf16*>(smem + G::SS);
  bf16* ph = reinterpret_cast<bf16*>(smem + G::PD);  // diagonal scores
  bf16* pl = ph + CH * LDP;
  float* wsum = reinterpret_cast<float*>(smem + G::WSUM);
  float* us = reinterpret_cast<float*>(smem + G::US);

  const int cs = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const bf16* rb = r + b * p.r_sb + h * p.r_sh;
  const bf16* kb = k + b * p.k_sb + h * p.k_sh;
  const bf16* vb = v + b * p.v_sb + h * p.v_sh + cs * DV;
  const float* wb = logw + b * p.w_sb + h * p.w_sh;
  bf16* ob = o + ((long long)b * p.H + h) * p.S * HD + cs * DV;

  // chunk n into shared memory: r, k and logw rows whole, v's DV columns;
  // rows at or past S are zero-filled without a read
  auto stage = [&](int n) {
    const int t0 = n * CH;
    for (int i = tid; i < CH * (HD / 8); i += THREADS) {
      const int t = i / (HD / 8), c = i % (HD / 8) * 8;
      const bool in = t0 + t < p.S;
      const long long tt = in ? t0 + t : 0;
      cp_async16(rraw + t * HD + c, rb + tt * p.r_ss + c, in);
      cp_async16(kraw + t * HD + c, kb + tt * p.k_ss + c, in);
    }
    for (int i = tid; i < CH * (HD / 4); i += THREADS) {
      const int t = i / (HD / 4), c = i % (HD / 4) * 4;
      const bool in = t0 + t < p.S;
      cp_async16(ws + t * HD + c, wb + (in ? t0 + t : 0) * p.w_ss + c, in);
    }
    bf16* vd = vs + (n & 1) * CH * LDV;
    for (int i = tid; i < CH * (DV / 8); i += THREADS) {
      const int t = i / (DV / 8), c = i % (DV / 8) * 8;
      const bool in = t0 + t < p.S;
      cp_async16(vd + t * LDV + c, vb + (in ? t0 + t : 0) * p.v_ss + c, in);
    }
    cp_async_commit();
  };

  const int nch = (p.S + CH - 1) / CH;
  if (nch > 0) stage(0);
  for (int i = tid; i < HD; i += THREADS) us[i] = u[h * HD + i];
  for (int i = tid; i < 2 * CH * LDP; i += THREADS)  // s > t stays 0
    ph[i] = __float2bfloat16(0.f);
  for (int i = tid; i < G::SBUF; i += THREADS) ss[i] = __float2bfloat16(0.f);

  // this warp's tiles of the state: m-tiles [wm WM, wm WM + WM), n-tiles
  // [wn WN, wn WN + WN); f32 accumulators, from the first token to S_fin
  const int wm = warp % G::WGM, wn = warp / G::WGM;
  float acc[G::WM][G::WN][4];
#pragma unroll
  for (int mt = 0; mt < G::WM; ++mt)
#pragma unroll
    for (int nt = 0; nt < G::WN; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  // ldmatrix lane offsets: x4 non-trans A from [m][k] rows (and x4 trans B
  // from [k][n] rows): row lane & 7 + 8 ((lane >> 3) & 1), column 8 (lane >> 4)
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, lcol = (lane >> 4) * 8;
  const int oc0 = warp * 8;  // this warp's o columns

  for (int n = 0; n < nch; ++n) {
    cp_async_wait_all();
    __syncthreads();  // chunk n is staged; the previous chunk's steps are done

    // (A.0) w = exp(logw) in place
    for (int i = tid; i < CH * HD / 4; i += THREADS) {
      float4 x = reinterpret_cast<float4*>(ws)[i];
      x.x = expf(x.x), x.y = expf(x.y), x.z = expf(x.z), x.w = expf(x.w);
      reinterpret_cast<float4*>(ws)[i] = x;
    }
    __syncthreads();  // w is set

    // (A.1) one (direction, sub-chunk, key channel) a thread: forward, r
    // decayed from the sub-chunk's start (a running product of w) and the
    // sub-chunk's total decay; backward, k decayed to its end
    for (int it = tid; it < 2 * NSUB * HD; it += THREADS) {
      const bool fwd = it < NSUB * HD;
      const int j = it / HD % NSUB, c = it % HD, t0 = j * SUB;
      float f = 1.f;
      if (fwd) {
#pragma unroll
        for (int tt = 0; tt < SUB; ++tt) {
          const int t = t0 + tt;
          split1(__bfloat162float(rraw[t * HD + c]) * f, xh + t * LDX + c,
                 xl + t * LDX + c);
          f *= ws[t * HD + c];
        }
        wsum[j * HD + c] = f;
      } else {
#pragma unroll
        for (int tt = SUB - 1; tt >= 0; --tt) {
          const int t = t0 + tt;
          split1(__bfloat162float(kraw[t * HD + c]) * f, kh + t * LDX + c,
                 kl + t * LDX + c);
          f *= ws[t * HD + c];
        }
      }
    }

    // (A.2) the diagonal blocks: P[t][s] = sum_c r_tc k_sc prod_{s<q<t} w_qc
    // for s < t and the bonus P[t][t] = r_t . (u (.) k_t). Thread (j, rp,
    // cg): rows ta = rp and tb = 15 - rp of sub-chunk j, whose 15 pairs in
    // all (step it = 0..14: ta's, then tb's, s descending) every thread
    // walks in the same unrolled steps, and their two bonuses (steps 15,
    // 16); channels [cg CPT, cg CPT + CPT). The 17 partial sums are summed
    // over the CG lanes of (j, rp) by reduce-scatters, each lane keeping
    // and storing some of the sums. A.1 and A.2 share no output.
    {
      constexpr int CG = G::CG, CPT = G::CPT;
      const int j = tid / (8 * CG), rp = tid / CG % 8, cg = tid % CG;
      const int c0 = cg * CPT, ta = j * SUB + rp, tb = j * SUB + SUB - 1 - rp;
      auto load4 = [&](const bf16* src, float* dst) {
        const uint2 raw4 = *reinterpret_cast<const uint2*>(src);
        const float2 lo = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&raw4.x));
        const float2 hi = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&raw4.y));
        dst[0] = lo.x, dst[1] = lo.y, dst[2] = hi.x, dst[3] = hi.y;
      };
      // the step's (t, s): a pair, or a bonus (s = t)
      auto pair = [&](int it, int& t, int& sc) {
        if (it >= SUB - 1) {
          t = sc = it == SUB - 1 ? ta : tb;
        } else {
          t = it >= rp ? tb : ta;
          sc = it >= rp ? tb - 1 - (it - rp) : ta - 1 - it;
        }
      };
      float ra[CPT], rbv[CPT], gg[CPT], val[SUB + 1];
      val[SUB - 1] = val[SUB] = 0.f;
#pragma unroll
      for (int m = 0; m < CPT; m += 4) {
        float ka[4], kb4[4];
        load4(rraw + ta * HD + c0 + m, ra + m);
        load4(rraw + tb * HD + c0 + m, rbv + m);
        load4(kraw + ta * HD + c0 + m, ka);
        load4(kraw + tb * HD + c0 + m, kb4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          val[SUB - 1] = fmaf(ra[m + e] * us[c0 + m + e], ka[e], val[SUB - 1]);
          val[SUB] = fmaf(rbv[m + e] * us[c0 + m + e], kb4[e], val[SUB]);
        }
      }
#pragma unroll
      for (int e = 0; e < CPT; ++e) gg[e] = rp > 0 ? ra[e] : rbv[e];
#pragma unroll
      for (int it = 0; it < SUB - 1; ++it) {
        if (it == rp) {
#pragma unroll
          for (int e = 0; e < CPT; ++e) gg[e] = rbv[e];
        }
        int t, sc;
        pair(it, t, sc);
        float a0 = 0.f, a1 = 0.f;
#pragma unroll
        for (int m = 0; m < CPT; m += 4) {
          float kk[4];
          load4(kraw + sc * HD + c0 + m, kk);
          const float4 w4 =
              *reinterpret_cast<const float4*>(ws + sc * HD + c0 + m);
          a0 = fmaf(gg[m], kk[0], a0);
          a1 = fmaf(gg[m + 1], kk[1], a1);
          a0 = fmaf(gg[m + 2], kk[2], a0);
          a1 = fmaf(gg[m + 3], kk[3], a1);
          gg[m] *= w4.x, gg[m + 1] *= w4.y, gg[m + 2] *= w4.z,
          gg[m + 3] *= w4.w;
        }
        val[it] = a0 + a1;
      }
      // reduce-scatter over the CG lanes, CG sums at a time: at each stage
      // a lane keeps half of its sums (the upper half where its lane bit is
      // set) and adds its partner's copy of that half; lane cg ends with
      // sum base + cg (CG - 1 shuffles, not CG log2 CG)
#pragma unroll
      for (int base = 0; base < SUB; base += CG) {
#pragma unroll
        for (int st = 1; st <= G::CGLOG; ++st) {
          const int half = CG >> st;
          const bool up = cg & half;
#pragma unroll
          for (int i = 0; i < CG / 2; ++i) {  // a constant trip count
            if (i >= half) continue;
            const float lo = val[base + i], hi = val[base + i + half];
            val[base + i] = (up ? hi : lo) +
                            __shfl_xor_sync(0xffffffffu, up ? lo : hi, half);
          }
        }
        const float sum = val[base];
        int t, sc;
        pair(base + cg, t, sc);
        split1(sum, ph + t * LDP + sc - j * SUB, pl + t * LDP + sc - j * SUB);
      }
#pragma unroll
      for (int off = 1; off < CG; off <<= 1)
        val[SUB] += __shfl_xor_sync(0xffffffffu, val[SUB], off);
      if (cg == 0)
        split1(val[SUB], ph + tb * LDP + tb - j * SUB,
               pl + tb * LDP + tb - j * SUB);
    }
    __syncthreads();  // (A) done: the raw tiles are free, P and the decays set
    if (n + 1 < nch) stage(n + 1);

    // (B) the sub-chunks in order
    const bf16* vc = vs + (n & 1) * CH * LDV;
    for (int i = 0; i < NSUB; ++i) {
      const int t0 = n * CH + i * SUB;
      if (t0 >= p.S) break;  // block-uniform
      const int step = n * NSUB + i;
      const bf16* sh = ss + (step & 1) * G::SBUF;  // the state before t0
      const bf16* sl = sh + HD * LDV;
      bf16* nh = ss + ((step + 1) & 1) * G::SBUF;  // the state after
      bf16* nl = nh + HD * LDV;

      // o = x . S (hi/lo) + P . v on 16 tokens x this warp's 8 columns, in
      // three accumulators (shorter chains of dependent mma)
      float oc[4] = {0.f, 0.f, 0.f, 0.f}, od[4] = {0.f, 0.f, 0.f, 0.f},
            oe[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t ah[4], al[4], bh[2], bl[2];
        ldsm_x4(ah, xh + (i * SUB + lrow) * LDX + kk * 16 + lcol);
        ldsm_x4(al, xl + (i * SUB + lrow) * LDX + kk * 16 + lcol);
        ldsm_x2_t(bh, sh + (kk * 16 + lrow) * LDV + oc0);
        ldsm_x2_t(bl, sl + (kk * 16 + lrow) * LDV + oc0);
        mma(oc, ah, bh[0], bh[1]);
        mma(od, ah, bl[0], bl[1]);
        mma(oe, al, bh[0], bh[1]);
      }
      {
        uint32_t pa[4], pb[4], vf[2];
        ldsm_x4(pa, ph + (i * SUB + lrow) * LDP + lcol);
        ldsm_x4(pb, pl + (i * SUB + lrow) * LDP + lcol);
        ldsm_x2_t(vf, vc + (i * SUB + lrow) * LDV + oc0);
        mma(oc, pa, vf[0], vf[1]);
        mma(od, pb, vf[0], vf[1]);
      }
      const int col = oc0 + 2 * q;
      if (t0 + g < p.S)
        *reinterpret_cast<__nv_bfloat162*>(ob + (t0 + g) * HD + col) =
            __floats2bfloat162_rn(oc[0] + od[0] + oe[0],
                                  oc[1] + od[1] + oe[1]);
      if (t0 + g + 8 < p.S)
        *reinterpret_cast<__nv_bfloat162*>(ob + (t0 + g + 8) * HD + col) =
            __floats2bfloat162_rn(oc[2] + od[2] + oe[2],
                                  oc[3] + od[3] + oe[3]);

      // the state: S = diag(W) S + k~^T v on this warp's tiles, then its
      // hi/lo copy for the next sub-chunk
#pragma unroll
      for (int mt = 0; mt < G::WM; ++mt) {
        const int m0 = (wm * G::WM + mt) * 16;
        const float w0 = wsum[i * HD + m0 + g], w1 = wsum[i * HD + m0 + g + 8];
        // A = k~^T from [token][channel] rows: trans, matrices (m 0-7, k
        // 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15)
        const int krow = i * SUB + (lane & 7) + (lane >> 4) * 8;
        const int kcol = m0 + ((lane >> 3) & 1) * 8;
        uint32_t ka[4], kb2[4], vf[G::WN / 2][4];
        ldsm_x4_t(ka, kh + krow * LDX + kcol);
        ldsm_x4_t(kb2, kl + krow * LDX + kcol);
#pragma unroll
        for (int np = 0; np < G::WN / 2; ++np)
          ldsm_x4_t(vf[np], vc + (i * SUB + lrow) * LDV +
                                (wn * G::WN + 2 * np) * 8 + lcol);
#pragma unroll
        for (int nt = 0; nt < G::WN; ++nt) {
          float* a = acc[mt][nt];
          a[0] *= w0, a[1] *= w0, a[2] *= w1, a[3] *= w1;
          mma(acc[mt][nt], ka, vf[nt / 2][2 * (nt & 1)],
              vf[nt / 2][2 * (nt & 1) + 1]);
        }
#pragma unroll
        for (int nt = 0; nt < G::WN; ++nt)
          mma(acc[mt][nt], kb2, vf[nt / 2][2 * (nt & 1)],
              vf[nt / 2][2 * (nt & 1) + 1]);
#pragma unroll
        for (int nt = 0; nt < G::WN; ++nt) {
          const int scol = (wn * G::WN + nt) * 8 + 2 * q;
          uint32_t hi, lo;
          split2(acc[mt][nt][0], acc[mt][nt][1], hi, lo);
          *reinterpret_cast<uint32_t*>(nh + (m0 + g) * LDV + scol) = hi;
          *reinterpret_cast<uint32_t*>(nl + (m0 + g) * LDV + scol) = lo;
          split2(acc[mt][nt][2], acc[mt][nt][3], hi, lo);
          *reinterpret_cast<uint32_t*>(nh + (m0 + g + 8) * LDV + scol) = hi;
          *reinterpret_cast<uint32_t*>(nl + (m0 + g + 8) * LDV + scol) = lo;
        }
      }
      if (i + 1 < NSUB) __syncthreads();  // the next sub-chunk reads nh
    }
  }

  float* sb = sfin + ((long long)b * p.H + h) * HD * HD + cs * DV;
#pragma unroll
  for (int mt = 0; mt < G::WM; ++mt)
#pragma unroll
    for (int nt = 0; nt < G::WN; ++nt) {
      const int row = (wm * G::WM + mt) * 16 + g;
      const int col = (wn * G::WN + nt) * 8 + 2 * q;
      *reinterpret_cast<float2*>(sb + row * HD + col) =
          make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(sb + (row + 8) * HD + col) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
}

// DV value columns a block, W = DV / 8 warps
template <int HD, int DV>
int launch_mma(const void* r, const void* k, const void* v, const float* logw,
               const float* u, void* o, float* sfin, int B, const Params& p,
               int smem_passed, cudaStream_t stream) {
  constexpr int W = DV / 8;
  auto kern = wkv_kernel_mma<HD, DV, W>;
  constexpr int smem = Geo<HD, DV, W>::BYTES;
  if (smem_passed != smem) return (int)cudaErrorInvalidValue;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  kern<<<dim3(HD / DV, p.H, B), W * 32, smem, stream>>>(
      static_cast<const bf16*>(r), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), logw, u, static_cast<bf16*>(o), sfin, p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, token by token

constexpr int SPLIT = 4;            // lanes sharing one column of S
constexpr int COLS = 32 / SPLIT;    // columns of S per warp

template <int HD>
__global__ void __launch_bounds__(HD * SPLIT)
wkv_kernel_f32(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ logw,
               const float* __restrict__ u, float* __restrict__ o,
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
  const float* rb = r + b * p.r_sb + h * p.r_sh;
  const float* kb = k + b * p.k_sb + h * p.k_sh;
  const float* vb = v + b * p.v_sb + h * p.v_sh;
  const float* wb = logw + b * p.w_sb + h * p.w_sh;
  float* ob = o + ((long long)b * p.H + h) * p.S * HD + j;
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
      rs[idx] = rb[tt * p.r_ss + c];
      ks[idx] = kb[tt * p.k_ss + c];
      vs[idx] = vb[tt * p.v_ss + c];
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
        ob[(long long)(t0 + t) * HD] = a + bonus[t] * vj;
    }
  }

  float* sb = sfin + ((long long)b * p.H + h) * HD * HD + q * CQ * HD + j;
#pragma unroll
  for (int c = 0; c < CQ; ++c) sb[c * HD] = st[c];
}


// dynamic shared memory of the f32 kernel for a tile of ch tokens (the
// wrapper's smem_bytes)
size_t smem_bytes_f32(int ch, int hd) {
  return sizeof(float) * (4 * (size_t)ch * hd + hd + ch);
}

template <int HD>
int launch_f32(const void* r, const void* k, const void* v, const float* logw,
               const float* u, void* o, float* sfin, int B, const Params& p,
               int smem_passed, cudaStream_t stream) {
  auto kern = wkv_kernel_f32<HD>;
  const size_t smem = smem_bytes_f32(p.ch, HD);
  if ((size_t)smem_passed != smem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(p.H, B), HD * SPLIT, smem, stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), logw, u, static_cast<float*>(o), sfin, p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype of r/k/v/o: 0 = float32, 1 = bfloat16; logw, u and S_fin are f32.
// Strides are in elements; hd is contiguous. ch is the f32 kernel's staging
// tile; the bf16 kernel takes min(hd, 64) value columns a block. smem is the
// dynamic shared memory the wrapper computed for the kernel it expects
// (smem_bytes or mma_smem_bytes); one that is not the kernel's own returns
// cudaErrorInvalidValue. Returns a cudaError_t (0 on success), launch
// errors included.
extern "C" int rwkv6_wkv_launch(
    const void* r, const void* k, const void* v, const void* logw,
    const void* u, void* o, void* sfin, int dtype, int B, int H, int S,
    int hd, int ch, long long r_sb, long long r_sh,
    long long r_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long w_sb,
    long long w_sh, long long w_ss, int smem, void* stream) {
  if (B < 0 || H <= 0 || S < 0 || ch <= 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Params p{H, S, ch, r_sb, r_sh, r_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
           w_sb, w_sh, w_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lw = static_cast<const float*>(logw);
  const float* uu = static_cast<const float*>(u);
  float* sf = static_cast<float*>(sfin);
  if (dtype == 0) {
    switch (hd) {
      case 32:
        return launch_f32<32>(r, k, v, lw, uu, o, sf, B, p, smem, s);
      case 64:
        return launch_f32<64>(r, k, v, lw, uu, o, sf, B, p, smem, s);
      case 128:
        return launch_f32<128>(r, k, v, lw, uu, o, sf, B, p, smem, s);
    }
  } else if (dtype == 1) {
    switch (hd) {
      case 32:
        return launch_mma<32, 32>(r, k, v, lw, uu, o, sf, B, p, smem, s);
      case 64:
        return launch_mma<64, 64>(r, k, v, lw, uu, o, sf, B, p, smem, s);
      case 128:
        return launch_mma<128, 64>(r, k, v, lw, uu, o, sf, B, p, smem, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}
