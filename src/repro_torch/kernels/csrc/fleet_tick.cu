// Fused fleet-tick observation window: the T-tick queueing recurrence of N
// simulated clusters plus the per-tick latency-lane statistics, one launch
// per window.
//
// Replaces the TPU kernel `repro.kernels.fleet_tick.fleet_tick_window`
// (pl.pallas_call of `_tick_window_kernel`): same inputs, same outputs, same
// (rows, T, N) layouts, same arithmetic. The random draws stay inputs.
//
// Bound on an H100 (N=1024, T=48, S=32, K=32): one launch moves
// 4*N*(15 + 21*T + 2*T*S + K) bytes ~ 16.9 MB (state in and out, the C_USED
// coefficient rows it reads, the (T, N) and (T, S, N) inputs, the outputs),
// ~5 us at 3.35 TB/s; its ~1k compare/arithmetic ops per (tick, cluster)
// are ~0.8 us at 67 TFLOP/s f32, so memory bounds it. What a launch cannot
// avoid is the chain of T dependent ticks per cluster.
//
// Design: the S latency lanes of a cluster across the lanes of a warp.
// - Geometry. A cluster takes L = min(S, 32) lanes (several clusters share a
//   warp when S < 32), each lane holding NS = S / L of the tick's lane
//   values; the head ++ lanes merge holds R = (K + S) / L values a lane. A
//   block takes a tile of CPB = 8 adjacent clusters (CPB L threads), so
//   N=1024 runs 128 blocks. The Python wrapper's `launch_geometry` computes
//   all of it; the launcher checks it against its own instantiations.
// - Staging. The (T, N) and (T, S, N) operands are contiguous in N: each
//   tick the block copies its tile (9 rows of 8 clusters, and 2 x S rows of
//   8 clusters: one 32-byte sector a row) into shared memory with 4-byte
//   cp.async, NST = 4 ticks ahead of the tick it computes, so the loads of
//   the T-tick chain overlap its compute. One barrier a tick.
// - The tick. The scalar queueing recurrence runs on every lane of the
//   cluster (the same values, no broadcast needed). The lane sum is an xor
//   shuffle tree with offsets 1, 2, 4, ..., exactly the reference `_sum0`'s
//   adjacent-pair tree (then register pairs for S = 64); the S lanes are
//   bitonic-sorted DESCENDING with __shfl_xor_sync stages (register pairs
//   for distances >= L); the quantiles are gathered with __shfl_sync; the
//   streaming top-K head (ascending, K values) ++ the sorted lanes is a
//   bitonic sequence, merged in registers across the warp, and its top K
//   values are the next head.
// - Long windows. Past R = 32 values a lane (K + S > 32 L: windows of
//   ~3300 ticks and more at S = 8) the head does not fit in registers. It
//   then lives in memory, two K-float buffers and the tick's S sorted lanes
//   per cluster, in shared memory or, when the tile's buffers do not fit
//   there, in a global workspace the wrapper allocates. The merge is by
//   rank: a head value's place in head ++ lanes is its index plus the lanes
//   below it (S compares against the lanes, held in every lane's
//   registers), a lane's is its index plus the head values at or below it
//   (a binary search), and each value whose place is S or more is written
//   to the other buffer at place - S; two __syncwarp a tick. Every (S, K)
//   the port makes launches.
// Sorting and merging are exact (min/max only), so the statistics are
// bit-for-bit the reference's on equal inputs; the lane sum keeps the
// reference's order. Build with -fmad=false: the plain torch version is the
// yardstick of these numbers and contracts no multiply-add.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// coefficient rows of `consts`, in pack_tick_consts' order; C_USED rows are
// read (the array may be padded beyond them)
enum { C_TB, C_MAXB, C_ACOMP, C_CCOLL, C_BMEM, C_KVP, C_OVH, C_SLOWCAP,
       C_BACKUP, C_FAIL, C_INFLIGHT, C_USED };
// the (T, N) operands, in the order they are staged; wmask and fmult may be
// absent (null)
enum { G_RATE, G_SIZE, G_Z, G_USTRAG, G_URAW, G_UFAIL, G_ACTIVE, G_WMASK,
       G_FMULT, NG };

constexpr float TOKENS_PER_MB = 16.0f;
constexpr int CPB = 8;   // clusters a block: one 32-byte sector of a row
constexpr int NST = 4;   // ticks staged at once
constexpr int HG = 8;    // head values a lane loads at once (R = 0)
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const float* grid[NG];
  const float* u_wait;
  const float* z2a;
  const float* state;
  const float* consts;
  float* state_out;
  float* ys;
  float* stats;
  float* head;
  float* head_ws;  // the heads when they live in global memory, else null
  int N, T;
  float noise, retention_s, straggler_prob, slo, slo_span;
};

// floats of one staged tick: the grids, then u_wait and z2a as [S][CPB + 1]
// (the padding column spreads a cluster's lanes over the banks)
__host__ __device__ constexpr int stage_floats(int S) {
  return NG * CPB + 2 * S * (CPB + 1);
}

// floats of one cluster's head in memory (R = 0), for P = K + S: head
// buffer 0 at [0, K), the sorted lanes at [K, P), head buffer 1 at [P,
// P + K); in shared memory L floats of padding put the clusters of one warp
// on different banks
__host__ __device__ constexpr int head_floats(int P, int L) {
  return 2 * P + L;
}

// values of a[0, n) (ascending) at or below x, by binary search; m is a
// power of two at least n
__device__ __forceinline__ int count_at_or_below(const float* a, int n, int m,
                                                 float x) {
  int pos = 0;
  for (int step = m >> 1; step > 0; step >>= 1)
    if (pos + step - 1 < n && a[pos + step - 1] <= x) pos += step;
  if (pos < n && a[pos] <= x) ++pos;
  return pos;
}

// 4 bytes global -> shared; pred false writes zero and reads nothing
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool pred) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// R > 0: the head ++ lanes merge in R registers a lane (K + S = R L);
// R = 0: the head in memory, merged by rank (see the header), P = K + S
template <int L, int NS, int R>
__global__ void __launch_bounds__(CPB * L)
fleet_tick_warp_kernel(Args a, int P) {
  constexpr int S = NS * L;
  constexpr int KR = R > 0 ? R - NS : 0;  // K = KR L head values in registers
  constexpr int RV = R > 0 ? R : NS;      // values a lane holds
  constexpr int CPW = 32 / L;       // clusters a warp
  constexpr int LDL = CPB + 1;      // a staged lane row
  constexpr int STAGE = stage_floats(S);
  constexpr int THREADS = CPB * L;
  static_assert(NS >= 1 && (R == 0 || KR >= 1) && (L & (L - 1)) == 0 &&
                L <= 32, "");
  extern __shared__ float smem[];

  const int tid = threadIdx.x, lane = tid & 31;
  const int l = lane & (L - 1);     // this lane's place in its cluster
  const int base = lane - l;        // the cluster's first lane
  const int c = (tid >> 5) * CPW + lane / L;  // cluster in the tile
  const int N = a.N, T = a.T;
  const int n0 = blockIdx.x * CPB, n = n0 + c;
  const bool live = n < N;

  // this thread's copies of the grid rows each tick: item i = grid i / CPB,
  // cluster i % CPB (the pointer chosen once, by constant indices)
  constexpr int GI = (NG * CPB + THREADS - 1) / THREADS;
  const float* gsrc[GI];
#pragma unroll
  for (int m = 0; m < GI; ++m) {
    gsrc[m] = nullptr;
#pragma unroll
    for (int g = 0; g < NG; ++g)
      if ((tid + m * THREADS) / CPB == g) gsrc[m] = a.grid[g];
  }
  auto stage = [&](int t) {
    float* st = smem + (t % NST) * STAGE;
#pragma unroll
    for (int m = 0; m < GI; ++m) {
      const int i = tid + m * THREADS, cc = i % CPB;
      const bool in = n0 + cc < N;
      if (gsrc[m] != nullptr)
        cp_async4(st + i, gsrc[m] + (in ? (size_t)t * N + n0 + cc : 0), in);
    }
    for (int i = tid; i < 2 * S * CPB; i += THREADS) {
      const int w = i / (S * CPB), s = (i / CPB) % S, cc = i % CPB;
      const bool in = n0 + cc < N;
      cp_async4(st + NG * CPB + (w * S + s) * LDL + cc,
                (w ? a.z2a : a.u_wait) +
                    (in ? ((size_t)t * S + s) * N + n0 + cc : 0),
                in);
    }
  };
#pragma unroll
  for (int t = 0; t < NST - 1; ++t) {
    if (t < T) stage(t);
    cp_async_commit();  // one group a tick, empty past T
  }

  float cv[C_USED];
#pragma unroll
  for (int i = 0; i < C_USED; ++i) cv[i] = live ? a.consts[i * N + n] : 0.f;
  const float T_b = cv[C_TB], max_b = cv[C_MAXB], a_comp = cv[C_ACOMP],
              c_coll = cv[C_CCOLL], b_mem = cv[C_BMEM], kvp = cv[C_KVP],
              ovh = cv[C_OVH], slow_cap = cv[C_SLOWCAP],
              backup = cv[C_BACKUP], fail_frac = cv[C_FAIL],
              inflight = cv[C_INFLIGHT];
  float backlog = live ? a.state[n] : 0.f;
  float sfree = live ? a.state[N + n] : 0.f;
  const bool has_wmask = a.grid[G_WMASK] != nullptr;
  const bool has_fmult = a.grid[G_FMULT] != nullptr;
  const float noise = a.noise, retention_s = a.retention_s;
  const float straggler_prob = a.straggler_prob, slo = a.slo,
              slo_span = a.slo_span;
  const size_t TN = (size_t)T * N;

  // v[0, KR): the head, element r L + l ascending; v[KR, RV): this tick's
  // lanes, element K + rr L + l
  float v[RV];
#pragma unroll
  for (int r = 0; r < KR; ++r) v[r] = -INFINITY;
  // R = 0: this cluster's head (ascending) in `cur`, the next one built in
  // `nxt`, the tick's lanes ascending in `lb`
  const int K = P - S;
  float *cur = nullptr, *nxt = nullptr, *lb = nullptr;
  if (R == 0) {
    cur = a.head_ws != nullptr
              ? a.head_ws + (size_t)(blockIdx.x * CPB + c) * 2 * P
              : smem + NST * STAGE + c * head_floats(P, L);
    lb = cur + K;
    nxt = cur + P;
    for (int e = l; e < K; e += L) cur[e] = -INFINITY;
  }

  const float q50 = (float)0.50, q95 = (float)0.95, q99 = (float)0.99;

  for (int t = 0; t < T; ++t) {
    cp_async_wait<NST - 2>();
    __syncthreads();  // tick t is staged; tick t - 1's stage is free
    if (t + NST - 1 < T) stage(t + NST - 1);
    cp_async_commit();
    const float* st = smem + (t % NST) * STAGE;
    const size_t tn = (size_t)t * N + n;

    // ---- the queueing recurrence (reference `_tick_step`) ----
    const float rate = st[G_RATE * CPB + c];
    const float arrivals = rate * T_b * (1.0f + noise * st[G_Z * CPB + c]);
    const float age = backlog / fmaxf(rate, 1.0f);
    float blg = backlog + fmaxf(arrivals, 0.0f);
    blg = fminf(blg, rate * retention_s);              // Kafka retention
    const float batch = fminf(blg, max_b);
    const float tokens = batch * st[G_SIZE * CPB + c] * TOKENS_PER_MB;
    const float mem_frac = fminf(tokens * b_mem + kvp, 1.5f);
    const float pen = 1.0f + 2.0f * fmaxf(mem_frac - 1.0f, 0.0f);
    float service = ovh + tokens * a_comp * pen + tokens * c_coll;
    const bool smask = st[G_USTRAG * CPB + c] < straggler_prob;
    const float raw = slo + slo_span * st[G_URAW * CPB + c];
    float slow = smask ? (backup != 0.0f ? 1.1f : fminf(raw, slow_cap)) : 1.0f;
    const bool fmask = st[G_UFAIL * CPB + c] < fail_frac;
    slow = fmask ? slow * 2.0f : slow;
    slow = slow * (has_fmult ? st[G_FMULT * CPB + c] : 1.0f);
    service = service * slow;
    const float start_rel = fmaxf(T_b, sfree);
    const float sfree_new = fminf(start_rel + service, T_b + inflight) - T_b;
    const float processed = service <= T_b ? batch : batch * (T_b / service);
    const float blg_after = fmaxf(blg - processed, 0.0f);
    const float qd = (start_rel - T_b) + age;
    const float active = st[G_ACTIVE * CPB + c];
    const bool act = active != 0.0f;
    if (act) {
      backlog = blg_after;
      sfree = sfree_new;
    }
    if (live && l == 0) {
      a.ys[0 * TN + tn] = service;
      a.ys[1 * TN + tn] = qd;
      a.ys[2 * TN + tn] = batch;
      a.ys[3 * TN + tn] = act ? processed : 0.0f;
      a.ys[4 * TN + tn] = smask ? 1.0f : 0.0f;
      a.ys[5 * TN + tn] = fmask ? 1.0f : 0.0f;
      a.ys[6 * TN + tn] = blg_after;
    }

    // ---- latency lanes (reference `_lane_stats`) ----
    const int n_s = batch >= (float)S ? S : max((int)batch, 1);
    const bool win = (has_wmask ? st[G_WMASK * CPB + c] : active) > 0.0f;
    float part[NS];
#pragma unroll
    for (int rr = 0; rr < NS; ++rr) {
      const int s = rr * L + l;
      const float uw = st[NG * CPB + s * LDL + c];
      const float z2 = st[NG * CPB + (S + s) * LDL + c];
      const float lat = uw * T_b + qd + service * (1.0f + 0.1f * z2);
      const bool valid = s < n_s && win;
      v[KR + rr] = valid ? lat : -INFINITY;
      part[rr] = valid ? lat : 0.0f;
    }
    // the pairwise lane sum: xor offsets 1, 2, ..., L/2 are the reference's
    // adjacent-pair levels over lane s = rr L + l; then register pairs
#pragma unroll
    for (int off = 1; off < L; off <<= 1)
#pragma unroll
      for (int rr = 0; rr < NS; ++rr)
        part[rr] += __shfl_xor_sync(FULL, part[rr], off);
#pragma unroll
    for (int w = 1; w < NS; w <<= 1)
#pragma unroll
      for (int rr = 0; rr < NS; rr += 2 * w) part[rr] = part[rr] + part[rr + w];
    const float lane_sum = part[0];

    // bitonic sort of the S lanes, descending: element e = rr L + l; the
    // lower element of a pair keeps the max where (e & k) == 0
#pragma unroll
    for (int k = 2; k <= S; k <<= 1) {
#pragma unroll
      for (int j = k >> 1; j > 0; j >>= 1) {
        if (j >= L) {
#pragma unroll
          for (int rr = 0; rr < NS; ++rr) {
            if (rr & (j / L)) continue;
            const bool desc = ((rr * L + l) & k) == 0;
            const float x = v[KR + rr], y = v[KR + rr + j / L];
            v[KR + rr] = desc ? fmaxf(x, y) : fminf(x, y);
            v[KR + rr + j / L] = desc ? fminf(x, y) : fmaxf(x, y);
          }
        } else {
#pragma unroll
          for (int rr = 0; rr < NS; ++rr) {
            const float y = __shfl_xor_sync(FULL, v[KR + rr], j);
            const bool desc = ((rr * L + l) & k) == 0;
            const bool lower = (l & j) == 0;
            v[KR + rr] = lower == desc ? fmaxf(v[KR + rr], y)
                                       : fminf(v[KR + rr], y);
          }
        }
      }
    }
    // quantiles: ascending rank rk of a valid lane is descending element
    // n_s - 1 - rk (invalid lanes sort to the end as -inf)
    auto gather = [&](int d) {
      float x = 0.f;
#pragma unroll
      for (int rr = 0; rr < NS; ++rr) {
        const float y = __shfl_sync(FULL, v[KR + rr], base + (d & (L - 1)));
        if (d / L == rr) x = y;
      }
      return x;
    };
    const float posm = (float)(n_s - 1);
    const float qs[3] = {q50, q95, q99};
    float qv[3];
#pragma unroll
    for (int qi = 0; qi < 3; ++qi) {
      const float pos = posm * qs[qi];
      const int lo = (int)floorf(pos), hi = (int)ceilf(pos);
      const float x = gather(n_s - 1 - lo);
      const float y = gather(n_s - 1 - hi);
      qv[qi] = x + (pos - (float)lo) * (y - x);
    }
    const float lane_max = __shfl_sync(FULL, v[KR], base);
    if (live && l == 0) {
      a.stats[0 * TN + tn] = lane_sum;
      a.stats[1 * TN + tn] = qv[0];
      a.stats[2 * TN + tn] = qv[1];
      a.stats[3 * TN + tn] = qv[2];
      a.stats[4 * TN + tn] = lane_max;
    }

    // streaming top-K: bitonic merge of head (ascending) ++ lanes
    // (descending) over element e = r L + l, then the top K (elements
    // S .. K + S - 1, registers NS .. R - 1) become the head
    if (R == 0) {
      // by rank: head value i goes to i + (lanes below it), lane j (its
      // ascending index) to j + (head values at or below it), so equal
      // values keep the head's first; places 0 .. S - 1 drop out
#pragma unroll
      for (int rr = 0; rr < NS; ++rr) lb[S - 1 - (rr * L + l)] = v[rr];
      __syncwarp();  // the lanes are in; the last tick's head is complete
      float lv[S];   // every lane value, ascending, in registers
#pragma unroll
      for (int j = 0; j < S; ++j) lv[j] = lb[j];
      // HG head values loaded before any is stored, so that their loads
      // overlap (a store to nxt could alias a later load of cur)
      for (int i0 = l; i0 < K; i0 += HG * L) {
        float h[HG];
#pragma unroll
        for (int g = 0; g < HG; ++g)
          h[g] = i0 + g * L < K ? cur[i0 + g * L] : 0.0f;
#pragma unroll
        for (int g = 0; g < HG; ++g) {
          int below = 0;
#pragma unroll
          for (int j = 0; j < S; ++j) below += lv[j] < h[g] ? 1 : 0;
          const int i = i0 + g * L;
          if (i < K && i + below >= S) nxt[i + below - S] = h[g];
        }
      }
#pragma unroll
      for (int rr = 0; rr < NS; ++rr) {
        const int at = S - 1 - (rr * L + l) +
                       count_at_or_below(cur, K, P, v[rr]) - S;
        if (at >= 0) nxt[at] = v[rr];
      }
      float* t = cur;
      cur = nxt;
      nxt = t;
      __syncwarp();  // every read of this tick's lanes and head is done
      continue;
    }
#pragma unroll
    for (int j = (RV * L) >> 1; j > 0; j >>= 1) {
      if (j >= L) {
#pragma unroll
        for (int r = 0; r < RV; ++r) {
          if (r & (j / L)) continue;
          const float x = v[r], y = v[r + j / L];
          v[r] = fminf(x, y);
          v[r + j / L] = fmaxf(x, y);
        }
      } else {
#pragma unroll
        for (int r = 0; r < RV; ++r) {
          const float y = __shfl_xor_sync(FULL, v[r], j);
          v[r] = (l & j) == 0 ? fminf(v[r], y) : fmaxf(v[r], y);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < KR; ++r) v[r] = v[NS + r];
  }
  cp_async_wait<0>();  // no copy outlives the block

  if (live) {
    if (l == 0) {
      a.state_out[n] = backlog;
      a.state_out[N + n] = sfree;
    }
#pragma unroll
    for (int r = 0; r < KR; ++r) a.head[(size_t)(r * L + l) * N + n] = v[r];
    if (R == 0)
      for (int e = l; e < K; e += L) a.head[(size_t)e * N + n] = cur[e];
  }
}

// R > 0: the register merge; R = 0: the head in memory (head_floats), in
// shared memory unless head_ws is set. The shared memory must be the
// kernel's own.
template <int L, int NS, int R>
int launch(const Args& a, int P, int blocks, int smem, cudaStream_t stream) {
  auto kern = fleet_tick_warp_kernel<L, NS, R>;
  int want = NST * stage_floats(NS * L) * (int)sizeof(float);
  if (R == 0 && a.head_ws == nullptr)
    want += CPB * head_floats(P, L) * (int)sizeof(float);
  if (smem != want) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<blocks, CPB * L, smem, stream>>>(a, P);
  return (int)cudaGetLastError();
}

// r merge values a lane: up to MAX_R in registers, past it the head in
// memory
constexpr int MAX_R = 32;
template <int L, int NS>
int launch_r(const Args& a, int r, int blocks, int smem, cudaStream_t s) {
  switch (r) {
    case 2:  // K >= 1 takes R > NS
      if constexpr (NS == 1)
        return launch<L, NS, 2>(a, 2 * L, blocks, smem, s);
      break;
    case 4: return launch<L, NS, 4>(a, 4 * L, blocks, smem, s);
    case 8: return launch<L, NS, 8>(a, 8 * L, blocks, smem, s);
    case 16: return launch<L, NS, 16>(a, 16 * L, blocks, smem, s);
    case 32: return launch<L, NS, 32>(a, 32 * L, blocks, smem, s);
    default:
      if (r > MAX_R) return launch<L, NS, 0>(a, r * L, blocks, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The number of coefficient rows the kernel reads; the Python wrapper checks
// it against its own CONSTS_USED when it loads the library.
extern "C" int fleet_tick_consts_used() { return C_USED; }

// The launch geometry comes from the wrapper's `launch_geometry`: L lanes a
// cluster, ns lane values and r merge values a lane (r > 32: the head in
// memory, in `head_ws` when that is not null), the blocks and the dynamic
// shared memory; a geometry the kernel is not instantiated for, or whose
// shared memory disagrees with the kernel's, returns cudaErrorInvalidValue.
extern "C" int fleet_tick_window_launch(
    const float* state, const float* consts, const float* rate,
    const float* size, const float* z, const float* u_strag,
    const float* u_raw, const float* u_fail, const float* active,
    const float* wmask, const float* fmult, const float* u_wait,
    const float* z2a, float* state_out, float* ys, float* stats, float* head,
    float* head_ws, int N, int T, int L, int ns, int r, int blocks, int smem,
    float noise, float retention_s, float straggler_prob, float slo,
    float slo_span, void* stream) {
  if (N < 0 || T < 1 || blocks != (N + CPB - 1) / CPB || r < 2 ||
      (r & (r - 1)) != 0 || (r <= MAX_R && head_ws != nullptr))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  Args a{{rate, size, z, u_strag, u_raw, u_fail, active, wmask, fmult},
         u_wait, z2a, state, consts, state_out, ys, stats, head, head_ws,
         N, T, noise, retention_s, straggler_prob, slo, slo_span};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (L * 10 + ns) {
    case 81: return launch_r<8, 1>(a, r, blocks, smem, s);
    case 161: return launch_r<16, 1>(a, r, blocks, smem, s);
    case 321: return launch_r<32, 1>(a, r, blocks, smem, s);
    case 322: return launch_r<32, 2>(a, r, blocks, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}
