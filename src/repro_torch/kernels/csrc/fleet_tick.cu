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
// ~5 us at 3.35 TB/s; its ~1k
// compare/arithmetic ops per (tick, cluster) are ~0.7 us at 67 TFLOP/s f32,
// so memory bounds it.
//
// Design (simple first): one thread per cluster. The (T, N) and (T, S, N)
// operands are contiguous in N, so a warp reads 32 neighbouring clusters'
// values as one coalesced transaction, the way clusters sat on the TPU's
// 128-wide lane axis. The tick loop runs in registers. Each thread keeps its
// K-entry top-K head and its S lanes in a private column of dynamic shared
// memory (slot i of thread t at smem[i * blockDim + t], so a warp touches 32
// consecutive words: no bank conflicts):
//   slots [0, K)      ascending streaming head
//   slots [K, K + S)  this tick's lanes, bitonic-sorted DESCENDING
//   scratch [S/2]     the pairwise lane sum
// With the lanes descending, head ++ lanes is a bitonic sequence, so one
// bitonic merge (no full sort) re-sorts it and the top K land in slots
// [S, K + S); they are shifted back to [0, K) for the next tick. Sorting and
// merging are exact (min/max only), so the statistics are bit-for-bit the
// reference's on equal inputs; the lane sum keeps the reference's
// adjacent-pair order. Build with -fmad=false: the plain torch version is
// the yardstick of these numbers and contracts no multiply-add.
//
// Only N/blockDim blocks run (8 at N=1024), each thread doing ~23k serial
// compare-exchanges per window: far from the bound. A warp-per-cluster
// layout with a shared-memory transpose of the lane tile is the next step.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// coefficient rows of `consts`, in pack_tick_consts' order; C_USED rows are
// read (the array may be padded beyond them)
enum { C_TB, C_MAXB, C_ACOMP, C_CCOLL, C_BMEM, C_KVP, C_OVH, C_SLOWCAP,
       C_BACKUP, C_FAIL, C_INFLIGHT, C_USED };

constexpr float TOKENS_PER_MB = 16.0f;

__global__ void fleet_tick_window_kernel(
    const float* __restrict__ state, const float* __restrict__ consts,
    const float* __restrict__ rate, const float* __restrict__ size,
    const float* __restrict__ z, const float* __restrict__ u_strag,
    const float* __restrict__ u_raw, const float* __restrict__ u_fail,
    const float* __restrict__ active, const float* __restrict__ wmask,
    const float* __restrict__ fmult, const float* __restrict__ u_wait,
    const float* __restrict__ z2a, float* __restrict__ state_out,
    float* __restrict__ ys, float* __restrict__ stats,
    float* __restrict__ head, int N, int T, int S, int K, float noise,
    float retention_s, float straggler_prob, float slo, float slo_span) {
  extern __shared__ float smem[];
  const int B = blockDim.x;
  const int n = blockIdx.x * B + threadIdx.x;
  if (n >= N) return;  // no block-wide barrier below, so this is safe
  const int P = K + S;
  float* slot = smem + threadIdx.x;          // slot(i) = slot[i * B]
  float* acc = smem + (size_t)P * B + threadIdx.x;

  const float T_b = consts[C_TB * N + n];
  const float max_b = consts[C_MAXB * N + n];
  const float a_comp = consts[C_ACOMP * N + n];
  const float c_coll = consts[C_CCOLL * N + n];
  const float b_mem = consts[C_BMEM * N + n];
  const float kvp = consts[C_KVP * N + n];
  const float ovh = consts[C_OVH * N + n];
  const float slow_cap = consts[C_SLOWCAP * N + n];
  const float backup = consts[C_BACKUP * N + n];
  const float fail_frac = consts[C_FAIL * N + n];
  const float inflight = consts[C_INFLIGHT * N + n];

  float backlog = state[n];
  float sfree = state[N + n];
  for (int i = 0; i < K; ++i) slot[i * B] = -INFINITY;

  const float q50 = (float)0.50, q95 = (float)0.95, q99 = (float)0.99;

  for (int t = 0; t < T; ++t) {
    const size_t tn = (size_t)t * N + n;
    const float r = rate[tn];
    // ---- the queueing recurrence (reference `_tick_step`) ----
    const float arrivals = r * T_b * (1.0f + noise * z[tn]);
    const float age = backlog / fmaxf(r, 1.0f);
    float blg = backlog + fmaxf(arrivals, 0.0f);
    blg = fminf(blg, r * retention_s);                 // Kafka retention
    const float batch = fminf(blg, max_b);
    const float tokens = batch * size[tn] * TOKENS_PER_MB;
    const float mem_frac = fminf(tokens * b_mem + kvp, 1.5f);
    const float pen = 1.0f + 2.0f * fmaxf(mem_frac - 1.0f, 0.0f);
    float service = ovh + tokens * a_comp * pen + tokens * c_coll;
    const bool smask = u_strag[tn] < straggler_prob;
    const float raw = slo + slo_span * u_raw[tn];
    float slow = smask ? (backup != 0.0f ? 1.1f : fminf(raw, slow_cap)) : 1.0f;
    const bool fmask = u_fail[tn] < fail_frac;
    slow = fmask ? slow * 2.0f : slow;
    slow = slow * (fmult != nullptr ? fmult[tn] : 1.0f);
    service = service * slow;
    const float start_rel = fmaxf(T_b, sfree);
    const float sfree_new = fminf(start_rel + service, T_b + inflight) - T_b;
    const float processed = service <= T_b ? batch : batch * (T_b / service);
    const float blg_after = fmaxf(blg - processed, 0.0f);
    const float qd = (start_rel - T_b) + age;
    const bool act = active[tn] != 0.0f;
    if (act) {
      backlog = blg_after;
      sfree = sfree_new;
    }
    const size_t TN = (size_t)T * N;
    ys[0 * TN + tn] = service;
    ys[1 * TN + tn] = qd;
    ys[2 * TN + tn] = batch;
    ys[3 * TN + tn] = act ? processed : 0.0f;
    ys[4 * TN + tn] = smask ? 1.0f : 0.0f;
    ys[5 * TN + tn] = fmask ? 1.0f : 0.0f;
    ys[6 * TN + tn] = blg_after;

    // ---- latency lanes (reference `_lane_stats`) ----
    const int n_s = batch >= (float)S ? S : max((int)batch, 1);
    const bool win = (wmask != nullptr ? wmask[tn] : active[tn]) > 0.0f;
    for (int s = 0; s < S; ++s) {
      const size_t i = ((size_t)t * S + s) * N + n;
      const float lat = u_wait[i] * T_b + qd + service * (1.0f + 0.1f * z2a[i]);
      slot[(K + s) * B] = (s < n_s && win) ? lat : -INFINITY;
    }
    // pairwise lane sum in the reference's adjacent-pair order
    float lane_sum;
    if (S == 1) {
      lane_sum = (n_s > 0 && win) ? slot[K * B] : 0.0f;
    } else {
      for (int i = 0; i < S / 2; ++i) {
        const bool va = win && 2 * i < n_s, vb = win && 2 * i + 1 < n_s;
        acc[i * B] = (va ? slot[(K + 2 * i) * B] : 0.0f)
                     + (vb ? slot[(K + 2 * i + 1) * B] : 0.0f);
      }
      for (int L = S / 2; L > 1; L >>= 1)
        for (int i = 0; i < L / 2; ++i)
          acc[i * B] = acc[2 * i * B] + acc[(2 * i + 1) * B];
      lane_sum = acc[0];
    }
    // bitonic sort of the S lanes, descending
    for (int k = 2; k <= S; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = 0; i < S; ++i) {
          const int l = i ^ j;
          if (l <= i) continue;
          const float a = slot[(K + i) * B], b = slot[(K + l) * B];
          const bool desc = (i & k) == 0;
          slot[(K + i) * B] = desc ? fmaxf(a, b) : fminf(a, b);
          slot[(K + l) * B] = desc ? fminf(a, b) : fmaxf(a, b);
        }
      }
    }
    // quantiles: ascending rank r of a valid lane is descending slot
    // K + n_s - 1 - r (invalid lanes sort to the end as -inf)
    const float posm = (float)(n_s - 1);
    const float qs[3] = {q50, q95, q99};
    float qv[3];
    for (int qi = 0; qi < 3; ++qi) {
      const float pos = posm * qs[qi];
      const int lo = (int)floorf(pos), hi = (int)ceilf(pos);
      const float a = slot[(K + n_s - 1 - lo) * B];
      const float b = slot[(K + n_s - 1 - hi) * B];
      qv[qi] = a + (pos - (float)lo) * (b - a);
    }
    stats[0 * TN + tn] = lane_sum;
    stats[1 * TN + tn] = qv[0];
    stats[2 * TN + tn] = qv[1];
    stats[3 * TN + tn] = qv[2];
    stats[4 * TN + tn] = slot[K * B];                  // the lane maximum
    // streaming top-K: bitonic merge of head (asc) ++ lanes (desc)
    for (int j = P >> 1; j > 0; j >>= 1) {
      for (int i = 0; i < P; ++i) {
        if (i & j) continue;
        const float a = slot[i * B], b = slot[(i + j) * B];
        slot[i * B] = fminf(a, b);
        slot[(i + j) * B] = fmaxf(a, b);
      }
    }
    for (int i = 0; i < K; ++i) slot[i * B] = slot[(i + S) * B];
  }
  state_out[n] = backlog;
  state_out[N + n] = sfree;
  for (int i = 0; i < K; ++i) head[(size_t)i * N + n] = slot[i * B];
}

bool pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

}  // namespace

// The number of coefficient rows the kernel reads; the Python wrapper checks
// it against its own CONSTS_USED when it loads the library.
extern "C" int fleet_tick_consts_used() { return C_USED; }

extern "C" int fleet_tick_window_launch(
    const float* state, const float* consts, const float* rate,
    const float* size, const float* z, const float* u_strag,
    const float* u_raw, const float* u_fail, const float* active,
    const float* wmask, const float* fmult, const float* u_wait,
    const float* z2a, float* state_out, float* ys, float* stats, float* head,
    int N, int T, int S, int K, float noise, float retention_s,
    float straggler_prob, float slo, float slo_span, void* stream) {
  if (N < 0 || T < 1 || K < 1 || !pow2(S) || !pow2(K + S))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const size_t per_thread = (size_t)(K + S + (S > 1 ? S / 2 : 1)) * sizeof(float);
  int threads = 128;
  while (threads > 32 && per_thread * threads > 48 * 1024) threads >>= 1;
  const size_t smem = per_thread * threads;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fleet_tick_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (N + threads - 1) / threads;
  fleet_tick_window_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      state, consts, rate, size, z, u_strag, u_raw, u_fail, active, wmask,
      fmult, u_wait, z2a, state_out, ys, stats, head, N, T, S, K, noise,
      retention_s, straggler_prob, slo, slo_span);
  return (int)cudaGetLastError();
}
