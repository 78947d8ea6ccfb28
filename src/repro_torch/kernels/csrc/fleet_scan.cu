// Lean tick scan: the T-tick queueing recurrence of N simulated clusters
// without latency lanes, one launch per window.
//
// Replaces the reference's lean scan body `_tick_body` under `lax.scan`
// (src/repro/engine/fleet_jax.py:194, scanned at :315 on the observe path
// and :1012 in the fused step), together with the state-independent (T, N)
// terms the reference prepares around the scan: the straggler / failure
// slow factor and the chaos multiplier, clamped arrivals, the retention cap,
// tokens per event and the backlog-age reciprocal. It has no Pallas twin
// (the reference leaves this path to XLA); in eager PyTorch a tick would
// take ~17 launches.
//
// Bound on an H100 (N=1024, T=48): a launch reads 7 or 8 (T, N) grids and
// writes 7 ys rows, ~60 T N bytes ~ 3.0 MB, ~0.9 us at 3.35 TB/s; its ~40
// f32 operations per (tick, cluster) are ~2 Mop, far under a microsecond at
// the f32 peak. What a launch cannot avoid is the chain of T dependent ticks
// of each cluster (backlog -> batch -> service -> processed -> backlog, with
// an IEEE division in it): the chain, not the roofline, sets its time. On
// an H100 at 700 W the chain alone (the grids of the first ticks reused, no
// further load) takes ~175-210 ns a tick (tools/scan_probe.py).
//
// Design: one thread a cluster, its carry (backlog, server-free time) in
// registers. At each tick consecutive threads read consecutive words of a
// (T, N) row and write consecutive words of a ys row, so every access is
// coalesced. A thread holds the grids of UNROLL ticks in registers, and
// (PREFETCH) loads the next UNROLL ticks' before it runs the chain through
// these, so the loads' latency (~0.6 us from device memory) overlaps UNROLL
// ticks of the chain instead of preceding them: ~5 % above the chain alone
// (tools/scan_probe.py; without the prefetch 1.13x at T=48 and 1.64x at
// T=768, and 8 or 16 ticks a thread run slower, at 255 registers). No
// shared memory, no synchronisation. The operations and their order are the
// plain version's (`tick_scan_ref` in kernels/fleet_scan.py); build with
// -fmad=false so that nvcc contracts no multiply-add and the two agree to
// the bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// coefficient rows of `consts`, in pack_tick_consts' order; C_USED rows are
// read (the array may be padded beyond them)
enum { C_TB, C_MAXB, C_ACOMP, C_CCOLL, C_BMEM, C_KVP, C_OVH, C_SLOWCAP,
       C_BACKUP, C_FAIL, C_INFLIGHT, C_USED };
// the (T, N) operands; fmult may be absent (null)
enum { G_RATE, G_SIZE, G_Z, G_USTRAG, G_URAW, G_UFAIL, G_ACTIVE, G_FMULT,
       NG };
// rows of ys, fleet_tick's layout
enum { Y_SERVICE, Y_QD, Y_BATCH, Y_PROCESSED, Y_STRAG, Y_FAIL, Y_BLG, NY };

constexpr float TOKENS_PER_MB = 16.0f;
constexpr int UNROLL = 4;  // ticks whose grids a thread holds at once
constexpr bool PREFETCH = true;  // load the next UNROLL ticks ahead
constexpr bool RELOAD = true;  // (tools/scan_probe.py: false times the chain)
constexpr int BLOCK = 64;  // threads (clusters) a block

struct Args {
  const float* grid[NG];
  const float* state;
  const float* consts;
  float* state_out;
  float* ys;
  int N, T;
  float noise, retention_s, straggler_prob, slo, slo_span;
};

// the grids of ticks [t0, t0 + UNROLL) of cluster n (1 past T, and for an
// absent fmult)
__device__ __forceinline__ void load_ticks(float (&g)[UNROLL][NG],
                                           const Args& a, int t0, int n,
                                           int ng) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long off = (long long)(t0 + u) * a.N + n;
    const bool ok = t0 + u < a.T;
#pragma unroll
    for (int k = 0; k < NG; ++k)
      g[u][k] = (ok && k < ng) ? __ldg(a.grid[k] + off) : 1.0f;
  }
}

__global__ void __launch_bounds__(BLOCK) fleet_scan_kernel(Args a) {
  const int n = blockIdx.x * BLOCK + threadIdx.x;
  if (n >= a.N) return;
  const int N = a.N;
  const long long TN = (long long)a.T * N;
  const float* c = a.consts;
  const float T_b = c[C_TB * N + n], max_b = c[C_MAXB * N + n];
  const float a_comp = c[C_ACOMP * N + n], c_coll = c[C_CCOLL * N + n];
  const float b_mem = c[C_BMEM * N + n], kvp = c[C_KVP * N + n];
  const float ovh = c[C_OVH * N + n], slow_cap = c[C_SLOWCAP * N + n];
  const float backup = c[C_BACKUP * N + n], fail_frac = c[C_FAIL * N + n];
  const float inflight = c[C_INFLIGHT * N + n];
  const bool has_fmult = a.grid[G_FMULT] != nullptr;
  const int ng = has_fmult ? NG : NG - 1;

  float backlog = a.state[n];
  float sfree = a.state[N + n];
  float g[UNROLL][NG], nxt[UNROLL][NG];
  load_ticks(g, a, 0, n, ng);
  for (int t0 = 0; t0 < a.T; t0 += UNROLL) {
    if (PREFETCH && RELOAD) load_ticks(nxt, a, t0 + UNROLL, n, ng);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (t0 + u >= a.T) break;
      const float rate = g[u][G_RATE];
      // the state-independent terms (the reference's (T, N) prep)
      const bool smask = g[u][G_USTRAG] < a.straggler_prob;
      const float raw = a.slo + a.slo_span * g[u][G_URAW];
      float slow = smask ? (backup != 0.0f ? 1.1f : fminf(raw, slow_cap))
                         : 1.0f;
      const bool fmask = g[u][G_UFAIL] < fail_frac;
      slow = fmask ? slow * 2.0f : slow;
      if (has_fmult) slow = slow * g[u][G_FMULT];
      const float arr =
          fmaxf(rate * T_b * (1.0f + a.noise * g[u][G_Z]), 0.0f);
      const float ret_ev = rate * a.retention_s;
      const float sz16 = g[u][G_SIZE] * TOKENS_PER_MB;
      const float inv_maxr = 1.0f / fmaxf(rate, 1.0f);
      // the state-coupled chain (`_tick_body`)
      const float backlog_age = backlog * inv_maxr;
      const float blg = fminf(backlog + arr, ret_ev);  // Kafka retention
      const float batch = fminf(blg, max_b);
      const float tokens = batch * sz16;
      const float mem_frac = fminf(tokens * b_mem + kvp, 1.5f);
      const float pen = 1.0f + 2.0f * fmaxf(mem_frac - 1.0f, 0.0f);
      const float service =
          (ovh + tokens * a_comp * pen + tokens * c_coll) * slow;
      const float start_rel = fmaxf(T_b, sfree);
      const float sfree_new = fminf(start_rel + service, T_b + inflight) - T_b;
      const float processed =
          service <= T_b ? batch : batch * (T_b / service);
      const float blg_after = fmaxf(blg - processed, 0.0f);
      const float qd = (start_rel - T_b) + backlog_age;
      if (g[u][G_ACTIVE] != 0.0f) {
        backlog = blg_after;
        sfree = sfree_new;
      }
      float* y = a.ys + (long long)(t0 + u) * N + n;
      y[Y_SERVICE * TN] = service;
      y[Y_QD * TN] = qd;
      y[Y_BATCH * TN] = batch;
      y[Y_PROCESSED * TN] = processed;
      y[Y_STRAG * TN] = smask ? 1.0f : 0.0f;
      y[Y_FAIL * TN] = fmask ? 1.0f : 0.0f;
      y[Y_BLG * TN] = blg_after;
    }
    if (PREFETCH && RELOAD) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int k = 0; k < NG; ++k) g[u][k] = nxt[u][k];
    } else if (RELOAD) {
      load_ticks(g, a, t0 + UNROLL, n, ng);
    }
  }
  a.state_out[n] = backlog;
  a.state_out[N + n] = sfree;
}

}  // namespace

// The coefficient rows the kernel reads (the wrapper checks it against
// pack_tick_consts).
extern "C" int fleet_scan_consts_used() { return C_USED; }

// One window: state (2, N), consts (>= C_USED, N), the (T, N) grids (fmult
// may be null), state_out (2, N), ys (NY, T, N); all f32, contiguous.
// slo_span = shi - slo. Returns a cudaError_t.
extern "C" int fleet_scan_launch(
    const float* state, const float* consts, const float* rate,
    const float* size, const float* z, const float* u_strag,
    const float* u_raw, const float* u_fail, const float* active,
    const float* fmult, float* state_out, float* ys, int N, int T,
    float noise, float retention_s, float straggler_prob, float slo,
    float slo_span, void* stream) {
  if (N < 0 || T < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  Args a;
  a.grid[G_RATE] = rate;
  a.grid[G_SIZE] = size;
  a.grid[G_Z] = z;
  a.grid[G_USTRAG] = u_strag;
  a.grid[G_URAW] = u_raw;
  a.grid[G_UFAIL] = u_fail;
  a.grid[G_ACTIVE] = active;
  a.grid[G_FMULT] = fmult;
  a.state = state;
  a.consts = consts;
  a.state_out = state_out;
  a.ys = ys;
  a.N = N;
  a.T = T;
  a.noise = noise;
  a.retention_s = retention_s;
  a.straggler_prob = straggler_prob;
  a.slo = slo;
  a.slo_span = slo_span;
  const int blocks = (N + BLOCK - 1) / BLOCK;
  fleet_scan_kernel<<<blocks, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  return (int)cudaGetLastError();
}
