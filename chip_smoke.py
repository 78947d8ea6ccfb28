"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):

1. facts    the card's name and power limit (nvidia-smi), torch and CUDA
2. build    nvcc builds every kernel of every path from the checkout's
            sources into build/kernels/ (one nvcc per source, all started
            together) and prints ptxas's report, and a line per kernel of
            its registers, spills and shared memory
3. kernels  fleet_tick against its plain PyTorch version on the card at the
            tuning path's shapes (and ragged / K>S ones), with the stated
            tolerance, then the kernel's device time (a CUDA graph of 100
            launches) and host-loop time and the plain version's time
            beside the bound
4. main     the tuning path through its entry points: FleetEnv of
            N=1024 clusters (10 nodes, 109 levers) + Configurator with the
            --quick metric/lever preset, 3 run_update outer iterations of 5
            fused steps with 240 s windows; the kernel launch count is read
            around exactly this run. Then the steady rate over 10 more
            updates (all their windows over all their time) and one
            profiled update (device busy share, host launch calls)
5. check    a 16-cluster greedy episode batch on the card, once through the
            kernel and once through its plain version, must agree
6. attn     the flash-attention kernel against its plain version at the
            serve shape, SmolLM's heads with a ragged tail, a q_offset case,
            full (non-causal) cases, group 1 and group 8, group 7 with a
            ragged Sq, Sq=1 decode at q_offset 511, causal S=2048 (several
            key tiles), each in bf16 and f32 with the stated tolerances;
            the kernel's device time (a CUDA graph of 100 launches) and
            host-loop time, the plain version's time, and at the serve shape
            scaled_dot_product_attention's device and host-loop times (the
            library yardstick, never on a path), beside the bound
7. serve    the serving path through its entry points: StreamEngine over
            the full Qwen2-7B config (28 layers, bf16, random weights from a
            seed, attn_impl="pallas"), a 640-event backlog of LocalEngine's
            default traffic drained in full micro-batches, then a short batch
            of 5 events; the attention kernel's launches must be 28 per
            forward pass. Then forward_prefill on the same weights and
            tokens with the kernel and with naive attention must agree
8. wkv      the RWKV-6 wkv kernel against its plain versions at the
            rwkv6-7b train shape (B=4, H=64, S=4096, hd=64; bf16 r/k/v with
            f32 logw/u, and all-f32; chunks 32 and 64), a ragged S, S <
            chunk and logw at both clip ends, with the stated tolerances;
            the kernel's device time (a CUDA graph of 20 launches) and
            host-loop time and the plain chunked version's time beside the
            bound (bf16 on the tensor cores' peak)
9. rwkv     the RWKV-6 path at full rwkv6-7b width (32 layers, bf16,
            random weights from a seed): forward_train on a 4x4096
            make_batch (the reference's route, the plain chunked wkv), then
            the same 32 layers walked as _rwkv_block composes them but with
            rwkv6_time_mix(impl="pallas"), exactly 32 kernel launches a
            pass, each layer's time mix against the chunked one, loss and
            logits against forward_train's, logits on an f32 copy of the
            weights, forward_prefill (no kernel launch) against score_last
10. ssd     the Mamba2 SSD kernel through ops.mamba2_ssd at zamba2-2.7b's
            mixer shape (B=4, nh=80, S=4096, hd=64, ns=64, chunk 128; f32
            and bf16), a ragged S, S < chunk, ns=128 and loga at -80 a step
            and at 0, against the plain chunked and sequential versions with
            the stated tolerances; its launch (grid, warps, shared memory,
            blocks an SM, ptxas registers and spills); the kernel's device
            time (a CUDA graph of 20 launches) and host-loop time and the
            plain chunked version's time beside the bound (on the TF32
            tensor cores' peak, which the kernel's products use)
11. tuner   the Lasso path's lasso_cd kernel against its CPU mirror
            (bitwise) and its plain version at the tuner's shape (1200 rows,
            109 levers and their squares: p = 218, A in shared memory; 60
            lambdas x up to 60 epochs) and at p = 300 (A's rows from global
            memory): coefficients within the stated scaled tolerance, entry
            order equal, device time (CUDA events over 3 launches), ns an
            update, epochs run and updates that moved, beside the plain
            version's time and the bound. Then
            the paper's whole method through AutoTuner: the 80-cluster
            sweep at full width (109 levers, 90 metrics, 10 nodes),
            collect(1200, windows_per_cluster=6), analyse(), 3 fused
            run_updates and 1 update of the per-step host fleet loop, then a
            serial SimCluster's collect(120), analyse() and 1 host-loop
            update (4 episodes x 5 steps); fleet_tick and lasso_cd launches
            equal to the counts the code gives, windows/s of collect and
            tune, analyse's split, the Lasso on the sweep's own matrix
            against its mirror and its plain version
12. chaos   fault scenarios and the safety shield on the fused tuning loop,
            in the configuration of the reference's chaos and shield rows
            (benchmarks/fleet_scaling.py: Poisson 10k ev/s fleets, its
            metrics and levers, 6 steps, 240 s windows, frozen bins,
            chaos_scenario(N, seed=0)) at N=1024: fault_effect_grid on the
            card bitwise equal to the CPU; a 16-cluster greedy batch under
            chaos, deploy delay 1 and the shield through the kernel and its
            plain version (phase 5's criterion, the shield's counters
            equal), no_faults(16) bitwise equal to no table; the chaos arm
            (its main path: 3 warm-up + 10 timed run_updates under the 2 s
            SLO reward, fleet_tick launches as the code counts them,
            ChaosCounters, a profiled update) beside a clean arm; recovery
            from a fleet-wide FailureFault(900, 480, 16) on a frozen config
            (spike above the pre-fault p99, back in 1..4 windows); the
            shielded and unshielded arms at a 12 s SLO, 14 updates
            interleaved (windows/s, breach rate and intensity, mean reward,
            ShieldCounters, the two ratios recorded; the shield must engage)
13. graphs  the fused loop's captured CUDA graphs, the pipeline and the
            epoch, in the configuration of the reference's pipelined and
            mega-scan rows (benchmarks/fleet_scaling.py: Poisson 10k ev/s
            fleets, its metrics and levers, 5 steps, 240 s windows, frozen
            bins, 3 warm-up updates): at N=16 on Philox draws, bitwise,
            graph-replayed tune(4) against the same run with every program
            run eagerly, run_epoch(1) x4, run_epoch(4, "full") and
            tune_pipelined(4, depth=1) against tune(4), and the shielded
            chaos twin (deploy delay 1) run_epoch(2) against tune(2); then
            at N=1024 chunks of K=8 updates interleaved over 3 passes:
            sequential tune, tune_pipelined(depth=2), run_epoch(8) in
            "full", "summary" and "off" (windows/s, chunk and update
            spread, fleet_tick launches as the code counts them,
            CAPTURE_COUNTS flat, the ratios beside the reference's CPU gates,
            recorded), a profiled chunk per mode (busy share, host
            kernel-launch and graph-launch calls an update, peak and
            reserved memory) and cProfile's host split of sequential updates
14. serve   the serve control plane (shadow -> canary -> promote/rollback)
            on the captured fused loop, in the reference's acceptance
            configuration (tests/test_serve.py: launch/serve.py's switching
            roster, 240 s windows, 2 steps, k_promote 2, margin 0.02, 20 s
            SLO, 2 evaluation windows, the degraded-stationary incumbent,
            frozen bins): a 3-cycle service at N=16 through the kernel and
            through its plain version (the same decisions, gate log and
            incumbent, rewards within RTOL); 20 cycles at shadow N=1024,
            canary 64 pairs, live 256 (its fleet_tick launches as the code
            counts them, at least 1 promotion, no served config breached
            during its winning canary, captures flat after cycle 4;
            cycles/s, wall by phase, a profiled cycle, peak memory);
            crash-resume at those sizes, bitwise against the uninterrupted
            run, from a fresh controller and in place into captured
            programs; epoch_k=2 (one epoch a cycle); every fleet of this
            phase names window_impl="kernel"
15. scan    the lean tick scan (window_impl="scan", the reference's
            backend="jax"): the fleet_scan kernel bitwise against its plain
            version at N=1024 with T=48, 768 and 3328 and at N=80 and
            N=1000, each with and without fmult and a partial active, with
            the kernel's device time (a CUDA graph of 100 launches),
            host-loop time, the plain version's time and the bound; one
            N=1024 fleet observed with both windows (the two estimators'
            median mean and p99 within the stated tolerance); the
            kernel-vs-scan calibration at N=1024 and N=80; a 16-cluster
            greedy batch on the scan through the kernel and its plain
            version; phase 4's main path on the scan (fleet_scan launches as
            the code counts them, no fleet_tick launch, steady windows/s, a
            profiled update); the epoch "summary" of 8 updates captured,
            bitwise against its eager twin, and its windows/s; the serve
            plane at its default window (cycles/s at phase 14's sizes, then
            crash-resume after capture, fresh and in place, bitwise)
16. local   LocalEngine on the card in the reference's configuration
            (examples/serve_autotune.py: the reduced smollm-135m, Poisson
            30 events/s of 0.5 MB, seed 0) on 2 s wall-clock windows:
            events/s, p50/p99, batch service ms, jit_compiles and their
            time; the mean latency at batch_interval_s 0.1 must be below
            that at 1.0; the reboot lever attn_chunk 32 re-"compiles"; then
            AutoTuner's collect(16) -> analyse -> 1 host-loop update (6
            windows), the wall by stage; one lasso_cd launch (analyse's
            Lasso path) and no other kernel launch
17. train   the training step at full SmolLM-135M width (30 layers,
            d_model 576, 9/3 heads, d_ff 1536, vocab 49152, tied
            embeddings, bf16 params, f32 AdamW moments, scan_layers,
            remat "block"): (a) the reduced f32 step on the card against
            the host from the same state, with the stated tolerance; (b)
            launch/train.main at the reference launcher's defaults (--full
            --batch 8 --seq 128), 60 steps, --ckpt-every 20
            --inject-failure 30: resumed at step 20, the restored tree
            bitwise equal to the saved one, every loss finite, the final
            loss within the stated tolerance of an uninterrupted run; (c)
            tokens/s and ms/step (median, min, max) over 20 steps at
            8 x 1024 after 3, peak memory, and the peak and step of remat
            "none" and "full"; (d) a profiled step; (e) the step's
            operations counted from the code beside the bf16 and f32
            peaks; (f) accum_steps 2 against 1 on an f32 copy; no kernel
            launches
18. decode  distribution/steps.py's make_prefill_step then 32 greedy
            make_decode_step steps at decode_32k's context of 32768
            positions, bf16, random weights drawn on the card, at full
            width for qwen2-7b (dense; batch 16 of 16 x 512 prompts, the
            prefill under attn_impl "pallas"), rwkv6-7b (ssm; batch 128 of
            128 x 128) and zamba2-2.7b (hybrid; batch 8 of 8 x 512), one
            model at a time: prefill ms, tokens/s and ms a step (median
            and spread over the steps after 3), peak memory, a profiled
            step (busy share, kernel-launch calls), the step's byte bound
            (weights, the whole cache or state read, the state written, at
            3.35 TB/s) and its fraction; pos advancing one a step, every
            state tensor on the card, finite logits; exactly 28
            flash_attention launches for qwen2's prefill and none
            elsewhere. Before qwen2's run, the bf16 flash-attention kernel
            against its plain version at the prefill's shape and strides
            (B=16, Hq=28, Hkv=4, S=512, hd=128, causal) within ATTN_TOL,
            with its times and SDPA's on the same views. Each config also
            at full width in f32 cut to 4 layers (the hybrid: 2 periods),
            decode after S - 1 tokens
            against prefill's last logits on S within DECODE_F32_TOL of the
            logits' scale; and
            at full depth in bf16 that distance within DECODE_BF16_X times
            the bf16-vs-f32 distance of the prefill (its floor, measured in
            the run)
19. families the MoE, VLM and audio families at full width through the
            same steps: qwen2-moe-a2.7b (moe; batch 4 of 4 x 512 into
            32768 positions), internvl2-26b (vlm; batch 2 of 256 patch
            embeddings + 512 tokens into 32768) and whisper-large-v3
            (audio; batch 32 of 1500 frames and a 4-token prompt into its
            448-position decoder context), bf16, random weights, attn_impl
            "pallas", one model at a time: (a) the bf16 flash-attention
            kernel against its plain version at whisper's encoder shape
            (B=4, Hq=Hkv=20, S=1500, hd=64, non-causal) and InternVL2's
            prefill shape (B=2, Hq=48, Hkv=8, S=768, hd=128, causal), in
            the model's transposed views, within ATTN_TOL and within
            FAMILY_ATTN_REL of the output's rms, a limit that planted
            faults of the plain version (the padded key tail unmasked, the
            ragged tail dropped, one key past the diagonal) must each
            exceed, with its device time, bound and SDPA's time; (b) at
            full width in f32 cut to 4 layers (whisper 4 + 4 encoder
            layers) decode after S - 1 tokens against prefill on S within
            DECODE_F32_TOL of the logits' scale (the MoE at a capacity
            factor that drops nothing, its drop fractions printed), and at
            full depth in bf16 within DECODE_BF16_X of the bf16-vs-f32
            floor (the MoE's experts pinned on both bf16 routes to those
            the f32 prefill chose, so that the floor is rounding and not
            other experts); (c) prefill and
            32 greedy steps: prefill ms, tokens/s and ms a step, peak
            memory, a profiled step, the step's byte bound (the MoE's
            experts counted as routed), flash_attention launches (one a
            self-attention layer of the prefill, none in the steps), the
            MoE's drop fraction at prefill and decode; (d) grok-1-314b at
            full width cut to 2 of its 64 layers: a 2 x 512 prefill and 8
            steps, finite logits, its drop fractions

20. dryrun  the one-device dry-run (launch/dryrun.py) held against the
            card: (a) smollm-135m x train_4k cut to 8 x 1024 (remat
            "block"), qwen2-7b x decode_32k cut to batch 16, rwkv6-7b x
            long_500k whole (batch 1, 524288 positions), each at full
            width: the dry-run's FLOPs, bytes, roofline times and predicted
            peak, then the step through make_step_for_cell on the card with
            random weights: the arguments' bytes equal to the dry-run's and
            FlopCounterMode's count of one step equal to its FLOPs (both
            exact), ms a step (median of 5 after 3), the step over its
            dry-run bound, the predicted over the measured peak, no kernel
            launch; the decode cell beside phase 18's tree byte bound. (b)
            FleetEnv.prewarm on twin N=1024 fleets (phase 4's) on
            window_impl "kernel" and "scan": 8 launches of the window's
            kernel, the twins' clocks, backlogs, pending buffers and draw
            streams equal, the next window bitwise equal. (c)
            SimCluster.backlog_events after a reboot lever, a window, a
            write, a reset

The tuning loop's episode batches and updates (phases 4, 11-15) run
as captured CUDA graphs from their second call at a shape
(``repro_torch.core.graphs``; the first is the capture's eager warm-up, so
phase 5's single greedy batch runs eagerly); a graph adds the fleet_tick
and fleet_scan launches it holds to their counts at every replay.

Each path's kernel launches are counted from 0 just before the path runs
and read just after. The last two lines are the kernels JSON and the
contract JSON. The script imports neither jax nor the JAX package; it
needs one card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

QUICK_METRICS = ["latency_p99_ms", "latency_mean_ms", "queue_depth",
                 "device_util", "sched_queue_depth"]
QUICK_LEVERS = ["max_batch_events", "prefetch_depth", "driver_memory_gb",
                "sink_partitions", "backup_tasks"]
MIX = ("poisson_low", "trapezoid", "yahoo_ads", "switching")
#: frozen §2.4.1 bin adaptation, as the reference's N=1024 training rows run
#: it (benchmarks/fleet_scaling.py): replaying 5k assignments per lever per
#: batch otherwise splits bins every few steps and the tables explode
FROZEN = dict(split_after=10**9, extend_after=10**9, merge_after=10**9)
#: published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 non-tensor
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
#: kernel vs plain tolerance: the kernel is built with -fmad=false and does
#: the plain version's f32 operations in its order (exact min/max sorting,
#: the same adjacent-pair lane sum), so they should agree to the bit; rtol
#: 1e-5 leaves room only for libm differences
RTOL, ATOL = 1e-5, 1e-6
#: published H100 SXM dense bf16 and TF32 tensor-core peaks (NVIDIA data
#: sheet)
BF16_OPS_S = 989e12
TF32_OPS_S = 495e12
#: flash attention vs its plain version: the tolerances of
#: tests/test_kernels.py (online vs full softmax, f32 sums in other orders;
#: bf16 outputs one rounding apart)
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
#: phase 19(a): rms(kernel - plain) / rms(plain) at most this. ATTN_TOL is
#: about as large as the outputs there (1500 keys of N(0, 1) inputs
#: average to an rms of ~0.04), so this relative limit is the one that
#: discriminates: it lies between the sound kernel's reading and the
#: smallest planted fault's (PERF.md §6, PR 25), and the phase checks
#: that every planted fault exceeds it
FAMILY_ATTN_REL = 6e-3
#: the whole 28-layer model in f32, kernel vs naive attention: the per-call
#: 2e-5, compounded over 28 layers of 3584-wide matmuls (measured ~1e-5 of
#: growth per layer at most), with room
F32_DEPTH_TOL = 1e-3
#: the whole 28-layer model in bf16, kernel vs naive attention: at most this
#: many times the distance between the two plain implementations (chunked vs
#: naive) on the same weights and tokens, the floor that bf16 rounding of
#: each layer's attention output sets at depth
BF16_DEPTH_FLOOR_X = 1.5
#: wkv kernel vs its plain versions, max |difference| over the plain
#: output's scale max(1, max |plain|) (printed beside it: at S=4096 with
#: slow decays the state sums thousands of k vT products, and o reaches
#: hundreds). f32: tests/test_kernels.py's 1e-3 (the Pallas kernel against
#: the sequential oracle; the f32 kernel runs the recurrence token by token,
#: the chunked plain version sums in another order). bf16 r/k/v: o is rounded
#: to bf16 on both sides, one bf16 ulp is 2^-8 of the value: the bf16 3e-2 of
#: tests/test_kernels.py (the bf16 kernel's chunked products keep ~2^-16 of
#: each term before that rounding). S_fin is f32 in both cases: 1e-3
WKV_TOL = {torch.float32: 1e-3, torch.bfloat16: 3e-2}
#: SSD kernel vs its plain versions, on the same scale: tests/test_kernels.py's
#: f32 2e-4 (chunked vs sequential) and bf16 3e-2
SSD_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}
#: lasso_cd vs its plain version, max |difference| over max(1, max |plain|):
#: the same f32 updates with the gradient carried instead of a dot taken
#: afresh, chained over up to 3600 epochs (the tests hold the port's path
#: to the reference's at rtol 1e-4 the same way); against its CPU mirror,
#: which takes the kernel's steps in its order, the kernel is bitwise equal
LASSO_TOL = 1e-4
#: the RWKV-6 loss in bf16, kernel route vs forward_train's chunked route:
#: the loss is the f32 mean over 16384 positions of CE on bf16 logits; the
#: two routes' logits differ by single bf16 ulps (2^-8 relative) of both
#: signs, so the mean moves far less than one ulp; 1e-3 of the loss would
#: take a systematic quarter-ulp shift of every logit
RWKV_LOSS_RTOL = 1e-3
#: phase 17(a): the reduced SmolLM f32 train step on the card against the
#: same step on the host from the same state. The two sum the matmuls and
#: the softmax in other orders (~1e-6 relative a layer, as the CPU tests'
#: port-vs-reference gradients); AdamW divides each gradient element by its
#: own size, so an element whose gradient is as small as that rounding moves
#: by a share of lr: the loss within TRAIN_RTOL, each leaf within TRAIN_RTOL
#: of its scale (1 + max |leaf| for a parameter, the leaf's own max |leaf|
#: for an AdamW moment, whose elements are ~1e-3 and ~1e-7) but for fewer
#: than TRAIN_FAR of its elements, and those within a quarter of the leaf's
#: largest step
TRAIN_RTOL, TRAIN_FAR = 1e-5, 1e-3
#: phase 17(b): the failure drill against an uninterrupted run: each step's
#: loss relative to the uninterrupted run's at that step, and each final
#: parameter and moment leaf relative to its own max |leaf|. Both runs take
#: the same steps from the same bits (the restored tree is checked bitwise
#: against the saved one) through the same kernels, and the embedding's
#: backward (index_put_ with accumulate on a sorted index) adds its rows in
#: a fixed order: measured 0 on an H100 for both. The limit is ~10 f32 ulps
#: of the ~10.9 loss; a resume from any other state shows at 1e-2
DRILL_RTOL = 1e-6
#: phase 17(b)'s steps, the step its failure is injected at and the
#: checkpoint interval (the reference launcher's 60 / 30 / 20 cut in half to
#: keep the script inside its time limit)
DRILL_STEPS, DRILL_FAIL, DRILL_CKPT = 30, 15, 10
#: phases 18-19, decode after S - 1 tokens against prefill's last logits on
#: S, at full width in f32 cut to 4 layers (a hybrid to 2 periods) with
#: full-precision f32 products: the two routes compute the same f32
#: function and sum in other orders (the decode token's products run on one
#: row, its attention over the cache in one softmax), ~1e-6 relative a
#: layer (measured 1.3e-6 to 5.5e-6 of the logits' scale). The limit is
#: relative to that scale, max(1, max |logits|); 200x tighter than the
#: reference's own 2e-2 (tests/test_smoke_archs.py)
DECODE_F32_TOL = 1e-4
#: phase 18 at full depth in bf16: that distance against the floor bf16
#: rounding sets, the distance between the bf16 and the f32 prefill's
#: logits on the same weights and tokens. Each bf16 route lands about a
#: floor away from the f32 function (every product of the decode token
#: runs on one row, so its bf16 roundings fall elsewhere than the
#: prompt's), so two of them may be up to twice the floor apart
DECODE_BF16_X = 2.0
#: phase 18: (config, batch, prompt tokens, attn_impl) at decode_32k's
#: context; the batch cut from decode_32k's 128 where the cache would not
#: fit one card (PERF.md §4)
DECODE_RUNS = (("qwen2_7b", 16, 512, "pallas"),
               ("rwkv6_7b", 128, 128, "chunked"),
               ("zamba2_2p7b", 8, 512, "chunked"))
DECODE_CONTEXT, DECODE_STEPS, DECODE_WARM, DECODE_CHECK_ROWS = 32768, 32, 3, 4
#: phase 19: (config, batch, prompt tokens, context positions), bf16 at full
#: depth; the batch cut from decode_32k's 128 where weights and caches
#: would not fit one card (PERF.md §4); whisper at its decoder's own
#: 448-position context (n_text_ctx, arXiv 2212.04356)
FAMILY_RUNS = (("qwen2_moe_a2p7b", 4, 512, 32768),
               ("internvl2_26b", 2, 512, 32768),
               ("whisper_large_v3", 32, 4, 448))
#: phase 19's check prompt where it is not the run's (whisper's 4 tokens
#: would test decode at pos 3 only)
FAMILY_CHECK_P = {"whisper_large_v3": 64}
#: phase 19(d): grok-1 at full width, (layers, batch, prompt, steps)
GROK_CUT = (2, 2, 512, 8)


def _gpu_facts() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _bound(nbytes: float, ops: float, peak: float) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes at
    HBM_BYTES_S and the operations at ``peak``, and which of the two."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def _time_ms(fn, reps: int = 100, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _kernel_inputs(N: int, T: int, S: int, seed: int, dev):
    """Operands at one (N, T, S) point: real packed constants of a
    heterogeneous fleet, seeded draw words (uint32 values in int64, as the
    draw source returns them), a non-trivial fault multiplier and a window
    mask with a stabilisation preroll."""
    from repro_torch.engine import FleetEnv
    from repro_torch.kernels.fleet_tick import pack_tick_consts

    env = FleetEnv.heterogeneous(N, seed=seed, mix=MIX, backend="torch",
                                 device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    cc = {k: torch.as_tensor(v, **f32) for k, v in env.packed().items()}
    mc = {k: torch.as_tensor(v, device=dev,
                             dtype=torch.bool if v.dtype == bool else torch.float32)
          for k, v in env.mc.items()}
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    bits = lambda shape: torch.as_tensor(rng.integers(0, 2 ** 32, shape),
                                         dtype=torch.int64, device=dev)
    n_ticks = rng.integers(T // 2, T + 1, N)
    n_skip = rng.integers(0, T // 4 + 1, N)
    t_ax = np.arange(T)[:, None]
    ops = dict(
        state=t(np.stack([rng.uniform(0, 5e4, N), rng.uniform(0, 5, N)])),
        consts=pack_tick_consts(cc, mc, env.spec, env.chips).contiguous(),
        rate=t(rng.uniform(5e3, 6e4, (T, N))),
        size=t(rng.uniform(0.001, 5.0, (T, N))),
        tick_bits=bits((T, 2, N)),
        active=t(t_ax < n_ticks[None, :]),
        lane_bits=bits((T, S, N)),
        fmult=t(np.where(rng.random((T, N)) < 0.1,
                         rng.uniform(1.0, 4.0, (T, N)), 1.0)),
        wmask=t((t_ax < n_ticks[None, :]) & (t_ax >= n_skip[None, :])))
    kw = dict(noise=env.spec.noise, retention_s=env.spec.retention_s,
              straggler_prob=env.spec.straggler_prob,
              slo=env.spec.straggler_slow[0], shi=env.spec.straggler_slow[1])
    return ops, kw


def phase_kernels(dev, facts: str) -> dict:
    from repro_torch.engine.fleet_torch import p99_depth
    from repro_torch.kernels import fleet_tick as ft

    # (N, T, S, p99_k): the fused step's window, the observe window, a
    # ragged long window, a K > S head, a window of 768 ticks (16 merge
    # values a lane), one of 3328 ticks (its head merged by rank in shared
    # memory), a head too long for shared memory (in global memory), and
    # the step's window on one rank of phase 21's 2-rank mesh; None takes
    # the port's own depth
    shapes = [(1024, 48, 32, None), (1024, 24, 64, None),
              (1000, 192, 8, None), (777, 32, 16, 40), (1024, 768, 8, None),
              (1024, 3328, 8, None), (1000, 16, 8, 8000),
              (MESH_N // 2, 48, 32, None)]
    main = None
    for N, T, S, p99_k in shapes:
        p99_k = p99_depth(T, S) if p99_k is None else p99_k
        K = ft.head_budget(S, p99_k)
        ops, kw = _kernel_inputs(N, T, S, seed=N + T + S, dev=dev)
        args = list(ops.values())
        got = ft.fleet_tick_window(*args, **kw, p99_k=p99_k)
        ref = ft.fleet_tick_window_ref(*args, **kw, p99_k=p99_k)
        torch.cuda.synchronize()
        worst = 0.0
        for name, a, b in zip(("state", "ys", "stats", "head"), got, ref):
            a, b = a.cpu().numpy(), b.cpu().numpy()
            fin = np.isfinite(b)
            if not np.array_equal(fin, np.isfinite(a)):
                raise AssertionError(f"{name}: finite masks differ at {N, T, S}")
            # the non-finite entries (-inf padding, quantiles of ticks outside
            # the window) must be the same values: sign of inf, NaN slots
            if not np.array_equal(a[~fin], b[~fin], equal_nan=True):
                raise AssertionError(f"{name}: non-finite entries differ at "
                                     f"{N, T, S}")
            err = np.abs(a[fin] - b[fin])
            rel = err / np.maximum(np.abs(b[fin]), 1e-30)
            ok = np.all(err <= ATOL + RTOL * np.abs(b[fin]))
            exact = np.array_equal(a, b, equal_nan=True)
            mx = float(err.max()) if err.size else 0.0
            worst = max(worst, mx)
            print(f"  N={N} T={T} S={S} K={K} {name:5s} max_abs={mx:.3e} "
                  f"max_rel={float(rel.max()) if rel.size else 0.0:.3e} "
                  f"bitwise={exact} (rtol {RTOL}, atol {ATOL})")
            if not ok:
                raise AssertionError(f"{name} out of tolerance at {N, T, S}")
        run = lambda: ft.fleet_tick_window(*args, **kw, p99_k=p99_k)
        geo = ft.launch_geometry(N, T, S, K)
        reps = 100 if geo["head"] == "registers" else 5  # these take ms
        ms, host_ms = _graph_ms(run, reps=reps), _time_ms(run, reps=reps)
        # what the kernel's own decode replaces: the eager rows that decoded
        # the same words before it took them raw
        decode_ms = _graph_ms(lambda: ft.decode_draws(ops["tick_bits"],
                                                      ops["lane_bits"]),
                              reps=reps)
        plain_ms = _time_ms(   # ~1k torch ops a tick: fewer reps when long
            lambda: ft.fleet_tick_window_ref(*args, **kw, p99_k=p99_k),
            reps=min(100, max(3, 4800 // T)), warmup=2)
        nbytes, nops = ft.window_cost(T, S, K, N, fmult=True)
        bound_ms, by = _bound(nbytes, nops, F32_OPS_S)
        print(f"  N={N} T={T} S={S}: kernel device {ms * 1e3:.3f} us (host "
              f"loop {host_ms * 1e3:.3f} us; the eager decode it replaces "
              f"{decode_ms * 1e3:.3f} us), plain {plain_ms * 1e3:.1f} us, "
              f"bound {bound_ms * 1e3:.3f} us by {by} ({nbytes / 1e6:.2f} MB, "
              f"{nops / 1e6:.1f} Mop), {bound_ms / ms:.4f} of the bound; "
              f"{geo['blocks']} blocks of {geo['threads']} threads, "
              f"{geo['smem_bytes']} B shared, head in {geo['head']} "
              f"[{facts}]")
        if main is None:
            main = {"max_abs_err": worst, "ms": ms, "ms_host_loop": host_ms,
                    "decode_ms": decode_ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": by}
    return main


def phase_main(dev, facts: str) -> dict:
    from repro_torch.core import Configurator
    from repro_torch.engine import FleetEnv
    from repro_torch.kernels import fleet_tick as ft

    N, S, updates = 1024, 5, 3
    env = FleetEnv.heterogeneous(N, seed=0, backend="torch", mix=MIX)
    assert env.device.type == "cuda" and env.n_nodes == 10
    assert len(env.lever_specs) == 109
    cfgr = Configurator(env, QUICK_METRICS, QUICK_LEVERS, device_loop="on",
                        window_s=240.0, steps_per_episode=S, bin_kw=FROZEN)
    assert cfgr.hspec.state_dim == 65 and cfgr.agent.n_actions == 10
    w0 = {k: v.detach().clone() for k, v in cfgr.agent.params.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    per_update = []
    for _ in range(updates):
        t1 = time.perf_counter()
        stats = cfgr.run_update()
        torch.cuda.synchronize()
        per_update.append(time.perf_counter() - t1)
    wall = time.perf_counter() - t0
    launches = ft.LAUNCHES
    expected = 1 + updates * S      # first batch's observe + one per step
    print(f"  fleet_tick launches {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != {expected}")
    r = np.array([rec.reward for rec in cfgr.history])
    p = np.array([rec.p99_ms for rec in cfgr.history])
    assert r.shape == (updates * N * S,), r.shape
    assert np.isfinite(r).all(), "non-finite rewards"
    assert (p > 0).all() and np.isfinite(p).all(), "bad p99"
    assert np.isfinite(stats["pg_loss"]), stats
    moved = [k for k, v in cfgr.agent.params.items()
             if not torch.equal(v.detach(), w0[k])]
    assert moved, "policy parameters did not change"
    mem = torch.cuda.max_memory_allocated()
    print(f"  {updates} run_updates at N={N}: {wall:.3f} s "
          f"(per update {', '.join(f'{x:.3f}' for x in per_update)} s; the "
          f"first carries one-time set-up), {updates * N * S / wall:.1f} "
          f"windows/s, peak device memory {mem / 2**20:.1f} MiB [{facts}]")
    print(f"  reward mean {r.mean():.4f} median {np.median(r):.4f}, p99 median "
          f"{np.median(p):.1f} ms, last pg_loss {stats['pg_loss']:.5f}, "
          f"params moved: {moved}")
    _steady_rate(cfgr, N, S, facts)
    _profile_update(cfgr, facts)
    return {"launches": launches}


def _steady_rate(cfgr, N: int, S: int, facts: str, updates: int = 10,
                 kernel: str = "fleet_tick") -> None:
    """Training windows/s after warm-up: all N·S windows of ``updates`` more
    outer iterations over their whole wall time (after the main path's launch
    count was read), with the spread of the per-update times; ``kernel``
    names the window kernel whose launches are checked."""
    ft = _kernel_mods()[kernel]

    before = ft.LAUNCHES
    times = []
    for _ in range(updates):
        t1 = time.perf_counter()
        cfgr.run_update()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    if ft.LAUNCHES - before != updates * S:
        raise AssertionError(f"steady run: {ft.LAUNCHES - before} launches, "
                             f"expected {updates * S}")
    t = np.array(times)
    print(f"  steady: {updates} more run_updates, {updates * N * S} windows in "
          f"{t.sum():.6f} s = {updates * N * S / t.sum():.1f} windows/s; per "
          f"update min {t.min():.6f}, median {np.median(t):.6f}, max "
          f"{t.max():.6f} s [{facts}]")
    print(f"  steady per update, in order: "
          f"{', '.join(f'{x:.6f}' for x in t)} s")


def _profile(fn, label: str, facts: str, top: int = 8) -> dict:
    """``fn()`` once under torch.profiler: wall, device busy share, device
    launches (kernel and copy rows, a replayed graph's kernels included)
    and the host's launch calls (the CUDA runtime's kernel-launch rows
    against its graph-launch rows), with the kernels that take the device
    time. Returns the numbers."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    # device-side rows only (kernels, copies): the CPU-side aten rows carry
    # the same device time again
    rows = [e for e in avgs
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in rows)
    launches = sum(e.count for e in rows)
    host = [e for e in avgs
            if e.device_type == torch.autograd.DeviceType.CPU]
    kernel_calls = sum(e.count for e in host if "LaunchKernel" in e.key)
    graph_calls = sum(e.count for e in host if "GraphLaunch" in e.key)
    print(f"  profiled {label}: wall {wall * 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.1f} ms ({100 * busy_us / 1e6 / wall:.1f} %), "
          f"{launches} device launches; host launch calls: "
          f"{kernel_calls} kernel, {graph_calls} graph [{facts}]")
    for e in sorted(rows, key=lambda e: e.device_time_total,
                    reverse=True)[:top]:
        print(f"    {e.device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:70]}")
    return {"wall_ms": wall * 1e3, "busy_ms": busy_us / 1e3,
            "launches": launches, "kernel_calls": kernel_calls,
            "graph_calls": graph_calls}


def _profile_update(cfgr, facts: str) -> dict:
    """One more outer iteration under torch.profiler (after the launch
    count was read, so the main-path count is untouched)."""
    return _profile(cfgr.run_update, "run_update", facts)


def phase_check(dev) -> None:
    """A small greedy batch through the kernel and through its plain
    version, with identical draws, on the card."""
    from repro_torch.core import Configurator
    from repro_torch.engine import FleetEnv
    from repro_torch.engine.draws import PhiloxDraws
    from repro_torch.kernels import fleet_tick as ft

    def run():
        env = FleetEnv.heterogeneous(16, seed=3, backend="torch", mix=MIX)
        env._dev.draws = PhiloxDraws(1234, dev)
        cfgr = Configurator(env, QUICK_METRICS, QUICK_LEVERS,
                            device_loop="on", window_s=240.0,
                            steps_per_episode=3)
        batch, recs = cfgr.run_fleet_episodes_device(explore=False)
        return (batch["actions"].cpu().numpy(), batch["rewards"].cpu().numpy(),
                np.array([x.p99_ms for x in recs]), env.clock.copy())

    kern = run()
    saved = ft.fleet_tick_window
    ft.fleet_tick_window = ft.fleet_tick_window_ref
    try:
        plain = run()
    finally:
        ft.fleet_tick_window = saved
    assert np.array_equal(kern[0], plain[0]), "greedy actions differ"
    for name, a, b in zip(("rewards", "p99", "clock"), kern[1:], plain[1:]):
        assert np.isfinite(a).all(), name
        if not np.allclose(a, b, rtol=RTOL, atol=0.0):
            raise AssertionError(f"{name}: kernel path {a} vs plain {b}")
        print(f"  greedy N=16 {name}: max_rel "
              f"{float(np.max(np.abs(a - b) / np.abs(b))):.3e} (rtol {RTOL})")


def _attn_inputs(B, Hq, Hkv, Sq, Skv, hd, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *shape: torch.randn(shape, generator=g, device=dev).to(dtype)
    return mk(B, Hq, Sq, hd), mk(B, Hkv, Skv, hd), mk(B, Hkv, Skv, hd)


def phase_attention(dev, facts: str) -> dict:
    """The flash-attention kernel against its plain version on the same
    tensors at the serve shape and the edge cases, then its times beside the
    bound: device time from a CUDA graph of captured launches, and the
    host-loop CUDA-event time (which includes the wrapper's host cost)."""
    bf16, f32 = torch.bfloat16, torch.float32
    # (label, B, Hq, Hkv, Sq, Skv, hd, causal, q_offset, dtypes)
    shapes = [
        ("qwen2-serve", 32, 28, 4, 64, 64, 128, True, 0, (bf16, f32)),
        ("smollm-ragged", 8, 9, 3, 40, 40, 64, True, 0, (f32, bf16)),
        ("qwen2-offset", 2, 28, 4, 16, 80, 128, True, 64, (bf16, f32)),
        ("full", 4, 8, 2, 50, 72, 32, False, 0, (f32, bf16)),
        ("group1-mha", 4, 8, 8, 64, 64, 128, True, 0, (bf16, f32)),
        ("group8", 4, 32, 4, 64, 64, 64, True, 0, (bf16, f32)),
        ("group7-ragged", 3, 28, 4, 40, 40, 128, True, 0, (bf16, f32)),
        ("decode", 4, 28, 4, 1, 512, 128, True, 511, (bf16, f32)),
        ("long-causal", 1, 28, 4, 2048, 2048, 128, True, 0, (bf16, f32)),
        ("full-bf16", 2, 28, 4, 100, 300, 128, False, 0, (bf16, f32)),
    ]
    main = None
    seed = 0
    for label, B, Hq, Hkv, Sq, Skv, hd, causal, off, dts in shapes:
        for dt in dts:
            q, k, v = _attn_inputs(B, Hq, Hkv, Sq, Skv, hd, dt, dev, seed=seed)
            seed += 1
            row = _attention_case(label, q, k, v, causal, off, facts)
            if main is None:
                sdpa_ms, sdpa_host_ms = _sdpa_ms(q, k, v, Hq // Hkv)
                main = {**row, "library_ms": sdpa_ms,
                        "library_ms_host_loop": sdpa_host_ms}
                print(f"    scaled_dot_product_attention(is_causal=True, "
                      f"enable_gqa=True): device {sdpa_ms * 1e3:.3f} us, host "
                      f"loop {sdpa_host_ms * 1e3:.3f} us (yardstick only, never "
                      f"on a path); the kernel's device time is "
                      f"{row['ms'] / sdpa_ms:.3f}x SDPA's [{facts}]")
            del q, k, v
    return main


def _attention_case(label, q, k, v, causal, off, facts) -> dict:
    """One shape: the kernel against its plain version, then the kernel's
    device and host-loop times and the plain version's beside the bound."""
    from repro_torch.kernels import flash_attention as fa

    B, Hq, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    dt = q.dtype
    kw = dict(causal=causal, q_offset=off)
    got = fa.flash_attention_bhsd(q, k, v, **kw)
    want = fa.flash_attention_bhsd_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    a, b = got.float(), want.float()
    if not torch.isfinite(a).all():
        raise AssertionError(f"flash_attention: non-finite output at {label}")
    err = float((a - b).abs().max())
    tol = ATTN_TOL[dt]
    ok = bool(((a - b).abs() <= tol + tol * b.abs()).all())
    shape = f"B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} Skv={Skv} hd={hd}"
    print(f"  {label} {shape} causal={causal} q_offset={off} "
          f"{str(dt).removeprefix('torch.')}: max_abs={err:.3e} "
          f"(rtol=atol={tol})")
    if not ok:
        raise AssertionError(f"flash_attention out of tolerance at {label} "
                             f"{dt}")
    ms = _graph_ms(lambda: fa.flash_attention_bhsd(q, k, v, **kw))
    host_ms = _time_ms(lambda: fa.flash_attention_bhsd(q, k, v, **kw))
    plain_ms = _time_ms(lambda: fa.flash_attention_bhsd_ref(q, k, v, **kw),
                        reps=20, warmup=2)
    nbytes, flops = fa.attention_cost(B, Hq, Hkv, Sq, Skv, hd, causal=causal,
                                      q_offset=off, itemsize=q.element_size())
    bound_ms, by = _bound(nbytes, flops,
                          BF16_OPS_S if dt == torch.bfloat16 else F32_OPS_S)
    print(f"    kernel device {ms * 1e3:.3f} us (host loop {host_ms * 1e3:.3f}"
          f" us), plain {plain_ms * 1e3:.3f} us, bound {bound_ms * 1e3:.3f} us "
          f"by {by} ({nbytes / 1e6:.2f} MB, {flops / 1e9:.4f} GFLOP), "
          f"{bound_ms / ms:.3f} of the bound [{facts}]")
    return {"max_abs_err": err, "ms": ms, "ms_host_loop": host_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by}


def _graph_ms(fn, reps: int = 100, replays: int = 5) -> float:
    """Device time of one call: ``reps`` calls captured in one CUDA graph,
    the graph replayed ``replays`` times under CUDA events; the median
    replay over ``reps``. The host's launch cost is out of the figure."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):  # warm-up off the capture (one-time set-up)
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return float(np.median(times))


def _sdpa_ms(q, k, v, group: int,
             causal: bool = True) -> tuple[float, float]:
    """One PyTorch call computing the same function, GQA attention (causal
    unless told otherwise), the library's yardstick for the table: (device
    ms, host-loop ms)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = sdpa(q, k, v, is_causal=causal, enable_gqa=True)
    want = sdpa(q, k.repeat_interleave(group, 1), v.repeat_interleave(group, 1),
                is_causal=causal)
    torch.cuda.synchronize()
    assert out.shape == q.shape and torch.isfinite(out.float()).all()
    assert float((out.float() - want.float()).abs().max()) <= 3e-2
    fn = lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True)
    return _graph_ms(fn), _time_ms(fn)


def _serve_events(n: int, seed: int):
    """n events of LocalEngine's default traffic (Poisson, 24 events/s,
    0.5 MB mean, sizes drawn +-30 %: ~32 tokens each)."""
    from repro_torch.data.workloads import PoissonWorkload

    wl = PoissonWorkload(lam=24.0, event_size_mb=0.5)
    rng = np.random.default_rng(seed)
    evs, t = [], 0.0
    while len(evs) < n:
        evs += wl.sample_events(t, t + 10.0, rng)
        t += 10.0
    return evs[:n]


def phase_serve(dev, facts: str) -> dict:
    """StreamEngine on full-width Qwen2-7B: a 640-event backlog in full
    micro-batches, then a short batch; the attention kernel's launches are read around
    exactly this run. Then the kernel path against naive attention on the
    same weights and tokens."""
    from repro_torch.configs import qwen2_7b
    from repro_torch.engine import EngineConfig, StreamEngine
    from repro_torch.kernels import fleet_tick as ft
    from repro_torch.kernels import flash_attention as fa

    cfg = qwen2_7b.CONFIG
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.d_ff, cfg.vocab_size) == (28, 3584, 28, 4, 18944, 152064)
    econf = EngineConfig(compute_dtype="bfloat16", attn_impl="pallas",
                         max_batch_events=32, max_seq=64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = StreamEngine(cfg, seed=0, econf=econf)
    torch.cuda.synchronize()
    assert eng.device.type == dev.type
    n_params = sum(t.numel() for t in _leaves(eng.params))
    print(f"  StreamEngine({cfg.name}, {cfg.num_layers} layers, bf16): "
          f"{n_params} parameters "
          f"drawn on the card in {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    assert n_params == cfg.param_count()
    evs = _serve_events(645, seed=0)
    backlog, short = evs[:640], evs[640:]
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    passes0 = eng.forward_passes
    t_start = time.perf_counter()
    eng.buffer.put(backlog)
    reports = []
    while len(eng.buffer):
        reports.append(eng.process_batch(backlog[-1].arrival_s))
    eng.buffer.put(short)
    reports.append(eng.process_batch(short[-1].arrival_s))
    wall = time.perf_counter() - t_start
    launches, passes = fa.LAUNCHES, eng.forward_passes - passes0
    print(f"  flash_attention launches {launches} over {passes} forward passes "
          f"(expected {cfg.num_layers} each); fleet_tick launches {ft.LAUNCHES}")
    if launches != cfg.num_layers * passes or launches == 0:
        raise AssertionError(f"attention launches {launches} != "
                             f"{cfg.num_layers} x {passes}")
    if ft.LAUNCHES:
        raise AssertionError("fleet_tick launched on the serve path")
    sizes = [r.n_events for r in reports]
    assert sizes == [32] * 20 + [5], sizes
    rows = eng.sink.rows
    assert len(rows) == 645 and len({r["event_key"] for r in rows}) > 1
    toks_out = np.array([r["next_token"] for r in rows])
    assert ((toks_out >= 0) & (toks_out < cfg.vocab_size)).all()
    svc = np.array([r.service_s for r in reports])
    seq_of = lambda r_events: eng._bucket_seq(max(e.tokens for e in r_events))
    batches = [backlog[i:i + 32] for i in range(0, 640, 32)] + [short]
    real_tokens = sum(min(e.tokens, seq_of(b)) for b in batches for e in b)
    padded = sum((1 << int(np.ceil(np.log2(len(b))))) * seq_of(b)
                 for b in batches)
    mem = torch.cuda.max_memory_allocated()
    print(f"  {len(reports)} batches ({sizes[0]} x{len(sizes) - 1} + "
          f"{sizes[-1]}), shapes {sorted(eng._step_cache)}; service "
          f"{svc.sum():.6f} s: {645 / svc.sum():.1f} events/s, "
          f"{real_tokens / svc.sum():.1f} tokens/s ({real_tokens} real of "
          f"{padded} scored tokens); wall {wall:.3f} s with the first calls")
    print(f"  batch service ms: median {np.median(svc[:-1]) * 1e3:.3f} (full "
          f"batches), max {svc.max() * 1e3:.3f}, short batch "
          f"{svc[-1] * 1e3:.3f}; in order: "
          f"{', '.join(f'{x * 1e3:.2f}' for x in svc)}")
    print(f"  padding fraction: {1 - real_tokens / padded:.4f} overall, per "
          f"batch mean {np.mean([r.padding_frac for r in reports]):.4f}; "
          f"jit_compiles {eng.jit_compiles} (first calls, "
          f"{eng.jit_time_s:.3f} s); peak device memory "
          f"{mem / 2**30:.3f} GiB [{facts}]")

    _profile_serve_batch(eng, _serve_events(32, seed=1))
    # the kernel path against plain attention on the same weights and tokens
    # (the last full batch, at its own bucket)
    seq = seq_of(batches[-2])
    toks = torch.from_numpy(eng._tokens_of(batches[-2], seq)).to(dev)
    engine_tok = torch.as_tensor(toks_out[608:640], device=dev)
    _prefill_agreement(eng, cfg, toks, engine_tok)
    return {"launches": launches}


def _profile_serve_batch(eng, events) -> None:
    """One more full micro-batch under torch.profiler (after the launch
    count was read): device busy share and where the device time goes."""
    from torch.profiler import ProfilerActivity, profile

    eng.buffer.put(events)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rep = eng.process_batch(events[-1].arrival_s)
        wall = time.perf_counter() - t0
    assert rep.n_events == len(events) and not rep.compiled
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in rows)
    launches = sum(e.count for e in rows)
    groups = {"attention kernel": 0.0, "matmul (cuBLAS)": 0.0, "other": 0.0}
    for e in rows:
        key = e.key.lower()
        if "attn_kernel" in key:
            groups["attention kernel"] += e.device_time_total
        elif any(w in key for w in ("gemm", "nvjet", "cutlass", "xmma")):
            groups["matmul (cuBLAS)"] += e.device_time_total
        else:
            groups["other"] += e.device_time_total
    print(f"  profiled batch of {rep.n_events}: wall {wall * 1e3:.3f} ms "
          f"(profiler on), service {rep.service_s * 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms ({100 * busy_us / 1e6 / wall:.1f} % of the "
          f"wall), {launches} device launches")
    print("  device time by group: " + ", ".join(
        f"{k} {v / 1e3:.3f} ms ({100 * v / max(busy_us, 1e-9):.1f} %)"
        for k, v in groups.items()))
    for e in sorted(rows, key=lambda e: e.device_time_total,
                    reverse=True)[:12]:
        print(f"    {e.device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:70]}")


def _prefill_agreement(eng, cfg, toks, engine_tok) -> None:
    """forward_prefill's last-position logits with the kernel ("pallas")
    against the plain "naive" and "chunked" attention, on the engine's bf16
    weights and on an f32 copy of the same values.

    In bf16, each attention output is rounded to bf16 once per layer by
    every implementation, and 28 layers carry those one-ulp differences into
    the logits; two plain implementations (chunked vs naive) differ by as
    much. So in bf16 the kernel's distance to naive must stay within
    BF16_DEPTH_FLOOR_X times that floor, and the argmax must agree on every
    row whose naive top-2 margin exceeds twice the floor. In f32 the rounding is gone and the whole model
    is held to F32_DEPTH_TOL."""
    import dataclasses

    from repro_torch.engine.engine import _cast_floats
    from repro_torch.models import forward_prefill

    def run(params, dtype):
        out = {}
        with torch.inference_mode():
            for impl in ("pallas", "naive", "chunked"):
                c = dataclasses.replace(eng.model_cfg, attn_impl=impl,
                                        dtype=dtype)
                logits, state = forward_prefill(params, c, {"tokens": toks},
                                                max_seq=64)
                out[impl] = logits[:, -1].float()
                assert torch.isfinite(out[impl]).all(), (dtype, impl)
                assert out[impl].shape == (toks.shape[0], cfg.vocab_size)
                assert tuple(state.kv_k.shape) == (
                    cfg.num_layers, toks.shape[0], 64, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
                assert torch.isfinite(state.kv_k.float()).all()
        return out

    dist = lambda a, b: float((a - b).abs().max())
    agree = lambda a, b: float((a.argmax(-1) == b.argmax(-1)).float().mean())
    out = run(eng.params, "bfloat16")
    a, b, c = out["pallas"], out["naive"], out["chunked"]
    floor = dist(c, b)
    top2 = b.topk(2, dim=-1).values
    robust = (top2[:, 0] - top2[:, 1]) > 2 * floor
    print(f"  forward_prefill bf16 last-position logits (scale "
          f"{float(b.abs().max()):.3f}): pallas vs naive max_abs "
          f"{dist(a, b):.4e}, chunked vs naive {floor:.4e} (the plain floor; "
          f"ratio {dist(a, b) / max(floor, 1e-30):.3f}, limit "
          f"{BF16_DEPTH_FLOOR_X}); "
          f"argmax agreement pallas/naive {agree(a, b):.4f}, chunked/naive "
          f"{agree(c, b):.4f}; {int(robust.sum())} of {len(robust)} rows with "
          f"a top-2 margin above twice the floor")
    if dist(a, b) > BF16_DEPTH_FLOOR_X * floor:
        raise AssertionError(f"bf16 serve logits: kernel vs naive "
                             f"{dist(a, b):.4e} > {BF16_DEPTH_FLOOR_X} x the "
                             f"plain floor {floor:.4e}")
    if not torch.equal(a.argmax(-1)[robust], b.argmax(-1)[robust]):
        raise AssertionError("bf16 serve logits: the kernel's argmax differs "
                             "from naive on a row with a robust margin")
    same_engine = float((a.argmax(-1) == engine_tok).float().mean())
    print(f"  forward_prefill (pallas) argmax = the engine's sink on "
          f"{same_engine:.4f} of the batch")
    if same_engine != 1.0:
        raise AssertionError("forward_prefill's argmax differs from the "
                             "engine's step on the same tokens")
    params32 = _cast_floats(eng.params, torch.float32)
    out = run(params32, "float32")
    del params32
    a, b, c = out["pallas"], out["naive"], out["chunked"]
    err = dist(a, b)
    ok = bool(((a - b).abs() <= F32_DEPTH_TOL * (1 + b.abs())).all())
    print(f"  forward_prefill f32 (same weights) logits: pallas vs naive "
          f"max_abs {err:.4e}, chunked vs naive {dist(c, b):.4e} "
          f"(rtol=atol={F32_DEPTH_TOL}); argmax agreement {agree(a, b):.4f}")
    if not ok:
        raise AssertionError("f32 serve logits: kernel vs naive out of "
                             "tolerance")


KERNEL_MODULES = ("fleet_tick", "flash_attention", "rwkv6_wkv", "mamba2_ssd",
                  "lasso_cd", "fleet_scan")


def _kernel_mods():
    import importlib

    return {n: importlib.import_module(f"repro_torch.kernels.{n}")
            for n in KERNEL_MODULES}


def _zero_counts() -> None:
    for mod in _kernel_mods().values():
        mod.LAUNCHES = 0


def _counts() -> dict:
    return {n: mod.LAUNCHES for n, mod in _kernel_mods().items()}


def _scaled_err(got, want) -> tuple[float, float]:
    """(max |got - want|, the scale max(1, max |want|)), in f32."""
    a, b = got.float(), want.float()
    if not torch.isfinite(a).all():
        raise AssertionError("non-finite kernel output")
    return float((a - b).abs().max()), max(1.0, float(b.abs().max()))


def _wkv_inputs(B, H, S, hd, dtype, dev, seed, logw="clip"):
    """Model-layout (B, S, H, hd) operands: r, k, v ~ N(0, 1) in ``dtype``;
    logw f32 log-uniform over the model's whole clip range [-8, -1e-6]
    (layers.py clamps it there) with both ends present, or all at one end
    (``logw`` = -8.0 or -1e-6); u ~ N(0, 1) f32."""
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *shape: torch.randn(shape, generator=g, device=dev)
    r, k, v = (mk(B, S, H, hd).to(dtype) for _ in range(3))
    if logw == "clip":
        lo, hi = np.log(1e-6), np.log(8.0)
        lw = -torch.exp(lo + (hi - lo) * torch.rand(
            (B, S, H, hd), generator=g, device=dev))
        lw.view(-1)[0], lw.view(-1)[-1] = -8.0, -1e-6
    else:
        lw = torch.full((B, S, H, hd), float(logw), device=dev)
    return r, k, v, lw, mk(H, hd)


def phase_wkv(dev, facts: str) -> dict:
    """The wkv kernel against the plain chunked wkv6_chunked (every shape)
    and the sequential rwkv6_wkv_ref (shorter S), on the same tensors, in
    the model layout the path gives it (strided (B,H,S,hd) views); then
    CUDA-event times at the main shape beside the bound."""
    from repro_torch.kernels import rwkv6_wkv as wkv
    from repro_torch.models.layers import wkv6_chunked

    bf16, f32 = torch.bfloat16, torch.float32
    bhsd = lambda *a: [x.transpose(1, 2) for x in a]
    # (label, B, H, S, hd, chunk, dtype, logw, sequential oracle too)
    shapes = [
        ("rwkv6-7b-train", 4, 64, 4096, 64, 32, bf16, "clip", False),
        ("rwkv6-7b-train", 4, 64, 4096, 64, 64, bf16, "clip", False),
        ("rwkv6-7b-train", 4, 64, 4096, 64, 32, f32, "clip", False),
        ("rwkv6-7b-train", 4, 64, 4096, 64, 64, f32, "clip", False),
        ("ragged", 2, 8, 1000, 64, 32, bf16, "clip", True),
        ("ragged", 2, 8, 1000, 64, 64, f32, "clip", True),
        ("S<chunk", 3, 4, 20, 64, 64, f32, "clip", True),
        ("logw=-8", 1, 8, 512, 64, 32, f32, -8.0, True),
        ("logw=-1e-6", 1, 8, 512, 64, 32, f32, -1e-6, True),
        ("reduced-hd32", 2, 4, 300, 32, 32, f32, "clip", True),
    ]
    main = None
    for i, (label, B, H, S, hd, ch, dt, lwr, seq) in enumerate(shapes):
        r, k, v, lw, u = _wkv_inputs(B, H, S, hd, dt, dev, seed=i, logw=lwr)
        o, sfin = wkv.rwkv6_wkv(*bhsd(r, k, v, lw), u, chunk=ch)
        oc, sc = wkv6_chunked(r, k, v, lw, u, chunk=ch)
        torch.cuda.synchronize()
        checks = [("chunked", o, oc.transpose(1, 2).to(dt), sfin, sc)]
        if seq:
            oq, sq = wkv.rwkv6_wkv_ref(*bhsd(r, k, v, lw), u)
            checks.append(("sequential", o, oq, sfin, sq))
        for name, a, b, sa, sb in checks:
            err, scale = _scaled_err(a, b)
            serr, sscale = _scaled_err(sa, sb)
            tol = WKV_TOL[dt]
            print(f"  {label} B={B} H={H} S={S} hd={hd} chunk={ch} "
                  f"{str(dt).removeprefix('torch.')} vs {name}: o max_abs "
                  f"{err:.3e} (scale {scale:.2f}, scaled {err / scale:.3e}, "
                  f"tol {tol}); S_fin max_abs {serr:.3e} (scale {sscale:.2f},"
                  f" scaled {serr / sscale:.3e}, tol {WKV_TOL[f32]})")
            if err / scale > tol or serr / sscale > WKV_TOL[f32]:
                raise AssertionError(f"wkv kernel vs {name} out of tolerance "
                                     f"at {label} chunk {ch} {dt}")
        # chunk is the f32 kernel's staging tile; the bf16 kernel has its own
        # (MMA_CHUNK), so it is timed once
        if label != "rwkv6-7b-train" or (dt == bf16 and ch != 32):
            continue
        run = lambda: wkv.rwkv6_wkv(*bhsd(r, k, v, lw), u, chunk=ch)
        ms, host_ms = _graph_ms(run, reps=20), _time_ms(run, reps=20,
                                                         warmup=2)
        plain_ms = _time_ms(lambda: wkv6_chunked(r, k, v, lw, u, chunk=ch),
                            reps=3, warmup=1)
        nbytes, flops = wkv.wkv_cost(B, H, S, hd, itemsize=r.element_size())
        peak = BF16_OPS_S if dt == bf16 else F32_OPS_S
        bound_ms, by = _bound(nbytes, flops, peak)
        print(f"    kernel device {ms:.4f} ms (host loop {host_ms:.4f} ms), "
              f"plain wkv6_chunked {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"by {by} ({nbytes / 1e9:.4f} GB, {flops / 1e9:.3f} GFLOP at "
              f"{peak / 1e12:.0f} TFLOP/s), {bound_ms / ms:.3f} of the bound "
              f"[{facts}]")
        if main is None:
            n = B * H * S
            dv = min(hd, wkv.MMA_VALUE_COLUMNS)
            splits = hd // dv
            print(f"    bf16 kernel: {B * H * splits} blocks of {dv // 8} "
                  f"warps, {wkv.mma_smem_bytes(hd, dv)} B of dynamic shared "
                  f"memory a block (the launch refuses any other size)")
            print(f"    exp count: the kernel {n * hd * splits} (one per token "
                  f"and key channel in each of {splits} value-column "
                  f"block(s); the decay factors are running products); the "
                  f"chunked form at chunk {ch} "
                  f"{n // ch * (ch * (ch - 1) // 2 + 3 * ch) * hd} (the "
                  f"C(C-1)/2 x hd intra-chunk decays and 3 C x hd more per "
                  f"chunk); no PyTorch call computes this function "
                  f"(library: none)")
            main = {"max_abs_err": err, "ms": ms, "ms_host_loop": host_ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": by, "library_ms": None}
        del r, k, v, lw, o, oc, sfin, sc
    return main


def _rwkv_walk(params, cfg, tokens, impl: str, check: bool = False):
    """The backbone walked as lm._rwkv_block composes its layers, with
    rwkv6_time_mix(..., impl=impl); with ``check``, each layer's time mix
    is also run with impl="chunked" on the same input and the scaled
    distance kept. Returns (final hidden states, per-layer distances)."""
    from repro_torch.models import layers as L
    from repro_torch.models.lm import _layers

    x = params["embed"][tokens]
    dists = []
    for p in _layers(params["layers"], cfg):
        hn = L.rmsnorm(p["tm_norm"], x, cfg.norm_eps)
        h, _ = L.rwkv6_time_mix(p, cfg, hn, impl=impl)
        if check:
            h_ref, _ = L.rwkv6_time_mix(p, cfg, hn, impl="chunked")
            err, scale = _scaled_err(h, h_ref)
            dists.append(err / scale)
            del h_ref
        x = x + h
        h, _ = L.rwkv6_channel_mix(p, cfg, L.rmsnorm(p["cm_norm"], x,
                                                     cfg.norm_eps))
        x = x + h
    return x, dists


def _masked_loss(logits, batch):
    from repro_torch.utils import softmax_cross_entropy

    ce = softmax_cross_entropy(logits, batch["labels"])
    return float((ce * batch["mask"]).sum() / batch["mask"].sum())


def _profile_pass(fn) -> None:
    """One call under torch.profiler: wall, device busy share, launches,
    and the device time by group and by kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in rows)
    groups = {"wkv kernel": 0.0, "matmul (cuBLAS)": 0.0, "other": 0.0}
    for e in rows:
        key = e.key.lower()
        if "wkv_kernel" in key:
            groups["wkv kernel"] += e.device_time_total
        elif any(w in key for w in ("gemm", "nvjet", "cutlass", "xmma")):
            groups["matmul (cuBLAS)"] += e.device_time_total
        else:
            groups["other"] += e.device_time_total
    print(f"  profiled pass: wall {wall:.3f} s (profiler on), device busy "
          f"{busy_us / 1e6:.3f} s ({100 * busy_us / 1e6 / wall:.1f} %), "
          f"{sum(e.count for e in rows)} device launches; by group: " +
          ", ".join(f"{k} {v / 1e3:.3f} ms ({100 * v / max(busy_us, 1e-9):.1f}"
                    f" %)" for k, v in groups.items()))
    for e in sorted(rows, key=lambda e: e.device_time_total,
                    reverse=True)[:10]:
        print(f"    {e.device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:70]}")


def phase_rwkv(dev, facts: str, seed: int = 0) -> dict:
    """The RWKV-6 path at full rwkv6-7b width (see the module docstring),
    with weights and batch drawn from ``seed``."""
    from repro_torch.configs import rwkv6_7b
    from repro_torch.data.synthetic import make_batch
    from repro_torch.engine.engine import _cast_floats
    from repro_torch.models import lm

    cfg = rwkv6_7b.CONFIG
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.ssm_head_dim,
            cfg.d_ff, cfg.vocab_size, cfg.dtype, cfg.wkv_chunk) == (
        32, 4096, 64, 64, 14336, 65536, "bfloat16", 32)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  before the model: {torch.cuda.memory_allocated() / 2**30:.3f} "
          f"GiB allocated")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg,
                            torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"  {cfg.name}: {cfg.num_layers} layers, bf16, {n_params} parameters "
          f"drawn on the card in {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    B, S = 4, 4096
    batch = make_batch(cfg, B, S, seed=seed, device=dev)
    toks = batch["tokens"]
    with torch.inference_mode():
        # forward_train, the reference's route: the plain chunked wkv
        walls = []
        for _ in range(2):  # the first call carries one-time set-up
            _zero_counts()
            t0 = time.perf_counter()
            loss_c, _ = lm.forward_train(params, cfg, batch)
            loss_c = float(loss_c)
            walls.append(time.perf_counter() - t0)
            train_counts = _counts()
        print(f"  forward_train (chunked wkv) loss {loss_c:.6f}; wall "
              f"{walls[1]:.3f} s ({walls[0]:.3f} s first), "
              f"{B * S / walls[1]:.1f} tokens/s; kernel launches "
              f"{train_counts}")
        if any(train_counts.values()):
            raise AssertionError("forward_train launched a kernel")
        _profile_pass(lambda: lm.forward_train(params, cfg, batch))
        # the kernel route: counts read around exactly this pass
        _zero_counts()
        x_k, dists = _rwkv_walk(params, cfg, toks, "pallas", check=True)
        torch.cuda.synchronize()
        counts = _counts()
        print(f"  kernel walk (rwkv6_time_mix impl=pallas): launches {counts} "
              f"(expected {cfg.num_layers} rwkv6_wkv); time mix vs chunked "
              f"per layer, scaled max_abs: max {max(dists):.3e} (layer "
              f"{int(np.argmax(dists))}), mean {np.mean(dists):.3e} (tol "
              f"{WKV_TOL[torch.bfloat16]})")
        if counts != {**{n: 0 for n in KERNEL_MODULES},
                      "rwkv6_wkv": cfg.num_layers}:
            raise AssertionError(f"kernel walk launches {counts}")
        if max(dists) > WKV_TOL[torch.bfloat16]:
            raise AssertionError("a layer's time mix: kernel vs chunked out "
                                 "of tolerance")
        logits_k = lm._logits(params, cfg, x_k)
        del x_k
        loss_k = _masked_loss(logits_k, batch)
        logits_c = lm._logits(params, cfg, lm._backbone(
            params, cfg, params["embed"][toks])[0])
        loss_cc = _masked_loss(logits_c, batch)
        cfg64 = dataclasses.replace(cfg, wkv_chunk=64)
        logits_64 = lm._logits(params, cfg64, lm._backbone(
            params, cfg64, params["embed"][toks])[0])
        loss_64 = _masked_loss(logits_64, batch)
        dist = lambda a, b: float((a.float() - b.float()).abs().max())
        d_k, floor = dist(logits_k, logits_c), dist(logits_64, logits_c)
        top2 = logits_c.float().topk(2, dim=-1).values
        robust = (top2[..., 0] - top2[..., 1]) > 2 * floor
        agree = lambda a, b: float((a.argmax(-1) == b.argmax(-1))
                                   .float().mean())
        same_robust = bool(torch.equal(logits_k.argmax(-1)[robust],
                                       logits_c.argmax(-1)[robust]))
        print(f"  bf16 logits (scale {float(logits_c.float().abs().max()):.3f}"
              f", {B * S} positions): kernel route vs forward_train's chunked "
              f"route max_abs {d_k:.4e}; chunk 64 vs chunk 32 {floor:.4e} (the "
              f"plain floor; ratio {d_k / max(floor, 1e-30):.3f}, limit "
              f"{BF16_DEPTH_FLOOR_X}); argmax agreement "
              f"{agree(logits_k, logits_c):.4f} (chunk 64 vs 32: "
              f"{agree(logits_64, logits_c):.4f}), equal on "
              f"all {int(robust.sum())} rows with a top-2 margin above twice "
              f"the floor: {same_robust}")
        print(f"  bf16 loss: kernel route {loss_k:.6f}, forward_train "
              f"{loss_c:.6f} (recomputed from the chunked route's logits: "
              f"{loss_cc:.6f}), chunk 64 {loss_64:.6f}; relative difference "
              f"{abs(loss_k - loss_c) / loss_c:.3e} (tol {RWKV_LOSS_RTOL})")
        del logits_k, logits_c, logits_64, top2, robust
        if d_k > BF16_DEPTH_FLOOR_X * floor or not same_robust:
            raise AssertionError("bf16 rwkv logits: the kernel route is "
                                 "farther from the chunked route than the "
                                 "plain floor allows")
        if abs(loss_k - loss_c) > RWKV_LOSS_RTOL * abs(loss_c) or \
                abs(loss_cc - loss_c) > 1e-6 * abs(loss_c):
            raise AssertionError("bf16 rwkv loss out of tolerance")
        # the path's speed: one timed pass and one profiled pass
        _zero_counts()
        t0 = time.perf_counter()
        x_k, _ = _rwkv_walk(params, cfg, toks, "pallas")
        loss_t = _masked_loss(lm._logits(params, cfg, x_k), batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if _counts()["rwkv6_wkv"] != cfg.num_layers:
            raise AssertionError("timed kernel pass: launches != 32")
        del x_k
        print(f"  kernel route forward + loss: wall {wall:.3f} s, "
              f"{B * S / wall:.1f} tokens/s (loss {loss_t:.6f}); peak device "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
              f"[{facts}]")
        _profile_pass(lambda: _masked_loss(lm._logits(
            params, cfg, _rwkv_walk(params, cfg, toks, "pallas")[0]), batch))
        # forward_prefill's ssm branch: a state, so wkv6_chunked, no kernel
        _zero_counts()
        lp, st = lm.forward_prefill(params, cfg, {"tokens": toks},
                                    max_seq=S)
        torch.cuda.synchronize()
        pre_counts = _counts()
        ls = lm.score_last(params, cfg, toks)
        err, scale = _scaled_err(lp, ls)
        print(f"  forward_prefill (ssm branch): last-position logits vs "
              f"score_last (chunked backbone) max_abs {err:.3e} (scale "
              f"{scale:.2f}, tol {WKV_TOL[torch.bfloat16]}), bitwise "
              f"{bool(torch.equal(lp, ls))}; kernel launches {pre_counts} "
              f"(with a state the route falls back to wkv6_chunked, as in the "
              f"reference); state pos {int(st.pos)}, wkv state "
              f"{tuple(st.ssm['wkv'].shape)} finite "
              f"{bool(torch.isfinite(st.ssm['wkv']).all())}")
        if any(pre_counts.values()) or err / scale > WKV_TOL[torch.bfloat16] \
                or not torch.isfinite(st.ssm["wkv"]).all():
            raise AssertionError("forward_prefill (ssm) check failed")
        del lp, st, ls
    mem_bf16 = torch.cuda.max_memory_allocated()
    # the whole model in f32 on a copy of the same weights, at 2 x 2048
    params32 = _cast_floats(params, torch.float32)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    b32 = make_batch(cfg32, 2, 2048, seed=1, device=dev)
    with torch.inference_mode():
        _zero_counts()
        x_k, _ = _rwkv_walk(params32, cfg32, b32["tokens"], "pallas")
        n32 = _counts()["rwkv6_wkv"]
        a = lm._logits(params32, cfg32, x_k)
        del x_k
        loss32_c, _ = lm.forward_train(params32, cfg32, b32)
        b = lm._logits(params32, cfg32, lm._backbone(
            params32, cfg32, params32["embed"][b32["tokens"]])[0])
        ok = bool(((a - b).abs() <= F32_DEPTH_TOL * (1 + b.abs())).all())
        loss32_k = _masked_loss(a, b32)
        print(f"  f32 copy, 2 x 2048: logits kernel route vs chunked max_abs "
              f"{dist(a, b):.4e} (scale {float(b.abs().max()):.3f}, rtol=atol "
              f"{F32_DEPTH_TOL}); loss {loss32_k:.6f} vs forward_train "
              f"{float(loss32_c):.6f}; rwkv6_wkv launches {n32}")
        if not ok or n32 != cfg.num_layers or \
                abs(loss32_k - float(loss32_c)) > 1e-4 * float(loss32_c):
            raise AssertionError("f32 rwkv logits or loss out of tolerance")
    del params32, a, b
    print(f"  peak device memory: {mem_bf16 / 2**30:.3f} GiB (bf16 model "
          f"and checks), {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
          f"overall with the f32 copy")
    return {"launches": counts["rwkv6_wkv"]}


def _ssd_inputs(B, nh, S, hd, ns, dtype, dev, seed, loga=None):
    """Operands as mamba2_mix feeds its scan: dt = softplus(N(0, 1)) per
    (token, head), A = -exp(U(0, log 16)) per head (Mamba2's A in [1, 16]),
    x = N(0, 1) dt (the Δ-scaled input), loga = dt A (f32), or every step
    at ``loga`` (0: no decay; -80: each step all but wipes the state), B
    and C ~ N(0, 1); x, B and C in ``dtype``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *shape: torch.randn(shape, generator=g, device=dev)
    dt = torch.nn.functional.softplus(mk(B, nh, S))
    A = -torch.exp(np.log(16.0) * torch.rand((nh,), generator=g, device=dev))
    x = (mk(B, nh, S, hd) * dt[..., None]).to(dtype)
    la = dt * A[None, :, None] if loga is None else \
        torch.full((B, nh, S), float(loga), device=dev)
    return x, mk(B, S, ns).to(dtype), mk(B, S, ns).to(dtype), la


def _ssd_launch(B, nh, hd, ns, dtype) -> None:
    """The kernel's launch at one shape: the wrapper's geometry, the card's
    occupancy and registers, and ptxas's line for the instantiation."""
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import mamba2_ssd as ssd

    geo = ssd.launch_geometry(B, nh, hd, ns, torch.empty((), dtype=dtype)
                              .element_size())
    card = ssd.card_geometry(dtype, hd, ns)
    waves = geo["blocks"] / (torch.cuda.get_device_properties(0)
                             .multi_processor_count * card["blocks_per_sm"])
    name = str(dtype).removeprefix("torch.")
    print(f"    {name} kernel: grid {geo['grid']} = {geo['blocks']} blocks of "
          f"{geo['warps']} warps, {geo['smem']} B of dynamic shared memory a "
          f"block, {card['blocks_per_sm']} blocks an SM on the card (at "
          f"least {geo['min_blocks_per_sm']} by __launch_bounds__, "
          f"{geo['smem_blocks_per_sm']} by shared memory): {waves:.3f} "
          f"waves; {card['registers']} registers, {card['local_bytes']} B "
          f"of local memory a thread")
    tag = {"float32": "IfLi", "bfloat16": "I13__nv_bfloat16Li"}[name]
    for line in _ptxas_summary(kbuild.BUILD_LOGS.get(ssd.SOURCE, "")):
        if f"ssd_kernel{tag}{hd}ELi{ns}E" in line:
            print(f"    ptxas: {line}")


def phase_ssd(dev, facts: str) -> dict:
    """The SSD kernel through ops.mamba2_ssd (its path, counted around the
    main-shape call), then against the plain chunked and sequential
    versions on the same tensors, its launch, and device times (CUDA
    graphs) beside the bound."""
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import ops

    bf16, f32 = torch.bfloat16, torch.float32
    B, nh, S, hd, ns, ch = 4, 80, 4096, 64, 64, 128
    x, bm, cm, la = _ssd_inputs(B, nh, S, hd, ns, f32, dev, seed=0)
    torch.cuda.synchronize()
    _zero_counts()
    y = ops.mamba2_ssd(x, bm, cm, la, chunk=ch)
    torch.cuda.synchronize()
    counts = _counts()
    print(f"  ops.mamba2_ssd at zamba2-2.7b's mixer shape: launches {counts} "
          f"(expected 1 mamba2_ssd); y {tuple(y.shape)} finite "
          f"{bool(torch.isfinite(y).all())}")
    if counts != {**{n: 0 for n in KERNEL_MODULES}, "mamba2_ssd": 1}:
        raise AssertionError(f"ssd path launches {counts}")
    # the tile is the kernel's own: chunk does not change the result
    same = torch.equal(y, ssd.mamba2_ssd(x, bm, cm, la, chunk=5))
    print(f"  chunk 128 and chunk 5 bitwise equal: {same}")
    if not same:
        raise AssertionError("ssd kernel output depends on chunk")
    for dt in (f32, bf16):
        _ssd_launch(B, nh, hd, ns, dt)
    del x, bm, cm, la, y
    # (label, B, nh, S, hd, ns, chunk, dtype, loga, sequential oracle too)
    shapes = [
        ("zamba2-mixer", 4, 80, 4096, 64, 64, 128, f32, None, False),
        ("zamba2-mixer", 4, 80, 4096, 64, 64, 64, f32, None, False),
        ("zamba2-mixer", 4, 80, 4096, 64, 64, 128, bf16, None, False),
        ("ragged", 2, 8, 1000, 64, 64, 128, f32, None, True),
        ("ragged", 2, 8, 1000, 64, 64, 128, bf16, None, True),
        ("S<chunk", 3, 4, 100, 64, 64, 128, f32, None, True),
        ("ns128", 1, 4, 300, 64, 128, 64, f32, None, True),
        ("loga=-80", 2, 8, 1000, 64, 64, 128, f32, -80.0, True),
        ("loga=0", 2, 8, 1000, 64, 64, 128, f32, 0.0, True),
    ]
    main = None
    for i, (label, B, nh, S, hd, ns, ch, dt, lga, seq) in enumerate(shapes):
        x, bm, cm, la = _ssd_inputs(B, nh, S, hd, ns, dt, dev, seed=i + 1,
                                    loga=lga)
        y = ssd.mamba2_ssd(x, bm, cm, la, chunk=ch)
        yc = ssd.mamba2_ssd_chunked(x, bm, cm, la, chunk=ch)
        torch.cuda.synchronize()
        checks = [("chunked", yc)]
        if seq:
            checks.append(("sequential", ssd.mamba2_ssd_ref(x, bm, cm, la)))
        for name, want in checks:
            err, scale = _scaled_err(y, want)
            print(f"  {label} B={B} nh={nh} S={S} hd={hd} ns={ns} chunk={ch} "
                  f"{str(dt).removeprefix('torch.')} vs {name}: max_abs "
                  f"{err:.3e} (scale {scale:.2f}, scaled {err / scale:.3e}, "
                  f"tol {SSD_TOL[dt]})")
            if err / scale > SSD_TOL[dt]:
                raise AssertionError(f"ssd kernel vs {name} out of tolerance "
                                     f"at {label} chunk {ch} {dt}")
        if label != "zamba2-mixer":
            continue
        run = lambda: ssd.mamba2_ssd(x, bm, cm, la, chunk=ch)
        ms, host_ms = _graph_ms(run, reps=20), _time_ms(run, reps=20,
                                                         warmup=2)
        plain_ms = _time_ms(lambda: ssd.mamba2_ssd_chunked(x, bm, cm, la,
                                                           chunk=ch),
                            reps=5, warmup=1)
        nbytes, flops = ssd.ssd_cost(B, nh, S, hd, ns,
                                     itemsize=x.element_size())
        bound_ms, by = _bound(nbytes, flops, TF32_OPS_S)
        print(f"    kernel device {ms:.4f} ms (host loop {host_ms:.4f} ms), "
              f"plain chunked {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by "
              f"{by} ({nbytes / 1e9:.4f} GB, {flops / 1e9:.3f} GFLOP at "
              f"{TF32_OPS_S / 1e12:.0f} TFLOP/s TF32), {bound_ms / ms:.3f} "
              f"of the bound [{facts}]")
        if main is None:
            geo = ssd.launch_geometry(B, nh, hd, ns, x.element_size())
            subs = -(-S // ssd.STAGED) * ssd.STAGED // ssd.SUB
            exps = geo["blocks"] * subs * (ssd.SUB * ssd.SUB + 2 * ssd.SUB)
            print(f"    exp count: the kernel {exps} (each block: the 16 x 16 "
                  f"score decays and 2 per token of each sub-chunk); no "
                  f"PyTorch call computes this function (library: none)")
            main = {"max_abs_err": err, "ms": ms, "ms_host_loop": host_ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": by, "library_ms": None}
        del x, bm, cm, la, y, yc
    return {"launches": counts["mamba2_ssd"], **main}


def _lasso_case(A, b, lams, n: int, label: str, facts: str,
                reps: int = 3) -> dict:
    """lasso_cd on the card from w0 = 0 against its CPU mirror (bitwise:
    the same elementwise f32 steps in the same order, which also counts the
    epochs run and the updates that moved) and its plain version (the
    plain loop runs on the host over a copy: scaled error, entry order);
    the kernel's device time (CUDA events over ``reps`` launches), ns an
    update run, the plain version's time and the bound of this run's work."""
    from repro_torch.core.lasso import entry_order
    from repro_torch.kernels import lasso_cd as lc

    p = A.shape[0]
    w0 = torch.zeros(p, device=A.device)
    lt = torch.as_tensor(lams, dtype=torch.float32, device=A.device)
    run = lambda: lc.lasso_cd(A, b, w0, lt, float(n), epochs=60)
    got = run()
    torch.cuda.synchronize()
    mirror, cnt = lc.lasso_cd_mirror(A, b, w0, lt, float(n), epochs=60)
    runs, upd, moves = cnt["epochs"], cnt["updates"], cnt["moves"]
    bitwise = torch.equal(got, mirror)
    t0 = time.perf_counter()
    want = lc.lasso_cd_ref(A, b, w0, lt, float(n), epochs=60)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err, scale = _scaled_err(got, want)
    g, w = got.cpu().numpy(), want.cpu().numpy()
    order_k, order_p = entry_order(g, lams)[0], entry_order(w, lams)[0]
    ms = _time_ms(run, reps=reps, warmup=1)
    nbytes, flops = lc.cd_cost(p, len(lams), upd, moves, cnt["terms"])
    bound_ms, by = _bound(nbytes, flops, F32_OPS_S)
    print(f"  lasso_cd {label} p={p} ({'shared' if lc.a_in_smem(p) else 'global'}"
          f" A, c in {'registers' if p <= 32 * lc.MAX_REG_CHUNKS else 'shared'}"
          f") n_lam={len(lams)} epochs=60: bitwise equal to the mirror "
          f"{bitwise}; vs plain max_abs {err:.3e} (scale {scale:.3f}, scaled "
          f"{err / scale:.3e}, tol {LASSO_TOL}); entry order equal "
          f"{order_k == order_p} ({len(order_k)} features, first "
          f"{order_k[:6]})")
    print(f"    kernel device {ms:.3f} ms, plain (host loop over a CPU copy) "
          f"{plain_ms:.1f} ms, bound {bound_ms * 1e3:.3f} us by {by} "
          f"({nbytes / 1e6:.3f} MB, {flops / 1e9:.4f} GFLOP), "
          f"{bound_ms / ms:.2e} of the bound; the chain: {runs} epochs run "
          f"of {60 * len(lams)}, {upd} updates ({moves} moved) in "
          f"{cnt['rounds']} rounds, "
          f"{ms * 1e6 / upd:.1f} ns an update, {ms * 1e6 / cnt['rounds']:.1f}"
          f" ns a round [{facts}]")
    if not bitwise:
        raise AssertionError(f"lasso_cd differs from its mirror at {label}")
    if err / scale > LASSO_TOL:
        raise AssertionError(f"lasso_cd vs plain out of tolerance at {label}")
    if order_k != order_p:
        raise AssertionError(f"lasso_cd entry order differs at {label}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": None}


def _planted_levers(n: int, levers: int, seed: int):
    """Integer lever settings with four effective levers, one quadratic."""
    rng = np.random.default_rng(seed)
    R = rng.integers(0, 10, (n, levers)).astype(float)
    y = 0.8 * R[:, 3] - 0.5 * R[:, 17] + 0.03 * R[:, 40] ** 2 \
        + 0.2 * R[:, 60] + 0.5 * rng.standard_normal(n)
    return R, np.log(y - y.min() + 1.0)


def _lasso_design(R, y, dev, n_lambdas: int = 60):
    """The path's inputs as ``rank_levers`` builds them: normalised levers
    and their squares, the centred target, the lambda grid."""
    from repro_torch.core import lasso as lasso_mod

    Z, _, _ = lasso_mod.normalise_levers(R)
    X, _ = lasso_mod.polynomial_features(Z, [str(i) for i in range(R.shape[1])])
    A, b, lams = lasso_mod.path_inputs(X, y, device=dev)
    return A, b, lams[:n_lambdas]


def phase_tuner(dev, facts: str) -> dict:
    """lasso_cd against its plain version, then AutoTuner's collect ->
    analyse -> tune over the 80-cluster fleet and a serial SimCluster, with
    the launches of both kernels counted around it."""
    from repro_torch.core import AutoTuner, Configurator
    from repro_torch.engine import FleetEnv, SimCluster
    from repro_torch.kernels import fleet_tick as ft
    from repro_torch.kernels import lasso_cd as lc

    R, y = _planted_levers(1200, 109, seed=0)
    row = _lasso_case(*_lasso_design(R, y, dev), 1200, "planted", facts)
    R, y = _planted_levers(600, 150, seed=1)
    _lasso_case(*_lasso_design(R, y, dev, n_lambdas=6), 600, "planted", facts,
                reps=1)

    N, S, W = 80, 5, 6
    env = FleetEnv.heterogeneous(N, seed=0, backend="torch", mix=MIX)
    assert env.device.type == "cuda" and env.n_nodes == 10
    assert len(env.lever_specs) == 109 and len(env.metric_names) == 90
    tuner = AutoTuner(env, seed=0, window_s=240.0, top_levers=8)
    assert tuner.device.type == "cuda"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    expected = {n: 0 for n in KERNEL_MODULES}

    def check(stage: str, fleet_tick: int, lasso: int) -> None:
        expected["fleet_tick"] += fleet_tick
        expected["lasso_cd"] += lasso
        got = _counts()
        print(f"    launches after {stage}: {got}")
        if got != expected:
            raise AssertionError(f"{stage}: launches {got} != {expected}")

    rounds = -(-1200 // N)
    t0 = time.perf_counter()
    tuner.collect(1200, windows_per_cluster=W)
    torch.cuda.synchronize()
    t_collect = time.perf_counter() - t0
    print(f"  collect(1200) over N={N}: {t_collect:.3f} s, "
          f"{1200 / t_collect:.1f} windows/s ({rounds} rounds, guard "
          f"exhausted {tuner.guard_exhausted}) [{facts}]")
    check("collect (a stabilisation and a window a round)", 2 * rounds, 0)
    mets, levers = tuner.analyse()
    sp = tuner.analyse_s
    sel = tuner.selection
    print(f"  analyse: {sp['total']:.3f} s (FA {sp['fa']:.3f}, k-means "
          f"{sp['kmeans']:.3f}, Lasso {sp['lasso']:.3f}) [{facts}]")
    print(f"  metrics: reduction {sel.reduction:.4f}, {sel.n_factors} factors, "
          f"k={sel.k}: {mets}")
    print(f"  ranked levers: {levers}")
    check("analyse", 0, 1)
    if not 3 <= sel.k <= 12:
        raise AssertionError(f"selection.k = {sel.k} outside 3..12")

    env.reset()
    base = float(np.mean([w.p99_ms for w in env.observe(300.0)]))
    check("the default's window", 1, 0)
    cfgr = tuner.build_configurator(steps_per_episode=S, window_s=240.0,
                                    f_exploit=0.8, device_loop="on")
    w0 = {k: v.detach().clone() for k, v in cfgr.agent.params.items()}
    t0 = time.perf_counter()
    for _ in range(3):
        cfgr.run_update()
    torch.cuda.synchronize()
    t_fused = time.perf_counter() - t0
    check("3 fused run_updates", 1 + 3 * S, 0)
    host = Configurator(env, mets, levers, device_loop="off",
                        steps_per_episode=S, window_s=240.0, seed=1)
    h0 = {k: v.detach().clone() for k, v in host.agent.params.items()}
    t0 = time.perf_counter()
    host.run_update()
    torch.cuda.synchronize()
    t_host = time.perf_counter() - t0
    check("1 host-loop fleet update", 1 + S, 0)
    print(f"  tune: 3 fused updates {3 * N * S} windows in {t_fused:.3f} s = "
          f"{3 * N * S / t_fused:.1f} windows/s (the first carries one-time "
          f"set-up); host fleet loop {N * S} windows in {t_host:.3f} s = "
          f"{N * S / t_host:.1f} windows/s [{facts}]")

    ser = SimCluster(seed=0)
    assert ser.device.type == "cuda"
    stuner = AutoTuner(ser, seed=0, window_s=240.0, top_levers=8)
    t0 = time.perf_counter()
    stuner.collect(120)
    torch.cuda.synchronize()
    t_ser = time.perf_counter() - t0
    check("serial collect(120)", 2 * 120, 0)
    smets, slevers = stuner.analyse()
    check("serial analyse", 0, 1)
    scfgr = stuner.build_configurator(steps_per_episode=S,
                                      episodes_per_update=4, window_s=240.0)
    s0 = {k: v.detach().clone() for k, v in scfgr.agent.params.items()}
    t0 = time.perf_counter()
    scfgr.run_update()
    torch.cuda.synchronize()
    t_stune = time.perf_counter() - t0
    check("serial host-loop update", 1 + 4 * S * 2, 0)
    counts = _counts()
    mem = torch.cuda.max_memory_allocated()
    print(f"  serial SimCluster: collect(120) {t_ser:.3f} s = "
          f"{120 / t_ser:.1f} windows/s; analyse {stuner.analyse_s['total']:.3f}"
          f" s (Lasso {stuner.analyse_s['lasso']:.3f}); 1 update of 20 steps "
          f"{t_stune:.3f} s; k={stuner.selection.k}, levers {slevers} "
          f"[{facts}]")
    for name, c, p0 in (("fused", cfgr, w0), ("host fleet", host, h0),
                        ("serial", scfgr, s0)):
        r = np.array([x.reward for x in c.history])
        p = np.array([x.p99_ms for x in c.history])
        if not (np.isfinite(r).all() and np.isfinite(p).all() and (p > 0).all()):
            raise AssertionError(f"{name}: non-finite reward or p99")
        moved = [k for k, v in c.agent.params.items()
                 if not torch.equal(v.detach(), p0[k])]
        if not moved:
            raise AssertionError(f"{name}: policy parameters did not move")
        print(f"  {name}: {len(r)} steps, reward median {np.median(r):.4f}, "
              f"p99 median {np.median(p):.1f} ms, params moved {moved}")
    best = min(x.p99_ms for x in cfgr.history + host.history)
    print(f"  best p99 {best:.1f} ms against the default's {base:.1f} ms "
          f"(fleet mean), {best / base:.4f}; peak device memory "
          f"{mem / 2**20:.1f} MiB")

    # what a collect round spends on the host per cluster (after the count
    # was read): the 80 metric rows read one (N, nodes, 90) copy of the
    # window, the 80 target means each draw a latency sample on the host
    windows = env.observe(240.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = [tuner._metric_row(w) for w in windows]
    t_rows = time.perf_counter() - t0
    t0 = time.perf_counter()
    lats = [w.latencies_ms for w in windows]
    t_lat = time.perf_counter() - t0
    print(f"  a round's host reads at N={N}: metric rows {t_rows * 1e3:.2f} ms "
          f"({len(rows[0])} metrics each), latency samples {t_lat * 1e3:.2f} "
          f"ms ({np.mean([x.size for x in lats]):.0f} events each), of "
          f"{t_collect / rounds * 1e3:.2f} ms a collect round [{facts}]")

    # the Lasso on the sweep's own matrix, kernel against plain (after the
    # count was read: these launches are the comparison's)
    R, yk, _ = tuner.lasso_inputs()
    _lasso_case(*_lasso_design(R, yk, dev), len(yk), "on the N=80 sweep",
                facts, reps=1)
    return {"launches": counts["lasso_cd"], **row}


#: the reference's chaos and shield benchmark rows
#: (benchmarks/fleet_scaling.py::train_chaos_rows, ::train_safe_rows):
#: Poisson 10k ev/s fleets, these metrics and levers, 6 steps an episode,
#: 240 s windows, frozen bins; the SLO of the chaos arm and of the shield
#: matrix
TRAIN_METRICS = ["latency_p99_ms", "latency_mean_ms", "queue_depth",
                 "device_util", "sched_queue_depth"]
TRAIN_LEVERS = ["max_batch_events", "prefetch_depth", "driver_memory_gb",
                "sink_partitions", "microbatch_count"]
CHAOS_SLO_MS, SHIELD_SLO_MS = 2_000.0, 12_000.0


def _chaos_cfgr(N: int, faults, *, steps: int = 6, slo_ms=CHAOS_SLO_MS,
                seed: int = 0, safe: bool = False, shield_kw=None,
                mesh="auto", device=None):
    from repro_torch.core import Configurator
    from repro_torch.data.workloads import PoissonWorkload
    from repro_torch.engine import FleetEnv

    env = FleetEnv([PoissonWorkload(10_000, 0.5) for _ in range(N)],
                   seeds=[seed + i for i in range(N)], backend="torch",
                   faults=faults, device=device)
    return Configurator(env, TRAIN_METRICS, TRAIN_LEVERS, seed=seed,
                        steps_per_episode=steps, window_s=240.0,
                        device_loop="on", bin_kw=FROZEN, reward_mode="slo",
                        slo_ms=slo_ms, safe=safe, shield_kw=shield_kw,
                        mesh=mesh)


def _timed_updates(cfgr, n: int) -> list:
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        cfgr.run_update()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def _chaos_greedy(dev, faults, *, plain: bool = False, safe: bool = False):
    """A 16-cluster greedy episode batch on the card with fixed draws,
    through the kernel or through its plain version."""
    from repro_torch.engine.draws import PhiloxDraws
    from repro_torch.kernels import fleet_tick as ft

    saved = ft.fleet_tick_window
    if plain:
        ft.fleet_tick_window = ft.fleet_tick_window_ref
    try:
        # the chaos arm's 2 s SLO, a narrow trust region and budget: the
        # shield clamps and falls back inside the batch
        shield_kw = dict(trust_radius=1, breach_budget=2) if safe else None
        cfgr = _chaos_cfgr(16, faults, safe=safe, seed=3,
                           shield_kw=shield_kw)
        cfgr.env._dev.draws = PhiloxDraws(1234, dev)
        batch, recs = cfgr.run_fleet_episodes_device(explore=False)
    finally:
        ft.fleet_tick_window = saved
    return (batch["actions"].cpu().numpy(), batch["rewards"].cpu().numpy(),
            np.array([x.p99_ms for x in recs]), cfgr.env.clock.copy(),
            cfgr.env.current_configs(), cfgr.shield_counters.as_dict())


def phase_chaos(dev, facts: str, N: int = 1024) -> dict:
    """Fault scenarios and the safety shield on the fused tuning loop at
    N=1024: the fault grid on the card against the CPU, kernel against
    plain under chaos, the chaos arm against a clean one, recovery from a
    correlated failure, and the shielded against the unshielded arm."""
    from repro_torch.core.faults import (DeployLatencyFault, FailureFault,
                                         chaos_scenario, no_faults,
                                         pack_device_faults)
    from repro_torch.engine.fleet_torch import fault_effect_grid
    from repro_torch.kernels import fleet_tick as ft

    S = 6
    t_start = time.perf_counter()
    # ---- 12.1: the grid, card against CPU, bitwise ----
    tab = chaos_scenario(N, deploy_delay=1)
    rng = np.random.default_rng(0)
    T_b = rng.uniform(2.0, 10.0, N)
    clock = rng.uniform(300.0, 1200.0, N)
    times = torch.as_tensor(clock[None, :] + np.arange(48)[:, None]
                            * T_b[None, :], dtype=torch.float32)
    grids = {}
    for where in ("cuda", "cpu"):
        ftd = {k: torch.as_tensor(v, device=where)
               for k, v in tab.asdict().items()}
        grids[where] = [g.cpu() for g in fault_effect_grid(
            ftd, times.to(where))]
    for name, a, b in zip(("service", "rate"), grids["cuda"], grids["cpu"]):
        if not torch.equal(a, b):
            raise AssertionError(f"fault grid {name}: card and CPU differ, "
                                 f"max {float((a - b).abs().max()):.3e}")
        print(f"  fault_effect_grid {name} (48, {N}): card == CPU bitwise; "
              f"{int((a != 1.0).sum())} of {a.numel()} entries != 1, range "
              f"[{float(a.min()):.4f}, {float(a.max()):.4f}]")

    # ---- 12.2: kernel against plain under chaos, deploy delay, shield ----
    chaos16 = chaos_scenario(16, t0_s=500.0, deploy_delay=1)
    kern = _chaos_greedy(dev, chaos16, safe=True)
    plain = _chaos_greedy(dev, chaos16, safe=True, plain=True)
    assert np.array_equal(kern[0], plain[0]), "greedy actions differ"
    for name, a, b in zip(("rewards", "p99", "clock"), kern[1:4],
                          plain[1:4]):
        assert np.isfinite(a).all(), name
        if not np.allclose(a, b, rtol=RTOL, atol=0.0):
            raise AssertionError(f"{name}: kernel path {a} vs plain {b}")
        print(f"  chaos greedy N=16 (safe, deploy delay 1) {name}: max_rel "
              f"{float(np.max(np.abs(a - b) / np.abs(b))):.3e} (rtol {RTOL})")
    assert kern[4] == plain[4], "final configs differ"
    assert kern[5] == plain[5], (kern[5], plain[5])
    print(f"  shield counters, kernel == plain: {kern[5]}")
    if not kern[5]["clamped_actions"] + kern[5]["fallbacks"] > 0:
        raise AssertionError(f"the shield never engaged: {kern[5]}")
    off = _chaos_greedy(dev, None)
    pad = _chaos_greedy(dev, no_faults(16))
    for name, a, b in zip(("actions", "rewards", "p99", "clock"), off[:4],
                          pad[:4]):
        if not np.array_equal(a, b):
            raise AssertionError(f"no_faults(16) vs faults=None: {name} "
                                 "differ")
    print("  no_faults(16) against faults=None: bitwise equal")

    # ---- 12.3: the chaos arm (the phase's main path) and a clean arm ----
    arms, profiles = {}, {}
    for tag, faults in (("chaos", chaos_scenario(N, seed=0)),
                        ("clean", None)):
        cfgr = _chaos_cfgr(N, faults)
        assert cfgr.env.device.type == "cuda"
        _zero_counts()
        warm = _timed_updates(cfgr, 3)
        ts = _timed_updates(cfgr, 10)
        counts = _counts()
        expected = 1 + 13 * S
        print(f"  {tag} arm: fleet_tick launches {counts['fleet_tick']} "
              f"(expected {expected})")
        if counts["fleet_tick"] != expected:
            raise AssertionError(f"{tag}: launches {counts} != {expected}")
        r = np.array([x.reward for x in cfgr.history])
        if not (np.isfinite(r).all() and r.size == 13 * N * S):
            raise AssertionError(f"{tag}: {r.size} rewards, finite "
                                 f"{np.isfinite(r).all()}")
        arms[tag] = (N * S * len(ts) / sum(ts), N * S / float(np.median(ts)),
                     counts["fleet_tick"])
        print(f"  {tag} arm: warm-up {', '.join(f'{x:.3f}' for x in warm)} "
              f"s; 10 timed updates {N * S * len(ts)} windows in "
              f"{sum(ts):.6f} s = {arms[tag][0]:.1f} windows/s, median "
              f"{float(np.median(ts)):.6f} s an update = {arms[tag][1]:.1f} "
              f"windows/s [{facts}]")
        chaos = cfgr._runner.chaos
        print(f"  {tag} ChaosCounters: {json.dumps(chaos.as_dict())}")
        if tag == "chaos" and chaos.fault_events != int(
                (chaos_scenario(N, seed=0).kind != 0).sum()):
            raise AssertionError(f"fault_events {chaos.fault_events}")
        profiles[tag] = _profile_update(cfgr, facts)
    print(f"  chaos / clean: {arms['chaos'][0] / arms['clean'][0]:.4f} of "
          f"the windows/s; device launches per update "
          f"{profiles['chaos']['launches']} / {profiles['clean']['launches']}"
          f" ({(profiles['chaos']['launches'] - profiles['clean']['launches']) / S:.1f}"
          f" more a step) [{facts}]")

    # ---- 12.4: recovery from a correlated failure on a frozen config ----
    t0_s, dur, steps_r = 900.0, 480.0, 12
    faults = pack_device_faults([[FailureFault(t0_s, dur, 16.0),
                                  DeployLatencyFault(steps_r + 1)]
                                 for _ in range(N)])
    cfgr = _chaos_cfgr(N, faults, steps=steps_r)
    cfgr.run_update()
    torch.cuda.synchronize()
    clock = np.array([r.clock_s for r in cfgr.history])
    p99 = np.array([r.p99_ms for r in cfgr.history])
    pre = float(np.median(p99[clock < t0_s]))
    spike = float(np.median(p99[((clock - 240.0) < t0_s + dur)
                                & (clock > t0_s)]))
    end = t0_s + dur
    post = clock - 240.0 > end
    buckets = np.floor((clock - 240.0 - end) / 240.0)
    recovery = -1
    for b in range(int(buckets[post].max()) + 1 if post.any() else 0):
        sel = post & (buckets == b)
        if sel.any() and float(np.median(p99[sel])) <= 1.3 * pre:
            recovery = b + 1
            break
    print(f"  recovery (FailureFault({t0_s:.0f}, {dur:.0f}, 16) + "
          f"DeployLatencyFault({steps_r + 1}), {steps_r} steps): pre-fault "
          f"p99 {pre:.1f} ms, spike {spike:.1f} ms, recovery {recovery} "
          f"windows (gate 1..4)")
    if not spike > pre:
        raise AssertionError(f"no spike: pre {pre}, spike {spike}")
    if not 1 <= recovery <= 4:
        raise AssertionError(f"recovery {recovery} windows outside 1..4")

    # ---- 12.5: the shield matrix at a 12 s SLO ----
    mat = {tag: _chaos_cfgr(N, chaos_scenario(N, seed=0),
                            slo_ms=SHIELD_SLO_MS, safe=safe)
           for tag, safe in (("unshielded", False), ("shielded", True))}
    for cfgr in mat.values():
        _timed_updates(cfgr, 1)
    times_m = {tag: [] for tag in mat}
    for _ in range(14):
        for tag, cfgr in mat.items():
            times_m[tag] += _timed_updates(cfgr, 1)
    res = {}
    for tag, cfgr in mat.items():
        chaos = cfgr._runner.chaos
        ts = times_m[tag]
        res[tag] = dict(wps=N * S * len(ts) / sum(ts),
                        breach_rate=chaos.breach_rate,
                        intensity=chaos.breach_frac_sum / max(chaos.windows, 1),
                        mean_reward=chaos.mean_reward)
        print(f"  {tag}: {res[tag]['wps']:.1f} windows/s (median "
              f"{float(np.median(ts)):.6f} s an update), breach rate "
              f"{res[tag]['breach_rate']:.6f}, breach intensity "
              f"{res[tag]['intensity']:.6f}, mean reward "
              f"{res[tag]['mean_reward']:.6f} [{facts}]")
    sc = mat["shielded"].shield_counters
    print(f"  ShieldCounters: {json.dumps(sc.as_dict())}")
    for tag, cfgr in mat.items():      # after the counters were read
        res[tag]["launches"] = _profile_update(cfgr, facts)["launches"]
    print(f"  device launches per update: shielded "
          f"{res['shielded']['launches']}, unshielded "
          f"{res['unshielded']['launches']} ("
          f"{(res['shielded']['launches'] - res['unshielded']['launches']) / S:.1f}"
          f" more a step) [{facts}]")
    un, sh = res["unshielded"], res["shielded"]
    br = sh["breach_rate"] / un["breach_rate"] if un["breach_rate"] else -1.0
    tr = sh["wps"] / un["wps"]
    print(f"  shielded / unshielded: breach rate {br:.4f} (the reference's "
          f"full-run gate <= 0.25, recorded), windows/s {tr:.4f} (gate >= "
          f"0.8, recorded)")
    if not (sc.fallbacks > 0 or sc.clamped_actions > 0):
        raise AssertionError(f"the shield never engaged: {sc.as_dict()}")
    if not sc.trust_radius > 0.0:
        raise AssertionError(f"trust radius {sc.trust_radius}")
    print(f"  chaos summary: chaos {arms['chaos'][0]:.1f} windows/s, clean "
          f"{arms['clean'][0]:.1f} windows/s, unshielded {un['wps']:.1f} "
          f"windows/s breach rate {un['breach_rate']:.6f}, shielded "
          f"{sh['wps']:.1f} windows/s breach rate {sh['breach_rate']:.6f}")
    print(f"  phase 12 took {time.perf_counter() - t_start:.1f} s")
    return {"launches": arms["chaos"][2]}


#: the reference's pipelined and mega-scan training rows
#: (benchmarks/fleet_scaling.py::train_pipelined_rows, ::train_megascan_rows
#: over ``_train_cfgr``): Poisson 10k ev/s fleets, TRAIN_METRICS /
#: TRAIN_LEVERS, 5 steps, 240 s windows, frozen bins, 3 warm-up updates;
#: K updates a timed chunk, and the reference's CPU gates on the ratios
GRAPH_K, GRAPH_PASSES = 8, 3
PIPE_GATE, MEGA_GATE = 1.3, 1.5


def _graph_cfgr(N: int, *, warm: int = 3, steps: int = 5, seed: int = 0,
                window_impl: str = "kernel"):
    from repro_torch.core import Configurator
    from repro_torch.data.workloads import PoissonWorkload
    from repro_torch.engine import FleetEnv

    env = FleetEnv([PoissonWorkload(10_000, 0.5) for _ in range(N)],
                   seeds=[seed + i for i in range(N)], backend="torch",
                   window_impl=window_impl)
    cfgr = Configurator(env, TRAIN_METRICS, TRAIN_LEVERS, seed=seed,
                        steps_per_episode=steps, window_s=240.0,
                        device_loop="on", bin_kw=FROZEN)
    for _ in range(warm):
        cfgr.run_update()
    return cfgr


def _run_state(cfgr) -> dict:
    """What a tuning run leaves: parameters, rmsprop state, the record
    streams, the final configs and clocks (host copies)."""
    agent = cfgr.agent
    return {"params": {k: v.detach().cpu() for k, v in agent.params.items()},
            "nu": {k: v.cpu() for k, v in agent.opt_state["nu"].items()},
            "count": int(agent.opt_state["count"]),
            "rewards": [r.reward for r in cfgr.history],
            "p99": [r.p99_ms for r in cfgr.history],
            "levers": [(r.lever, r.direction) for r in cfgr.history],
            "configs": cfgr.env.current_configs(),
            "clock": cfgr.env.clock.copy(),
            "shield": cfgr.shield_counters.as_dict()}


def _same_state(label: str, a: dict, b: dict) -> None:
    for k in a["params"]:
        if not torch.equal(a["params"][k], b["params"][k]):
            d = float((a["params"][k] - b["params"][k]).abs().max())
            raise AssertionError(f"{label}: parameter {k} differs by {d:.3e}")
        if not torch.equal(a["nu"][k], b["nu"][k]):
            raise AssertionError(f"{label}: rmsprop state {k} differs")
    for key in ("count", "configs", "shield", "rewards", "p99", "levers"):
        if a[key] != b[key]:
            raise AssertionError(f"{label}: {key} differs")
    if not np.array_equal(a["clock"], b["clock"]):
        raise AssertionError(f"{label}: clocks differ")
    print(f"  {label}: bitwise equal ({len(a['rewards'])} records, "
          f"params, rmsprop state, final configs, clocks"
          f"{', shield counters' if a['shield']['clamped_actions'] else ''})")


def _captured_launch(dev, N: int = 64, T: int = 3328, S: int = 16) -> None:
    """One fleet_tick launch whose shared memory passes the 48 KB default
    (so the launch raises the kernel's limit with cudaFuncSetAttribute)
    captured into a graph and replayed: bitwise equal to the eager launch,
    and counted at the replay."""
    from repro_torch.core.graphs import Program
    from repro_torch.engine.fleet_torch import p99_depth
    from repro_torch.kernels import fleet_tick as ft

    p99_k = p99_depth(T, S)
    geo = ft.launch_geometry(N, T, S, ft.head_budget(S, p99_k))
    assert geo["smem_bytes"] > 48 * 1024, geo
    ops, kw = _kernel_inputs(N, T, S, seed=5, dev=dev)
    prog = Program(("fleet_tick", N, T, S), lambda: ft.fleet_tick_window(
        *ops.values(), **kw, p99_k=p99_k), dev)
    eager = [x.clone() for x in prog()]
    before = ft.LAUNCHES
    replayed = [x.clone() for x in prog()]
    torch.cuda.synchronize()
    if ft.LAUNCHES - before != 1 or prog.launches != 1:
        raise AssertionError(f"replay counted {ft.LAUNCHES - before} "
                             f"launches, the graph holds {prog.launches}")
    for name, a, b in zip(("state", "ys", "stats", "head"), eager, replayed):
        if not torch.equal(a.nan_to_num(), b.nan_to_num()):
            raise AssertionError(f"captured fleet_tick launch: {name} "
                                 "differs from the eager launch")
    print(f"  fleet_tick at N={N} T={T} S={S} ({geo['smem_bytes']} B shared, "
          f"head in {geo['head']}) captured and replayed: bitwise equal to "
          "the eager launch, 1 launch counted at the replay")


def _graph_equalities(dev) -> None:
    """The graph-replayed loop against itself on the card, N=16, Philox
    draws, frozen bins: each pair must agree to the bit."""
    from repro_torch.core import graphs
    from repro_torch.core.faults import chaos_scenario

    def fresh(**kw):
        return _graph_cfgr(16, warm=0, **kw)

    n = 4          # 2 updates before exploitation, 2 after (2 replays each)
    a = fresh()
    a.tune(n)
    replays = sum(p.calls - 1 for p in a._runner._programs.values()
                  if p.graph is not None)
    if dev.type == "cuda" and not replays:
        raise AssertionError("tune ran no replayed episode program")
    ref = _run_state(a)
    # the eager twin: every captured program runs its function instead
    saved = graphs.Program.__call__
    graphs.Program.__call__ = lambda self: self.fn()
    try:
        b = fresh()
        b.tune(n)
    finally:
        graphs.Program.__call__ = saved
    if b._runner._programs and any(
            p.graph is not None for p in b._runner._programs.values()):
        raise AssertionError("the eager twin captured a graph")
    _same_state(f"tune({n}) from graphs ({replays} episode replays) vs "
                f"eager", ref, _run_state(b))
    c = fresh()
    for _ in range(n):
        c.run_epoch(1)
    _same_state(f"run_epoch(1) x{n} vs tune({n})", ref, _run_state(c))
    d = fresh()
    d.run_epoch(n, records="full")
    _same_state(f"run_epoch({n}, full) vs tune({n})", ref, _run_state(d))
    e = fresh()
    e.tune_pipelined(n, depth=1)
    _same_state(f"tune_pipelined({n}, depth=1) vs tune({n})", ref,
                _run_state(e))

    def shielded():
        cfgr = _chaos_cfgr(16, chaos_scenario(16, t0_s=500.0,
                                              deploy_delay=1),
                           safe=True, seed=3, steps=5,
                           shield_kw=dict(trust_radius=1, breach_budget=2))
        return cfgr
    f, g = shielded(), shielded()
    f.tune(2)
    g.run_epoch(2)
    sf = _run_state(f)
    if not sf["shield"]["clamped_actions"] + sf["shield"]["fallbacks"]:
        raise AssertionError(f"the shield never engaged: {sf['shield']}")
    # a fallback reverts whole rows, which the records' configs do not
    # show; the final configs are re-synced from the indices
    _same_state("chaos + deploy delay 1 + shield: run_epoch(2) vs tune(2)",
                sf, _run_state(g))


def phase_graphs(dev, facts: str, N: int = 1024) -> dict:
    """The fused loop on captured CUDA graphs: the graph paths bitwise
    against the eager and sequential ones at N=16, then windows/s of the
    sequential, pipelined and epoch schedules at N=1024 with their spread,
    launch counts, device busy shares, host launch calls and memory."""
    from repro_torch.core.device_loop import CAPTURE_COUNTS
    from repro_torch.kernels import fleet_tick as ft

    t_start = time.perf_counter()
    S, K = 5, GRAPH_K
    # ---- 13.1: bitwise equalities on the card ----
    _captured_launch(dev)
    _graph_equalities(dev)

    # ---- 13.2: the schedules at N=1024, whole chunks interleaved ----
    modes = {"seq": lambda c: c.tune(K),
             "pipe2": lambda c: c.tune_pipelined(K, depth=2),
             "full": lambda c: c.run_epoch(K, records="full"),
             "summary": lambda c: c.run_epoch(K, records="summary"),
             "off": lambda c: c.run_epoch(K, records="off")}
    cfgrs = {}
    for name, run in modes.items():
        cfgrs[name] = _graph_cfgr(N)
        run(cfgrs[name])             # warm at the chunk's exact shape
    torch.cuda.synchronize()
    captures = dict(CAPTURE_COUNTS)
    times = {name: [] for name in modes}
    launches = {name: 0 for name in modes}
    per_update = []
    for p in range(GRAPH_PASSES):
        order = list(modes) if p % 2 == 0 else list(reversed(modes))
        for name in order:
            cfgr = cfgrs[name]
            before = ft.LAUNCHES
            marks = []
            cb = (lambda i, st, h: marks.append(time.perf_counter())) \
                if name == "seq" else None
            t0 = time.perf_counter()
            if cb is None:
                modes[name](cfgr)
            else:
                cfgr.tune(K, callback=cb)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
            launches[name] += ft.LAUNCHES - before
            if marks:
                per_update += list(np.diff([t0] + marks))
    if dict(CAPTURE_COUNTS) != captures:
        raise AssertionError("captures grew over the timed chunks: "
                             f"{captures} -> {dict(CAPTURE_COUNTS)}")
    print(f"  CAPTURE_COUNTS flat over the timed chunks: "
          f"{sum(captures.values())} captures in "
          f"{len(captures)} programs")
    want = GRAPH_PASSES * K * S
    wps = {}
    for name, ts in times.items():
        t = np.array(ts)
        if launches[name] != want:
            raise AssertionError(f"{name}: fleet_tick launches "
                                 f"{launches[name]}, expected {want}")
        wps[name] = N * S * K * len(t) / t.sum()
        print(f"  {name:8s}: {N * S * K * len(t)} windows in {t.sum():.6f} s"
              f" = {wps[name]:.1f} windows/s; chunks of {K} updates "
              f"{', '.join(f'{x:.6f}' for x in t)} s (median "
              f"{N * S * K / float(np.median(t)):.1f} windows/s); fleet_tick "
              f"launches {launches[name]} [{facts}]")
    u = np.array(per_update)
    print(f"  seq per update: min {u.min():.6f}, median {np.median(u):.6f}, "
          f"max {u.max():.6f} s over {u.size} updates [{facts}]")
    print(f"  ratios to seq (recorded; the reference's CPU gates "
          f">= {PIPE_GATE} pipelined, >= {MEGA_GATE} mega-scan): pipe2 "
          f"{wps['pipe2'] / wps['seq']:.4f}, full "
          f"{wps['full'] / wps['seq']:.4f}, summary "
          f"{wps['summary'] / wps['seq']:.4f}, off "
          f"{wps['off'] / wps['seq']:.4f} [{facts}]")

    # ---- 13.3: a profiled chunk per mode, memory ----
    for name, run in modes.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        prof = _profile(lambda: run(cfgrs[name]), f"{name} chunk of {K}",
                        facts, top=3)
        print(f"  {name:8s}: per update {prof['kernel_calls'] / K:.1f} "
              f"kernel launch calls, {prof['graph_calls'] / K:.1f} graph "
              f"launch calls, {prof['launches'] / K:.1f} device launches; "
              f"peak allocated {torch.cuda.max_memory_allocated() / 2**20:.1f}"
              f" MiB, reserved {torch.cuda.memory_reserved() / 2**20:.1f} "
              f"MiB (graph pools included) [{facts}]")
    _host_split(cfgrs["seq"], K, facts)
    print(f"  phase 13 took {time.perf_counter() - t_start:.1f} s")
    return {"launches": sum(launches.values())}


def _host_split(cfgr, k: int, facts: str, top: int = 12) -> None:
    """Where a sequential update's host time goes: ``k`` more updates under
    cProfile, the functions with the most time of their own."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.runcall(cfgr.tune, k)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = pstats.Stats(prof)
    rows = sorted(st.stats.items(), key=lambda kv: kv[1][2], reverse=True)
    print(f"  host split of {k} sequential updates under cProfile: wall "
          f"{wall * 1e3:.1f} ms ({wall / k * 1e3:.1f} ms an update, "
          f"cProfile's overhead included) [{facts}]; own time by function:")
    for (path, line, fn), (_, calls, own, cum, _) in rows[:top]:
        where = f"{Path(path).name}:{line}" if line else path
        print(f"    {own / k * 1e3:8.3f} ms an update (cumulative "
              f"{cum / k * 1e3:8.3f}) x{calls // k:<7d} {fn} ({where})")


#: the serve plane at tuning scale (phase 14): the reference's acceptance
#: run (tests/test_serve.py::test_twenty_cycle_switching_acceptance) with
#: launch/serve.py's roster, window and steps, raised to the gate size
SERVE_N, SERVE_PAIRS, SERVE_LIVE, SERVE_CYCLES = 1024, 64, 256, 20
SERVE_KW = dict(window_s=240.0, steps_per_episode=2, k_promote=2,
                margin=0.02, slo_ms=20_000.0, eval_windows=2,
                incumbent={"max_batch_events": 120_000.0}, bin_kw=FROZEN)
#: counters a resumed service must equal (wall clocks and the process-wide
#: capture gauge excepted)
_SERVE_SKIP = ("windows_per_s", "retraces")


def _serve_ctl(N: int, pairs: int, live: int, *, seed: int = 0, ckdir=None,
               window_impl: str = "kernel", **kw):
    """Phase 14's service names the fleet_tick path; phase 15 passes the
    controller's default, ``window_impl="scan"``."""
    from repro_torch.launch.serve import switching_fleet
    from repro_torch.serve import ServeController

    return ServeController(switching_fleet(N), metrics=QUICK_METRICS,
                           levers=QUICK_LEVERS, backend="torch", seed=seed,
                           canary_pairs=pairs, n_live=live,
                           checkpoint_dir=ckdir, window_impl=window_impl,
                           **dict(SERVE_KW, **kw))


def _service_state(ctl, after: int = 0) -> dict:
    """What a resumed service must replay bitwise (host copies)."""
    ag = ctl.cfgr.agent
    probe = np.linspace(-1.0, 1.0, 64 * ag.state_dim,
                        dtype=np.float32).reshape(64, ag.state_dim)
    envs = (ctl.shadow_env, ctl.canary_env, ctl.live_env)
    return {"greedy": ctl.greedy_actions(probe).tolist(),
            "params": {k: v.detach().cpu() for k, v in ag.params.items()},
            "nu": {k: v.cpu() for k, v in ag.opt_state["nu"].items()},
            "count": int(ag.opt_state["count"]), "n_updates": ag.n_updates,
            "gate": ctl.gate.log, "incumbent": ctl.incumbent,
            "clocks": [e.clock.copy() for e in envs],
            "reconfigs": [e.reconfigs.copy() for e in envs],
            "configs": [e.current_configs() for e in envs],
            "draws": [e._dev.draws.gen.get_state() for e in envs],
            "counters": {k: v for k, v in ctl.counters.as_dict().items()
                         if not ("wall" in k or k.endswith("_s")
                                 or k in _SERVE_SKIP)},
            "history": [r for r in ctl.history.rows() if r["cycle"] > after]}


def _same_service(label: str, a: dict, b: dict) -> None:
    for k in a["params"]:
        if not torch.equal(a["params"][k], b["params"][k]):
            raise AssertionError(f"{label}: parameter {k} differs")
        if not torch.equal(a["nu"][k], b["nu"][k]):
            raise AssertionError(f"{label}: rmsprop state {k} differs")
    for k in ("clocks", "reconfigs"):
        if not all(np.array_equal(x, y) for x, y in zip(a[k], b[k])):
            raise AssertionError(f"{label}: {k} differ")
    if not all(torch.equal(x, y) for x, y in zip(a["draws"], b["draws"])):
        raise AssertionError(f"{label}: generator states differ")
    for k in ("greedy", "count", "n_updates", "gate", "incumbent", "configs",
              "counters", "history"):
        if a[k] != b[k]:
            raise AssertionError(f"{label}: {k} differs")
    print(f"  {label}: bitwise equal (greedy actions, params, rmsprop "
          f"state, {len(a['gate'])} gate events, clocks, configs, counters, "
          f"{len(a['history'])} history rows, generator states)")


def _serve_rewards(summaries) -> np.ndarray:
    return np.array([[np.nan if s[k] is None else s[k] for k in
                      ("cand_reward", "inc_reward", "live_reward")]
                     for s in summaries], float)


def _serve_check(dev) -> None:
    """14(a): a 3-cycle service at N=16 through the kernel (its programs
    captured) and through fleet_tick's plain version (programs eager), on
    the same seeds: the same decisions, gate log and incumbent, rewards
    within RTOL."""
    from repro_torch.core import graphs
    from repro_torch.kernels import fleet_tick as ft

    def run():
        ctl = _serve_ctl(16, 4, 8, seed=3)
        return ctl, ctl.run(3)

    kern, ks = run()
    saved_fn, saved_call = ft.fleet_tick_window, graphs.Program.__call__
    ft.fleet_tick_window = ft.fleet_tick_window_ref
    graphs.Program.__call__ = lambda self: self.fn()
    try:
        plain, ps = run()
    finally:
        ft.fleet_tick_window, graphs.Program.__call__ = saved_fn, saved_call
    strip = lambda log: [{k: v for k, v in e.items() if "reward" not in k}
                         for e in log]
    if [s["decision"] for s in ks] != [s["decision"] for s in ps]:
        raise AssertionError(f"decisions: kernel {[s['decision'] for s in ks]}"
                             f" vs plain {[s['decision'] for s in ps]}")
    if strip(kern.gate.log) != strip(plain.gate.log):
        raise AssertionError("gate logs differ between kernel and plain")
    if kern.incumbent != plain.incumbent:
        raise AssertionError("incumbents differ between kernel and plain")
    a, b = _serve_rewards(ks), _serve_rewards(ps)
    if not np.array_equal(np.isnan(a), np.isnan(b)) or not np.allclose(
            a, b, rtol=RTOL, atol=0.0, equal_nan=True):
        raise AssertionError(f"rewards: kernel {a} vs plain {b}")
    fin = ~np.isnan(a)
    err = float(np.max(np.abs(a[fin] - b[fin]) / np.abs(b[fin])))
    print(f"  N=16, 3 cycles, kernel vs plain: decisions "
          f"{[s['decision'] for s in ks]} equal, gate log ({len(kern.gate.log)}"
          f" events) and incumbent equal, canary/live rewards max_rel "
          f"{err:.3e} (rtol {RTOL})")


def _serve_resume(dev, facts: str, tmp: Path, window_impl: str = "kernel",
                  tag: str = "14(c)") -> None:
    """14(c): crash-resume after capture at the card-scale sizes. A runs 6
    cycles; B checkpoints at cycle 3 and runs one more; C, fresh, restores
    step 3 and runs 4-6; D is B restoring step 3 in place, its programs
    captured, and running 4-6. C and D must equal A bitwise."""
    from repro_torch.core.graphs import CAPTURE_COUNTS

    size = (SERVE_N, SERVE_PAIRS, SERVE_LIVE)
    t0 = time.perf_counter()
    A = _serve_ctl(*size, window_impl=window_impl)
    A.run(6)
    ref = _service_state(A, after=3)
    B = _serve_ctl(*size, ckdir=tmp / "ck", window_impl=window_impl)
    B.run(3)
    B.checkpoint()
    B.run(1)
    C = _serve_ctl(*size, ckdir=tmp / "ck", window_impl=window_impl)
    assert C.restore(step=3) == 3 and C.cycle == 3
    C.run(3)
    _same_service(f"{tag} fresh controller C restored at cycle 3 vs A",
                  ref, _service_state(C, after=3))
    runner = B.cfgr._runner
    graphs_before = {k: p.graph for k, p in runner._programs.items()
                     if p.graph is not None}
    captures = dict(CAPTURE_COUNTS)
    assert B.restore(step=3) == 3 and B.cycle == 3
    B.run(3)
    replayed = [k for k, g in graphs_before.items()
                if k in runner._programs and runner._programs[k].graph is g]
    if not replayed or dict(CAPTURE_COUNTS) != captures:
        raise AssertionError("in-place restore recaptured its programs: "
                             f"{len(replayed)} kept, captures "
                             f"{captures} -> {dict(CAPTURE_COUNTS)}")
    _same_service(f"{tag} in-place restore D ({len(replayed)} graphs "
                  "captured before the restore, replayed after it) vs A",
                  ref, _service_state(B, after=3))
    print(f"  {tag} took {time.perf_counter() - t0:.1f} s [{facts}]")


def _serve_epoch(dev, facts: str, cycles: int = 4) -> None:
    """14(d): epoch_k=2 at the card-scale sizes: one epoch (2 body
    replays) a cycle, captures flat from cycle 3."""
    from repro_torch.core.device_loop import CAPTURE_COUNTS, EPOCH_DISPATCHES

    ctl = _serve_ctl(SERVE_N, SERVE_PAIRS, SERVE_LIVE, epoch_k=2)
    deltas, caps, times = [], [], []
    for _ in range(cycles):
        d0, t0 = EPOCH_DISPATCHES[0], time.perf_counter()
        ctl.run_cycle()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        deltas.append(EPOCH_DISPATCHES[0] - d0)
        caps.append(sum(CAPTURE_COUNTS.values()))
    if deltas != [2] * cycles or ctl.cfgr.agent.n_updates != 2 * cycles:
        raise AssertionError(f"epoch_k=2: body replays a cycle {deltas}, "
                             f"{ctl.cfgr.agent.n_updates} updates")
    if len(set(caps[1:])) != 1:
        raise AssertionError(f"epoch_k=2: captures grew after cycle 2: {caps}")
    print(f"  14(d) epoch_k=2 at N={SERVE_N}: one epoch of 2 body replays a "
          f"cycle ({deltas}), {ctl.cfgr.agent.n_updates} updates, captures "
          f"flat from cycle 3 ({caps}); cycles "
          f"{', '.join(f'{x:.4f}' for x in times)} s [{facts}]")


def phase_serve_plane(dev, facts: str) -> dict:
    """The serve control plane (shadow -> canary -> promote/rollback) on
    the captured fused loop: kernel against plain at N=16, the card-scale
    acceptance service, crash-resume after capture (fresh and in place),
    epoch_k=2."""
    import tempfile

    from repro_torch.core.graphs import CAPTURE_COUNTS
    from repro_torch.kernels import fleet_tick as ft

    t_start = time.perf_counter()
    _serve_check(dev)

    # ---- 14(b): the card-scale service, its launches counted ----
    ctl = _serve_ctl(SERVE_N, SERVE_PAIRS, SERVE_LIVE)
    envs = (ctl.shadow_env, ctl.canary_env, ctl.live_env)
    assert all(e.device.type == "cuda" for e in envs), ctl.device
    assert ctl.cfgr.device_loop_reason() is None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    walls, phases, caps, summaries = [], [], [], []
    t0 = time.perf_counter()
    for _ in range(SERVE_CYCLES):
        t1 = time.perf_counter()
        summaries.append(ctl.run_cycle())
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
        phases.append(dict(ctl.phase_s))
        caps.append(dict(CAPTURE_COUNTS))
    wall = time.perf_counter() - t0
    launches = ft.LAUNCHES
    c = ctl.counters
    M = ctl.canary_pairs
    evals = c.canary_windows // (2 * M * ctl.eval_windows)
    S = ctl.cfgr.steps_per_episode
    expected = (1 + SERVE_CYCLES * S + evals * ctl.eval_windows
                + SERVE_CYCLES)
    print(f"  fleet_tick launches {launches} (expected {expected}: 1 first "
          f"observe + {SERVE_CYCLES} cycles x {S} shadow steps + {evals} "
          f"canary evaluations x {ctl.eval_windows} + {SERVE_CYCLES} live "
          f"windows), {launches / SERVE_CYCLES:.2f} a cycle")
    if launches != expected:
        raise AssertionError(f"serve launches {launches} != {expected}")
    # a program captures at its second call: the exploit flip (after the
    # 2 warm-up updates) builds the last one at cycle 3, captured at 4
    if any(cp != caps[3] for cp in caps[4:]):
        raise AssertionError(f"captures grew after cycle 4: {caps[3]} -> "
                             f"{caps[-1]}")
    if c.promotions < 1:
        raise AssertionError(f"no promotion in {SERVE_CYCLES} cycles: "
                             f"{ctl.gate.log}")
    promoted = ctl.history.rows(role="promote")
    for p in promoted:
        adopt = [e["cycle"] for e in ctl.gate.log
                 if e["event"] == "adopt" and e["config"] == p["config"]
                 and e["cycle"] <= p["cycle"]][-1]
        window = [r for r in ctl.history.rows(role="canary")
                  if r["config"] == p["config"]
                  and adopt <= r["cycle"] <= p["cycle"]]
        if not window or any(r["breached"] for r in window):
            raise AssertionError(f"served a config that breached during its "
                                 f"winning canary: {p['cycle']}")
    if ctl.incumbent != promoted[-1]["config"] or any(
            cfg != ctl.incumbent for cfg in ctl.live_env.current_configs()):
        raise AssertionError("the live fleet does not serve the last "
                             "promotion")
    mem = torch.cuda.max_memory_allocated()
    w = np.array(walls)
    ph = {k: np.array([p[k] for p in phases]) for k in phases[0]}
    print(f"  {SERVE_CYCLES} cycles at shadow N={SERVE_N}, canary "
          f"{2 * M}, live {ctl.live_env.n_clusters}: {wall:.3f} s = "
          f"{SERVE_CYCLES / wall:.4f} cycles/s; per cycle min "
          f"{w.min():.6f}, median {np.median(w):.6f}, max {w.max():.6f} s "
          f"(cycle 1 carries the set-up) [{facts}]")
    for k, v in ph.items():
        print(f"    {k:7s} median {np.median(v):.6f} s, min {v.min():.6f}, "
              f"max {v.max():.6f} (cycles 2-{SERVE_CYCLES}: median "
              f"{np.median(v[1:]):.6f})")
    print(f"  decisions {[s['decision'] for s in summaries]}; promotions "
          f"{c.promotions}, rollbacks {c.rollbacks}, demotions "
          f"{c.demotions}, holds {c.holds}; canary breached "
          f"{c.canary_breached}/{c.canary_windows}, live breached "
          f"{c.live_breached}/{c.live_windows}; live p99 {c.live_p99_ms:.1f} "
          f"ms; captures {sum(caps[-1].values())}, flat after cycle 4; peak "
          f"device memory {mem / 2**20:.1f} MiB [{facts}]")
    prof = _profile(ctl.run_cycle, "serve cycle", facts, top=5)
    print(f"  a profiled cycle: device busy {prof['busy_ms']:.2f} of "
          f"{prof['wall_ms']:.2f} ms ({100 * prof['busy_ms'] / prof['wall_ms']:.1f}"
          f" %) [{facts}]")

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        _serve_resume(dev, facts, Path(tmp))
    _serve_epoch(dev, facts)
    print(f"  phase 14 took {time.perf_counter() - t_start:.1f} s")
    return {"launches": launches}


#: phase 15's kernel shapes (N, T): the main path's window, windows of 768
#: and 3328 ticks, and fleets that are not a multiple of 32
SCAN_SHAPES = ((1024, 48), (1024, 768), (1024, 3328), (80, 48), (1000, 48))
#: the two estimators of one mixture (15(b)): the kernel path's lane
#: statistics against the scan's analytic mean and sampled p99, their
#: medians over the fleet within tests/chaos_harness.py's median reward
#: and median p99 tolerances
ESTIMATOR_TOL = {"mean_ms": 0.10, "p99_ms": 0.15}


def _scan_inputs(N: int, T: int, seed: int, dev, fmult: bool) -> tuple:
    """fleet_scan's operands at (N, T): phase 3's (real packed constants,
    seeded noise, a ragged ``active``), its tick words decoded as the scan
    route decodes them, without the lane words."""
    from repro_torch.engine.fleet_torch import tick_noise

    ops, kw = _kernel_inputs(N, T, 1, seed=seed, dev=dev)
    args = [ops["state"], ops["consts"], ops["rate"], ops["size"],
            *tick_noise(ops["tick_bits"]), ops["active"],
            ops["fmult"] if fmult else None]
    return args, kw


def _scan_kernel_cases(dev, facts: str) -> dict:
    """15(a): fleet_scan bitwise against tick_scan_ref at SCAN_SHAPES, each
    with and without fmult; times at each shape with fmult."""
    from repro_torch.kernels import fleet_scan as fs

    main, worst = None, 0.0
    for N, T in SCAN_SHAPES:
        for fmult in (True, False):
            args, kw = _scan_inputs(N, T, seed=N + T, dev=dev, fmult=fmult)
            assert float(args[8].min()) == 0.0, "active is not partial"
            got = fs.fleet_scan(*args, **kw)
            want = fs.tick_scan_ref(*args, **kw)
            torch.cuda.synchronize()
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            exact = all(torch.equal(a, b) for a, b in zip(got, want))
            fin = all(bool(torch.isfinite(a).all()) for a in got)
            worst = max(worst, err)
            print(f"  N={N} T={T} fmult={fmult}: max_abs={err:.3e} "
                  f"bitwise={exact} finite={fin}")
            if not (exact and fin):
                raise AssertionError(f"fleet_scan differs from its plain "
                                     f"version at N={N} T={T} fmult={fmult}")
        args, kw = _scan_inputs(N, T, seed=N + T, dev=dev, fmult=True)
        run = lambda: fs.fleet_scan(*args, **kw)
        ms, host_ms = _graph_ms(run, reps=100), _time_ms(run, reps=100)
        plain_ms = _time_ms(lambda: fs.tick_scan_ref(*args, **kw),
                            reps=max(2, min(50, 2400 // T)), warmup=1)
        nbytes, nops = fs.scan_cost(T, N, fmult=True)
        bound_ms, by = _bound(nbytes, nops, F32_OPS_S)
        print(f"  N={N} T={T}: kernel device {ms * 1e3:.3f} us (host loop "
              f"{host_ms * 1e3:.3f} us, a CUDA graph of 100 for the device "
              f"figure), {ms * 1e6 / T:.1f} ns a tick, plain "
              f"{plain_ms:.3f} ms, bound {bound_ms * 1e3:.3f} us by {by} "
              f"({nbytes / 1e6:.3f} MB, {nops / 1e6:.2f} Mop), "
              f"{bound_ms / ms:.4f} of the bound; chain {fs.CHAIN_OPS} "
              f"dependent ops a tick [{facts}]")
        if main is None:
            main = {"ms": ms, "ms_host_loop": host_ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": by}
    return dict(main, max_abs_err=worst)


def _scan_estimators(dev, facts: str, N: int = 1024,
                     windows: int = 3) -> None:
    """15(b): one N=1024 fleet observed with the kernel path and with the
    scan (same seeds, the default config): the window mean and p99 are two
    estimators of the same latency mixture."""
    from repro_torch.engine import FleetEnv

    med = {}
    for impl in ("kernel", "scan"):
        env = FleetEnv.heterogeneous(N, seed=0, mix=MIX, backend="torch",
                                     window_impl=impl)
        env.observe_stats(240.0)                     # settle the backlog
        rows = [env.observe_stats(240.0) for _ in range(windows)]
        med[impl] = {k: float(np.median(torch.stack(
            [r[k] for r in rows]).cpu().numpy())) for k in ESTIMATOR_TOL}
        assert all(bool(torch.isfinite(r[k]).all()) for r in rows
                   for k in ESTIMATOR_TOL), impl
    for k, tol in ESTIMATOR_TOL.items():
        a, b = med["kernel"][k], med["scan"][k]
        rel = abs(b - a) / abs(a)
        print(f"  N={N}, {windows} windows after one: median {k} kernel "
              f"{a:.3f} / scan {b:.3f} ms, relative {rel:.5f} (tol {tol})")
        if rel > tol:
            raise AssertionError(f"the scan's {k} strays from the kernel "
                                 f"path's: {b} vs {a}")


def _scan_calibration(dev, facts: str) -> None:
    """15(c): the kernel-vs-scan probe at N=1024 and N=80."""
    from repro_torch.engine import fleet_torch as fj

    for N in (1024, 80):
        fj._IMPL_CACHE.pop(("cuda", fj._bucket(N)), None)
        verdict, t = fj.calibrate_window_impl(N, device=dev)
        print(f"  calibrate_window_impl({N}): kernel {t['kernel'] * 1e3:.4f}"
              f" ms, scan {t['scan'] * 1e3:.4f} ms (medians of 5 interleaved "
              f"reps, T=32) -> {verdict!r}; preferred "
              f"{fj.preferred_window_impl(N, device=dev)!r} [{facts}]")


def _scan_greedy_check(dev) -> None:
    """A 16-cluster greedy batch on the scan through the kernel and through
    its plain version, on the same Philox draws (phase 5's criterion)."""
    from repro_torch.core import Configurator
    from repro_torch.engine import FleetEnv
    from repro_torch.engine.draws import PhiloxDraws
    from repro_torch.kernels import fleet_scan as fs

    def run():
        env = FleetEnv.heterogeneous(16, seed=3, backend="torch", mix=MIX,
                                     window_impl="scan")
        env._dev.draws = PhiloxDraws(1234, dev)
        cfgr = Configurator(env, QUICK_METRICS, QUICK_LEVERS,
                            device_loop="on", window_s=240.0,
                            steps_per_episode=3)
        batch, recs = cfgr.run_fleet_episodes_device(explore=False)
        return (batch["actions"].cpu().numpy(), batch["rewards"].cpu().numpy(),
                np.array([x.p99_ms for x in recs]), env.clock.copy())

    kern = run()
    saved = fs.fleet_scan
    fs.fleet_scan = fs.tick_scan_ref
    try:
        plain = run()
    finally:
        fs.fleet_scan = saved
    if not all(np.array_equal(a, b) for a, b in zip(kern, plain)):
        raise AssertionError("greedy scan batch: kernel and plain differ")
    print("  greedy N=16 batch on the scan, kernel vs plain: actions, "
          "rewards, p99 and clocks bitwise equal")


def _scan_main(dev, facts: str) -> dict:
    """15(d): phase 4's main path on window_impl="scan": launch counts of
    both window kernels, steady windows/s, a profiled update."""
    from repro_torch.core import Configurator
    from repro_torch.engine import FleetEnv

    N, S, updates = 1024, 5, 3
    env = FleetEnv.heterogeneous(N, seed=0, backend="torch", mix=MIX,
                                 window_impl="scan")
    cfgr = Configurator(env, QUICK_METRICS, QUICK_LEVERS, device_loop="on",
                        window_s=240.0, steps_per_episode=S, bin_kw=FROZEN)
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    for _ in range(updates):
        stats = cfgr.run_update()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    expected = 1 + updates * S
    print(f"  main path on the scan: fleet_scan launches "
          f"{counts['fleet_scan']} (expected {expected}), fleet_tick "
          f"{counts['fleet_tick']} (expected 0); {updates} run_updates in "
          f"{wall:.3f} s")
    if counts["fleet_scan"] != expected or counts["fleet_tick"] != 0:
        raise AssertionError(f"scan main path launches {counts}")
    r = np.array([rec.reward for rec in cfgr.history])
    if r.shape != (updates * N * S,) or not np.isfinite(r).all() \
            or not np.isfinite(stats["pg_loss"]):
        raise AssertionError("scan main path: bad rewards or loss")
    _steady_rate(cfgr, N, S, facts, kernel="fleet_scan")
    prof = _profile_update(cfgr, facts)
    print(f"  a profiled update on the scan: device busy "
          f"{prof['busy_ms']:.2f} of {prof['wall_ms']:.2f} ms "
          f"({100 * prof['busy_ms'] / prof['wall_ms']:.1f} %) [{facts}]")
    return {"launches": counts["fleet_scan"]}


def _scan_epoch(dev, facts: str, N: int = 1024) -> int:
    """15(e): the epoch "summary" of K=8 updates on the scan, captured,
    bitwise against its eager twin; windows/s of a replayed epoch."""
    from repro_torch.core import graphs
    from repro_torch.kernels import fleet_scan as fs

    K, S = GRAPH_K, 5
    a = _graph_cfgr(N, window_impl="scan")
    a.run_epoch(K, records="summary")
    ref = _run_state(a)
    saved = graphs.Program.__call__
    graphs.Program.__call__ = lambda self: self.fn()
    try:
        b = _graph_cfgr(N, window_impl="scan")
        b.run_epoch(K, records="summary")
    finally:
        graphs.Program.__call__ = saved
    _same_state(f"15(e) run_epoch({K}, summary) on the scan from graphs vs "
                "eager", ref, _run_state(b))
    torch.cuda.synchronize()
    before = fs.LAUNCHES
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        a.run_epoch(K, records="summary")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = fs.LAUNCHES - before
    if launches != 2 * K * S:
        raise AssertionError(f"epoch on the scan: {launches} fleet_scan "
                             f"launches, expected {2 * K * S}")
    t = np.array(times)
    print(f"  15(e) replayed epochs of {K} on the scan: "
          f"{2 * N * S * K / t.sum():.1f} windows/s (chunks "
          f"{', '.join(f'{x:.6f}' for x in t)} s), fleet_scan launches "
          f"{launches} counted at the replays [{facts}]")
    return launches


def _scan_serve(dev, facts: str, tmp: Path, cycles: int = 6) -> int:
    """15(f): the serve plane at its default window, the scan, at phase
    14's sizes: cycles/s, launches, then crash-resume after capture."""
    ctl = _serve_ctl(SERVE_N, SERVE_PAIRS, SERVE_LIVE, window_impl="scan")
    assert ctl.live_env.window_impl == "scan"
    before = _counts()
    walls = []
    for _ in range(cycles):
        t0 = time.perf_counter()
        ctl.run_cycle()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    after = _counts()
    launches = after["fleet_scan"] - before["fleet_scan"]
    if after["fleet_tick"] != before["fleet_tick"] or not launches:
        raise AssertionError(f"serve on the scan: launches {before} -> "
                             f"{after}")
    w = np.array(walls)
    c = ctl.counters
    print(f"  15(f) {cycles} cycles on the scan at shadow N={SERVE_N}: "
          f"{cycles / w.sum():.4f} cycles/s (median over cycles 2-{cycles} "
          f"{np.median(w[1:]):.6f} s), fleet_scan launches {launches}, "
          f"fleet_tick 0; promotions {c.promotions}, rollbacks "
          f"{c.rollbacks} [{facts}]")
    _serve_resume(dev, facts, tmp, window_impl="scan", tag="15(f)")
    return launches


def phase_scan(dev, facts: str) -> dict:
    """The lean tick scan on the card: the fleet_scan kernel against its
    plain version, the two window estimators side by side, the calibration,
    the main path, the epoch and the serve plane on window_impl="scan"."""
    import tempfile

    t_start = time.perf_counter()
    row = _scan_kernel_cases(dev, facts)
    _scan_estimators(dev, facts)
    _scan_calibration(dev, facts)
    _scan_greedy_check(dev)
    row["launches"] = _scan_main(dev, facts)["launches"]
    row["launches_epoch"] = _scan_epoch(dev, facts)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        row["launches_serve"] = _scan_serve(dev, facts, Path(tmp))
    print(f"  phase 15 took {time.perf_counter() - t_start:.1f} s")
    return row


def _local_window(env, label: str, window_s: float, facts: str):
    """One observed window of ``env``, timed on the host clock, printed."""
    t0 = time.perf_counter()
    w = env.observe(window_s)
    wall = time.perf_counter() - t0
    pn = w.per_node
    print(f"  {label}: {w.latencies_ms.size} events in {wall:.3f} s "
          f"({w.latencies_ms.size / wall:.3f} events/s; cumulative "
          f"events_per_s {pn['events_per_s'][0]:.3f}), latency mean "
          f"{w.mean_ms:.3f} / p50 {pn['latency_p50_ms'][0]:.3f} / p99 "
          f"{w.p99_ms:.3f} ms, batch service {pn['batch_service_ms'][0]:.3f} "
          f"ms, {pn['batches_per_s'][0]:.3f} batches/s, padding "
          f"{pn['padding_waste_frac'][0]:.4f}, jit_compiles "
          f"{pn['jit_compiles'][0]:.0f} (jit_time_s "
          f"{pn['jit_time_s'][0]:.6f}) [{facts}]")
    return w


def _launches_as(label: str, **expect: int) -> dict:
    """The launch counts since the last ``_zero_counts``, which must be
    ``expect`` (0 for a kernel not named)."""
    counts = _counts()
    print(f"  kernel launches over {label}: {counts}")
    want = {n: expect.get(n, 0) for n in counts}
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, expected {want}")
    return counts


def phase_local(dev, facts: str, window_s: float = 2.0) -> dict:
    """LocalEngine on the card in the reference's configuration (the reduced
    smollm-135m, Poisson 30 events/s of 0.5 MB, seed 0): windows of real
    seconds, the batch interval's effect on latency, a reboot lever, then
    AutoTuner's collect -> analyse -> one host-loop update. One lasso_cd
    launch (analyse), no other; that launch's inputs, recorded at its
    wrapper, then go through ``_lasso_case``, and its output is held
    bitwise to the mirror."""
    from unittest import mock

    from repro_torch.core import AutoTuner
    from repro_torch.core import lasso as lasso_mod
    from repro_torch.kernels import lasso_cd as lc
    from repro_torch.data.workloads import PoissonWorkload
    from repro_torch.engine import LOCAL_LEVERS, LocalEngine

    t_start = time.perf_counter()
    _zero_counts()
    env = LocalEngine(PoissonWorkload(lam=30.0, event_size_mb=0.5), seed=0)
    torch.cuda.synchronize()
    cfg = env.engine.model_cfg
    assert env.device.type == env.engine.device.type == dev.type
    print(f"  LocalEngine({cfg.name} reduced: {cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.dtype}, attn {cfg.attn_impl}) on "
          f"{env.device}, up in {time.perf_counter() - t_start:.3f} s")
    _local_window(env, "default (batch_interval_s 0.5)", window_s, facts)
    c = env.current_config()
    means = {}
    for interval in (1.0, 0.1):
        c["batch_interval_s"] = interval
        env.apply_config(c)
        means[interval] = _local_window(env, f"batch_interval_s {interval}",
                                        window_s, facts).mean_ms
    print(f"  lever: mean latency {means[0.1]:.3f} ms at 0.1 s against "
          f"{means[1.0]:.3f} ms at 1.0 s")
    if not means[0.1] < means[1.0]:
        raise AssertionError("batch_interval_s 0.1 is not faster than 1.0")
    before = env.engine.jit_compiles
    c["attn_chunk"] = 32
    rep = env.apply_config(c)
    _local_window(env, "attn_chunk 32", 1.0, facts)
    print(f"  reboot lever attn_chunk 32: rebooted {rep['rebooted']}, load "
          f"{rep['load_s']:.3f} s, jit_compiles {before} -> "
          f"{env.engine.jit_compiles}")
    if not rep["rebooted"] or env.engine.jit_compiles <= before:
        raise AssertionError("attn_chunk did not reboot and re-compile")

    env.reset()
    tuner = AutoTuner(env, seed=0, window_s=window_s, top_levers=5)
    walls = {}
    t0 = time.perf_counter()
    tuner.collect(16, windows_per_cluster=8)
    walls["collect(16)"] = time.perf_counter() - t0
    launch, path = lasso_mod.lasso_cd, []

    def spy(xtx, xty, w0, lams, n, *, epochs):
        out = launch(xtx, xty, w0, lams, n, epochs=epochs)
        path.append(((xtx.clone(), xty.clone(), w0.clone(), lams.clone(), n,
                      epochs), out.clone()))
        return out

    t0 = time.perf_counter()
    with mock.patch.object(lasso_mod, "lasso_cd", spy):
        mets, levs = tuner.analyse()
    walls["analyse"] = time.perf_counter() - t0
    print(f"  analyse: metrics k={tuner.selection.k}: {mets}; levers {levs}")
    env.reset()
    cfgr = tuner.build_configurator(steps_per_episode=3,
                                    episodes_per_update=2, window_s=window_s,
                                    f_exploit=0.8)
    reason = cfgr.device_loop_reason()
    t0 = time.perf_counter()
    stats = cfgr.run_update()
    walls["1 host-loop update (6 windows)"] = time.perf_counter() - t0
    ps = [r.p99_ms for r in cfgr.history]
    print(f"  update: host loop ({reason}); {len(ps)} windows, p99 "
          f"{', '.join(f'{p:.3f}' for p in ps)} ms, return "
          f"{stats['mean_return']:.4f}")
    if len(ps) != 6 or not np.isfinite(ps).all():
        raise AssertionError(f"host-loop update gave {ps}")
    e = env.engine
    print(f"  tuner wall by stage: "
          + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items())
          + f"; engine: {e.buffer.stats.total_out} events served, "
          f"{e.jit_compiles} first calls ({e.jit_time_s:.3f} s), "
          f"{e.replays} replays [{facts}]")
    # analyse's Lasso path is one lasso_cd launch on the card; the engine's
    # attention is the plain chunked / naive one (LOCAL_LEVERS offers no
    # other), so nothing else launches
    counts = _launches_as("phase 16", lasso_cd=1)
    # that launch at the shape the local path gives it: as many rows as
    # collected windows, fewer than the features (the levers and their
    # squares)
    if len(path) != 1:
        raise AssertionError(f"analyse made {len(path)} lasso_cd calls")
    (A, b, w0, lt, n, epochs), out = path[0]
    if epochs != 60 or bool(w0.any()) or not A.is_cuda:
        raise AssertionError(f"analyse's lasso_cd: epochs {epochs}, w0 "
                             f"nonzero {bool(w0.any())}, on {A.device}")
    mirror, _ = lc.lasso_cd_mirror(A, b, w0, lt, n, epochs=epochs)
    print(f"  analyse's lasso_cd launch: {n:.0f} rows, p = {A.shape[0]} "
          f"({len(LOCAL_LEVERS)} levers and their squares), "
          f"{lt.numel()} lambdas; its output bitwise equal to the mirror: "
          f"{torch.equal(out.cpu(), mirror.cpu())}")
    if not torch.equal(out.cpu(), mirror.cpu()):
        raise AssertionError("phase 16: analyse's lasso_cd differs from its "
                             "mirror")
    _lasso_case(A, b, lt.cpu().numpy(), int(n), "on the local path", facts)
    print(f"  phase 16 took {time.perf_counter() - t_start:.1f} s")
    return counts


def _train_flops(cfg, B: int, S: int) -> dict:
    """The operations one train step does, counted from the code: the
    weight products (``x @ W`` and the tied head) forward, and twice that
    backward, in the params' dtype; attention's two batched products over
    every (query, key) pair (the chunked path masks, it does not skip) in
    f32, forward, backward twice, and once more recomputed under
    remat "block" or "full"; "full" recomputes the weight products too."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    per_layer = (d * cfg.num_heads * hd * 2 + 2 * d * cfg.num_kv_heads * hd
                 + 3 * d * cfg.d_ff)
    fwd_w = 2 * B * S * (cfg.num_layers * per_layer
                         + d * cfg.vocab_size)
    fwd_a = cfg.num_layers * 2 * (2 * B * cfg.num_heads * S * S * hd)
    recompute = cfg.remat in ("block", "full")
    return {"weights": fwd_w * (3 + (cfg.remat == "full")),
            "attention_f32": fwd_a * (3 + recompute)}


def _train_run(cfg, dev, B: int, S: int, steps: int, warm: int) -> dict:
    """``steps`` timed train steps (after ``warm``) of the full model at
    (B, S), each ended by reading its loss; peak memory over the timed
    steps."""
    from repro_torch.configs.base import InputShape
    from repro_torch.data.synthetic import make_batch
    from repro_torch.distribution import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import adamw

    gc.collect()
    torch.cuda.empty_cache()
    opt = adamw()
    fn = make_train_step(cfg, opt, InputShape("t", S, B, "train")).fn
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    state = opt.init(params)
    batches = [make_batch(cfg, B, S, seed=i, device=dev) for i in range(4)]
    for i in range(warm):
        params, state, m = fn(params, state, batches[i % 4])
        float(m["ce_loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, losses = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        params, state, m = fn(params, state, batches[i % 4])
        losses.append(float(m["ce_loss"]))
        walls.append(time.perf_counter() - t0)
    return {"walls": np.array(walls), "losses": losses,
            "peak": torch.cuda.max_memory_allocated(),
            "step": lambda: fn(params, state, batches[0])}


def _tree_err(got, want, own: bool = False) -> tuple[float, float, float]:
    """(max |got - want| over the scale 1 + max |want| (``own``: max |want|,
    or 1 where want is all zero), the share of elements beyond TRAIN_RTOL of
    that scale, max |got - want|)."""
    g, w = got.detach().float().cpu(), want.detach().float().cpu()
    d = (g - w).abs()
    scale = float(w.abs().max())
    scale = (scale or 1.0) if own else 1.0 + scale
    return (float(d.max()) / scale,
            float((d > TRAIN_RTOL * scale).float().mean()), float(d.max()))


def _train_card_vs_host(dev, facts: str) -> None:
    """17(a): one reduced f32 step on the card and on the host from the
    same state (3 host steps from a seeded init, so AdamW's moments are
    live)."""
    from repro_torch import configs
    from repro_torch.configs.base import InputShape
    from repro_torch.data.synthetic import make_batch
    from repro_torch.distribution import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import adamw
    from repro_torch.utils import tree_leaves, tree_map

    cfg = configs.get("smollm_135m", reduced=True)
    assert cfg.dtype == "float32" and not torch.backends.cuda.matmul.allow_tf32
    opt, shape = adamw(), InputShape("t", 128, 8, "train")
    host = make_train_step(cfg, opt, shape, device="cpu").fn
    card = make_train_step(cfg, opt, shape, device=dev).fn
    p = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    o = opt.init(p)
    for i in range(3):
        p, o, _ = host(p, o, make_batch(cfg, 8, 128, seed=i, device="cpu"))
    b = make_batch(cfg, 8, 128, seed=3, device="cpu")
    to = lambda t: tree_map(lambda x: x.to(dev), t)
    want_p, want_o, want_m = host(p, o, b)
    got_p, got_o, got_m = card(to(p), to(o), to(b))
    lw, lg = float(want_m["ce_loss"]), float(got_m["ce_loss"])
    worst = {"params": (0.0, 0.0, 0.0), "moments": (0.0, 0.0, 0.0)}
    trees = [("params", got_p, want_p, p)] + [
        ("moments", got_o[k], want_o[k], o[k]) for k in ("mu", "nu")]
    for kind, gt, wt, w0t in trees:
        for g, w, w0 in zip(tree_leaves(gt), tree_leaves(wt),
                            tree_leaves(w0t)):
            err, far, dmax = _tree_err(g, w, own=kind == "moments")
            worst[kind] = tuple(max(a, b) for a, b in
                                zip(worst[kind], (err, far, dmax)))
            step = float((w - w0).abs().max())
            if far >= TRAIN_FAR or dmax > 0.25 * step:
                raise AssertionError(
                    f"17(a) {kind} leaf {tuple(w.shape)}: {far} of it beyond "
                    f"{TRAIN_RTOL} of its scale, max {dmax} against a step "
                    f"of {step}")
    print(f"  (a) reduced f32 step, card vs host: loss {lg:.7f} / {lw:.7f} "
          f"(rel {abs(lg - lw) / lw:.3e}); "
          + "; ".join(f"{k}: worst leaf {v[0]:.3e} of its scale, {v[1]:.3e} "
                      f"of a leaf beyond {TRAIN_RTOL} (limit {TRAIN_FAR}), "
                      f"max |diff| {v[2]:.3e}" for k, v in worst.items()))
    if abs(lg - lw) > TRAIN_RTOL * lw:
        raise AssertionError("17(a) loss card vs host")


def _train_drill(dev, facts: str, tmp: Path) -> None:
    """17(b): launch/train.py at the reference launcher's batch and
    sequence on the full model, DRILL_STEPS steps with a failure at
    DRILL_FAIL, against an uninterrupted run. The checkpoint written at
    step DRILL_CKPT and the tree restored from it are held bitwise
    equal."""
    from unittest import mock

    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.checkpoint.store import _host_leaves
    from repro_torch.launch import train as ltrain

    seen = {}
    write, restore = CheckpointStore._write, CheckpointStore.restore

    def spy_write(self, step, host_flat, extra):
        if step == DRILL_CKPT and "saved" not in seen:
            seen["saved"] = {k: v.copy() for k, v in host_flat.items()}
        if step == DRILL_STEPS:
            seen[self.dir.parent.name] = {k: v.copy()
                                          for k, v in host_flat.items()}
        return write(self, step, host_flat, extra)

    def spy_restore(self, skeleton, **kw):
        out = restore(self, skeleton, **kw)
        seen["restored"] = (out[1], _host_leaves(out[0]))
        return out

    n, fail, ck = DRILL_STEPS, DRILL_FAIL, DRILL_CKPT
    args = ["--full", "--batch", "8", "--seq", "128", "--steps", str(n),
            "--ckpt-every", str(ck), "--log-every", str(ck)]
    t0 = time.perf_counter()
    with mock.patch.object(CheckpointStore, "_write", spy_write), \
            mock.patch.object(CheckpointStore, "restore", spy_restore):
        drill = ltrain.main(args + ["--inject-failure", str(fail),
                                    "--ckpt-dir",
                                    str(tmp / "drill")])
        t_drill = time.perf_counter() - t0
        t0 = time.perf_counter()
        plain = ltrain.main(args + ["--ckpt-dir", str(tmp / "plain")])
        t_plain = time.perf_counter() - t0
    step, got = seen["restored"]
    saved = seen["saved"]
    same = (step == ck and set(got) == set(saved) and all(
        got[k].dtype == saved[k].dtype and got[k].tobytes() == saved[k].tobytes()
        for k in saved))
    # the drill's steps are 0..fail-1, then ck..n-1 again from the checkpoint
    d_loss = np.array(drill["losses"], np.float64)
    p_loss = np.array(plain["losses"], np.float64)
    if len(d_loss) != fail + n - ck or len(p_loss) != n:
        raise AssertionError(f"17(b) {len(d_loss)} drill / {len(p_loss)} "
                             f"uninterrupted losses, expected "
                             f"{fail + n - ck} / {n}")
    at = np.r_[np.arange(fail), np.arange(ck, n)]
    rel = np.abs(d_loss - p_loss[at]) / np.abs(p_loss[at])
    move = abs(p_loss[ck] - p_loss[n - 1]) / p_loss[n - 1]
    fin_d, fin_p = seen["drill"], seen["plain"]
    leaf_rel = {}
    for k, v in fin_p.items():
        a, c = fin_d[k], v
        if c.dtype.kind == "V":             # bf16, stored as 2-byte records
            a = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            c = torch.from_numpy(c.view(np.int16)).view(torch.bfloat16)
        a, c = torch.as_tensor(a).double(), torch.as_tensor(c).double()
        leaf_rel[k] = float((a - c).abs().max()) / (float(c.abs().max())
                                                    or 1.0)
    worst_leaf = max(leaf_rel, key=leaf_rel.get)
    ms = 1e3 * np.median(plain["step_s"][5:])
    print(f"  (b) launch/train.main --full --batch 8 --seq 128, {n} steps: "
          f"drill resumed at {drill['resumed_at']}, restored tree of step "
          f"{step} bitwise equal to the saved one: {same} ({len(saved)} "
          f"leaves); each step's loss vs the uninterrupted run's: max rel "
          f"{rel.max():.3e} (steps {ck}-{n - 1} after the resume "
          f"{rel[fail:].max():.3e},"
          f" limit {DRILL_RTOL}); final loss {d_loss[-1]:.7f} / "
          f"{p_loss[-1]:.7f}; the loss moves {move:.3e} from step {ck} to "
          f"{n - 1}; "
          f"final params and moments, {len(fin_p)} leaves: worst "
          f"{leaf_rel[worst_leaf]:.3e} of its max ({worst_leaf}), bitwise "
          f"equal {all(fin_d[k].tobytes() == v.tobytes() for k, v in fin_p.items())}"
          f"; losses {p_loss[0]:.4f} -> {p_loss[-1]:.4f}; median step "
          f"{ms:.3f} ms; wall {t_drill:.1f} s (drill) / {t_plain:.1f} s, "
          f"checkpoints included [{facts}]")
    if drill["resumed_at"] != [ck] or not same:
        raise AssertionError(f"17(b) drill did not resume bitwise at step "
                             f"{ck}")
    if not (np.isfinite(d_loss).all() and np.isfinite(p_loss).all()):
        raise AssertionError("17(b) non-finite loss")
    if rel.max() > DRILL_RTOL or leaf_rel[worst_leaf] > DRILL_RTOL:
        raise AssertionError(f"17(b) drill vs uninterrupted: loss rel "
                             f"{rel.max()}, leaf {worst_leaf} "
                             f"{leaf_rel[worst_leaf]}")
    if not move > DRILL_RTOL:
        raise AssertionError(f"17(b) the loss moved {move} over steps "
                             f"{ck}-{n - 1}")


def _train_accum(dev, cfg) -> None:
    """17(f): accum_steps=2 against 1 at the same global batch (8 x 128),
    on an f32 copy of the full model, one step from the same init."""
    from repro_torch.configs.base import InputShape
    from repro_torch.data.synthetic import make_batch
    from repro_torch.distribution import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import adamw
    from repro_torch.utils import tree_leaves

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    opt, shape = adamw(), InputShape("t", 128, 8, "train")
    params = init_params(cfg32, torch.Generator(device=dev).manual_seed(0))
    b = make_batch(cfg32, 8, 128, seed=0, device=dev)
    outs = [make_train_step(cfg32, opt, shape, accum_steps=k).fn(
        params, opt.init(params), b) for k in (1, 2)]
    (p1, o1, m1), (p2, o2, m2) = outs
    l1, l2 = float(m1["ce_loss"]), float(m2["ce_loss"])
    worst_m = max(_tree_err(a, c, own=True)[0] for a, c in zip(
        tree_leaves([o2["mu"], o2["nu"]]), tree_leaves([o1["mu"], o1["nu"]])))
    far = max(_tree_err(a, c)[1] for a, c in zip(tree_leaves(p2),
                                                 tree_leaves(p1)))
    print(f"  (f) accum_steps 2 vs 1, f32 full width, 8 x 128: loss "
          f"{l2:.7f} / {l1:.7f} (rel {abs(l2 - l1) / l1:.3e}); moments worst "
          f"{worst_m:.3e} of their leaf's max (limit {TRAIN_RTOL}); params beyond {TRAIN_RTOL} of scale: "
          f"{far:.3e} of a leaf at most (limit {TRAIN_FAR})")
    if abs(l2 - l1) > TRAIN_RTOL * l1 or worst_m > TRAIN_RTOL \
            or far >= TRAIN_FAR:
        raise AssertionError("17(f) accum_steps 2 against 1")


def phase_train(dev, facts: str) -> dict:
    """The training step at full SmolLM-135M width: the card against the
    host on the reduced model, the launcher's failure drill, throughput at
    8 x 1024 by remat mode, a profiled step, the FLOP count, gradient
    accumulation. No kernel launches."""
    import tempfile

    from repro_torch.configs import smollm_135m

    t_start = time.perf_counter()
    cfg = smollm_135m.CONFIG
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.d_ff, cfg.vocab_size, cfg.tie_embeddings, cfg.dtype,
            cfg.scan_layers, cfg.remat, cfg.attn_chunk) == (
        30, 576, 9, 3, 1536, 49152, True, "bfloat16", True, "block", 1024)
    _zero_counts()
    _train_card_vs_host(dev, facts)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        _train_drill(dev, facts, Path(tmp))

    B, S = 8, 1024
    n_params = cfg.param_count()
    fl = _train_flops(cfg, B, S)
    t_w, t_a = fl["weights"] / BF16_OPS_S, fl["attention_f32"] / F32_OPS_S
    run = _train_run(cfg, dev, B, S, steps=20, warm=3)
    w = run["walls"]
    tok_s = 20 * B * S / w.sum()
    print(f"  (c) {cfg.name} full ({n_params} parameters, bf16, f32 AdamW "
          f"moments, remat block), {B} x {S}: {tok_s:.1f} tokens/s over 20 "
          f"steps after 3; ms/step median {1e3 * np.median(w):.3f}, min "
          f"{1e3 * w.min():.3f}, max {1e3 * w.max():.3f}; losses "
          f"{run['losses'][0]:.4f} -> {run['losses'][-1]:.4f}; peak "
          f"{run['peak'] / 2**30:.3f} GiB [{facts}]")
    if not np.isfinite(run["losses"]).all():
        raise AssertionError("non-finite training loss")
    prof = _profile(run["step"], "train step (8 x 1024, remat block)", facts,
                    top=10)
    print(f"  (d) profiled step: busy {prof['busy_ms']:.3f} of "
          f"{prof['wall_ms']:.3f} ms ({100 * prof['busy_ms'] / prof['wall_ms']:.1f}"
          f" %), {prof['kernel_calls']} kernel-launch calls")
    med = float(np.median(w))
    print(f"  (e) operations a step (from the code): weight products "
          f"{fl['weights'] / 1e12:.4f} TFLOP (bf16, {t_w * 1e3:.3f} ms at "
          f"989 TFLOP/s), attention {fl['attention_f32'] / 1e12:.4f} TFLOP "
          f"(f32 CUDA cores, {t_a * 1e3:.3f} ms at 67 TFLOP/s): "
          f"{(fl['weights'] + fl['attention_f32']) / (B * S) / 1e9:.4f} "
          f"GFLOP a token; the step at {med * 1e3:.3f} ms is "
          f"{(t_w + t_a) / med:.4f} of that bound, {t_w / med:.4f} of the "
          f"bf16 weight products' alone [{facts}]")
    del run, prof
    for remat in ("none", "full"):
        r = _train_run(dataclasses.replace(cfg, remat=remat), dev, B, S,
                       steps=3, warm=1)
        print(f"  (c) remat {remat}: peak {r['peak'] / 2**30:.3f} GiB, "
              f"ms/step median {1e3 * np.median(r['walls']):.3f} (3 steps "
              f"after 1)")
        del r
    _train_accum(dev, cfg)
    counts = _launches_as("phase 17")
    print(f"  phase 17 took {time.perf_counter() - t_start:.1f} s")
    return counts


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def _sync(dev) -> None:
    """Wait for the card (nothing to wait for on the host)."""
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree)
               if t is not None)


def _decode_step_bound(params, cfg, state, B: int,
                       experts: float = 0.0) -> dict:
    """The bytes one decode step must move: every decoder weight read once
    (the embedding's B rows where the head is its own, one row of
    whisper's ``dec_pos``, not its encoder; an MoE's experts only as many
    a layer as the step routed to, ``experts`` on average), the whole
    cache, recurrent state and whisper's cross K/V read (as the masked
    softmax over Smax reads the cache; and, beside it, only the positions
    up to pos), the state written (one position of each K/V cache; the
    whole recurrent state)."""
    el = lambda t: t.numel() * t.element_size()  # noqa: E731
    emb = params["embed"]
    w = _nbytes(params)
    if not cfg.tie_embeddings:
        w -= el(emb) - B * emb.shape[1] * emb.element_size()
    for k in ("enc_layers", "enc_norm", "enc_pos"):
        w -= _nbytes(params.get(k, {}))
    if "dec_pos" in params:
        w -= el(params["dec_pos"]) - params["dec_pos"][0].numel() * \
            params["dec_pos"].element_size()
    if cfg.family == "moe":
        moe = params["layers"]["moe"]
        per_expert = sum(el(moe[k]) for k in ("wg", "wu", "wd")) // (
            cfg.num_layers * cfg.num_experts)
        w -= per_expert * cfg.num_layers * (cfg.num_experts - experts)
    kv = _nbytes([state.kv_k, state.kv_v])
    cross = _nbytes([state.cross_k, state.cross_v])
    rec = _nbytes(state.ssm) if state.ssm is not None else 0
    per_pos = kv // state.kv_k.shape[2] if state.kv_k is not None else 0
    pos = int(state.pos)
    whole = w + kv + cross + rec + per_pos + rec
    valid = w + per_pos * (pos + 1) + cross + rec + per_pos + rec
    return {"weights": w, "kv": kv, "cross": cross, "recurrent": rec,
            "bytes": whole, "bytes_valid": valid,
            "ms": whole / HBM_BYTES_S * 1e3,
            "ms_valid": valid / HBM_BYTES_S * 1e3}


def _decode_run(dev, facts: str, name: str, B: int, P: int,
                impl: str) -> dict:
    """One config: the f32 cut-depth check, then the full model in bf16
    through make_prefill_step and DECODE_STEPS greedy make_decode_step
    steps (launch counts read around exactly these), a profiled step, the
    checks, then the bf16 full-depth decode-vs-prefill distance against its
    floor."""
    from repro_torch import configs
    from repro_torch.configs.base import InputShape
    from repro_torch.distribution import make_decode_step, make_prefill_step
    from repro_torch.models import forward_decode, lm

    cfg = dataclasses.replace(configs.get(name), attn_impl=impl)
    assert cfg.dtype == "bfloat16" and cfg.scan_layers
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, P)).astype(np.int32)).to(dev)
    rows = toks[:DECODE_CHECK_ROWS]
    _family_f32_check(dev, cfg, {"tokens": rows})
    attn = None
    if impl == "pallas":
        attn = _decode_attention_case(dev, facts, cfg, B, P)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"  {cfg.name} ({cfg.family}, {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, bf16, attn {impl}): {n_params} parameters drawn on "
          f"the card in {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    pre = make_prefill_step(cfg, InputShape("decode_32k", P, B, "prefill"),
                            max_seq=DECODE_CONTEXT, device=dev)
    dec = make_decode_step(cfg, InputShape("decode_32k", DECODE_CONTEXT, B,
                                           "decode"), device=dev)
    assert pre.meta["max_seq"] == dec.meta["max_seq"] == DECODE_CONTEXT
    _zero_counts()
    t0 = time.perf_counter()
    logits, state = pre.fn(params, {"tokens": toks})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    if not torch.isfinite(logits.float()).all():
        raise AssertionError(f"{cfg.name}: non-finite prefill logits")
    tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
    del logits
    walls, toks_out = [], [tok]
    for i in range(DECODE_STEPS):
        t0 = time.perf_counter()
        tok, state = dec.fn(params, tok, state)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        toks_out.append(tok)
        if int(state.pos) != P + i + 1:
            raise AssertionError(f"{cfg.name}: pos {int(state.pos)} after "
                                 f"step {i + 1} of a {P}-token prompt")
    counts = _counts()
    want = cfg.num_layers if impl == "pallas" else 0
    print(f"  kernel launches over the prefill and {DECODE_STEPS} steps: "
          f"{counts}")
    if counts != {**{n: 0 for n in KERNEL_MODULES}, "flash_attention": want}:
        raise AssertionError(f"{cfg.name}: launches {counts}, expected "
                             f"{want} flash_attention")
    out = torch.cat(toks_out, dim=1)
    if not ((out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError(f"{cfg.name}: a token out of the vocabulary")
    peak = torch.cuda.max_memory_allocated()
    w = np.array(walls[DECODE_WARM:])
    med = float(np.median(w))
    bound = _decode_step_bound(params, cfg, state, B)
    print(f"  prefill {B} x {P} into a {DECODE_CONTEXT}-position state: "
          f"{prefill_ms:.3f} ms ({B * P / prefill_ms * 1e3:.1f} tokens/s); "
          f"state {(bound['kv'] + bound['recurrent']) / 1e9:.3f} GB (K/V "
          f"{bound['kv'] / 1e9:.3f}, recurrent {bound['recurrent'] / 1e9:.3f})"
          f" [{facts}]")
    print(f"  decode: {B * len(w) / w.sum():.1f} tokens/s over "
          f"{len(w)} steps after {DECODE_WARM}; ms a step median "
          f"{med * 1e3:.3f}, min {w.min() * 1e3:.3f}, max "
          f"{w.max() * 1e3:.3f} (first {walls[0] * 1e3:.3f}); peak "
          f"{peak / 2**30:.3f} GiB [{facts}]")
    print(f"  byte bound a step: weights {bound['weights'] / 1e9:.3f} GB + "
          f"the whole cache / state read and the state written = "
          f"{bound['bytes'] / 1e9:.3f} GB -> {bound['ms']:.3f} ms at 3.35 "
          f"TB/s: the step at {bound['ms'] / (med * 1e3):.4f} of it; "
          f"positions <= pos only: {bound['bytes_valid'] / 1e9:.3f} GB -> "
          f"{bound['ms_valid']:.3f} ms ({bound['ms_valid'] / (med * 1e3):.4f})")
    held = {}

    def one_step():
        held["out"] = dec.fn(params, tok, state)

    prof = _profile(one_step, f"{cfg.name} decode step", facts, top=6)
    tok, state = held.pop("out")
    print(f"  profiled step: busy {prof['busy_ms']:.3f} of "
          f"{prof['wall_ms']:.3f} ms ({100 * prof['busy_ms'] / prof['wall_ms']:.1f}"
          f" %), {prof['kernel_calls']} kernel-launch calls")
    with torch.inference_mode():
        logits, state = forward_decode(params, cfg, tok, state)
    leaves = [t for t in _leaves([state.pos, state.kv_k, state.kv_v,
                                  state.ssm]) if t is not None]
    if not all(t.device.type == dev.type for t in leaves):
        raise AssertionError(f"{cfg.name}: a state tensor off the card")
    # layer by layer: a bool mask of a whole cache would take 15 GB
    if not torch.isfinite(logits).all() or not all(
            bool(torch.isfinite(x).all()) for t in leaves
            if t.is_floating_point() for x in t):
        raise AssertionError(f"{cfg.name}: non-finite decode logits or state")
    if int(state.pos) != P + DECODE_STEPS + 2:
        raise AssertionError(f"{cfg.name}: pos {int(state.pos)}")
    del state, logits, leaves, pre, dec
    _free()
    _family_bf16_check(params, cfg, {"tokens": rows})
    del params
    _free()
    return {"counts": counts, "tokens_s": B * len(w) / w.sum(),
            "ms": med * 1e3, "peak": peak, "bound_ms": bound["ms"],
            "attention": attn}


def _decode_attention_case(dev, facts: str, cfg, B: int, P: int) -> dict:
    """The flash-attention kernel against its plain version at the shape and
    strides the bf16 prefill gives it: (B, P, H, hd) tensors in the model's
    layout, passed as the transposed views ``ops.flash_attention`` passes,
    causal from offset 0, and SDPA's time on the same views (the library
    yardstick). Launched before the launch counts are zeroed."""
    g = torch.Generator(device=dev).manual_seed(7)
    hd = cfg.resolved_head_dim
    q, k, v = (torch.randn((B, P, h, hd), generator=g, device=dev)
               .to(torch.bfloat16).transpose(1, 2)
               for h in (cfg.num_heads, cfg.num_kv_heads, cfg.num_kv_heads))
    row = _attention_case(f"{cfg.name}-prefill", q, k, v, True, 0, facts)
    row["library_ms"], host = _sdpa_ms(q, k, v,
                                       cfg.num_heads // cfg.num_kv_heads)
    print(f"    scaled_dot_product_attention(is_causal=True, enable_gqa=True) "
          f"on the same views: device {row['library_ms'] * 1e3:.3f} us (host "
          f"loop {host * 1e3:.3f} us); the kernel "
          f"{row['ms'] / row['library_ms']:.2f}x of it [{facts}]")
    del q, k, v
    _free()
    return row


def phase_decode(dev, facts: str) -> dict:
    """Phase 18 (see the module docstring): each DECODE_RUNS config in
    turn, freed before the next. Returns the kernel launches summed over
    the three main runs."""
    t_start = time.perf_counter()
    _free()
    total = {n: 0 for n in KERNEL_MODULES}
    attn = None
    for name, B, P, impl in DECODE_RUNS:
        t0 = time.perf_counter()
        r = _decode_run(dev, facts, name, B, P, impl)
        total = {n: total[n] + r["counts"][n] for n in total}
        attn = r["attention"] or attn
        print(f"  {name} took {time.perf_counter() - t0:.1f} s")
    print(f"  kernel launches over phase 18's main runs: {total}")
    print(f"  phase 18 took {time.perf_counter() - t_start:.1f} s")
    return total, attn


@contextlib.contextmanager
def _moe_watch():
    """Records every MoE layer's aux (``moe_apply``) and router choices
    (``moe_route``) while the block runs, without a host sync."""
    from repro_torch.models import layers as L

    rec = {"drop": [], "idx": []}
    apply0, route0 = L.moe_apply, L.moe_route

    def apply(*a, **kw):
        out, aux = apply0(*a, **kw)
        rec["drop"].append(aux["moe_drop_frac"])
        return out, aux

    def route(*a, **kw):
        r = route0(*a, **kw)
        rec["idx"].append(r[1])
        return r

    L.moe_apply, L.moe_route = apply, route
    try:
        yield rec
    finally:
        L.moe_apply, L.moe_route = apply0, route0


def _mean_drop(drops: list) -> float:
    """The mean of recorded per-layer drop fractions (nan without any)."""
    return float(torch.stack(drops).mean()) if drops else float("nan")


def _watched(cfg, rec: dict, calls: int, what: str) -> None:
    """Fails unless ``_moe_watch`` saw one ``moe_apply`` and one
    ``moe_route`` a layer in each of ``calls`` forward calls of an MoE
    (none for another family): a path that bypassed them would leave the
    drop fractions and routed experts unrecorded."""
    want = cfg.num_layers * calls if cfg.family == "moe" else 0
    got = (len(rec["drop"]), len(rec["idx"]))
    if got != (want, want):
        raise AssertionError(f"{cfg.name}: {what}: the watch recorded "
                             f"{got} MoE layer calls, not {want}")


@contextlib.contextmanager
def _moe_pinned(plan: list):
    """Routes each ``moe_route`` call's tokens to the experts that the next
    entry of ``plan`` names ((B, S, k), reshaped to the call's groups), in
    GShard order (``moe_queue``), with the call's own router
    probabilities at those experts renormalised as its gates. ``rec``
    counts the (token, choice) slots whose expert the call's own top-k
    would have changed, and the entries of ``plan`` not used."""
    from repro_torch.models import layers as L

    route0 = L.moe_route
    rec = {"flips": 0, "slots": 0, "left": len(plan)}
    entries = iter(plan)

    def route(p, cfg, x):
        probs, own = route0(p, cfg, x)[:2]
        idx = next(entries).reshape(*x.shape[:2], -1)
        rec["left"] -= 1
        vals = probs.gather(-1, idx)
        vals = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
        kept = (idx[..., :, None] == own[..., None, :]).any(-1)
        rec["flips"] += int((~kept).sum())
        rec["slots"] += idx.numel()
        return probs, idx, vals, *L.moe_queue(idx, cfg.num_experts)

    L.moe_route = route
    try:
        yield rec
    finally:
        L.moe_route = route0


def _family_batch(cfg, B: int, P: int, dev, seed: int = 0) -> dict:
    """Tokens from a seed, and the stub front ends' inputs: a VLM's
    ``patch_embeds``, whisper's ``frames`` (N(0, 1) in the model's dtype)."""
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, P))
    batch = {"tokens": torch.from_numpy(toks.astype(np.int32)).to(dev)}
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, cfg.dtype)
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn(
            (B, cfg.vision_tokens, cfg.d_model), generator=g,
            device=dev).to(dt)
    if cfg.family == "audio":
        batch["frames"] = torch.randn((B, cfg.encoder_seq, cfg.d_model),
                                      generator=g, device=dev).to(dt)
    return batch


def _no_drop(cfg):
    """An MoE config whose capacity holds every choice (C >= S for a group
    of S tokens, cf = E / k); other configs as they are."""
    if cfg.family != "moe":
        return cfg
    return dataclasses.replace(
        cfg, moe_capacity_factor=cfg.num_experts / cfg.moe_top_k)


def _family_dvp(params, cfg, batch) -> tuple[float, torch.Tensor, dict]:
    """(max |decode - prefill|, prefill's last logits in f32, MoE drop
    fractions): decode's logits for the last token after a prefill of the
    others (with the batch's patch embeddings or frames), against the last
    logits of a prefill of all of them; caches of exactly the sequence."""
    from repro_torch.models import forward_decode, forward_prefill

    toks = batch["tokens"]
    extras = {k: v for k, v in batch.items() if k != "tokens"}
    Sp = toks.shape[1] + (cfg.vision_tokens if cfg.family == "vlm" else 0)
    with torch.inference_mode(), _moe_watch() as rec:
        _, st = forward_prefill(params, cfg, {**extras, "tokens": toks[:, :-1]},
                                max_seq=Sp)
        _watched(cfg, rec, 1, "the shorter prefill")
        n_pre = len(rec["drop"])
        dec, st = forward_decode(params, cfg, toks[:, -1:], st)
        _watched(cfg, rec, 2, "the decode step")
        n_dec = len(rec["drop"])
        assert int(st.pos) == Sp
        del st
        full, _ = forward_prefill(params, cfg, {**extras, "tokens": toks},
                                  max_seq=Sp)
        _watched(cfg, rec, 3, "the longer prefill")
    drops = {"prefill": _mean_drop(rec["drop"][:n_pre]),
             "decode": _mean_drop(rec["drop"][n_pre:n_dec]),
             "full": _mean_drop(rec["drop"][n_dec:])}
    dec, full = dec[:, -1].float(), full[:, -1].float()
    if not (torch.isfinite(dec).all() and torch.isfinite(full).all()):
        raise AssertionError(f"{cfg.name}: non-finite decode or prefill "
                             f"logits")
    return float((dec - full).abs().max()), full, drops


def _drops_line(cfg, drops: dict) -> str:
    if cfg.family != "moe":
        return ""
    if any(v != 0 for v in drops.values()):
        raise AssertionError(f"{cfg.name}: the no-drop check dropped "
                             f"tokens: {drops}")
    return (f"; capacity factor {cfg.moe_capacity_factor:g} (C >= S): "
            f"moe_drop_frac prefill {drops['prefill']:g}, decode "
            f"{drops['decode']:g}, longer prefill {drops['full']:g}")


def _family_f32_check(dev, cfg, batch) -> None:
    """The config at full width in f32, cut to 4 layers (a hybrid to 2
    periods, whisper's encoder to 4 too), fresh weights, full-precision f32
    products: decode against prefill within DECODE_F32_TOL of the logits'
    scale (an MoE at a capacity that drops nothing)."""
    from repro_torch.models import lm
    from repro_torch.utils import strict_f32

    n = 2 * cfg.hybrid_period if cfg.family == "hybrid" else 4
    c32 = _no_drop(dataclasses.replace(
        cfg, num_layers=n, encoder_layers=min(cfg.encoder_layers, 4),
        dtype="float32"))
    b32 = {k: (v.float() if v.is_floating_point() else v)
           for k, v in batch.items()}
    with strict_f32():
        params = lm.init_params(c32, torch.Generator(device=dev).manual_seed(1),
                                batch["tokens"].shape[1])
        err, full, drops = _family_dvp(params, c32, b32)
    scale = max(1.0, float(full.abs().max()))
    print(f"  (b) f32, {c32.num_layers} layers"
          f"{f' + {c32.encoder_layers} encoder' if c32.encoder_layers else ''}"
          f" at full width, {batch['tokens'].shape[0]} x "
          f"{batch['tokens'].shape[1]}: decode vs prefill max_abs {err:.3e}, "
          f"{err / scale:.3e} of the logits' scale {scale:.3f} (limit "
          f"{DECODE_F32_TOL}){_drops_line(c32, drops)}")
    del params
    _free()
    if err > DECODE_F32_TOL * scale:
        raise AssertionError(f"{cfg.name}: f32 decode vs prefill {err:.3e} "
                             f"out of tolerance")


class _LazyF32:
    """A layer stack walked as f32 copies made one layer at a time, so that
    a model whose f32 copy would not fit the card runs in f32 all the
    same (``lm._layers`` iterates a listed stack once)."""

    def __init__(self, layers, stacked: bool):
        from repro_torch.models import lm

        self.layers = lm._unstack(layers) if stacked else list(layers)

    def __iter__(self):
        from repro_torch.engine.engine import _cast_floats

        for p in self.layers:
            yield _cast_floats(p, torch.float32)


def _f32_last_logits(params, cfg, batch) -> torch.Tensor:
    """forward_prefill's last logits on an f32 copy of the bf16 weights,
    cast a layer at a time, with full-precision f32 products."""
    from repro_torch.engine.engine import _cast_floats
    from repro_torch.models import forward_prefill
    from repro_torch.utils import strict_f32

    stacks = ("layers", "enc_layers")
    p32 = {k: (_LazyF32(v, cfg.scan_layers) if k in stacks
               else _cast_floats(v, torch.float32)) for k, v in params.items()}
    c32 = dataclasses.replace(cfg, dtype="float32", scan_layers=False)
    b32 = {k: (v.float() if v.is_floating_point() else v)
           for k, v in batch.items()}
    Sp = batch["tokens"].shape[1] + (
        cfg.vision_tokens if cfg.family == "vlm" else 0)
    with torch.inference_mode(), strict_f32():
        logits, _ = forward_prefill(p32, c32, b32, max_seq=Sp)
    return logits[:, -1].float()


def _family_bf16_check(params, cfg, batch) -> dict:
    """Full depth in bf16: decode vs prefill against the floor, the bf16
    prefill's distance from the f32 prefill of the same weights. An MoE's
    bf16 routes are pinned to the experts the f32 prefill chose: a near-tie
    that bf16 rounds the other way sends a token to another expert and
    moves its logits by O(1), and over 24 layers such flips, not rounding,
    would set the floor."""
    c = _no_drop(cfg)
    with _moe_watch() as rec:
        f32 = _f32_last_logits(params, c, batch)
    _watched(c, rec, 1, "the f32 prefill")
    B, S = batch["tokens"].shape
    routes = [ix.reshape(B, S, -1) for ix in rec["idx"]]
    del rec
    plan = ([ix[:, :-1] for ix in routes] + [ix[:, -1:] for ix in routes]
            + routes)
    with _moe_pinned(plan) as pin:
        err, full, drops = _family_dvp(params, c, batch)
    if pin["left"]:
        raise AssertionError(f"{cfg.name}: {pin['left']} pinned routes unused")
    floor = float((full - f32).abs().max())
    _free()
    pinned = (f"; experts pinned to the f32 prefill's, where the bf16 routes"
              f" would have chosen another in {pin['flips']} of "
              f"{pin['slots']} (token, choice) slots" if routes else "")
    print(f"  (b) bf16, full depth, {batch['tokens'].shape[0]} x "
          f"{batch['tokens'].shape[1]}: decode vs prefill max_abs {err:.4e}; "
          f"the floor (bf16 vs f32 prefill) {floor:.4e}; ratio "
          f"{err / max(floor, 1e-30):.3f} (limit {DECODE_BF16_X}); logits "
          f"scale {float(full.abs().max()):.3f}{_drops_line(c, drops)}"
          f"{pinned}")
    if err > DECODE_BF16_X * floor:
        raise AssertionError(f"{cfg.name}: bf16 decode vs prefill {err:.4e} "
                             f"> {DECODE_BF16_X} x the floor {floor:.4e}")
    return {"err": err, "floor": floor}


def _family_run(dev, facts: str, name: str, B: int, P: int,
                context: int) -> dict:
    """One config (the module docstring's phase 19 (b) and (c))."""
    from repro_torch import configs
    from repro_torch.configs.base import InputShape
    from repro_torch.distribution import make_decode_step, make_prefill_step
    from repro_torch.models import lm
    from repro_torch.models.layers import moe_capacity

    cfg = dataclasses.replace(configs.get(name), attn_impl="pallas")
    assert cfg.dtype == "bfloat16" and cfg.scan_layers
    rows = min(B, DECODE_CHECK_ROWS)
    check = _family_batch(cfg, rows, FAMILY_CHECK_P.get(name, P), dev, seed=3)
    _family_f32_check(dev, cfg, check)

    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            context)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"  {cfg.name} ({cfg.family}, {cfg.num_layers} layers"
          f"{f' + {cfg.encoder_layers} encoder' if cfg.encoder_layers else ''}"
          f", d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads "
          f"of {cfg.resolved_head_dim}, bf16, attn pallas): {n_params} "
          f"parameters drawn on the card in {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB; rows x prompt x "
          f"context = {B} x {P} x {context}"
          f"{f' after {cfg.vision_tokens} patch positions' if cfg.vision_tokens else ''}"
          f"{f' over {cfg.encoder_seq} frames' if cfg.encoder_seq else ''}")
    bf16 = _family_bf16_check(params, cfg, check)
    del check
    batch = _family_batch(cfg, B, P, dev)
    toks = batch["tokens"]
    pre = make_prefill_step(cfg, InputShape("family", P, B, "prefill"),
                            max_seq=context, device=dev)
    dec = make_decode_step(cfg, InputShape("family", context, B, "decode"),
                           device=dev)
    Sp = P + (cfg.vision_tokens if cfg.family == "vlm" else 0)
    _free()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    with _moe_watch() as rec:
        t0 = time.perf_counter()
        logits, state = pre.fn(params, batch)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        _watched(cfg, rec, 1, "the prefill")
        n_pre = len(rec["drop"])
        if not torch.isfinite(logits.float()).all():
            raise AssertionError(f"{cfg.name}: non-finite prefill logits")
        tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
        del logits
        walls, toks_out = [], [tok]
        for i in range(DECODE_STEPS):
            t0 = time.perf_counter()
            tok, state = dec.fn(params, tok, state)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            toks_out.append(tok)
            if int(state.pos) != Sp + i + 1:
                raise AssertionError(f"{cfg.name}: pos {int(state.pos)} after "
                                     f"step {i + 1}")
        _watched(cfg, rec, 1 + DECODE_STEPS, "the steps")
    counts = _counts()
    want = cfg.num_layers + cfg.encoder_layers
    print(f"  kernel launches over the prefill and {DECODE_STEPS} steps: "
          f"{counts}")
    if counts != {**{n: 0 for n in KERNEL_MODULES}, "flash_attention": want}:
        raise AssertionError(f"{cfg.name}: launches {counts}, expected "
                             f"{want} flash_attention (the prefill's)")
    out = torch.cat(toks_out, dim=1)
    if not ((out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError(f"{cfg.name}: a token out of the vocabulary")
    peak = torch.cuda.max_memory_allocated()
    w = np.array(walls[DECODE_WARM:])
    med = float(np.median(w))
    experts, drops = float(cfg.num_experts), {}
    if cfg.family == "moe":
        L = cfg.num_layers
        steps = rec["idx"][n_pre:]
        per = [int(ix.unique().numel()) for ix in steps[L * DECODE_WARM:]]
        experts = float(np.mean(per))
        drops = {"prefill": _mean_drop(rec["drop"][:n_pre]),
                 "decode": _mean_drop(rec["drop"][n_pre:])}
        print(f"  MoE: moe_drop_frac at prefill {drops['prefill']:.6f} "
              f"(capacity factor {cfg.moe_capacity_factor}, C = "
              f"{moe_capacity(cfg, P)} a row of {P}), at decode "
              f"{drops['decode']:.6f} (one group of {B}, C = "
              f"{moe_capacity(cfg, B)}); experts a layer a step "
              f"{experts:.2f} of {cfg.num_experts} (min {min(per)}, max "
              f"{max(per)})")
    del rec
    bound = _decode_step_bound(params, cfg, state, B, experts)
    print(f"  prefill {B} x {Sp} into a {context}-position state: "
          f"{prefill_ms:.3f} ms ({B * Sp / prefill_ms * 1e3:.1f} positions/s); "
          f"K/V {bound['kv'] / 1e9:.3f} GB, cross K/V {bound['cross'] / 1e9:.3f}"
          f" GB [{facts}]")
    print(f"  decode: {B * len(w) / w.sum():.1f} tokens/s over {len(w)} steps "
          f"after {DECODE_WARM}; ms a step median {med * 1e3:.3f}, min "
          f"{w.min() * 1e3:.3f}, max {w.max() * 1e3:.3f} (first "
          f"{walls[0] * 1e3:.3f}); peak {peak / 2**30:.3f} GiB [{facts}]")
    print(f"  byte bound a step: weights read {bound['weights'] / 1e9:.3f} GB"
          f" + the caches read and one position written = "
          f"{bound['bytes'] / 1e9:.3f} GB -> {bound['ms']:.3f} ms at 3.35 "
          f"TB/s: the step at {bound['ms'] / (med * 1e3):.4f} of it; "
          f"positions <= pos only {bound['ms_valid']:.3f} ms "
          f"({bound['ms_valid'] / (med * 1e3):.4f}) [{facts}]")
    held = {}

    def one_step():
        held["out"] = dec.fn(params, tok, state)

    prof = _profile(one_step, f"{cfg.name} decode step", facts, top=6)
    tok, state = held.pop("out")
    print(f"  profiled step: busy {prof['busy_ms']:.3f} of "
          f"{prof['wall_ms']:.3f} ms ({100 * prof['busy_ms'] / prof['wall_ms']:.1f}"
          f" %), {prof['kernel_calls']} kernel-launch calls")
    leaves = [t for t in _leaves([state.pos, state.kv_k, state.kv_v,
                                  state.cross_k, state.cross_v])
              if t is not None]
    if not all(t.device.type == dev.type for t in leaves):
        raise AssertionError(f"{cfg.name}: a state tensor off the card")
    del state, leaves, pre, dec, params, batch, toks
    _free()
    return {"counts": counts, "tokens_s": B * len(w) / w.sum(),
            "ms": med * 1e3, "peak": peak, "bound_ms": bound["ms"],
            "prefill_ms": prefill_ms, "busy": prof["busy_ms"] /
            prof["wall_ms"], "drops": drops, **bf16}


def _rel_rms(a, b) -> float:
    """rms(a - b) / rms(b), in f32."""
    a, b = a.float(), b.float()
    return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())


def _planted_faults(q, k, v, causal: bool) -> dict:
    """The plain version with a fault planted that a kernel could have:
    non-causal with a ragged key tail, the tail's padding to a whole
    64-key tile (k = v = 0) left unmasked, or the tail dropped; causal,
    each query seeing one key past the diagonal."""
    from repro_torch.kernels import flash_attention as fa

    Skv, tile = k.shape[2], 64
    if causal:
        return {"one key past the diagonal":
                fa.flash_attention_bhsd_ref(q, k, v, causal=True, q_offset=1)}
    out = {}
    if Skv % tile:
        pad = (0, 0, 0, -Skv % tile)
        out["padded tail unmasked"] = fa.flash_attention_bhsd_ref(
            q, torch.nn.functional.pad(k, pad),
            torch.nn.functional.pad(v, pad), causal=False)
        n = Skv - Skv % tile
        out["ragged tail dropped"] = fa.flash_attention_bhsd_ref(
            q, k[:, :, :n], v[:, :, :n], causal=False)
    return out


def _family_attention(dev, facts: str) -> dict:
    """Phase 19(a): the bf16 kernel against its plain version at whisper's
    encoder shape and InternVL2's prefill shape, in the model's (B, S, H,
    hd) layout passed as the transposed views ``ops.flash_attention``
    passes, with SDPA's time on the same views. Beside ATTN_TOL, the error
    relative to the output's rms is held within FAMILY_ATTN_REL, and each
    planted fault of the plain version must exceed that limit."""
    from repro_torch.kernels import flash_attention as fa

    rows = {}
    for label, B, Hq, Hkv, S, hd, causal in (
            ("whisper-encoder", 4, 20, 20, 1500, 64, False),
            ("internvl2-prefill", 2, 48, 8, 768, 128, True)):
        g = torch.Generator(device=dev).manual_seed(11)
        q, k, v = (torch.randn((B, S, h, hd), generator=g, device=dev)
                   .to(torch.bfloat16).transpose(1, 2)
                   for h in (Hq, Hkv, Hkv))
        row = _attention_case(label, q, k, v, causal, 0, facts)
        want = fa.flash_attention_bhsd_ref(q, k, v, causal=causal)
        rel = _rel_rms(fa.flash_attention_bhsd(q, k, v, causal=causal), want)
        faults = {name: _rel_rms(bad, want) for name, bad in
                  _planted_faults(q, k, v, causal).items()}
        rms = float(want.float().pow(2).mean().sqrt())
        print(f"    output rms {rms:.4e}: max_abs {row['max_abs_err'] / rms:.4f}"
              f" of it; rms(kernel - plain) {rel:.4e} of it (limit "
              f"{FAMILY_ATTN_REL}); planted faults of the plain version: "
              + ", ".join(f"{n} {e:.4e}" for n, e in faults.items()))
        if rel > FAMILY_ATTN_REL:
            raise AssertionError(f"flash_attention at {label}: rms error "
                                 f"{rel:.4e} of the output's > "
                                 f"{FAMILY_ATTN_REL}")
        missed = [n for n, e in faults.items() if e <= FAMILY_ATTN_REL]
        if missed:
            raise AssertionError(f"flash_attention at {label}: the limit "
                                 f"{FAMILY_ATTN_REL} would pass {missed}")
        del want
        sdpa_ms, sdpa_host = _sdpa_ms(q, k, v, Hq // Hkv, causal=causal)
        print(f"    scaled_dot_product_attention(is_causal={causal}, "
              f"enable_gqa=True): device {sdpa_ms * 1e3:.3f} us, host loop "
              f"{sdpa_host * 1e3:.3f} us; the kernel {row['ms'] / sdpa_ms:.3f}"
              f"x SDPA's [{facts}]")
        rows[label] = {**row, "library_ms": sdpa_ms, "rel_rms_err": rel,
                       "planted_rel_rms": faults}
        del q, k, v
        _free()
    return rows


def _grok_cut(dev, facts: str) -> dict:
    """Phase 19(d): grok-1-314b at full width, cut to GROK_CUT's layers."""
    from repro_torch import configs
    from repro_torch.configs.base import InputShape
    from repro_torch.distribution import make_prefill_step
    from repro_torch.models import lm
    from repro_torch.models.layers import moe_capacity

    n, B, P, steps = GROK_CUT
    cfg = dataclasses.replace(configs.get("grok1_314b"), num_layers=n,
                              attn_impl="pallas")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"  (d) {cfg.name} cut to {n} of 64 layers (moe, d_model "
          f"{cfg.d_model}, {cfg.num_experts} experts top-{cfg.moe_top_k} of "
          f"moe_d_ff {cfg.moe_d_ff}, no shared expert, bf16): {n_params} "
          f"parameters ({_nbytes(params) / 1e9:.3f} GB) drawn in "
          f"{time.perf_counter() - t0:.2f} s")
    pre = make_prefill_step(cfg, InputShape("grok", P, B, "prefill"),
                            max_seq=P + steps, device=dev)
    batch = _family_batch(cfg, B, P, dev)
    _zero_counts()
    with _moe_watch() as rec:
        t0 = time.perf_counter()
        logits, state = pre.fn(params, batch)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        _watched(cfg, rec, 1, "the prefill")
        n_pre = len(rec["drop"])
        finite = bool(torch.isfinite(logits.float()).all())
        tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
        walls = []
        for _ in range(steps):
            t0 = time.perf_counter()
            logits, state = lm.forward_decode(params, cfg, tok, state)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            finite &= bool(torch.isfinite(logits.float()).all())
            tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
        _watched(cfg, rec, 1 + steps, "the steps")
    counts = _counts()
    drops = {"prefill": _mean_drop(rec["drop"][:n_pre]),
             "decode": _mean_drop(rec["drop"][n_pre:])}
    peak = torch.cuda.max_memory_allocated()
    print(f"  prefill {B} x {P}: {prefill_ms:.3f} ms, moe_drop_frac "
          f"{drops['prefill']:.6f} (C = {moe_capacity(cfg, P)}); {steps} steps, "
          f"ms a step median {np.median(walls) * 1e3:.3f}, moe_drop_frac "
          f"{drops['decode']:.6f} (C = {moe_capacity(cfg, B)}); launches "
          f"{counts}; peak {peak / 2**30:.3f} GiB; logits finite: {finite} "
          f"[{facts}]")
    del params, state, logits, pre, batch, rec
    _free()
    if not finite:
        raise AssertionError(f"{cfg.name}: non-finite logits")
    if counts != {**{k: 0 for k in KERNEL_MODULES}, "flash_attention": n}:
        raise AssertionError(f"{cfg.name}: launches {counts}")
    return {"counts": counts, "drops": drops}


def phase_families(dev, facts: str) -> tuple[dict, dict]:
    """Phase 19 (see the module docstring): the kernel at this phase's
    shapes, then each FAMILY_RUNS config in turn and grok-1's cut, freed
    before the next. Returns the kernel launches summed over the main runs
    and the kernel rows of (a)."""
    t_start = time.perf_counter()
    _free()
    attn = _family_attention(dev, facts)
    total = {n: 0 for n in KERNEL_MODULES}
    for name, B, P, context in FAMILY_RUNS:
        t0 = time.perf_counter()
        r = _family_run(dev, facts, name, B, P, context)
        total = {n: total[n] + r["counts"][n] for n in total}
        print(f"  {name} took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _grok_cut(dev, facts)
    print(f"  grok-1 took {time.perf_counter() - t0:.1f} s")
    print(f"  kernel launches over phase 19's three main runs: {total}")
    print(f"  phase 19 took {time.perf_counter() - t_start:.1f} s")
    return total, attn


#: phase 20(a): the dry-run's cells held against the card, each at full
#: width: (arch, shape, (batch, seq) cut or None). train_4k cut to phase 17's
#: 8 x 1024, decode_32k to phase 18's batch 16; long_500k whole
DRYRUN_CELLS = (("smollm_135m", "train_4k", (8, 1024)),
                ("qwen2_7b", "decode_32k", (16, 32768)),
                ("rwkv6_7b", "long_500k", None))
DRYRUN_STEPS, DRYRUN_WARM = 5, 2


def _cell_args(cfg, shape, opt, dev) -> tuple:
    """The step's arguments on the card, drawn from seeds: the parameter
    tree, then the optimizer state and a make_batch batch (train), or
    random tokens and a fresh decode state (decode)."""
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models import lm

    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            shape.seq_len)
    B = shape.global_batch
    if shape.kind == "train":
        return params, opt.init(params), make_batch(cfg, B, shape.seq_len,
                                                    seed=0, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (B, 1), dtype=torch.int32,
                         generator=torch.Generator(device=dev).manual_seed(1),
                         device=dev)
    return params, toks, lm.init_decode_state(cfg, B, shape.seq_len,
                                              device=dev)


def _dryrun_cell(dev, facts: str, arch: str, shape_name: str, cut) -> dict:
    """20(a), one cell: the dry-run on the meta device, then the same step
    on the card with random weights: the arguments' bytes and the FLOP count
    held exactly to the dry-run's, DRYRUN_STEPS timed steps after
    DRYRUN_WARM, the peak memory."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import configs
    from repro_torch.distribution import make_step_for_cell
    from repro_torch.launch import dryrun
    from repro_torch.optim import adamw

    cfg = configs.get(arch)
    shape = configs.SHAPES[shape_name]
    if cut:
        shape = dataclasses.replace(shape, global_batch=cut[0],
                                    seq_len=cut[1])
    t0 = time.perf_counter()
    rec = dryrun.cell_costs(cfg, shape)
    t_dry = time.perf_counter() - t0
    mem = rec["bytes_per_device"]
    bound_s = max(rec["t_compute_s"], rec["t_memory_s"])
    label = f"{arch} x {shape_name} ({shape.global_batch} x {shape.seq_len})"
    print(f"  {label}: dry-run {t_dry:.1f} s (probes {rec['probe']['L1']} / "
          f"{rec['probe']['L2']} of {rec['probe']['n_units']} units): flops "
          f"{rec['flops']:.6e}, hbm_bytes {rec['hbm_bytes']:.6e}, t_compute "
          f"{rec['t_compute_s'] * 1e3:.3f} ms, t_memory "
          f"{rec['t_memory_s'] * 1e3:.3f} ms, dominant {rec['dominant']}, "
          f"useful_ratio {rec['useful_ratio']:.4f}; arguments "
          f"{mem['argument'] / 2**30:.3f} GiB, predicted peak "
          f"{mem['peak'] / 2**30:.3f} GiB")
    _free()
    opt = adamw(moment_dtype="bfloat16")
    bundle = make_step_for_cell(cfg, shape, opt, device=dev)
    args = _cell_args(cfg, shape, opt, dev)
    specs = [(tuple(t.shape), t.dtype) for t in _leaves(list(bundle.arg_specs))
             if t is not None]
    got = [(tuple(t.shape), t.dtype) for t in _leaves(list(args))
           if t is not None]
    arg_bytes = _nbytes(list(args))
    if got != specs or arg_bytes != mem["argument"]:
        raise AssertionError(f"20(a) {label}: arguments on the card "
                             f"{arg_bytes} B, dry-run {mem['argument']} B "
                             f"(leaves equal: {got == specs})")
    train = shape.kind == "train"

    def step(a):
        out = bundle.fn(*a)
        if train:
            float(out[2]["ce_loss"])
            return (out[0], out[1], a[2])
        return (a[0], out[0], out[1])        # the next token, the state

    _zero_counts()
    with FlopCounterMode(display=False) as fc:
        args = step(args)
    torch.cuda.synchronize()
    card_flops = fc.get_total_flops()
    for _ in range(DRYRUN_WARM):
        args = step(args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(DRYRUN_STEPS):
        t0 = time.perf_counter()
        args = step(args)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    counts = _launches_as(f"20(a) {label}")
    w = np.array(walls) * 1e3
    med = float(np.median(w))
    print(f"  {label} on the card: FlopCounterMode {card_flops} FLOP, the "
          f"dry-run {int(rec['flops'])} (equal: {card_flops == rec['flops']});"
          f" arguments {arg_bytes} B = the dry-run's; ms a step median "
          f"{med:.3f} (min {w.min():.3f}, max {w.max():.3f}, {DRYRUN_STEPS} "
          f"steps after {DRYRUN_WARM + 1}), {med / 1e3 / bound_s:.3f}x its "
          f"dry-run bound {bound_s * 1e3:.3f} ms; peak "
          f"{peak / 2**30:.3f} GiB, predicted / measured "
          f"{mem['peak'] / peak:.4f} [{facts}]")
    if card_flops != rec["flops"]:
        raise AssertionError(f"20(a) {label}: {card_flops} FLOP on the card,"
                             f" {rec['flops']} on the meta device")
    row = {"ms": med, "bound_ms": bound_s * 1e3, "peak": peak,
           "peak_predicted": mem["peak"], "counts": counts}
    if not train:
        b = _decode_step_bound(args[0], cfg, args[2], shape.global_batch)
        print(f"  {label}: phase 18's tree byte bound {b['bytes']:.6e} B "
              f"({b['ms']:.3f} ms) beside the dry-run's hbm_bytes "
              f"{rec['hbm_bytes']:.6e} ({rec['hbm_bytes'] / b['bytes']:.3f}x)")
    del args, bundle
    _free()
    return row


def _twin_state(env) -> dict:
    dev = env._dev
    return {"clock": env.clocks(), "backlog": dev._backlog.clone(),
            "sfree": dev._sfree_rel.clone(),
            "pending": np.stack([dev._pending_arrivals, dev._pending_gap]),
            "draws": dev.draws.gen.get_state()}


def _prewarm_twins(dev, facts: str, impl: str, N: int = 1024) -> int:
    """20(b): two twin N=1024 fleets (phase 4's) after one window; one is
    prewarmed, then both take the next window. Returns prewarm's
    launches."""
    from repro_torch.engine import FleetEnv

    twins = [FleetEnv.heterogeneous(N, seed=0, backend="torch", mix=MIX,
                                    window_impl=impl, device=dev)
             for _ in range(2)]
    for e in twins:
        e.observe_stats(240.0)
    torch.cuda.synchronize()
    a, b = twins
    _zero_counts()
    t0 = time.perf_counter()
    b.prewarm(240.0)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    kernel = "fleet_scan" if impl == "scan" else "fleet_tick"
    counts = _launches_as(f"20(b) prewarm on {impl}", **{kernel: 8})
    sa, sb = _twin_state(a), _twin_state(b)
    same = {k: (np.array_equal(sa[k], sb[k]) if isinstance(sa[k], np.ndarray)
                else torch.equal(sa[k], sb[k])) for k in sa}
    walls, stats = [], []
    for e in (a, b):
        t0 = time.perf_counter()
        st = e.observe_stats(240.0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        stats.append(st)
    bitwise = {k: torch.equal(stats[0][k], stats[1][k])
               for k in ("mean_ms", "p99_ms", "processed", "per_node")}
    print(f"  (b) prewarm on {impl}, N={N}: {t_pre * 1e3:.3f} ms, "
          f"{counts[kernel]} {kernel} launches; twin state equal {same}; "
          f"the next window {walls[1] * 1e3:.3f} ms (the twin that did not "
          f"prewarm {walls[0] * 1e3:.3f} ms), bitwise equal {bitwise} "
          f"[{facts}]")
    if not (all(same.values()) and all(bitwise.values())):
        raise AssertionError(f"20(b) prewarm on {impl} is not transparent")
    return counts[kernel]


def _backlog_events_on_card(dev) -> None:
    """20(c): SimCluster.backlog_events on the card after a reboot lever,
    after a window, through its setter, after reset."""
    from repro_torch.data.workloads import PoissonWorkload
    from repro_torch.engine import SimCluster

    sim = SimCluster(PoissonWorkload(10_000, 0.5), seed=0, device=dev)
    assert sim.store is None
    c = sim.current_config()
    c["driver_memory_gb"] = 16.0
    rep = sim.apply_config(c)
    buffered = sim.backlog_events
    sim.observe(100.0)
    after = sim.backlog_events
    held = float(sim._core._dev._backlog[0])
    sim.backlog_events = 1234.5
    back = sim.backlog_events
    sim.reset()
    print(f"  (c) SimCluster on the card: load {rep['load_s']:.3f} s, "
          f"backlog after apply_config {buffered:.3f} events (10000 ev/s x "
          f"load = {10_000 * rep['load_s']:.3f}), after a 100 s window "
          f"{after:.3f} (device {held:.3f}), written 1234.5 read {back}, "
          f"after reset {sim.backlog_events}")
    if not (rep["rebooted"] and buffered == 10_000 * rep["load_s"]
            and after == held and back == 1234.5
            and sim.backlog_events == 0.0):
        raise AssertionError("20(c) SimCluster.backlog_events")


def phase_dryrun(dev, facts: str) -> dict:
    """Phase 20 (see the module docstring). Returns the prewarm launches by
    window and the kernel launches of (a)'s three cells."""
    t_start = time.perf_counter()
    _free()
    total = {n: 0 for n in KERNEL_MODULES}
    for arch, shape_name, cut in DRYRUN_CELLS:
        r = _dryrun_cell(dev, facts, arch, shape_name, cut)
        total = {n: total[n] + r["counts"][n] for n in total}
    prewarm = {impl: _prewarm_twins(dev, facts, impl)
               for impl in ("kernel", "scan")}
    _zero_counts()
    _backlog_events_on_card(dev)
    _launches_as("20(c)", fleet_tick=1)
    print(f"  phase 20 took {time.perf_counter() - t_start:.1f} s")
    return {"prewarm": prewarm, "counts": total}


#: phase 21: phase 4's configuration on the fleet mesh (N clusters, S
#: steps, the checked updates, the timed steady updates, the epoch's K)
MESH_N, MESH_S, MESH_UPDATES, MESH_STEADY, MESH_EPOCH = 1024, 5, 3, 5, 8
#: the 2-rank run's reward median against the unsharded run's: the
#: reference's distributional pin for its sharded run
#: (tests/test_device_loop.py:291), per-shard streams differ by design
MESH_MEDIAN_REL = 0.15
#: seconds a spawned process group may take
MESH_JOIN_S = 300


def _mesh_rank(fn, rank: int, world: int, backend: str, store: str,
               args: tuple, q) -> None:
    """One spawned rank: join the group (NCCL with card ``rank``, or
    gloo), run ``fn(rank, world, *args)``, put its result (or the
    traceback) on ``q``; a hard crash prints the Python stacks."""
    import faulthandler
    import traceback

    import torch.distributed as dist

    faulthandler.enable()

    kw = {}
    if backend == "nccl":
        torch.cuda.set_device(rank)
        kw["device_id"] = torch.device("cuda", rank)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world, **kw)
    try:
        q.put((rank, fn(rank, world, *args)))
    except BaseException:
        q.put((rank, {"error": traceback.format_exc()}))
        raise
    finally:
        dist.destroy_process_group()


def _mesh_group(fn, world: int, backend: str, tmp: Path, *args) -> list:
    """``fn(rank, world, *args)`` on ``world`` spawned ranks of one process
    group (a file store under ``tmp``), so this process keeps no group.
    Returns the ranks' results in rank order; every process is stopped."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    store = tmp / f"store-{fn.__name__}-{backend}-{world}"
    procs = [ctx.Process(target=_mesh_rank, args=(fn, r, world, backend,
                                                  str(store), args, q))
             for r in range(world)]
    for p in procs:
        p.start()
    out: dict = {}
    deadline = time.monotonic() + MESH_JOIN_S
    try:
        while len(out) < world and time.monotonic() < deadline:
            try:
                rank, res = q.get(timeout=1.0)
                out[rank] = res
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
    finally:
        for p in procs:
            p.join(30 if len(out) == world else 0)
            if p.is_alive():
                p.kill()
                p.join()
    for r in range(world):
        if r not in out or "error" in out[r]:
            codes = [p.exitcode for p in procs]
            raise AssertionError(f"{fn.__name__} rank {r} of {world} "
                                 f"({backend}) failed (exit codes {codes}):\n"
                                 f"{out.get(r, {}).get('error', 'no result')}")
    return [out[r] for r in range(world)]


def _mesh_cfgr(N: int, mesh, window_impl: str = "kernel", device=None):
    """Phase 4's configuration: N heterogeneous clusters (10 nodes, 109
    levers), the --quick preset, MESH_S steps of 240 s windows, bins
    frozen, on ``mesh``."""
    from repro_torch.core import Configurator
    from repro_torch.engine import FleetEnv

    env = FleetEnv.heterogeneous(N, seed=0, backend="torch", mix=MIX,
                                 window_impl=window_impl, device=device)
    return Configurator(env, QUICK_METRICS, QUICK_LEVERS, device_loop="on",
                        window_s=240.0, steps_per_episode=MESH_S,
                        bin_kw=FROZEN, mesh=mesh)


def _mesh_run(cfgr, updates: int, *, epoch: bool = False) -> dict:
    """``updates`` outer iterations (sequential, or one ``run_epoch``) with
    the kernel and collective counts read around exactly them, then the
    run's state."""
    from repro_torch.distribution import sharding as shd

    _zero_counts()
    c0 = shd.COLLECTIVES
    if epoch:
        cfgr.run_epoch(updates)
        torch.cuda.synchronize()
    else:
        _timed_updates(cfgr, updates)
    counts, coll = _counts(), shd.COLLECTIVES - c0
    runner = cfgr._runner
    progs = list(runner._programs.values())
    return {"state": _run_state(cfgr), "counts": counts, "collectives": coll,
            "captured": sum(p.graph is not None for p in progs),
            "programs": len(progs),
            "graph_collectives": sum(p.collectives for p in progs),
            "reason": runner.graph_reason,
            "reconfigs": cfgr.env.reconfigs.tolist()}


def _mesh_steady(cfgrs: dict, epoch_k: int = 0) -> dict:
    """Windows/s of each configurator over MESH_STEADY rounds, one update
    each a round (or one ``run_epoch(epoch_k)``), the order alternating
    round by round so that a drift of the card or the host falls on all
    alike. Returns tag -> (windows/s, median seconds an update)."""
    times = {tag: [] for tag in cfgrs}
    tags = list(cfgrs)
    for i in range(MESH_STEADY):
        for tag in (tags if i % 2 == 0 else tags[::-1]):
            cfgr = cfgrs[tag]
            t0 = time.perf_counter()
            if epoch_k:
                cfgr.run_epoch(epoch_k)
            else:
                cfgr.run_update()
            torch.cuda.synchronize()
            times[tag].append(time.perf_counter() - t0)
    out = {}
    for tag, ts in times.items():
        env, per = cfgrs[tag].env, max(epoch_k, 1)
        n = env.n_clusters * cfgrs[tag].steps_per_episode * per
        out[tag] = (n * len(ts) / sum(ts), float(np.median(ts)) / per)
    return out


def _mesh_one_rank(rank: int, world: int, N: int, dev, facts: str) -> dict:
    """Phase 21(a), on a 1-rank NCCL mesh: each run twice, unsharded and on
    the mesh, on captured graphs; returns each arm's counts and rates."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.faults import chaos_scenario

    mesh1 = init_device_mesh(dev.type, (1,), mesh_dim_names=("fleet",))
    arms = [(f"window {impl}",
             lambda m, impl=impl: _mesh_cfgr(N, m, impl, device=dev),
             MESH_UPDATES, False) for impl in ("kernel", "scan")]
    # phase 12's shielded chaos fleet, with a deploy delay so that the
    # config-history ring is sharded too
    arms.append(("shielded chaos", lambda m: _chaos_cfgr(
        N, chaos_scenario(N, seed=0, deploy_delay=1), steps=MESH_S,
        slo_ms=SHIELD_SLO_MS, safe=True, mesh=m, device=dev), 2, False))
    arms.append((f"run_epoch({MESH_EPOCH})",
                 lambda m: _mesh_cfgr(N, m, device=dev), MESH_EPOCH, True))
    out = {}
    for label, make, updates, epoch in arms:
        cfgrs = {tag: make(mesh) for tag, mesh in (("unsharded", "off"),
                                                   ("mesh", mesh1))}
        runs = {tag: _mesh_run(c, updates, epoch=epoch)
                for tag, c in cfgrs.items()}
        rates = _mesh_steady(cfgrs, updates if epoch else 0)
        for tag, (rate, med) in rates.items():
            runs[tag].update(rate=rate, median_update_s=med)
        a, b = runs["unsharded"], runs["mesh"]
        _same_state(f"1-rank NCCL mesh vs unsharded, {label}",
                    a["state"], b["state"])
        kernel = "fleet_scan" if label == "window scan" else "fleet_tick"
        want_l = 1 + updates * MESH_S
        if a["counts"] != b["counts"] or (dev.type == "cuda" and b["counts"][
                kernel] != want_l):
            raise AssertionError(f"{label}: launches {a['counts']} vs "
                                 f"{b['counts']}, {kernel} expected "
                                 f"{want_l}")
        # a range reduce a step and one gather a batch, in the graphs,
        # and the engine stream's broadcast after each epoch
        want = (updates * (MESH_S + 1) + (1 if epoch else updates))
        if b["collectives"] != want or a["collectives"] != 0:
            raise AssertionError(f"{label}: {b['collectives']} collectives, "
                                 f"expected {want}")
        if dev.type == "cuda" and not (b["captured"] and b["graph_collectives"]
                                       and b["reason"] is None):
            raise AssertionError(f"{label}: mesh programs not captured: "
                                 f"{b['captured']} of {b['programs']}, "
                                 f"{b['graph_collectives']} collectives in "
                                 f"graphs, reason {b['reason']}")
        print(f"  (a) {label}: {b['captured']} of {b['programs']} mesh "
              f"programs captured, {b['graph_collectives']} NCCL "
              f"collectives inside their graphs; launches {b['counts']}; "
              f"{b['collectives'] / updates:.3f} collectives an update; "
              f"{MESH_STEADY} alternated rounds: windows/s unsharded "
              f"{a['rate']:.1f} vs 1-rank mesh "
              f"{b['rate']:.1f} ({b['rate'] / a['rate']:.4f}); "
              f"median update {a['median_update_s']:.6f} vs "
              f"{b['median_update_s']:.6f} s [{facts}]", flush=True)
        out[label] = {k: {kk: v[kk] for kk in ("counts", "collectives",
                                               "rate", "median_update_s")}
                      for k, v in runs.items()}
        if label == "window kernel":
            out["unsharded_rewards"] = np.array(a["state"]["rewards"])
    return out


def _mesh_gloo(rank: int, world: int, N: int, dev, tmp: str,
               facts: str) -> dict:
    """Phase 21(b) and (c) on one rank of a gloo group sharing the card:
    the sharded tuning run (eager), then a serve cycle writing under
    ``tmp``."""
    cfgr = _mesh_cfgr(N, "auto", device=dev)
    run = _mesh_run(cfgr, MESH_UPDATES)
    run["rate"], run["median_update_s"] = _mesh_steady({"mesh": cfgr})["mesh"]
    runner = cfgr._runner
    if rank == 0:
        print(f"  (b) rank 0: {runner.mesh.size()}-rank gloo mesh, block "
              f"[{runner._block.lo}, {runner._block.lo + runner._block.n}) "
              f"of {N}; programs: {run['reason']}", flush=True)
    res = {"params": {k: v.numpy() for k, v in run["state"]["params"].items()},
           "rewards": np.array(run["state"]["rewards"]),
           "configs": run["state"]["configs"],
           "reconfigs": run["reconfigs"], "counts": run["counts"],
           "collectives": run["collectives"], "rate": run["rate"],
           "median_update_s": run["median_update_s"],
           "reason": run["reason"], "captured": run["captured"]}
    # (c) the serve plane, its shadow fleet on the mesh: every rank runs the
    # same controller, rank 0 writes
    ctl = _serve_ctl(SERVE_N if N == MESH_N else N,
                     SERVE_PAIRS if N == MESH_N else 2,
                     SERVE_LIVE if N == MESH_N else 2, mesh="auto",
                     device=dev, ckdir=Path(tmp) / "ck",
                     history_path=Path(tmp) / "history.jsonl")
    t0 = time.perf_counter()
    summaries = ctl.run(2)
    torch.cuda.synchronize()
    ctl.checkpoint()
    res["serve"] = {"decisions": [x["decision"] for x in summaries],
                    "rewards": [x["live_reward"] for x in summaries],
                    "rows": len(ctl.history), "cycles": ctl.counters.cycles,
                    "sharded": ctl.cfgr._runner.mesh is not None,
                    "wall": time.perf_counter() - t0}
    return res


def phase_mesh(dev, facts: str, N: int = MESH_N,
               backend: str = "nccl") -> dict:
    """The tuner's fleet axis sharded over ranks (DESIGN.md §11): (a) a
    1-rank NCCL mesh on captured graphs against the unsharded run; (b) 2
    gloo ranks sharing the card; (c) a serve cycle on those 2 ranks.
    ``N`` and ``backend`` shrink it for a rehearsal on the host."""
    import tempfile

    t_start = time.perf_counter()
    if dev.type == "cuda":   # built here once, loaded by every rank
        mods = _kernel_mods()
        mods["fleet_tick"]._library()
        mods["fleet_scan"]._library()
    if backend == "nccl":
        print(f"  torch {torch.__version__}, NCCL "
              f"{'.'.join(map(str, torch.cuda.nccl.version()))}")
    with tempfile.TemporaryDirectory() as tmp:
        (a,) = _mesh_group(_mesh_one_rank, 1, backend, Path(tmp), N, dev,
                           facts)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ranks = _mesh_group(_mesh_gloo, 2, "gloo", tmp, N, dev, str(tmp),
                            facts)
        r0, r1 = ranks
        for k in r0["params"]:
            if not np.array_equal(r0["params"][k], r1["params"][k]):
                raise AssertionError(f"(b) parameter {k} differs across "
                                     "ranks")
        if not (np.array_equal(r0["rewards"], r1["rewards"])
                and r0["configs"] == r1["configs"]):
            raise AssertionError("(b) records or configs differ across ranks")
        want = [MESH_UPDATES * MESH_S] * N
        if r0["reconfigs"] != want or r1["reconfigs"] != want:
            raise AssertionError("(b) reconfigs are not updates·steps each")
        expected = 1 + MESH_UPDATES * MESH_S
        for r, res in enumerate(ranks):
            if dev.type == "cuda" and res["counts"]["fleet_tick"] != expected:
                raise AssertionError(f"(b) rank {r}: fleet_tick launches "
                                     f"{res['counts']} != {expected}")
            if res["captured"] or "gloo" not in res["reason"]:
                raise AssertionError(f"(b) rank {r}: programs captured on a "
                                     "gloo mesh")
        m_sh = float(np.median(r0["rewards"]))
        m_un = float(np.median(a["unsharded_rewards"]))
        dev_rel = abs(m_sh - m_un) / max(abs(m_un), 1e-12)
        print(f"  (b) 2 gloo ranks on one card, {N // 2} clusters each: "
              f"parameters, records and configs equal on both ranks; "
              f"reconfigs {MESH_UPDATES}·{MESH_S} each; fleet_tick launches "
              f"per rank {r0['counts']['fleet_tick']}, "
              f"{r1['counts']['fleet_tick']} (expected {expected}); "
              f"{r0['collectives'] / MESH_UPDATES:.1f} collectives an update "
              f"a rank; reward median {m_sh:.4f} vs unsharded {m_un:.4f} "
              f"(rel {dev_rel:.4f}, limit {MESH_MEDIAN_REL}); windows/s "
              f"{r0['rate']:.1f} (median update {r0['median_update_s']:.6f} "
              f"s) against the unsharded {a['window kernel']['unsharded']['rate']:.1f} "
              f"[{facts}]")
        if dev_rel >= MESH_MEDIAN_REL:
            raise AssertionError(f"(b) reward median {m_sh} vs {m_un}")
        s0, s1 = r0["serve"], r1["serve"]
        lines = (tmp / "history.jsonl").read_text().splitlines()
        steps = sorted(p.name for p in (tmp / "ck").iterdir())
        if not (s0["sharded"] and s0["decisions"] == s1["decisions"]
                and s0["rewards"] == s1["rewards"]):
            raise AssertionError(f"(c) ranks disagree: {s0} vs {s1}")
        if len(lines) != s0["rows"] or steps != ["step_00000002"]:
            raise AssertionError(f"(c) {len(lines)} history rows on disk for "
                                 f"{s0['rows']} a rank, checkpoints {steps}")
        print(f"  (c) serve on 2 gloo ranks, shadow on the mesh: decisions "
              f"{s0['decisions']} on both ranks, {len(lines)} history rows "
              f"and checkpoints {steps} written once (rank 0), "
              f"{s0['wall']:.3f} s for 2 cycles [{facts}]")
    print(f"  phase 21 took {time.perf_counter() - t_start:.1f} s")
    return {"nccl": a, "gloo": [{k: r[k] for k in ("counts", "rate")}
                                for r in ranks]}


#: phase 22: the LM mesh's 1-rank NCCL arm (phase 18's qwen2-7b prefill
#: and decode, phase 17's SmolLM-135M train shape) and its dry-run cells
LM_MESH_B, LM_MESH_P, LM_MESH_STEPS = 16, 512, 8
LM_MESH_TRAIN = (8, 1024, 3)       # batch, sequence, steps
LM_MESH_CELLS = (("qwen2_7b", "train_4k", False, False),
                 ("qwen2_moe_a2p7b", "decode_32k", False, True),
                 ("zamba2_2p7b", "long_500k", True, False))  # multi, ep
CARD_GB = 80.0
#: phase 22(c), 2 gloo ranks sharing the card: qwen2-7b's width cut to
#: LM_MESH_GLOO_LAYERS layers, (batch, prompt, context, steps) on a (1, 2)
#: mesh and its first prompt split-K on (2, 1); SmolLM-135M's train step
#: (batch, sequence) on (1, 2)
LM_MESH_GLOO_LAYERS = 4
LM_MESH_GLOO = (4, 512, 1024, 4)
LM_MESH_GLOO_TRAIN = (4, 512)
#: a bf16 loss: the order of the bf16 products' sums moves it by a few bf16
#: roundings
LM_MESH_LOSS_REL = 1e-2
#: the host rehearsal's reduced configs in place of the card's
LM_MESH_REDUCED = False


def _bitwise(label: str, got, want) -> None:
    """Raise unless two trees of tensors (DTensors taken whole) are equal
    bit for bit."""
    from repro_torch.distribution.sharding import whole

    g = [whole(t) for t in _leaves(got) if t is not None]
    w = [t for t in _leaves(want) if t is not None]
    if len(g) != len(w):
        raise AssertionError(f"{label}: {len(g)} leaves vs {len(w)}")
    for i, (a, b) in enumerate(zip(g, w)):
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(
                a.view(torch.uint8) if a.dtype == torch.bool else a, b):
            raise AssertionError(f"{label}: leaf {i} {tuple(a.shape)} "
                                 f"differs")


def _lm_mesh_one_rank(rank: int, world: int, dev, facts: str) -> dict:
    """Phase 22(a) on a 1-rank NCCL ``DeviceMesh`` (1x1): qwen2-7b's prefill
    on the attention kernel and LM_MESH_STEPS greedy steps, then SmolLM-135M
    train steps, each sharded bundle against the unsharded one. Every
    placement on a 1x1 mesh is replicated, so this holds the mesh's
    dispatch, not its split arithmetic (that is (c)'s)."""
    from repro_torch import configs
    from repro_torch.configs.base import InputShape
    from repro_torch.distribution import sharding as sh
    from repro_torch.distribution.steps import (make_decode_step,
                                                make_prefill_step,
                                                make_train_step)
    from repro_torch.launch.mesh import make_local_mesh, mesh_name
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    mesh = make_local_mesh(1, 1)
    assert mesh.device_type == dev.type and mesh_name(mesh) == "1x1"
    out = {}
    cfg = dataclasses.replace(configs.get("qwen2_7b"), attn_impl="pallas")
    B, P = LM_MESH_B, LM_MESH_P
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, P)).astype(np.int32)).to(dev)
    pshape = InputShape("p", P, B, "prefill")
    dshape = InputShape("d", DECODE_CONTEXT, B, "decode")
    runs = {}
    for tag, m in (("unsharded", None), ("mesh", mesh)):
        pre = make_prefill_step(cfg, pshape, max_seq=DECODE_CONTEXT,
                                device=dev, mesh=m)
        dec = make_decode_step(cfg, dshape, device=dev, mesh=m)
        p = params if m is None else sh.distribute_tree(
            params, pre.meta["pspecs"], mesh)
        batch = {"tokens": toks}
        if m is not None:
            batch = sh.distribute_tree(batch, pre.meta["bspecs"], mesh)
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = pre.fn(p, batch)
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t0) * 1e3
        counts = _counts()
        tok = lm.whole_vocab(logits)[:, -1].argmax(dim=-1).to(
            torch.int32)[:, None]
        toks_out, walls = [tok], []
        for _ in range(LM_MESH_STEPS):
            t0 = time.perf_counter()
            tok, state = dec.fn(p, tok, state)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            toks_out.append(tok)
        full = sh.whole
        # the first and last layers' K/V caches to the host (the whole
        # caches are 30 GB a run: both on the card beside the weights would
        # not fit 80 GB, and copying them out costs the phase ~30 s)
        runs[tag] = dict(logits=full(logits), tokens=torch.cat(
            [full(t) for t in toks_out], dim=1),
            kv=[full(t)[i].cpu() for t in (state.kv_k, state.kv_v)
                for i in (0, cfg.num_layers - 1)],
            counts=counts, prefill_ms=pre_ms,
            step_ms=float(np.median(walls[2:])) * 1e3)
        del logits, state
        _free()
    a, b = runs["unsharded"], runs["mesh"]
    _bitwise("qwen2-7b prefill logits, 1x1 mesh vs unsharded",
             b["logits"], a["logits"])
    if not torch.equal(a["tokens"], b["tokens"]):
        raise AssertionError("qwen2-7b greedy tokens differ on the 1x1 mesh")
    _bitwise("qwen2-7b first and last layers' K/V caches after the steps",
             b["kv"], a["kv"])
    want = {**{n: 0 for n in KERNEL_MODULES},
            "flash_attention": cfg.num_layers if dev.type == "cuda" else 0}
    for tag in runs:
        if runs[tag]["counts"] != want:
            raise AssertionError(f"{tag} prefill launches "
                                 f"{runs[tag]['counts']}, expected {want}")
    print(f"  (a) {cfg.name} bf16 on the attention kernel, {B} x {P} into "
          f"{DECODE_CONTEXT} positions + {LM_MESH_STEPS} greedy steps: 1x1 "
          f"NCCL mesh bitwise against unsharded (prefill logits, every "
          f"token, the first and last layers' K/V caches); flash_attention "
          f"launches "
          f"{b['counts']['flash_attention']} in the mesh prefill; prefill "
          f"{a['prefill_ms']:.3f} vs {b['prefill_ms']:.3f} ms, decode step "
          f"median {a['step_ms']:.3f} vs {b['step_ms']:.3f} ms (unsharded vs "
          f"mesh) [{facts}]", flush=True)
    out["prefill"] = {k: {kk: runs[k][kk] for kk in
                          ("prefill_ms", "step_ms")} for k in runs}
    out["launches"] = b["counts"]["flash_attention"]
    del runs, a, b, params
    _free()

    tcfg = configs.get("smollm_135m")
    Bt, St, steps = LM_MESH_TRAIN
    opt = adamw()
    shape = InputShape("t", St, Bt, "train")
    params = lm.init_params(tcfg, torch.Generator(device=dev).manual_seed(0),
                            St)
    from repro_torch.data.synthetic import make_batch

    res = {}
    for tag, m in (("unsharded", None), ("mesh", mesh)):
        bundle = make_train_step(tcfg, opt, shape, device=dev, mesh=m)
        p, o = params, opt.init(params)
        if m is not None:
            p = sh.distribute_tree(p, bundle.meta["pspecs"], mesh)
            o = sh.distribute_tree(o, bundle.meta["ospecs"], mesh)
        losses, walls = [], []
        for i in range(steps):
            batch = make_batch(tcfg, Bt, St, seed=i, device=dev)
            if m is not None:
                batch = sh.distribute_tree(batch, bundle.meta["bspecs"], mesh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, o, met = bundle.fn(p, o, batch)
            losses.append(met["ce_loss"].clone())
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        res[tag] = dict(params=p, losses=torch.stack(losses),
                        ms=float(np.median(walls[1:])) * 1e3)
    _bitwise("smollm-135m losses, 1x1 mesh vs unsharded",
             res["mesh"]["losses"], res["unsharded"]["losses"])
    _bitwise("smollm-135m parameters after the steps",
             res["mesh"]["params"], res["unsharded"]["params"])
    print(f"  (a) {tcfg.name} train {Bt} x {St}, {steps} steps: losses "
          f"{[round(float(x), 6) for x in res['mesh']['losses']]} and every "
          f"parameter bitwise on the 1x1 mesh; ms a step (after the first) "
          f"{res['unsharded']['ms']:.3f} vs {res['mesh']['ms']:.3f} "
          f"(unsharded vs mesh) [{facts}]", flush=True)
    out["train_ms"] = {k: v["ms"] for k, v in res.items()}
    return out


def _lm_prompts(cfg, n: int, P: int) -> np.ndarray:
    """``n`` random prompts of ``P`` tokens (seed 0; the first rows of a
    larger draw are the smaller draw's)."""
    return np.random.default_rng(0).integers(
        0, cfg.vocab_size, (n, P)).astype(np.int32)


def _lm_serve(cfg, dev, toks: np.ndarray, ctx: int, steps: int, mesh=None,
              floor: bool = False) -> tuple:
    """Prefill of ``toks`` into ``ctx`` positions, then ``steps`` greedy
    steps, on one device or over ``mesh`` (weights from Generator(0); a
    batch that splits over no data axis decodes split-K, the prefill's
    state moved to that layout). Returns (the last prefill logits (n, V)
    f32 on the host, the tokens (n, 1 + steps) on the host, prefill ms,
    median step ms after the first two, split_k, and with ``floor`` the
    largest distance of those logits from the f32 prefill of the same
    weights, else None)."""
    from repro_torch.configs.base import InputShape
    from repro_torch.distribution import sharding as sh
    from repro_torch.distribution.steps import (make_decode_step,
                                                make_prefill_step)
    from repro_torch.models import lm

    n, P = toks.shape
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    pre = make_prefill_step(cfg, InputShape("p", P, n, "prefill"),
                            max_seq=ctx, device=dev, mesh=mesh)
    dec = make_decode_step(cfg, InputShape("d", ctx, n, "decode"),
                           device=dev, mesh=mesh)
    batch = {"tokens": torch.from_numpy(toks).to(dev)}
    if mesh is not None:
        params = sh.distribute_tree(params, pre.meta["pspecs"], mesh)
        batch = sh.distribute_tree(batch, pre.meta["bspecs"], mesh)
        _free()
    _sync(dev)
    t0 = time.perf_counter()
    logits, state = pre.fn(params, batch)
    _sync(dev)
    pre_ms = (time.perf_counter() - t0) * 1e3
    logits = sh.whole(lm.whole_vocab(logits))[:, -1].float()
    gap = None
    if floor:
        f32 = _f32_last_logits(params, cfg, batch)
        gap = float((logits - f32).abs().max())
        del f32
    if dec.meta["split_k"]:   # the prefill's layout to the split-K decode's
        state = sh._map_specs(
            lambda t, s: t if t.ndim == 0 else t.redistribute(
                mesh, sh.placements_for(s, mesh)), state, dec.meta["sspecs"])
    tok = logits.argmax(dim=-1).to(torch.int32)[:, None]
    if mesh is not None:
        tok = sh.distribute_tree(tok, (sh._n(dec.meta["dp"]), None), mesh)
    out, walls = [sh.whole(tok)], []
    for _ in range(steps):
        _sync(dev)
        t0 = time.perf_counter()
        tok, state = dec.fn(params, tok, state)
        _sync(dev)
        walls.append(time.perf_counter() - t0)
        out.append(sh.whole(tok))
    res = (logits.cpu(), torch.cat(out, dim=1).cpu(), pre_ms,
           float(np.median(walls[2:])) * 1e3, dec.meta["split_k"], gap)
    del params, state, logits, pre, dec
    _free()
    return res


def _lm_train(cfg, dev, shape: tuple, mesh=None) -> tuple:
    """One AdamW step of ``cfg`` on a (batch, sequence) ``shape`` batch
    (weights from Generator(0), the batch from seed 0), on one device or
    over ``mesh``: (loss, the parameters before and after, f32 on the
    host)."""
    from repro_torch.configs.base import InputShape
    from repro_torch.data.synthetic import make_batch
    from repro_torch.distribution import sharding as sh
    from repro_torch.distribution.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.utils import tree_leaves

    Bt, St = shape
    opt = adamw()
    bundle = make_train_step(cfg, opt, InputShape("t", St, Bt, "train"),
                             device=dev, mesh=mesh)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            St)
    state = opt.init(params)
    batch = make_batch(cfg, Bt, St, seed=0, device=dev)
    if mesh is not None:
        params = sh.distribute_tree(params, bundle.meta["pspecs"], mesh)
        state = sh.distribute_tree(state, bundle.meta["ospecs"], mesh)
        batch = sh.distribute_tree(batch, bundle.meta["bspecs"], mesh)
    before = [t.float().cpu() for t in tree_leaves(sh.whole(params))]
    p, _, met = bundle.fn(params, state, batch)
    after = [t.float().cpu() for t in tree_leaves(sh.whole(p))]
    return float(met["ce_loss"]), before, after


def _lm_mesh_cfgs() -> tuple:
    """Phase 22(c)'s configs: qwen2-7b (bf16, the attention kernel) cut to
    LM_MESH_GLOO_LAYERS layers, and SmolLM-135M; the reduced ones for the
    host rehearsal."""
    from repro_torch import configs

    if LM_MESH_REDUCED:
        return (dataclasses.replace(configs.get("qwen2_7b", reduced=True),
                                    dtype="bfloat16"),
                configs.get("smollm_135m", reduced=True))
    return (dataclasses.replace(configs.get("qwen2_7b"), attn_impl="pallas",
                                num_layers=LM_MESH_GLOO_LAYERS),
            configs.get("smollm_135m"))


#: the library that holds ``_gloo_cuda_all_gather``'s kernel (alive while
#: the registration is wanted)
_GLOO_LIB = None


def _gloo_cuda_all_gather() -> None:
    """Route the functional all-gather of CUDA tensors (the collective
    DTensor's ``Shard -> Replicate`` issues) through c10d's
    ``all_gather_into_tensor`` in this process. torch 2.11's
    ``_c10d_functional.all_gather_into_tensor`` segfaults in its
    ``wait_tensor`` on a gloo group's CUDA tensors, where c10d's own call,
    the functional all-reduce and reduce-scatter all work (checked on an
    H100, 2 gloo ranks); NCCL, which the port runs on, is not touched."""
    global _GLOO_LIB
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d

    if _GLOO_LIB is not None:
        return

    def all_gather(inp, group_size, group_name):
        out = inp.new_empty((inp.shape[0] * group_size,) + tuple(
            inp.shape[1:]))
        dist.all_gather_into_tensor(
            out, inp.contiguous(),
            group=c10d._resolve_process_group(group_name))
        return out
    _GLOO_LIB = torch.library.Library("_c10d_functional", "IMPL")
    _GLOO_LIB.impl("all_gather_into_tensor", all_gather, "CUDA")


def _lm_mesh_gloo(rank: int, world: int, dev, setup: tuple) -> dict:
    """Phase 22(c) on one of 2 gloo ranks sharing the card, on ``cuda``
    meshes: qwen2-7b's prefill and steps on (1, 2) (the heads and the
    vocab split over the ranks: ``on_blocks`` runs the attention kernel on
    each rank's heads, the embedding is vocab-parallel), its first prompt
    split-K on (2, 1), and a SmolLM-135M train step on (1, 2) (the
    vocab-parallel loss). Each rank's attention launches in the two
    prefills; the readings from rank 0, as numpy arrays. ``setup`` is the
    parent's (LM_MESH_REDUCED, LM_MESH_GLOO, LM_MESH_GLOO_TRAIN): a spawned
    rank imports this module afresh."""
    global LM_MESH_REDUCED, LM_MESH_GLOO, LM_MESH_GLOO_TRAIN
    LM_MESH_REDUCED, LM_MESH_GLOO, LM_MESH_GLOO_TRAIN = setup
    from torch.distributed.device_mesh import init_device_mesh

    if dev.type == "cuda":
        _gloo_cuda_all_gather()
    # launch.mesh gives a gloo group cpu meshes; these hold the card's
    m12, m21 = (init_device_mesh(dev.type, shape,
                                 mesh_dim_names=("data", "model"))
                for shape in ((1, 2), (2, 1)))
    cfg, tcfg = _lm_mesh_cfgs()
    B, P, ctx, steps = LM_MESH_GLOO
    toks = _lm_prompts(cfg, B, P)
    launches = []
    _zero_counts()
    big = _lm_serve(cfg, dev, toks, ctx, steps, mesh=m12)
    launches.append(_counts()["flash_attention"])
    _zero_counts()
    one = _lm_serve(cfg, dev, toks[:1], ctx, steps, mesh=m21)
    launches.append(_counts()["flash_attention"])
    loss, before, after = _lm_train(tcfg, dev, LM_MESH_GLOO_TRAIN, m12)
    if rank:
        return {"launches": launches}
    # the unsharded step here: its 1 GB of f32 parameters stay in this rank
    tloss, tbefore, tafter = _lm_train(tcfg, dev, LM_MESH_GLOO_TRAIN)
    drift = max(float(((a - b) - (c - d)).abs().max()) for a, b, c, d in
                zip(after, before, tafter, tbefore))
    moved = max(float((c - d).abs().max()) for c, d in zip(tafter, tbefore))
    np_ = lambda x: x.numpy() if isinstance(x, torch.Tensor) else x  # noqa: E731,E501
    return {"launches": launches, "big": tuple(map(np_, big)),
            "one": tuple(map(np_, one)),
            "train": (loss, tloss, drift, moved)}


def _lm_mesh_sharded(dev, facts: str) -> list:
    """Phase 22(c): the unsharded runs here, then the two gloo ranks
    (``_lm_mesh_gloo``) held against them: the (1, 2) prefill's last
    logits within DECODE_BF16_X of the bf16 depth floor and the first
    greedy token on every row past twice the floor's margin; the split-K
    tokens equal; the train loss within LM_MESH_LOSS_REL of rank 0's
    unsharded step; each rank's attention launches a layer a prefill.
    Returns the ranks' launches."""
    import tempfile

    cfg, tcfg = _lm_mesh_cfgs()
    B, P, ctx, steps = LM_MESH_GLOO
    toks = _lm_prompts(cfg, B, P)
    base = _lm_serve(cfg, dev, toks, ctx, steps, floor=True)
    base1 = _lm_serve(cfg, dev, toks[:1], ctx, steps)
    floor = base[5]
    with tempfile.TemporaryDirectory() as tmp:
        ranks = _mesh_group(_lm_mesh_gloo, 2, "gloo", Path(tmp), dev,
                            (LM_MESH_REDUCED, LM_MESH_GLOO,
                             LM_MESH_GLOO_TRAIN))
    r0 = ranks[0]
    t_ = lambda x: torch.from_numpy(x) if isinstance(x, np.ndarray) else x  # noqa: E731,E501
    logits, tk, pre_ms, step_ms, split, _ = map(t_, r0["big"])
    err = float((logits - base[0]).abs().max())
    top2 = base[0].topk(2, dim=-1).values
    robust = (top2[:, 0] - top2[:, 1]) > 2 * floor
    first = tk[:, 0] == base[1][:, 0]
    same = (tk == base[1]).all(dim=1)
    print(f"  (c) 2 gloo ranks on one card, {cfg.name} cut to "
          f"{cfg.num_layers} layers, {B} x {P} into {ctx} positions + "
          f"{steps} steps on (1, 2) (heads and vocab split): last prefill "
          f"logits max_abs {err:.4e} from the unsharded run's "
          f"({err / floor:.3f} of the bf16 depth floor {floor:.4e}, limit "
          f"{DECODE_BF16_X}); first token equal on {int(first.sum())} of "
          f"{B} rows ({int(robust.sum())} past the margin, all required), "
          f"all {1 + steps} on {int(same.sum())}; prefill {base[2]:.3f} vs "
          f"{pre_ms:.3f} ms, step {base[3]:.3f} vs {step_ms:.3f} ms "
          f"(unsharded vs mesh) [{facts}]", flush=True)
    fails = []
    if not err <= DECODE_BF16_X * floor:
        fails.append(f"(1, 2) logits {err} from unsharded, floor {floor}")
    if not bool(first[robust].all()):
        fails.append(f"(1, 2) first tokens {first.tolist()} on robust rows "
                     f"{robust.tolist()}")
    l1, t1, _, s1, split1, _ = map(t_, r0["one"])
    print(f"  (c) split-K (split_k={split1}) on (2, 1), batch 1: tokens "
          f"{t1.flatten().tolist()} vs unsharded "
          f"{base1[1].flatten().tolist()}; last prefill logits max_abs "
          f"{float((l1 - base1[0]).abs().max()):.4e}; step {base1[3]:.3f} "
          f"vs {s1:.3f} ms [{facts}]", flush=True)
    if not split1 or not torch.equal(t1, base1[1]):
        fails.append("(2, 1) split-K tokens differ from the unsharded run")
    loss, tloss, drift, moved = r0["train"]
    print(f"  (c) {tcfg.name} train step {LM_MESH_GLOO_TRAIN[0]} x "
          f"{LM_MESH_GLOO_TRAIN[1]} on (1, 2) (the vocab-parallel loss): "
          f"loss {loss:.6f} vs {tloss:.6f} unsharded "
          f"({abs(loss - tloss) / tloss:.3e}, limit {LM_MESH_LOSS_REL}); the "
          f"largest update {moved:.3e}, its largest difference {drift:.3e} "
          f"[{facts}]", flush=True)
    if not abs(loss - tloss) < LM_MESH_LOSS_REL * tloss:
        fails.append(f"(1, 2) train loss {loss} vs {tloss}")
    want = [cfg.num_layers if dev.type == "cuda" else 0] * 2
    launches = [r["launches"] for r in ranks]
    print(f"  (c) flash_attention launches a rank in the (1, 2) and (2, 1) "
          f"prefills: {launches} (expected {want} each)", flush=True)
    if any(x != want for x in launches):
        fails.append(f"attention launches {launches}, expected {want}")
    if fails:
        raise AssertionError("; ".join(fails))
    return launches


def _lm_mesh_dryrun(facts: str) -> list:
    """Phase 22(b): LM_MESH_CELLS on the production meshes, each mesh in a
    child process on a ``fake`` process group, on the meta device."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import PRODUCTION

    rows = []
    for multi in (False, True):
        cells = [c for c in LM_MESH_CELLS if c[2] == multi]
        jobs = [(dryrun.run_cell, (arch, shape, Path(".")),
                 dict(ep=ep, save=False, roofline=not multi))
                for arch, shape, _, ep in cells]
        for (arch, shape, _, ep), rec in zip(
                cells, dryrun.run_mesh_cells(*PRODUCTION[multi], jobs)):
            if isinstance(rec, str):
                raise AssertionError(f"dry-run {arch} x {shape}: {rec}")
            if rec["status"] != "ok":
                raise AssertionError(f"dry-run {arch} x {shape}: {rec}")
            mem = rec["bytes_per_device"]
            coll = rec["collectives"]
            kinds = {k: coll[k] for k in dryrun._COLLECTIVES if coll[k]}
            fits = mem["peak"] / 1e9 <= CARD_GB
            print(f"  (b) {arch} x {shape} x {rec['mesh']}"
                  f"{' --ep' if ep else ''}: per device argument "
                  f"{mem['argument'] / 1e9:.3f} GB, peak "
                  f"{mem['peak'] / 1e9:.3f} GB (fits {CARD_GB:.0f} GB: "
                  f"{fits}); collective bytes "
                  f"{ {k: f'{v / 1e9:.3f} GB' for k, v in kinds.items()} } by "
                  f"axis { {k: f'{v / 1e9:.3f} GB' for k, v in coll.get('by_axis', {}).items()} }; "
                  f"t_compute {rec['t_compute_s'] * 1e3:.3f} ms, t_memory "
                  f"{rec['t_memory_s'] * 1e3:.3f} ms, t_collective "
                  f"{rec['t_collective_s'] * 1e3:.3f} ms: {rec['dominant']} "
                  f"dominates; useful {rec['useful_ratio']:.4f} "
                  f"(passes {rec['compile_s']} s on the host)", flush=True)
            if not (rec["dominant"] and rec["flops"] > 0):
                raise AssertionError(f"{arch} x {shape}: {rec}")
            rows.append(rec)
    return rows


def phase_lm_mesh(dev, facts: str, backend: str = "nccl") -> dict:
    """The LM mesh (DESIGN.md §4): (a) a 1-rank NCCL mesh in a spawned child
    against the unsharded steps, bitwise, at full qwen2-7b and SmolLM-135M
    width (every placement replicated: the mesh's dispatch, no split);
    (b) the dry-run's production-mesh cells on the meta device; (c) 2 gloo
    ranks sharing the card, the sharded arithmetic (heads, vocab, split-K)
    against the unsharded runs. ``backend`` "gloo" with a cpu ``dev``
    rehearses (a) and (b) on the host."""
    import tempfile

    t_start = time.perf_counter()
    if dev.type == "cuda":
        mods = _kernel_mods()
        mods["flash_attention"]._launcher()   # built once, loaded by the child
    with tempfile.TemporaryDirectory() as tmp:
        (a,) = _mesh_group(_lm_mesh_one_rank, 1, backend, Path(tmp), dev,
                           facts)
    rows = _lm_mesh_dryrun(facts)
    _free()
    gloo = _lm_mesh_sharded(dev, facts)
    print(f"  phase 22 took {time.perf_counter() - t_start:.1f} s")
    return {"nccl": a, "dryrun": rows, "gloo": gloo}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _build_all() -> None:
    """Every kernel library, one nvcc per source, all started together so
    that the build time does not grow with the number of kernels."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import build as kbuild

    root = Path(__file__).resolve().parent
    flags = {m.SOURCE: m.NVCC_FLAGS for m in _kernel_mods().values()}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(flags)) as ex:
        libs = list(ex.map(lambda s: kbuild.build(s, flags[s], force=True),
                           flags))
    print(f"  {len(libs)} libraries built in {time.perf_counter() - t0:.1f} s")
    for src, lib in zip(flags, libs):
        print(f"  {lib.relative_to(root)}")
        for line in kbuild.BUILD_LOGS[src].strip().splitlines():
            print(f"  | {line}")
        for line in _ptxas_summary(kbuild.BUILD_LOGS[src]):
            print(f"  {src}: {line}")


def _ptxas_summary(log: str) -> list[str]:
    """One line per compiled kernel from ptxas's -v report: registers,
    spill stores/loads, stack frame and static shared memory (the dynamic
    shared memory is the wrapper's, printed where each kernel is timed)."""
    import re

    out, name, frame = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            frame = (f"stack {m.group(1)} B, spills {m.group(2)} B stored / "
                     f"{m.group(3)} B loaded")
            continue
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {frame}, "
                       f"{m.group(2) or 0} B static smem")
            name, frame = None, ""
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

    dev = torch.device("cuda")
    print("[1] facts")
    facts = _gpu_facts()
    print(f"  {facts}")
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}")
    print("[2] build")
    _build_all()
    print("[3] kernel against plain")
    row = phase_kernels(dev, facts)
    print("[4] main path")
    main_row = phase_main(dev, facts)
    print("[5] small-input check")
    phase_check(dev)
    print("[6] flash-attention kernel against plain")
    attn_row = phase_attention(dev, facts)
    print("[7] serve path")
    serve_row = phase_serve(dev, facts)
    print("[8] wkv kernel against plain")
    wkv_row = phase_wkv(dev, facts)
    print("[9] RWKV-6 path")
    rwkv_row = phase_rwkv(dev, facts)
    print("[10] SSD kernel through ops.mamba2_ssd, against plain")
    ssd_row = phase_ssd(dev, facts)
    print("[11] tuner path")
    lasso_row = phase_tuner(dev, facts)
    print("[12] chaos: fault scenarios and the shield on the tuning loop")
    chaos_row = phase_chaos(dev, facts)
    print("[13] graphs: the fused loop's captured programs, the pipeline "
          "and the epoch")
    graphs_row = phase_graphs(dev, facts)
    print("[14] serve: the control plane on the captured fused loop")
    serve_plane_row = phase_serve_plane(dev, facts)
    print("[15] scan: the lean tick scan on the card")
    scan_row = phase_scan(dev, facts)
    print("[16] local: LocalEngine and the tuner on wall-clock windows")
    local_counts = phase_local(dev, facts)
    print("[17] train: the training step at full SmolLM-135M width")
    train_counts = phase_train(dev, facts)
    print("[18] decode: prefill and 32 greedy steps at a 32768-position "
          "context, qwen2-7b, rwkv6-7b, zamba2-2.7b")
    decode_counts, decode_attn = phase_decode(dev, facts)
    print("[19] families: the MoE, VLM and audio families at full width "
          "through prefill and decode, qwen2-moe-a2.7b, internvl2-26b, "
          "whisper-large-v3, and grok-1-314b cut to 2 layers")
    family_counts, family_attn = phase_families(dev, facts)
    print("[20] dryrun: the one-device dry-run held against the card, "
          "FleetEnv.prewarm, SimCluster.backlog_events")
    dryrun_row = phase_dryrun(dev, facts)
    print("[21] mesh: the tuner's fleet axis sharded across ranks, a 1-rank "
          "NCCL mesh on captured graphs and 2 gloo ranks on one card")
    _free()
    mesh_row = phase_mesh(dev, facts)
    print("[22] lm mesh: the train, prefill and decode steps on a 1-rank "
          "NCCL DeviceMesh against the unsharded steps, the production-"
          "mesh dry-run, and 2 gloo ranks on one card splitting heads, "
          "vocab and KV positions")
    _free()
    lm_mesh_row = phase_lm_mesh(dev, facts)
    kernels = [
        {"name": "fleet_tick_window", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fleet_tick.cu",
         "replaces": "src/repro/kernels/fleet_tick.py:387",
         "launches": main_row["launches"], **row, "library_ms": None,
         "launches_chaos": chaos_row["launches"],
         "launches_graphs": graphs_row["launches"],
         "launches_serve": serve_plane_row["launches"],
         "launches_prewarm": dryrun_row["prewarm"]["kernel"],
         "launches_mesh": mesh_row["nccl"]["window kernel"]["mesh"][
             "counts"]["fleet_tick"],
         "launches_mesh_gloo_rank0": mesh_row["gloo"][0]["counts"][
             "fleet_tick"],
         "launches_mesh_gloo_rank1": mesh_row["gloo"][1]["counts"][
             "fleet_tick"]},
        {"name": "flash_attention_bhsd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:88",
         "launches": serve_row["launches"], **attn_row,
         "launches_lm_mesh": lm_mesh_row["nccl"]["launches"],
         "launches_lm_mesh_gloo_rank0": lm_mesh_row["gloo"][0][0],
         "launches_lm_mesh_gloo_rank1": lm_mesh_row["gloo"][1][0],
         "max_abs_err_decode": decode_attn["max_abs_err"],
         "ms_decode": decode_attn["ms"],
         "bound_ms_decode": decode_attn["bound_ms"],
         "library_ms_decode": decode_attn["library_ms"],
         **{f"{key}_{label.replace('-', '_')}": r[key]
            for label, r in family_attn.items()
            for key in ("max_abs_err", "rel_rms_err", "ms", "bound_ms",
                        "library_ms")}},
        {"name": "rwkv6_wkv", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rwkv6_wkv.cu",
         "replaces": "src/repro/kernels/rwkv6_wkv.py:81",
         "launches": rwkv_row["launches"], **wkv_row},
        {"name": "mamba2_ssd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/mamba2_ssd.cu",
         "replaces": "src/repro/kernels/mamba2_ssd.py:72", **ssd_row},
        {"name": "lasso_cd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/lasso_cd.cu",
         "replaces": "src/repro/core/lasso.py:61", **lasso_row},
        {"name": "fleet_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fleet_scan.cu",
         "replaces": "src/repro/engine/fleet_jax.py:194", **scan_row,
         "library_ms": None,
         "launches_prewarm": dryrun_row["prewarm"]["scan"],
         "launches_mesh": mesh_row["nccl"]["window scan"]["mesh"][
             "counts"]["fleet_scan"]},
    ]
    for row in kernels:
        row["bound_frac"] = row["bound_ms"] / row["ms"]
        mod = row["source"].rsplit("/", 1)[1].split(".")[0]
        row["launches_local"] = local_counts[mod]
        row["launches_train"] = train_counts[mod]
        row["launches_decode"] = decode_counts[mod]
        row["launches_families"] = family_counts[mod]
        row["launches_dryrun"] = dryrun_row["counts"][mod]
    print(facts)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
