"""The engine's 109 configuration levers (paper §2.1 tuned 109 Spark levers).

Grouped as DESIGN.md §6: ingest/batching 14, scheduling 12, memory 16,
parallelism 15, kernels 14, precision 8, collectives 10, misc 20 = 109.

A subset (~17, flagged ``EFFECTIVE``) has first-order ground-truth effect in
the SimCluster performance model; the rest act weakly or not at all —
mirroring Xu et al.'s "developers ignore >80 % of knobs" observation the
paper cites. Lasso must *discover* the effective set; nothing in the tuner
reads EFFECTIVE (it exists for tests/benchmarks to validate recovery).
"""
from __future__ import annotations

from repro_torch.core.discretize import LeverSpec


def _ing(n, **kw):
    return LeverSpec(n, group="ingest", **kw)


def _sch(n, **kw):
    return LeverSpec(n, group="sched", **kw)


def _mem(n, **kw):
    return LeverSpec(n, group="memory", **kw)


def _par(n, **kw):
    return LeverSpec(n, group="parallel", **kw)


def _ker(n, **kw):
    return LeverSpec(n, group="kernel", **kw)


def _pre(n, **kw):
    return LeverSpec(n, group="precision", **kw)


def _col(n, **kw):
    return LeverSpec(n, group="collective", **kw)


def _msc(n, **kw):
    return LeverSpec(n, group="misc", **kw)


def build_lever_specs() -> list[LeverSpec]:
    L: list[LeverSpec] = []
    # --- ingest / batching (14) --------------------------------------------
    L += [
        _ing("batch_interval_s", kind="log", lo=0.25, hi=20.0, default=10.0,
             hard_lo=0.05, hard_hi=30.0),                                       # E
        _ing("max_batch_events", kind="log", lo=1e3, hi=1e6, default=3e5,
             hard_lo=100.0, hard_hi=3e6),                                       # E
        _ing("max_batch_mb", kind="log", lo=8, hi=4096, default=512),
        _ing("event_bucketing", kind="choice", choices=("none", "by_key", "by_size")),
        _ing("ingest_threads", kind="int", lo=1, hi=32, default=4),
        _ing("receiver_buffer_mb", kind="log", lo=16, hi=2048, default=128),
        _ing("backpressure", kind="bool", default=True),
        _ing("backpressure_hwm_frac", lo=0.5, hi=0.99, default=0.9),
        _ing("dedupe_window_s", lo=0.0, hi=600.0, default=0.0),
        _ing("compression_codec", kind="choice", choices=("none", "lz4", "zstd")),
        _ing("max_inflight_batches", kind="int", lo=1, hi=16, default=2),
        _ing("pad_to_pow2", kind="bool", default=True),
        _ing("seq_bucket_count", kind="int", lo=1, hi=16, default=4),
        _ing("drop_policy", kind="choice", choices=("never", "oldest", "newest")),
    ]
    # --- scheduling (12) ------------------------------------------------------
    L += [
        _sch("prefetch_depth", kind="int", lo=0, hi=16, default=2),              # E
        _sch("straggler_timeout_s", kind="log", lo=0.5, hi=60.0, default=30.0),  # E
        _sch("backup_tasks", kind="bool", default=False),                        # E
        _sch("sched_queue_depth", kind="int", lo=1, hi=64, default=8),
        _sch("work_stealing", kind="bool", default=False),
        _sch("locality_wait_s", lo=0.0, hi=10.0, default=3.0),
        _sch("task_retries", kind="int", lo=0, hi=8, default=3),
        _sch("heartbeat_interval_s", lo=1.0, hi=60.0, default=10.0),
        _sch("dispatch_batching", kind="bool", default=True),
        _sch("priority_classes", kind="int", lo=1, hi=8, default=1),
        _sch("drain_on_rescale", kind="bool", default=True),
        _sch("elastic_rescale", kind="choice", choices=("off", "shrink", "grow", "auto")),
    ]
    # --- memory (16) -------------------------------------------------------------
    L += [
        _mem("remat_policy", kind="choice", choices=("none", "block", "full"),
             default="block", reboot=True),                                      # E
        _mem("kv_block", kind="choice", choices=(64, 128, 256, 512), default=128),  # E
        _mem("allocator_arena_mb", kind="log", lo=64, hi=8192, default=512),     # E
        _mem("driver_memory_gb", kind="log", lo=2, hi=64, default=8, reboot=True),  # E
        _mem("worker_memory_gb", kind="log", lo=8, hi=64, default=16, reboot=True),
        _mem("kv_cache_dtype", kind="choice", choices=("bf16", "f32", "int8")),
        _mem("donate_buffers", kind="bool", default=True),
        _mem("preallocate_frac", lo=0.1, hi=0.95, default=0.75),
        _mem("defrag_threshold_frac", lo=0.5, hi=0.99, default=0.9),
        _mem("spill_to_host", kind="bool", default=False),
        _mem("activation_offload", kind="bool", default=False),
        _mem("max_cache_entries", kind="log", lo=16, hi=4096, default=256),
        _mem("weight_dedup", kind="bool", default=True),
        _mem("host_pinned_mb", kind="log", lo=64, hi=8192, default=1024),
        _mem("arena_growth_factor", lo=1.1, hi=4.0, default=2.0),
        _mem("gc_interval_s", kind="log", lo=1, hi=600, default=60),
    ]
    # --- parallelism (15) -----------------------------------------------------------
    L += [
        _par("model_axis_size", kind="choice", choices=(4, 8, 16, 32),
             default=16, reboot=True),                                            # E
        _par("microbatch_count", kind="choice", choices=(1, 2, 4, 8), default=1),  # E
        _par("expert_parallel", kind="bool", default=False, reboot=True),          # E
        _par("pipeline_stages", kind="choice", choices=(1, 2, 4), default=1, reboot=True),
        _par("seq_shard_decode", kind="bool", default=True),
        _par("fsdp_params", kind="bool", default=True, reboot=True),
        _par("zero_stage", kind="choice", choices=(1, 2, 3), default=2),
        _par("replica_groups", kind="choice", choices=("ring", "tree", "mesh2d")),
        _par("decode_batch_lanes", kind="int", lo=1, hi=16, default=4),
        _par("prefill_chunk", kind="choice", choices=(512, 1024, 2048, 4096), default=1024),
        _par("async_dispatch", kind="bool", default=True),
        _par("overlap_grad_comm", kind="bool", default=True),
        _par("shard_optimizer_state", kind="bool", default=True),
        _par("vocab_shard", kind="bool", default=True),
        _par("moe_capacity_factor", lo=1.0, hi=4.0, default=1.25),
    ]
    # --- kernels (14) ----------------------------------------------------------------
    L += [
        _ker("attn_block_q", kind="choice", choices=(64, 128, 256, 512), default=128),  # E
        _ker("attn_block_k", kind="choice", choices=(64, 128, 256, 512), default=128),  # E
        _ker("attn_impl", kind="choice", choices=("chunked", "pallas", "naive")),
        _ker("ssd_chunk", kind="choice", choices=(32, 64, 128, 256), default=64),
        _ker("wkv_chunk", kind="choice", choices=(16, 32, 64, 128), default=32),
        _ker("matmul_tile_m", kind="choice", choices=(128, 256, 512), default=256),
        _ker("matmul_tile_n", kind="choice", choices=(128, 256, 512), default=256),
        _ker("fused_softmax", kind="bool", default=True),
        _ker("fused_rmsnorm", kind="bool", default=True),
        _ker("fused_rope", kind="bool", default=True),
        _ker("dot_dimension_sort", kind="bool", default=True),
        _ker("layout_opt", kind="bool", default=True),
        _ker("vmem_limit_mb", kind="choice", choices=(64, 96, 128), default=128),
        _ker("scan_unroll", kind="int", lo=1, hi=8, default=1),
    ]
    # --- precision (8) -------------------------------------------------------------------
    L += [
        _pre("compute_dtype", kind="choice", choices=("bf16", "f32"), default="bf16",
             reboot=True),                                                          # E
        _pre("accum_dtype", kind="choice", choices=("f32", "bf16"), default="f32"),
        _pre("optimizer_dtype", kind="choice", choices=("f32", "bf16"), default="f32"),
        _pre("logits_dtype", kind="choice", choices=("f32", "bf16"), default="f32"),
        _pre("quantize_weights", kind="choice", choices=("none", "int8", "int4")),
        _pre("quantize_kv", kind="bool", default=False),
        _pre("stochastic_rounding", kind="bool", default=False),
        _pre("loss_scale", kind="log", lo=1.0, hi=65536.0, default=1.0),
    ]
    # --- collectives (10) ---------------------------------------------------------------------
    L += [
        _col("grad_compression", kind="choice", choices=("none", "int8", "topk"),
             default="none"),                                                       # E
        _col("allgather_vs_rs", kind="choice", choices=("allgather", "reduce_scatter"),
             default="reduce_scatter"),
        _col("collective_chunk_mb", kind="log", lo=1, hi=256, default=32),
        _col("async_collectives", kind="bool", default=True),
        _col("latency_opt_small", kind="bool", default=True),
        _col("pod_axis_compression", kind="bool", default=False),
        _col("permute_decomposition", kind="bool", default=False),
        _col("allreduce_algo", kind="choice", choices=("ring", "bidir", "tree")),
        _col("coalesce_small_tensors", kind="bool", default=True),
        _col("ici_priority", kind="choice", choices=("throughput", "latency")),
    ]
    # --- misc engine (20) ---------------------------------------------------------------------------
    L += [
        _msc("sink_partitions", kind="int", lo=1, hi=64, default=8),                 # E
        _msc("sink_commit_interval_s", kind="log", lo=0.5, hi=60, default=5),
        _msc("idempotent_sink", kind="bool", default=True),
        _msc("checkpoint_interval_steps", kind="log", lo=10, hi=10000, default=500),
        _msc("async_checkpoint", kind="bool", default=True),
        _msc("metrics_interval_s", kind="log", lo=1, hi=300, default=60),
        _msc("log_level", kind="choice", choices=("error", "warn", "info", "debug")),
        _msc("trace_sampling_frac", lo=0.0, hi=1.0, default=0.01),
        _msc("profiler_enabled", kind="bool", default=False),
        _msc("watchdog_timeout_s", kind="log", lo=10, hi=3600, default=300),
        _msc("result_cache", kind="bool", default=False),
        _msc("speculative_decode", kind="bool", default=False),
        _msc("warmup_batches", kind="int", lo=0, hi=64, default=2),
        _msc("max_retries_per_event", kind="int", lo=0, hi=8, default=2),
        _msc("failure_inject_frac", lo=0.0, hi=0.1, default=0.0),
        _msc("replay_on_restart", kind="bool", default=True),
        _msc("rate_limit_events_s", kind="log", lo=1e3, hi=1e7, default=1e7),
        _msc("admission_control", kind="bool", default=False),
        _msc("ntp_sync_interval_s", kind="log", lo=16, hi=4096, default=1024),
        _msc("telemetry_batch", kind="int", lo=1, hi=1024, default=64),
    ]
    assert len(L) == 109, len(L)
    names = [s.name for s in L]
    assert len(set(names)) == 109, "duplicate lever names"
    return L


LEVER_SPECS: list[LeverSpec] = build_lever_specs()
LEVER_NAMES: list[str] = [s.name for s in LEVER_SPECS]

# Ground-truth effective levers in SimCluster (validation targets only).
EFFECTIVE: tuple[str, ...] = (
    "batch_interval_s", "max_batch_events", "prefetch_depth",
    "straggler_timeout_s", "backup_tasks", "remat_policy", "kv_block",
    "allocator_arena_mb", "driver_memory_gb", "model_axis_size",
    "microbatch_count", "expert_parallel", "attn_block_q", "attn_block_k",
    "compute_dtype", "grad_compression", "sink_partitions",
)
