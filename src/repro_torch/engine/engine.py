"""StreamEngine — the real micro-batched streaming engine (Spark Discretized
Streams analogue, DESIGN.md §2), on PyTorch.

Events wait in the EventBuffer until the batch interval closes (the paper's
headline lever); each micro-batch is scored with one LM prefill — the
argmax of the last position's logits — and the results land in the
IdempotentSink.

What a "compile" is here. The reference jits one ``serve_step`` per
(batch, seq-bucket) shape and counts each compile in ``jit_compiles`` and
its time in ``jit_time_s``. PyTorch runs eagerly and has nothing to
compile; what a new shape costs on the card is its first call (the
kernel library's build and load at first use, cuBLAS's choice of
algorithms, the caching allocator's first blocks of that size). So the
port's step cache keeps the reference's keys and invalidation, and a
"compile" is that first call: ``_get_step`` runs the new step once on a
zero batch of its shape, synchronises, and counts it and its time in the
same fields. The counts equal the reference's for the same sequence of
batches and reconfigures.

What the step runs. The reference's step is ``forward_prefill`` under
``jit``, of which it keeps only the argmax, so XLA drops the per-layer K/V
recompute and the decode-cache allocation. Eager PyTorch would run them, so
the port's step runs what the compiled step keeps (``lm.score_last``):
embed, backbone, last-position logits, argmax. ``forward_prefill`` itself
is ported whole and pinned by the tests.

Levers with real effect in this engine:
  batch_interval_s, max_batch_events, pad_to_pow2, seq_bucket_count,
  compute_dtype (re-"compile"), attn_impl/attn_chunk (re-"compile"),
  sink_partitions, warmup_batches, failure_inject_frac.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.workloads import Event
from repro_torch.engine.queue import EventBuffer, IdempotentSink
from repro_torch.models import init_params
from repro_torch.models.lm import score_last
from repro_torch.utils import resolve_device, round_up, tree_map


@dataclass
class EngineConfig:
    batch_interval_s: float = 0.25
    max_batch_events: int = 32
    pad_to_pow2: bool = True
    seq_bucket_count: int = 4
    compute_dtype: str = "float32"
    attn_impl: str = "chunked"
    attn_chunk: int = 64
    sink_partitions: int = 8
    warmup_batches: int = 1
    failure_inject_frac: float = 0.0
    max_seq: int = 64


@dataclass
class BatchReport:
    n_events: int
    service_s: float
    padding_frac: float
    compiled: bool
    latencies_s: list = field(default_factory=list)


def _cast_floats(tree, dtype: torch.dtype):
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t,
                    tree)


class StreamEngine:
    """Micro-batch scoring engine over an LM whose step needs only tokens
    (the dense, ssm, hybrid and moe families).

    Runs on ``device`` (``cuda`` unless another device is named; without a
    card ``device=None`` raises). The parameters are drawn there from a
    ``torch.Generator`` seeded with ``seed``, one tensor at a time, directly
    in ``compute_dtype``."""

    def __init__(self, model_cfg: ModelConfig, *, seed: int = 0,
                 econf: Optional[EngineConfig] = None, device=None):
        self.econf = econf or EngineConfig()
        self.model_cfg = dataclasses.replace(
            model_cfg,
            dtype=self.econf.compute_dtype,
            attn_impl=self.econf.attn_impl,
            attn_chunk=self.econf.attn_chunk,
        )
        self.device = resolve_device(device, "StreamEngine")
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = init_params(self.model_cfg, gen, device=self.device)
        self.buffer = EventBuffer()
        self.sink = IdempotentSink(self.econf.sink_partitions)
        self._rng = np.random.default_rng(seed)
        self._step_cache: dict[tuple, Callable] = {}
        self.jit_time_s = 0.0
        self.jit_compiles = 0
        #: LM forward passes run (first calls of new shapes included)
        self.forward_passes = 0
        self.replays = 0
        self._offset = 0

    # ------------------------------------------------------------- config
    def reconfigure(self, econf: EngineConfig) -> float:
        """Apply a new engine config. Returns the (real) loading cost in
        seconds — the params cast and the step cache cleared when
        step-relevant levers moved (the first calls come later)."""
        t0 = time.perf_counter()
        rejit = (econf.compute_dtype != self.econf.compute_dtype
                 or econf.attn_impl != self.econf.attn_impl
                 or econf.attn_chunk != self.econf.attn_chunk)
        self.econf = econf
        if rejit:
            self.model_cfg = dataclasses.replace(
                self.model_cfg, dtype=econf.compute_dtype,
                attn_impl=econf.attn_impl, attn_chunk=econf.attn_chunk)
            self.params = _cast_floats(self.params,
                                       getattr(torch, econf.compute_dtype))
            self._step_cache.clear()
        self.sink = IdempotentSink(econf.sink_partitions)
        return time.perf_counter() - t0

    # --------------------------------------------------------------- batching
    def _bucket_seq(self, n_tokens: int) -> int:
        s = max(8, min(n_tokens, self.econf.max_seq))
        if self.econf.pad_to_pow2:
            s = 1 << int(np.ceil(np.log2(s)))
        nb = max(1, self.econf.seq_bucket_count)
        bucket = round_up(s, max(self.econf.max_seq // nb, 8))
        return min(bucket, self.econf.max_seq)

    def _get_step(self, batch: int, seq: int) -> Callable:
        key = (batch, seq)
        if key not in self._step_cache:
            cfg = self.model_cfg

            @torch.inference_mode()
            def step(params, tokens):
                self.forward_passes += 1
                logits = score_last(params, cfg, tokens)
                return torch.argmax(logits[:, -1], dim=-1)

            t0 = time.perf_counter()
            step(self.params, torch.zeros((batch, seq), dtype=torch.int32,
                                          device=self.device))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.jit_time_s += time.perf_counter() - t0
            self.jit_compiles += 1
            self._step_cache[key] = step
        return self._step_cache[key]

    def _tokens_of(self, events: Sequence[Event], seq: int) -> np.ndarray:
        out = np.zeros((len(events), seq), np.int32)
        for i, e in enumerate(events):
            n = min(e.tokens, seq)
            rng = np.random.default_rng(e.key)
            out[i, :n] = rng.integers(1, self.model_cfg.vocab_size, n)
        return out

    # ----------------------------------------------------------------- serving
    def process_batch(self, now: float) -> Optional[BatchReport]:
        """Close the current batch window and score it. Returns None if idle."""
        events = self.buffer.take(self.econf.max_batch_events, now)
        if not events:
            return None
        seq = self._bucket_seq(max(e.tokens for e in events))
        bsz = len(events)
        if self.econf.pad_to_pow2:
            bsz = 1 << int(np.ceil(np.log2(bsz)))
        pad_frac = 1.0 - sum(min(e.tokens, seq) for e in events) / (bsz * seq)

        compiled = (bsz, seq) not in self._step_cache
        step = self._get_step(bsz, seq)
        toks = np.zeros((bsz, seq), np.int32)
        toks[: len(events)] = self._tokens_of(events, seq)

        t0 = time.perf_counter()
        if self._rng.uniform() < self.econf.failure_inject_frac:
            # injected worker failure: replay the batch once (idempotent sink)
            self.buffer.replay()
            self.replays += 1
            events = self.buffer.take(self.econf.max_batch_events, now)
            toks = np.zeros((bsz, seq), np.int32)
            toks[: len(events)] = self._tokens_of(events, seq)
        out = step(self.params, torch.from_numpy(toks).to(self.device))
        out = out.cpu().numpy()  # waits for the device
        service = time.perf_counter() - t0

        done = time.perf_counter()
        lats = []
        for i, e in enumerate(events):
            self.sink.write(self._offset + i, {"event_key": e.key, "next_token": int(out[i])})
            lats.append(max(done - e.arrival_s, service))
        self._offset += len(events)
        self.buffer.commit()
        return BatchReport(n_events=len(events), service_s=service,
                           padding_frac=pad_frac, compiled=compiled,
                           latencies_s=lats)

    def warmup(self) -> None:
        for _ in range(self.econf.warmup_batches):
            b = min(self.econf.max_batch_events, 4)
            seq = self._bucket_seq(32)
            if self.econf.pad_to_pow2:
                b = 1 << int(np.ceil(np.log2(b)))
            self._get_step(b, seq)
