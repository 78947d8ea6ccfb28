"""The port's ``StreamEngine`` and its queue against the reference's.

* ``engine/queue.py`` is a numpy copy: the same puts, takes, commits and
  replays give the same events, stats and sink rows, bitwise.
* ``StreamEngine`` on reduced SmolLM with the reference's weights carried
  into the port (f32, CPU): the same events give the same sink records
  (``next_token``), the same padding fractions and "compiled" flags, the same
  ``jit_compiles`` across reconfigures, and the same idempotent failure
  replay. Tokens are compared exactly: the argmax's top-2 margin on these
  inputs is far above the f32 logit agreement (~1e-5, tests/test_torch_lm.py),
  and the test checks that margin on every scored row.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.data.workloads import Event as RefEvent  # noqa: E402
from repro.engine import EngineConfig as RefEngineConfig  # noqa: E402
from repro.engine import StreamEngine as RefStreamEngine  # noqa: E402
from repro.engine import queue as ref_queue  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data.workloads import PoissonWorkload  # noqa: E402
from repro_torch.engine import EngineConfig, StreamEngine  # noqa: E402
from repro_torch.engine import queue  # noqa: E402
from repro_torch.models import lm  # noqa: E402

#: the margin (top-1 minus top-2 logit) a scored row needs for its argmax to
#: be compared exactly: 100x the f32 logit tolerance of tests/test_torch_lm.py
MARGIN = 1e-2


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _events(n, seed=0, t0=0.0):
    """Events of LocalEngine's default traffic, ragged token counts."""
    rng = np.random.default_rng(seed)
    evs = PoissonWorkload(lam=24.0, event_size_mb=0.5).sample_events(
        t0, t0 + 2 * n / 24.0, rng)[:n]
    assert len(evs) == n
    return evs


def _ref_events(evs):
    return [RefEvent(e.arrival_s, e.size_mb, key=e.key, tokens=e.tokens)
            for e in evs]


def _asdict(stats):
    return dataclasses.asdict(stats)


@pytest.mark.parametrize("capacity,policy", [(1_000_000, "never"),
                                             (5, "oldest"), (5, "newest"),
                                             (5, "never")])
def test_queue_copy_is_bitwise(capacity, policy):
    evs = _events(24, seed=capacity % 7)
    port = queue.EventBuffer(capacity, policy)
    ref = ref_queue.EventBuffer(capacity, policy)
    psink, rsink = queue.IdempotentSink(3), ref_queue.IdempotentSink(3)
    rng = np.random.default_rng(1)
    offset = 0
    for step in range(12):
        lo = 2 * step
        assert port.put(evs[lo:lo + 2]) == ref.put(_ref_events(evs[lo:lo + 2]))
        now = 0.05 * step
        n = int(rng.integers(1, 4))
        got, want = port.take(n, now), ref.take(n, now)
        assert [e.key for e in got] == [e.key for e in want]
        assert [e.arrival_s for e in got] == [e.arrival_s for e in want]
        if rng.uniform() < 0.3:
            port.replay()
            ref.replay()
        else:
            for i, e in enumerate(got):
                assert psink.write(offset + i, {"k": e.key}) == \
                    rsink.write(offset + i, {"k": e.key})
            # a replayed write is a no-op on both
            assert psink.write(offset, {"k": -1}) == rsink.write(offset, {"k": -1})
            offset += len(got)
            port.commit()
            ref.commit()
        assert len(port) == len(ref)
        assert _asdict(port.stats) == _asdict(ref.stats)
    assert psink.rows == rsink.rows and psink.duplicates == rsink.duplicates


def _engines(econf_kw, seed=0):
    cfg_r = ref_configs.get("smollm_135m", reduced=True)
    cfg_p = configs.get("smollm_135m", reduced=True)
    ref = RefStreamEngine(cfg_r, seed=seed, econf=RefEngineConfig(**econf_kw))
    tree = jax.tree.map(np.asarray, ref.params)
    port = StreamEngine(cfg_p, seed=seed, econf=EngineConfig(**econf_kw),
                        device="cpu")
    port.params = lm.load_reference_params(tree, cfg_p, "cpu")
    return ref, port


def _margins(ref, tokens):
    """Top-1 minus top-2 logit of each row's last position (reference)."""
    logits, _ = rlm.forward_prefill(ref.params, ref.model_cfg,
                                    {"tokens": jnp.asarray(tokens)},
                                    max_seq=tokens.shape[1])
    top = np.sort(np.asarray(logits[:, -1], np.float64), axis=-1)
    return top[:, -1] - top[:, -2]


def _serve(ref, port, evs, now, batches):
    """Put ``evs`` into both engines and run ``batches`` process_batch calls;
    compare every report. Returns the number of rows scored."""
    ref.buffer.put(_ref_events(evs))
    port.buffer.put(evs)
    for _ in range(batches):
        before = len(ref.buffer)
        peek = [e for _, e in list(ref.buffer._q)[:ref.econf.max_batch_events]]
        rrep, prep = ref.process_batch(now), port.process_batch(now)
        if rrep is None:
            assert prep is None
            continue
        assert prep.n_events == rrep.n_events
        assert prep.padding_frac == rrep.padding_frac
        assert prep.compiled == rrep.compiled
        assert len(prep.latencies_s) == len(rrep.latencies_s)
        assert len(port.buffer) == len(ref.buffer) == before - rrep.n_events
        seq = ref._bucket_seq(max(e.tokens for e in peek))
        assert (_margins(ref, ref._tokens_of(peek, seq)) > MARGIN).all()
    assert port.jit_compiles == ref.jit_compiles
    assert [r["next_token"] for r in port.sink.rows] == \
        [r["next_token"] for r in ref.sink.rows]
    assert port.sink.rows == ref.sink.rows
    assert port.replays == ref.replays
    assert _asdict(port.buffer.stats) == _asdict(ref.buffer.stats)


def test_stream_engine_matches_reference_across_reconfigures():
    base = dict(max_batch_events=8, max_seq=32, seq_bucket_count=2)
    ref, port = _engines(base)
    assert port.device.type == "cpu"
    ref.warmup()
    port.warmup()
    assert port.jit_compiles == ref.jit_compiles == 1
    evs = _events(40)
    _serve(ref, port, evs[:19], now=5.0, batches=3)     # 8, 8, 3 (pads to 4)
    # the same config again: no new "compile"
    for eng, cls in ((ref, RefEngineConfig), (port, EngineConfig)):
        eng.reconfigure(cls(**base))
    _serve(ref, port, evs[19:27], now=6.0, batches=1)
    # attention impl and chunk move: the step cache is cleared on both
    for impl, chunk, parts in (("pallas", 64, 3), ("naive", 16, 5)):
        kw = dict(base, attn_impl=impl, attn_chunk=chunk, sink_partitions=parts)
        ref.reconfigure(RefEngineConfig(**kw))
        port.reconfigure(EngineConfig(**kw))
        assert port.model_cfg.attn_impl == impl
        _serve(ref, port, evs[27:40], now=7.0, batches=2)
        evs = evs[13:] + evs[:13]
    # pad_to_pow2 off: new shapes, exact batch sizes
    kw = dict(base, pad_to_pow2=False)
    ref.reconfigure(RefEngineConfig(**kw))
    port.reconfigure(EngineConfig(**kw))
    _serve(ref, port, _events(11, seed=5, t0=9.0), now=10.0, batches=2)
    assert port.jit_compiles == ref.jit_compiles >= 6
    assert port.forward_passes >= port.jit_compiles


def test_stream_engine_failure_replay_matches_reference():
    kw = dict(max_batch_events=4, max_seq=32, failure_inject_frac=0.5)
    ref, port = _engines(kw, seed=3)
    _serve(ref, port, _events(22, seed=2), now=3.0, batches=7)
    assert port.replays == ref.replays > 0
    assert ref.buffer.stats.replayed > 0
    offsets = [r["event_key"] for r in port.sink.rows]
    assert len(offsets) == 22


def test_compute_dtype_reconfigure_casts_params_and_recompiles():
    kw = dict(max_batch_events=4, max_seq=16)
    ref, port = _engines(kw)
    evs = _events(6, seed=4)
    _serve(ref, port, evs[:4], now=1.0, batches=1)
    for eng, cls in ((ref, RefEngineConfig), (port, EngineConfig)):
        eng.reconfigure(cls(**dict(kw, compute_dtype="bfloat16")))
    assert port.params["embed"].dtype == torch.bfloat16
    assert port.params["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert not port._step_cache
    ref.buffer.put(_ref_events(evs[4:]))
    port.buffer.put(evs[4:])
    rrep, prep = ref.process_batch(2.0), port.process_batch(2.0)
    assert prep.compiled and rrep.compiled
    assert prep.padding_frac == rrep.padding_frac
    assert port.jit_compiles == ref.jit_compiles == 2
    toks = np.array([r["next_token"] for r in port.sink.rows])
    assert toks.shape == (2,) and (toks >= 0).all()
    assert (toks < port.model_cfg.vocab_size).all()


def test_batching_rules_and_tokens_match_reference():
    ref, port = _engines(dict(max_seq=64))
    for econf in (dict(), dict(pad_to_pow2=False), dict(seq_bucket_count=1),
                  dict(seq_bucket_count=16, max_seq=128)):
        ref.econf = RefEngineConfig(**econf)
        port.econf = EngineConfig(**econf)
        for n in range(1, 140, 3):
            assert port._bucket_seq(n) == ref._bucket_seq(n), (econf, n)
    evs = _events(9, seed=6)
    np.testing.assert_array_equal(port._tokens_of(evs, 48),
                                  ref._tokens_of(_ref_events(evs), 48))


def test_engine_config_defaults_are_the_reference():
    assert dataclasses.asdict(EngineConfig()) == \
        dataclasses.asdict(RefEngineConfig())


def test_stream_engine_without_device_runs_on_cuda_or_raises():
    cfg = configs.get("qwen2_7b")
    econf = EngineConfig(attn_impl="pallas")
    if torch.cuda.is_available():  # pragma: no cover - on the card
        assert StreamEngine(configs.get("qwen2_7b", reduced=True),
                            econf=econf).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            StreamEngine(cfg, econf=econf)
