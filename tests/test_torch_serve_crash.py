"""Crash-safe serve checkpoints of the port (DESIGN.md §13): the kill/resume
pins of tests/test_serve_crash.py, the port against itself, bitwise, on the
CPU.

An uninterrupted run A and a killed-then-resumed run B→C must end with
identical greedy actions, bitwise-identical policy parameters and rmsprop
state, the same gate log, the same fleet clocks/configs, the same counters
(wall-clock timings and the process-wide ``retraces`` gauge excepted) and
the same history rows. This holds only because every RNG stream is
restored exactly — each fleet's ``PhiloxDraws`` generator and the agent's
device sampler (``torch.Generator`` states as uint8 leaves), the engines'
window counters, the per-cluster SFC64 generators, the agent's and bins'
PCG64 states — and because the device runner's carries go back through
``_load_fresh``. The in-process case restores a controller whose runner
already holds its carry buffers and programs (on the card: captured
graphs; here the same program objects run eagerly on the same buffers).
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointStore
from repro_torch.data.workloads import PoissonWorkload, SwitchingWorkload
from repro_torch.serve import ServeController

METRICS = ["latency_p99_ms", "latency_mean_ms", "queue_depth",
           "device_util", "sched_queue_depth"]
LEVERS = ["max_batch_events", "prefetch_depth", "driver_memory_gb",
          "sink_partitions", "backup_tasks"]
FROZEN = dict(split_after=10**9, extend_after=10**9, merge_after=10**9)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wl(i):
    return SwitchingWorkload(PoissonWorkload(6_000, 0.5),
                             PoissonWorkload(12_000, 0.5),
                             period_s=700.0 + 60.0 * i)


def _controller(ckdir=None, **kw):
    # resumed controllers MUST be constructed with the same workloads /
    # seed / backend / window impl: the generators derive from the fleet
    # seeds. The pins below name the kernel path; the *_on_the_scan twins
    # run the controller's default, the lean scan
    kw.setdefault("slo_ms", 20_000.0)
    kw.setdefault("window_impl", "kernel")
    return ServeController([_wl(i) for i in range(3)],
                           metrics=METRICS, levers=LEVERS, backend="torch",
                           seed=0, window_s=240.0, steps_per_episode=2,
                           k_promote=2, margin=0.0, canary_pairs=2,
                           n_live=2, bin_kw=FROZEN, mesh="off",
                           checkpoint_dir=ckdir, device="cpu", **kw)


def _safe(ckdir=None):
    # slo_ms where the switching fleet mixes clean and breached windows, so
    # the shield state evolves across the crash point
    return _controller(ckdir, slo_ms=12_000.0, safe=True, trust_radius=2,
                       breach_budget=2)


def _tensors_equal(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k].detach(), b[k].detach()) for k in a)


def assert_same_service(A, C, rows_after=None):
    """Everything a resumed service must replay bitwise."""
    dim = A.cfgr.agent.state_dim
    probe = np.linspace(-1.0, 1.0, 5 * dim, dtype=np.float32).reshape(5, dim)
    assert np.array_equal(A.greedy_actions(probe), C.greedy_actions(probe))
    ag, cg = A.cfgr.agent, C.cfgr.agent
    assert _tensors_equal(ag.params, cg.params)
    assert _tensors_equal(ag.opt_state["nu"], cg.opt_state["nu"])
    assert torch.equal(ag.opt_state["count"], cg.opt_state["count"])
    assert ag.n_updates == cg.n_updates
    assert A.gate.log == C.gate.log
    assert A.incumbent == C.incumbent
    for ea, ec in [(A.shadow_env, C.shadow_env),
                   (A.canary_env, C.canary_env),
                   (A.live_env, C.live_env)]:
        assert np.array_equal(ea.clock, ec.clock)
        assert np.array_equal(ea.reconfigs, ec.reconfigs)
        assert ea.configs == ec.configs
        assert ea._dev._windows == ec._dev._windows
        assert torch.equal(ea._dev.draws.gen.get_state(),
                           ec._dev.draws.gen.get_state())
    # counters agree on everything except process-environment gauges:
    # wall-clock timings, and the retraces gauge (an absolute sample of
    # the process-wide capture total)
    ca, cc = A.counters.as_dict(), C.counters.as_dict()
    for k in ca:
        if ("wall" in k or k.endswith("_s") or k == "windows_per_s"
                or k == "retraces"):
            continue
        assert ca[k] == cc[k], k
    rows = A.history.rows()
    if rows_after is not None:
        rows = [r for r in rows if r["cycle"] > rows_after]
    assert C.history.rows() == rows


def _crash_resume(tmp_path, window_impl, step=None):
    """``step``: the checkpoint C restores (None: the latest, which must be
    B's mid-run checkpoint; a promotion in cycles 3-4 checkpoints too)."""
    # A: the uninterrupted reference run
    A = _controller(window_impl=window_impl)
    A.run(4)

    # B: same service, killed after a mid-run checkpoint at cycle 2
    B = _controller(tmp_path / "ck", window_impl=window_impl)
    B.run(2)
    B.checkpoint()
    B.run(2)        # work after the checkpoint — lost in the crash

    # C: a fresh process resumes from the store and replays cycles 3-4
    C = _controller(tmp_path / "ck", window_impl=window_impl)
    assert C.restore(step=step) == 2 and C.cycle == 2
    C.run(2)
    assert C.shadow_env.window_impl == window_impl
    assert_same_service(A, C, rows_after=2)
    # not vacuous: the service trained, canaried and moved its clocks
    assert A.cfgr.agent.n_updates == 4 and A.counters.canary_windows > 0


def _in_place(tmp_path, window_impl):
    A = _controller(window_impl=window_impl)
    A.run(4)
    B = _controller(tmp_path / "ck", window_impl=window_impl)
    B.run(2)
    B.checkpoint()
    B.run(2)
    runner = B.cfgr._runner
    bufs, progs = runner._bufs, dict(runner._programs)
    assert B.restore(step=2) == 2 and B.cycle == 2
    B.run(2)
    # the programs and the buffers they read were kept, not rebuilt
    assert runner._bufs is bufs and runner._programs == progs
    assert_same_service(A, B)


def test_serve_crash_resume_is_bitwise(tmp_path):
    _crash_resume(tmp_path, "kernel")


def test_serve_crash_resume_is_bitwise_on_the_scan(tmp_path):
    """The same pin on the controller's default window, the lean scan
    (whose run promotes in cycles 3-4: C restores B's step 2 by number)."""
    _crash_resume(tmp_path, "scan", step=2)


def test_in_place_restore_replays_the_same_cycles(tmp_path):
    """The same controller restores its own earlier checkpoint — its runner
    already holds carry buffers and built programs, and its generators
    have run on — and replays cycles 3-4 bitwise."""
    _in_place(tmp_path, "kernel")


def test_in_place_restore_replays_the_same_cycles_on_the_scan(tmp_path):
    _in_place(tmp_path, "scan")


def test_restore_host_mode_preserves_wide_dtypes(tmp_path):
    # the serve controller restores simulator clocks (f64), RNG words
    # (u64), bin hit counts (i64) and generator states (u8) through
    # host=True; the port's default path keeps every dtype too, as tensors
    # on the store's device (the reference's rounds under x64-off)
    store = CheckpointStore(tmp_path / "ck")
    tree = {"clock": np.arange(3, dtype=np.float64) + 0.1234567890123456,
            "hits": np.arange(3, dtype=np.int64) + 2**40,
            "words": np.arange(3, dtype=np.uint64) + 2**60,
            "gen": torch.Generator().manual_seed(7).get_state(),
            "t64": torch.arange(3, dtype=torch.float64) / 3.0}
    store.save(0, tree)
    host, _, _ = store.restore(tree, host=True)
    for k in tree:
        want = np.asarray(tree[k])
        assert isinstance(host[k], np.ndarray)
        assert host[k].dtype == want.dtype, k
        assert np.array_equal(host[k], want)
    dev, _, _ = store.restore(tree)
    for k in tree:
        want = np.asarray(tree[k])
        assert isinstance(dev[k], torch.Tensor) and dev[k].device.type == "cpu"
        assert np.array_equal(dev[k].numpy(), want) and \
            dev[k].numpy().dtype == want.dtype, k


def test_safe_controller_restores_safe_off_checkpoint(tmp_path):
    """§16 forward-compat: turning --safe on for a service that already has
    checkpoints (taken safe-off, so without the shield-carry leaves) must
    resume cleanly — the shield simply starts from its init state."""
    plain = _controller(tmp_path / "ck")
    plain.run(2)
    plain.checkpoint()

    safe = _controller(tmp_path / "ck", safe=True, trust_radius=2,
                       breach_budget=2)
    assert safe.restore() == 2 and safe.cycle == 2
    # non-shield state restored from the plain run; shield still at init
    assert safe.incumbent == plain.incumbent
    assert _tensors_equal(safe.cfgr.agent.params, plain.cfgr.agent.params)
    assert safe.cfgr.shield_counters.budget_exhaustions == 0
    assert safe.cfgr._runner._shield is None
    safe.run_cycle()           # and the shielded service runs from here
    assert safe.cycle == 3 and safe.cfgr._runner._shield is not None


def test_safe_mode_crash_resume_is_bitwise(tmp_path):
    """§16: the shield's per-cluster carry (LKG indices, trust radius,
    clean-window streak, breach risk), the controller's budget watermark
    and the shield counters all ride the checkpoint — a resumed safe-mode
    service replays the uninterrupted one bitwise."""
    A = _safe()
    A.run(4)

    B = _safe(tmp_path / "ck")
    B.run(2)
    B.checkpoint()

    C = _safe(tmp_path / "ck")
    assert C.restore() == 2 and C.cycle == 2
    # the restored shield carry is bitwise what B checkpointed
    sb, sc = B.cfgr._runner._shield, C.cfgr._runner._shield
    assert sb is not None and sc is not None
    for xb, xc in zip(sb, sc):
        assert torch.equal(xb, xc) and xb.dtype == xc.dtype
    assert C._budget_seen == B._budget_seen
    assert C.cfgr.shield_counters == B.cfgr.shield_counters
    C.run(2)

    # resumed replay ends bitwise-identical to the uninterrupted run —
    # and the pin is not vacuous: the shield moved off its init state
    sa, sc = A.cfgr._runner._shield, C.cfgr._runner._shield
    assert float(sa[3].max()) > 0.0
    for xa, xc in zip(sa, sc):
        assert torch.equal(xa, xc)
    assert A.cfgr.shield_counters == C.cfgr.shield_counters
    assert A._budget_seen == C._budget_seen
    assert_same_service(A, C, rows_after=2)
