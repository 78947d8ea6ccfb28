"""The port's serve control plane (DESIGN.md §13) on the CPU, against the
reference (tests/test_serve.py) and against itself.

Bitwise against the reference:
* the ``CanaryGate`` and ``EpisodeStore`` scenarios of tests/test_serve.py
  run on both packages, compared state for state and row for row (the
  JSONL files byte for byte);
* ``_window_reward``, ``_blocked_configs`` and ``_adopt_challenger`` on the
  same window arrays, gate logs and fake shadow records.

``ServeCounters`` accounting and its Prometheus text, ``flush_guard`` on
an interrupt.

Statistical against the reference (tests/chaos_harness.py tolerances
only, each side on its own draws): paired canary slices agree within
``DEFAULT_TOL.median_reward`` in the port and the port against the
reference; a degraded incumbent is promoted within 8 cycles on both (at
the median seed of ``SEED_MATRIX``); a permanent ``FailureFault`` on the
challenger slice gives 0 promotions, at least 1 rollback and the
incumbent back bit for bit on both.

The controller defaults to ``window_impl="scan"`` (the lean ``fleet_scan``
window, the twin of the reference's default ``backend="jax"``); the pins
above name ``window_impl="kernel"`` (the ``fleet_tick`` path they were
measured on), and their scan twins run the default: the paired canary
slices against the reference's jax controller, the degraded promotion,
the fault rollback and the acceptance run.

The port's own pins: ``CAPTURE_COUNTS`` and ``retrace_counts()`` flat from
cycle 3 (on the CPU programs run eagerly, so this pins the counters'
wiring: the card pins the capture, chip_smoke.py phase 14); ``epoch_k=2``
trains 2 updates a cycle; the warm-start hint; the 20-cycle switching
acceptance run over ``SEED_MATRIX``; the launcher's ``--quick`` run and
its ``--resume``; the card is the default device.
"""
import numpy as np
import pytest
import torch

from chaos_harness import DEFAULT_TOL, SEED_MATRIX, assert_rel_close
from repro.core.faults import FailureFault as RefFailureFault
from repro.data.workloads import PoissonWorkload as RefPoisson
from repro.data.workloads import SwitchingWorkload as RefSwitching
from repro.monitoring import ServeCounters as RefServeCounters
from repro.serve import CanaryGate as RefGate
from repro.serve import EpisodeStore as RefStore
from repro.serve import ServeController as RefController
from repro.serve import workload_features as ref_features
from repro_torch.core.device_loop import CAPTURE_COUNTS, EPOCH_DISPATCHES
from repro_torch.core.faults import FailureFault
from repro_torch.data.workloads import PoissonWorkload, SwitchingWorkload
from repro_torch.monitoring import ServeCounters, flush_guard, retrace_counts
from repro_torch.serve import (CanaryGate, EpisodeStore, ServeController,
                               workload_features)

METRICS = ["latency_p99_ms", "latency_mean_ms", "queue_depth",
           "device_util", "sched_queue_depth"]
LEVERS = ["max_batch_events", "prefetch_depth", "driver_memory_gb",
          "sink_partitions", "backup_tasks"]
#: freeze §2.4.1 bin adaptation — serve pins want a stable lever table
FROZEN = dict(split_after=10**9, extend_after=10**9, merge_after=10**9)
#: tests/test_serve.py's degraded incumbents: saturated (promote tests run
#: it with a huge SLO) and stationary (the acceptance run's start)
DEGRADED = {"max_batch_events": 20_000.0}
DEGRADED_STATIONARY = {"max_batch_events": 120_000.0}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wl(i, P=PoissonWorkload, S=SwitchingWorkload):
    return S(P(6_000, 0.5), P(12_000, 0.5), period_s=700.0 + 60.0 * i)


def _kw(kw):
    kw.setdefault("seed", 0)
    kw.setdefault("window_s", 240.0)
    kw.setdefault("steps_per_episode", 2)
    kw.setdefault("canary_pairs", 2)
    kw.setdefault("n_live", 2)
    kw.setdefault("bin_kw", FROZEN)
    kw.setdefault("mesh", "off")
    return kw


def _controller(n=3, **kw):
    """The port's controller; the pins name the kernel path unless the test
    passes ``window_impl`` (the controller's default is the scan)."""
    kw.setdefault("window_impl", "kernel")
    return ServeController([_wl(i) for i in range(n)], metrics=METRICS,
                           levers=LEVERS, backend="torch", device="cpu",
                           **_kw(kw))


def _ref_controller(n=3, **kw):
    return RefController([_wl(i, RefPoisson, RefSwitching)
                          for i in range(n)], metrics=METRICS,
                         levers=LEVERS, backend="jax", **_kw(kw))


# ------------------------------------------------------ bitwise: the gate
def _gate_scenarios(Gate):
    """tests/test_serve.py's gate scenarios; every state and decision."""
    out = []

    def snap(g, d=None):
        out.append((d, g.state(), g.streak, g.challenger))

    g = Gate(k=2, margin=0.02)                  # K consecutive wins
    g.adopt({"x": 1}, cycle=1)
    snap(g, g.decide(-1.0, -2.0, False, cycle=1))
    snap(g, g.decide(-1.0, -2.0, False, cycle=2))
    out.append(g.last_promoted)
    g = Gate(k=3, margin=0.0)                   # one loss demotes
    g.adopt({"x": 1}, cycle=1)
    snap(g, g.decide(-1.0, -2.0, False, cycle=1))
    snap(g, g.decide(-2.0, -1.0, False, cycle=2))
    g = Gate(k=1, margin=0.0)                   # breach beats reward
    g.adopt({"x": 1}, cycle=1)
    snap(g, g.decide(-1.0, -5.0, True, cycle=1))
    out.append((len(g.rollbacks()), len(g.promotions())))
    g = Gate(k=1, margin=0.10)                  # relative margin
    out.append((g.beats(-0.89, -1.0), g.beats(-0.95, -1.0)))
    g.adopt({"x": 1}, cycle=1)
    snap(g, g.decide(-0.95, -1.0, False, cycle=1))
    g = Gate(k=3, margin=0.05)                  # state round trip
    g.adopt({"x": 1}, cycle=4)
    g.decide(-1.0, -2.0, False, cycle=4)
    h = Gate()
    h.load_state(g.state())
    snap(h, h.decide(-1.0, -2.0, False, cycle=5))
    g = Gate(k=2, margin=0.0)                   # the §16 budget trip
    g.adopt({"x": 2}, cycle=3, shadow_reward=-1.5)
    g.force_demote(cycle=3)
    snap(g)
    return out


def test_gate_scenarios_equal_the_reference_state_for_state():
    port, ref = _gate_scenarios(CanaryGate), _gate_scenarios(RefGate)
    assert port == ref
    assert [d for d, *_ in port[:2]] == ["hold", "promote"]


def test_episode_store_equals_the_reference(tmp_path):
    """JSONL round trip, the crash-resume truncation and the warm-start
    query, row for row and byte for byte."""
    feats = workload_features(_wl(0), t=100.0)
    assert feats == ref_features(_wl(0, RefPoisson, RefSwitching), t=100.0)
    stores = {}
    for name, Store in (("port", EpisodeStore), ("ref", RefStore)):
        s = Store(tmp_path / f"{name}.jsonl")
        for c in range(4):
            s.append(cycle=c, role="shadow", workload=feats,
                     config={"max_batch_events": np.float64(1e5 + c),
                             "flag": np.bool_(c % 2)},
                     reward=np.float32(-c), p99_ms=5000.0, clock_s=240.0 * c,
                     breached=bool(c == 3))
        s2 = Store(tmp_path / f"{name}.jsonl")
        assert s2.rows() == s.rows()
        assert s2.truncate_to_cycle(1) == 2
        stores[name] = s2
    assert stores["port"].rows() == stores["ref"].rows()
    assert ((tmp_path / "port.jsonl").read_bytes()
            == (tmp_path / "ref.jsonl").read_bytes())

    lo = {"kind": "SwitchingWorkload", "rate": 6_000.0, "mean_size": 0.5}
    hi = {"kind": "SwitchingWorkload", "rate": 12_000.0, "mean_size": 0.5}
    answers = []
    for Store in (EpisodeStore, RefStore):
        s = Store()
        for c, (w, v, r, br) in enumerate([(lo, 1, -2.0, False),
                                           (lo, 2, -1.0, False),
                                           (hi, 3, -0.5, False),
                                           (hi, 4, -0.1, True)]):
            s.append(cycle=c, role="promote", workload=w, config={"v": v},
                     reward=r, p99_ms=1.0, clock_s=0.0, breached=br)
        answers.append([s.best_config_for(lo), s.best_config_for(hi),
                        s.best_config_for({"kind": "Nope", "rate": 1.0})])
    # the breached row never wins; an unknown kind falls back to the
    # nearest rate over every kind
    assert answers[0] == answers[1] == [{"v": 2}, {"v": 3}, {"v": 2}]


class _Rec:
    def __init__(self, cfg, reward, p99_ms=50.0):
        self.config, self.reward, self.p99_ms = cfg, reward, p99_ms


def test_window_reward_blocklist_and_challenger_pick_equal_the_reference():
    port = _controller(n=2, slo_ms=12_000.0)
    ref = _ref_controller(n=2, slo_ms=12_000.0)
    assert port.incumbent == ref.incumbent
    rng = np.random.default_rng(4)
    mean = rng.uniform(2e3, 3e4, 16)
    p99 = rng.uniform(5e3, 4e4, 16)
    for mode in ("slo", "neg_p99", "neg_mean"):
        port.reward_mode = ref.reward_mode = mode
        a = port._window_reward(mean, p99)
        b = ref._window_reward(mean, p99)
        assert a.dtype == b.dtype == np.float64 and np.array_equal(a, b)
    # f32 window statistics, as a device window returns them
    p32 = torch.as_tensor(p99, dtype=torch.float32)
    m32 = torch.as_tensor(mean, dtype=torch.float32)
    from repro_torch.serve.controller import _host
    assert np.array_equal(
        port._window_reward(_host(m32), _host(p32)),
        ref._window_reward(m32.numpy(), p32.numpy()))
    port.reward_mode = ref.reward_mode = "slo"

    inc = dict(port.incumbent)
    cfgs = []
    for v in (77_000.0, 88_000.0, 99_000.0, 111_000.0, 122_000.0):
        c = dict(inc)
        c["max_batch_events"] = v
        cfgs.append(c)
    log = [{"event": "rollback", "cycle": 1, "config": cfgs[0]},
           {"event": "demote", "cycle": 3, "config": cfgs[1]},
           {"event": "demote", "cycle": 5, "config": cfgs[2]}]
    recs = [_Rec(cfgs[0], -0.5), _Rec(cfgs[1], -0.6), _Rec(cfgs[2], -0.7),
            _Rec(inc, -0.1), _Rec(cfgs[3], -0.8, p99_ms=13_000.0),
            _Rec(cfgs[4], -0.9)]
    for cycle in (4, 5, 7, 9):
        picks = []
        for ctl in (port, ref):
            ctl.cycle = cycle
            ctl.gate.log = [dict(e) for e in log]
            ctl.gate.challenger = None
            blocked = ctl._blocked_configs()
            ctl._adopt_challenger(recs)
            picks.append((blocked, ctl.gate.challenger, ctl.gate.log[-1]))
        assert picks[0] == picks[1], cycle
    # the warm-start hint: a promoted row for these workload features
    for ctl in (port, ref):
        feats = {"kind": "SwitchingWorkload",
                 "rate": float(ctl.shadow_env.workloads[0].rate(
                     float(ctl.shadow_env.clock[0]))), "mean_size": 0.5}
        ctl.history.append(cycle=0, role="promote", workload=feats,
                           config=cfgs[1], reward=-0.2, p99_ms=1.0,
                           clock_s=0.0)
        ctl.gate.challenger = None
        ctl.cycle = 9
        ctl._adopt_challenger(recs)
    assert port.gate.log[-1] == ref.gate.log[-1]
    assert port.gate.challenger == cfgs[1]


# --------------------------------------------------- counters and the guard
def test_serve_counters_accounting_and_prometheus_text():
    ctl = _controller(n=2, k_promote=2, margin=0.0, slo_ms=20_000.0)
    ctl.run_cycle()
    ctl.run_cycle()
    c = ctl.counters
    assert c.cycles == 2
    assert c.shadow_windows == 2 * 2 * 2   # cycles × clusters × steps
    assert c.canary_windows == 2 * 2 * ctl.canary_pairs
    assert c.live_windows == 2 * ctl.live_env.n_clusters
    d = c.as_dict()
    assert d["windows_per_s"] > 0 and d["cycle_latency_s"] > 0
    text = c.prometheus_text()
    assert "# TYPE repro_serve_cycles_total counter" in text
    assert "repro_serve_cycles_total 2" in text
    assert "# TYPE repro_serve_live_p99_ms gauge" in text
    assert f"repro_serve_promotions_total {c.promotions}" in text
    assert "# TYPE repro_serve_retraces gauge" in text
    c2 = ServeCounters.from_dict(d)
    assert c2.as_dict() == d
    # the counters class is the reference's, field for field and line for
    # line of its exposition
    r = RefServeCounters.from_dict(d)
    assert r.as_dict() == d and r.prometheus_text() == text
    assert set(ctl.phase_s) == {"shadow", "canary", "live"}


def test_flush_guard_writes_dump_even_on_interrupt(tmp_path):
    path = tmp_path / "m" / "metrics.prom"
    c = ServeCounters(cycles=3)
    with pytest.raises(KeyboardInterrupt):
        with flush_guard(path, c.prometheus_text):
            c.inc("cycles")
            raise KeyboardInterrupt
    assert "repro_serve_cycles_total 4" in path.read_text()


# ----------------------------------------------- statistical, vs reference
def test_paired_canary_slices_statistically_equivalent():
    """Both canary slices run the SAME config on matched workloads: their
    rewards agree within the harness's loop tolerance, in the port and the
    port against the reference (the noise floor the gate margin sits on)."""
    ctl = _controller(slo_ms=400_000.0)
    cand_r, inc_r, breached = ctl._canary_eval(dict(ctl.incumbent))
    assert not breached
    assert_rel_close(cand_r, inc_r, DEFAULT_TOL.median_reward,
                     "paired canary slices (port)")
    ref = _ref_controller(slo_ms=400_000.0)
    rc, ri, rb = ref._canary_eval(dict(ref.incumbent))
    assert not rb
    assert_rel_close(cand_r, rc, DEFAULT_TOL.median_reward,
                     "challenger slice, port vs reference")
    assert_rel_close(inc_r, ri, DEFAULT_TOL.median_reward,
                     "incumbent slice, port vs reference")


def test_paired_canary_slices_on_the_scan_match_the_jax_backend():
    """The port's default controller runs the lean scan: its paired canary
    slices agree with each other and with the reference's default
    (``backend="jax"``) controller's, each side on its own draws."""
    ctl = ServeController([_wl(i) for i in range(3)], metrics=METRICS,
                          levers=LEVERS, device="cpu",
                          **_kw({"slo_ms": 400_000.0}))
    assert all(e.window_impl == "scan" for e in
               (ctl.shadow_env, ctl.canary_env, ctl.live_env))
    cand_r, inc_r, breached = ctl._canary_eval(dict(ctl.incumbent))
    assert not breached
    assert_rel_close(cand_r, inc_r, DEFAULT_TOL.median_reward,
                     "paired canary slices (port, scan)")
    ref = _ref_controller(slo_ms=400_000.0)
    rc, ri, rb = ref._canary_eval(dict(ref.incumbent))
    assert not rb
    assert_rel_close(cand_r, rc, DEFAULT_TOL.median_reward,
                     "challenger slice, port scan vs reference jax")
    assert_rel_close(inc_r, ri, DEFAULT_TOL.median_reward,
                     "incumbent slice, port scan vs reference jax")


def _maker(side):
    """The controller factory of a parametrised side: the port's kernel
    path, the reference's jax backend, or the port's scan."""
    if side == "port-scan":
        return lambda **kw: _controller(window_impl="scan", **kw)
    return _controller if side == "port" else _ref_controller


@pytest.mark.parametrize("side", ["port", "reference", "port-scan"])
def test_challenger_beats_degraded_incumbent_and_promotes(side):
    """A degraded incumbent is promoted within 8 cycles on the harness's
    seed matrix: at the median seed on each side (first promotions over
    seeds 0-31: the port 28 of 32 within 8 cycles, on the scan 29 of 32,
    the reference 8 of 10 over seeds 0-7, 11 and 23 — each misses some
    seeds, the port seed 0 on both windows), and every promotion beats the
    incumbent and reaches the live fleet."""
    make = _maker(side)
    first = []
    for seed in SEED_MATRIX:
        ctl = make(seed=seed, k_promote=2, margin=0.02, slo_ms=400_000.0,
                   incumbent=DEGRADED)
        assert ctl.incumbent["max_batch_events"] == 20_000.0
        for i in range(8):
            if ctl.run_cycle()["decision"] == "promote":
                break
        promos = ctl.gate.promotions()
        assert ctl.counters.promotions == len(promos)
        first.append(promos[0]["cycle"] if promos else None)
        if promos:
            assert promos[0]["cand_reward"] > promos[0]["inc_reward"]
            assert ctl.incumbent["max_batch_events"] != 20_000.0
            assert all(c == ctl.incumbent
                       for c in ctl.live_env.current_configs())
            assert ctl.history.rows(role="promote")
    assert sum(f is not None for f in first) * 2 > len(SEED_MATRIX), first


@pytest.mark.parametrize("side", ["port", "reference", "port-scan"])
def test_failure_fault_on_canary_triggers_rollback_bit_for_bit(side):
    # a permanent outage on the CHALLENGER slice only (clusters 0..M-1):
    # every canary evaluation breaches, so nothing may ever be promoted and
    # the incumbent must come back on the canary fleet bit-for-bit
    M = 2
    Fault = RefFailureFault if side == "reference" else FailureFault
    make = _maker(side)
    faults = [[Fault(t0_s=0.0, duration_s=1e9, slow_mult=8.0)]
              for _ in range(M)] + [[] for _ in range(M)]
    ctl = make(k_promote=1, margin=0.0, slo_ms=12_000.0,
               canary_faults=faults)
    incumbent0 = dict(ctl.incumbent)
    ctl.run(3)
    c = ctl.counters
    assert c.rollbacks >= 1 and c.promotions == 0, ctl.gate.log
    assert c.rollbacks == len(ctl.gate.rollbacks())
    assert c.canary_breached >= c.rollbacks
    assert ctl.incumbent == incumbent0
    assert all(cfg == incumbent0 for cfg in ctl.canary_env.current_configs())
    assert all(cfg == incumbent0 for cfg in ctl.live_env.current_configs())
    canary_rows = ctl.history.rows(role="canary")
    assert canary_rows and all(r["breached"] for r in canary_rows)


# ------------------------------------------------------- the port's own pins
def test_captures_and_retrace_gauge_flat_from_cycle_three():
    """Cycle 3 builds the last program (the exploit warm-up flips after two
    updates); later cycles reuse cycle 3's program set. The ``retraces``
    gauge samples ``retrace_counts()`` (kernel builds + captures) each
    cycle and stays flat with it."""
    ctl = _controller(n=2, slo_ms=20_000.0)
    assert ctl.cfgr.device_loop_reason() is None
    ctl.run_cycle()
    assert ctl.counters.retraces > 0
    assert ctl.counters.retraces == retrace_counts()
    ctl.run(2)
    captures, gauge = dict(CAPTURE_COUNTS), ctl.counters.retraces
    progs = dict(ctl.cfgr._runner._programs)
    ctl.run(2)
    assert dict(CAPTURE_COUNTS) == captures
    assert ctl.counters.retraces == gauge == retrace_counts()
    assert ctl.cfgr._runner._programs == progs
    text = ctl.counters.prometheus_text()
    assert f"repro_serve_retraces {gauge:g}" in text
    assert "repro_serve_retraces_total" not in text


def test_epoch_k_cycle_trains_k_updates_in_one_epoch():
    """``epoch_k=2``: one epoch of 2 captured body replays a cycle; the
    full record stream still lands in history for challenger picking."""
    ctl = _controller(epoch_k=2)
    s1 = ctl.run_cycle()
    assert ctl.cfgr.agent.n_updates == 2
    assert ctl.counters.as_dict()["shadow_windows"] == 2 * 3 * 2
    assert np.isfinite(s1["mean_return"])
    ctl.run_cycle()
    captures = dict(CAPTURE_COUNTS)
    d0 = EPOCH_DISPATCHES[0]
    s3 = ctl.run_cycle()
    assert dict(CAPTURE_COUNTS) == captures
    assert EPOCH_DISPATCHES[0] - d0 == 2       # one epoch of K=2 updates
    assert ctl.cfgr.agent.n_updates == 6
    assert s3["cycle"] == 3 and ctl.counters.cycles == 3


def test_warm_start_hint_adopts_the_promoted_config_at_cycle_one():
    """A controller started against a history that holds a promotion for
    these workload features canaries that config at cycle 1, before its
    own shadow records could surface it (history adoptions carry no
    shadow reward)."""
    ctl = _controller(incumbent=DEGRADED, slo_ms=400_000.0)
    promoted = dict(ctl.incumbent)
    promoted["max_batch_events"] = 300_000.0
    feats = workload_features(ctl.shadow_env.workloads[0], 0.0)
    ctl.history.append(cycle=0, role="promote", workload=feats,
                       config=promoted, reward=-5.0, p99_ms=1e4, clock_s=0.0)
    ctl.run_cycle()
    first = [e for e in ctl.gate.log if e["event"] == "adopt"][0]
    assert first["cycle"] == 1
    assert first["config"] == promoted
    assert first["shadow_reward"] is None


def test_twenty_cycle_switching_acceptance():
    """tests/test_serve.py's acceptance run on the port, over the harness's
    seed matrix: at every seed, no served config breached SLO during its
    winning canary evaluation and the live fleet serves the last promotion;
    at the median seed, 20 cycles promote at least one candidate (the port
    promotes at 31 of seeds 0-31, all but seed 0, whose shadow policy walks
    ``max_batch_events`` down; the reference at 10 of 10)."""
    _acceptance(_controller)


def test_twenty_cycle_switching_acceptance_on_the_scan():
    """The same acceptance run on the controller's default window, the
    lean scan (it promotes at 29 of seeds 0-31, seed 0 not among them)."""
    _acceptance(_maker("port-scan"))


def _acceptance(make):
    promotions = []
    for seed in SEED_MATRIX:
        ctl = make(seed=seed, k_promote=2, margin=0.02,
                   slo_ms=20_000.0, eval_windows=2,
                   incumbent=DEGRADED_STATIONARY)
        ctl.run(20)
        assert ctl.counters.cycles == 20
        promotions.append(ctl.counters.promotions)
        promoted = ctl.history.rows(role="promote")
        assert len(promoted) == ctl.counters.promotions
        for p in promoted:
            run_rows = [r for r in ctl.history.rows(role="canary")
                        if r["config"] == p["config"]
                        and r["cycle"] <= p["cycle"]]
            adopt = [e["cycle"] for e in ctl.gate.log
                     if e["event"] == "adopt" and e["config"] == p["config"]
                     and e["cycle"] <= p["cycle"]][-1]
            window = [r for r in run_rows if r["cycle"] >= adopt]
            assert window and not any(r["breached"] for r in window)
        if promoted:
            assert ctl.incumbent == promoted[-1]["config"]
        assert all(cfg == ctl.incumbent
                   for cfg in ctl.live_env.current_configs())
    assert sum(p >= 1 for p in promotions) * 2 > len(SEED_MATRIX), promotions


def test_launcher_quick_run_then_resume_accumulates(tmp_path, capsys):
    from repro_torch.launch import serve

    out = tmp_path / "serve"
    argv = ["--cycles", "2", "--quick", "--fleet", "3", "--device", "cpu",
            "--out", str(out)]
    serve.main(argv)
    text = (out / "metrics.prom").read_text()
    assert "repro_serve_cycles_total 2" in text
    assert (out / "ck" / "step_00000002" / "manifest.json").exists()
    serve.main(argv + ["--resume"])
    log = capsys.readouterr().out
    assert "[resume] restored checkpoint step 2 (cycle 2" in log
    assert "fused device loop (§10): ACTIVE" in log
    assert "repro_serve_cycles_total 4" in (out / "metrics.prom").read_text()
    assert (out / "ck" / "step_00000004").exists()
    rows = EpisodeStore(out / "history.jsonl").rows()
    assert sorted({r["cycle"] for r in rows}) == [1, 2, 3, 4]
    assert {r["role"] for r in rows} >= {"shadow", "live"}


def test_the_card_is_the_default_and_the_mesh_waits_for_item_7(tmp_path):
    wls = [_wl(0)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            ServeController(wls, metrics=METRICS, levers=LEVERS)
        from repro_torch.launch import serve
        with pytest.raises(RuntimeError, match="CUDA card"):
            serve.main(["--cycles", "1", "--quick", "--fleet", "1",
                        "--out", str(tmp_path)])
    # the mesh is a fleet DeviceMesh (tests/test_torch_fleet_mesh.py); an
    # LM mesh's axes are refused
    with pytest.raises(TypeError, match="DeviceMesh"):
        ServeController(wls, metrics=METRICS, levers=LEVERS, device="cpu",
                        mesh=("data",))
    with pytest.raises(ValueError, match="backend"):
        ServeController(wls, metrics=METRICS, levers=LEVERS, device="cpu",
                        backend="jax")
