"""The port's ``SimCluster`` (the N=1 view over the torch fleet engine, on
the CPU): the twin of tests/test_simcluster.py's nine tests, with the same
workloads, seeds and limits, plus ``backlog_events`` and ``store`` held
against the reference's numpy ``SimCluster``.

The reference draws each reconfiguration's loading time from the
cluster's own numpy stream, and so does the port: after ``apply_config``
both report the same buffered backlog from the same ``load_s``, bit for
bit; the test holds them equal in f32, the device engine's precision.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.workloads import PoissonWorkload as RefPoisson  # noqa: E402
from repro.engine import SimCluster as RefSimCluster  # noqa: E402
from repro_torch.data.workloads import PoissonWorkload  # noqa: E402
from repro_torch.engine import EFFECTIVE, LEVER_SPECS, SimCluster  # noqa: E402
from repro_torch.monitoring.metrics import METRIC_NAMES  # noqa: E402


@pytest.fixture()
def env():
    return SimCluster(PoissonWorkload(10_000, 0.5), seed=0, device="cpu")


def _p99(env, window=400.0, **levers):
    c = env.current_config()
    c.update(levers)
    env.apply_config(c)
    env.observe(120.0)  # stabilise
    return env.observe(window).p99_ms


def test_observe_advances_clock_and_emits_90_metrics(env):
    w = env.observe(100.0)
    assert env.clock >= 100.0
    assert set(w.per_node) == set(METRIC_NAMES)
    assert all(v.shape == (env.n_nodes,) for v in w.per_node.values())
    assert np.isfinite(w.p99_ms) and w.p99_ms > 0


def test_batch_interval_ground_truth_shape(env):
    """Fig 7: 10 s barely copes; 2.5 s is much better (paper's headline), and
    below ~1 s the dispatch-overhead floor stops further gains."""
    p10 = _p99(env, batch_interval_s=10.0)
    env.reset()
    p2p5 = _p99(env, batch_interval_s=2.5)
    env.reset()
    p1 = _p99(env, batch_interval_s=1.0)
    env.reset()
    p_tiny = _p99(env, batch_interval_s=0.05)
    assert p2p5 < 0.5 * p10, (p2p5, p10)
    assert p1 < p2p5, (p1, p2p5)
    assert p_tiny > 0.6 * p1, (p_tiny, p1)  # overhead floor: no free lunch


def test_retention_caps_runaway_latency(env):
    p = _p99(env, batch_interval_s=10.0, max_batch_events=1e3)  # hopeless config
    assert p < 2.5 * env.spec.retention_s * 1000


def test_apply_config_buffers_backlog_and_costs_time(env):
    c = env.current_config()
    c["driver_memory_gb"] = 16.0  # reboot lever
    t0 = env.clock
    rep = env.apply_config(c)
    assert rep["rebooted"] is True
    assert rep["load_s"] > 60.0
    assert env.clock == pytest.approx(t0 + rep["load_s"])
    assert env.backlog_events > 0


def test_inert_levers_do_not_move_the_service_model(env):
    base = env._service_terms(10_000, 0.5)["service"]
    c = env.current_config()
    for lever in ("log_level", "trace_sampling_frac", "ntp_sync_interval_s",
                  "telemetry_batch", "locality_wait_s"):
        spec = next(s for s in LEVER_SPECS if s.name == lever)
        c[lever] = spec.choices[-1] if spec.kind == "choice" else spec.hi
    env.config = c
    assert env._service_terms(10_000, 0.5)["service"] == pytest.approx(base)


def test_effective_levers_move_the_service_model(env):
    base = env._service_terms(50_000, 0.5)
    c = env.current_config()
    c["compute_dtype"] = "f32"
    env.config = c
    worse = env._service_terms(50_000, 0.5)
    assert worse["t_compute"] > 1.5 * base["t_compute"]
    c["grad_compression"] = "int8"
    env.config = c
    assert env._service_terms(50_000, 0.5)["t_collective"] < worse["t_collective"]


def test_straggler_mitigation_lever(env):
    # backup_tasks=True caps the straggler multiplier at 1.1 (see observe())
    rng_hits = []
    for flag in (False, True):
        e = SimCluster(PoissonWorkload(10_000, 0.5), seed=7, device="cpu")
        c = e.current_config()
        c["backup_tasks"] = flag
        e.apply_config(c)
        w = e.observe(1200.0)
        rng_hits.append(np.percentile(w.latencies_ms, 99.9))
    assert rng_hits[1] <= rng_hits[0]


def test_reset_restores_defaults(env):
    c = env.current_config()
    c["batch_interval_s"] = 1.0
    env.apply_config(c)
    env.observe(50.0)
    env.reset()
    assert env.clock == 0.0
    assert env.current_config()["batch_interval_s"] == 10.0
    assert env.backlog_events == 0.0


def test_effective_set_is_subset_of_lever_names():
    names = {s.name for s in LEVER_SPECS}
    assert set(EFFECTIVE) <= names
    assert len(LEVER_SPECS) == 109


# ---------------------------------------------------------------------------
# backlog_events and store against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,levers", [
    (0, {"driver_memory_gb": 16.0}),                       # reboot
    (3, {"driver_memory_gb": 16.0, "attn_block_q": 64}),   # reboot + rejit
    (11, {"log_level": "debug"}),                          # no reboot
])
def test_backlog_after_apply_config_matches_reference(seed, levers):
    """Right after ``apply_config`` the backlog is the buffered arrivals of
    the loading time, from the same numpy draw on both sides; a second
    reconfiguration before any window adds to it."""
    ref = RefSimCluster(RefPoisson(10_000, 0.5), seed=seed)
    env = SimCluster(PoissonWorkload(10_000, 0.5), seed=seed, device="cpu")
    for _ in range(2):
        reps = []
        for e in (ref, env):
            c = e.current_config()
            c.update(levers)
            reps.append(e.apply_config(c))
        assert reps[0] == reps[1] and env.clock == ref.clock
        assert env.backlog_events > 0
        assert np.float32(env.backlog_events) == np.float32(ref.backlog_events)


def test_backlog_setter_round_trips_and_reads_the_device_state(env):
    env.backlog_events = 1234.5                # before any window: the host
    assert env.backlog_events == 1234.5
    w = env.observe(100.0)
    dev = env._core._dev
    assert dev._backlog is not None            # the window moved it on device
    assert env.backlog_events == float(dev._backlog[0])
    assert np.isfinite(w.p99_ms)
    env.backlog_events = 42.0
    assert env.backlog_events == 42.0 and float(dev._backlog[0]) == 42.0
    c = env.current_config()
    c["driver_memory_gb"] = 16.0
    env.apply_config(c)                        # arrivals wait on the host
    pending = float(dev._pending_arrivals[0])
    assert pending > 0 and env.backlog_events == 42.0 + pending
    env.observe(10.0)                          # the window folds them in
    assert float(dev._pending_arrivals[0]) == 0.0
    env.reset()
    assert env.backlog_events == 0.0


def test_store_is_none_as_on_the_reference_device_backends(env):
    assert env.store is None
    assert RefSimCluster(RefPoisson(10_000, 0.5), seed=0).store is not None
