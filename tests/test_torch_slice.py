"""The first port slice end to end: ``FleetEnv(backend="torch")`` +
``Configurator`` fused loop against the reference's ``backend="pallas"``
fused loop, plus the port's package rules.

* Greedy episode batch with the reference's draws injected (``JaxDraws``):
  actions exact; states, rewards, p99, final backlog and clock f32-allclose.
* Exploring ``run_update``s, each side on its own RNG: statistical agreement
  at the ``tests/chaos_harness.py`` tolerances.
* Import hygiene: the port and ``chip_smoke.py`` load neither jax nor any
  ``repro`` module; no port source imports them.
* Device choice: ``backend="torch"`` without a device needs a card.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chaos_harness import assert_loop_equivalent  # noqa: E402
from test_torch_window import JaxDraws  # noqa: E402

from repro.core.configurator import Configurator as RefConfigurator  # noqa: E402
from repro.data.workloads import PoissonWorkload, SwitchingWorkload  # noqa: E402
from repro.engine import FleetEnv as RefFleetEnv  # noqa: E402
from repro_torch.core import Configurator  # noqa: E402
from repro_torch.data.workloads import PoissonWorkload as TPoisson  # noqa: E402
from repro_torch.data.workloads import SwitchingWorkload as TSwitching  # noqa: E402
from repro_torch.engine import FleetEnv  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
METRICS = ["latency_p99_ms", "latency_mean_ms", "queue_depth", "device_util",
           "sched_queue_depth"]
LEVERS = ["max_batch_events", "prefetch_depth", "driver_memory_gb",
          "sink_partitions", "backup_tasks"]
MIX = ("poisson_low", "trapezoid", "yahoo_ads", "switching")
FROZEN = dict(split_after=10**9, extend_after=10**9, merge_after=10**9)
#: f32-allclose across a whole batch: same draws and formulas, but XLA's
#: fused multiply-adds and erfinv differ in the last bits, and 3 chained
#: windows carry the queueing state (measured worst ~1e-5 relative)
RTOL, ATOL = 1e-4, 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reference_compiled_tier(monkeypatch):
    """Pin the reference's kernel tier to its compiled CPU tier (the port's
    CPU shapes follow it): tests/test_kernels.py sets
    ``REPRO_PALLAS_INTERPRET`` at import, which every xdist worker inherits
    when it collects that module."""
    monkeypatch.delenv("REPRO_PALLAS_INTERPRET", raising=False)
    monkeypatch.delenv("REPRO_REQUIRE_COMPILED", raising=False)


def _pair(n, *, seed=0, steps=3, window_s=240.0, mix=MIX):
    ref_env = RefFleetEnv.heterogeneous(n, seed=seed, mix=mix,
                                        backend="pallas")
    env = FleetEnv.heterogeneous(n, seed=seed, mix=mix, backend="torch",
                                 device="cpu")
    kw = dict(seed=seed, steps_per_episode=steps, window_s=window_s,
              device_loop="on", bin_kw=FROZEN)
    ref = RefConfigurator(ref_env, METRICS, LEVERS, mesh="off", **kw)
    port = Configurator(env, METRICS, LEVERS, **kw)
    return ref_env, ref, env, port


def test_greedy_batch_matches_reference_exactly():
    ref_env, ref, env, port = _pair(8)
    port.agent.load_reference_params(
        {k: np.asarray(v) for k, v in ref.agent.params.items()})
    env._dev.draws = JaxDraws(ref_env._dev._key)
    rb, rrec = ref.run_fleet_episodes_device(explore=False)
    pb, prec = port.run_fleet_episodes_device(explore=False)
    np.testing.assert_array_equal(pb["actions"].numpy(),
                                  np.asarray(rb["actions"]))
    np.testing.assert_allclose(pb["states"].numpy(), np.asarray(rb["states"]),
                               rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(pb["rewards"].numpy(),
                               np.asarray(rb["rewards"]), rtol=RTOL, atol=0.0)
    assert len(prec) == len(rrec) == 8 * 3
    for a, b in zip(prec, rrec):
        assert a.lever == b.lever and a.direction == b.direction
        assert a.config == b.config
        assert a.p99_ms == pytest.approx(b.p99_ms, rel=RTOL)
        assert a.clock_s == pytest.approx(b.clock_s, rel=1e-6)
    np.testing.assert_allclose(env._dev._backlog.numpy(),
                               np.asarray(ref_env._dev._backlog),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(env.clock, ref_env.clock, rtol=1e-6)
    assert env.reconfigs.tolist() == ref_env.reconfigs.tolist() == [3] * 8
    assert env.current_configs() == ref_env.current_configs()


def _stable_fleet(poisson, switching, n):
    """Rates the default config keeps up with (saturated windows turn the
    statistical pins into coin flips), half of them regime-switching."""
    return [poisson(10_000, 0.5) if i % 2 == 0 else
           switching(poisson(6_000, 0.5), poisson(12_000, 0.5),
                     period_s=700.0 + 60.0 * i) for i in range(n)]


def test_exploring_updates_statistically_match_reference():
    """Two exploring ``run_update``s per side on a stable-regime fleet, each
    side drawing its own numbers (threefry vs Philox): medians, trimmed
    means and returns agree at the chaos-harness tolerances."""
    n = 24
    ref_env = RefFleetEnv(_stable_fleet(PoissonWorkload, SwitchingWorkload, n),
                          seeds=list(range(n)), backend="pallas")
    env = FleetEnv(_stable_fleet(TPoisson, TSwitching, n),
                   seeds=list(range(n)), backend="torch", device="cpu")
    kw = dict(seed=0, steps_per_episode=3, window_s=240.0, device_loop="on",
              bin_kw=FROZEN)
    ref = RefConfigurator(ref_env, METRICS, LEVERS, mesh="off", **kw)
    port = Configurator(env, METRICS, LEVERS, **kw)
    w0 = port.agent.policy.l2.weight.detach().clone()
    for _ in range(2):
        ref.run_update()
        st = port.run_update()
    assert st["episodes"] == n and st["steps"] == n * 3
    assert np.isfinite(st["pg_loss"]) and np.isfinite(st["mean_return"])
    assert not torch.equal(w0, port.agent.policy.l2.weight)
    r_ref = np.array([x.reward for x in ref.history])
    p_ref = np.array([x.p99_ms for x in ref.history])
    r = np.array([x.reward for x in port.history])
    p = np.array([x.p99_ms for x in port.history])
    assert np.isfinite(r).all() and (p > 0).all()
    assert_loop_equivalent(r_ref, p_ref, r, p)


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.path[:0] = [{src!r}, {root!r}]\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('clean', len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
    ).format(src=str(REPO / "src"), root=str(REPO))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


def test_port_sources_do_not_import_jax_or_repro():
    pat = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)[\s.])",
                     re.M)
    files = list((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        hits = pat.findall(f.read_text())
        assert not hits, (f, hits)


def test_torch_backend_needs_a_card_unless_asked_for_the_cpu():
    for kw in ({}, {"backend": "torch"}):   # torch is the default backend
        if torch.cuda.is_available():
            assert FleetEnv(n=2, **kw).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                FleetEnv(n=2, **kw)
            with pytest.raises(RuntimeError, match="CUDA"):
                FleetEnv.heterogeneous(2, seed=0, **kw)
        assert FleetEnv(n=2, device="cpu", **kw).device.type == "cpu"
    # the reference's other engines are not ported: no silent numpy engine
    for backend in ("numpy", "jax", "pallas"):
        with pytest.raises(ValueError, match="torch"):
            FleetEnv(n=2, backend=backend, device="cpu")


def test_unported_paths_raise_instead_of_falling_back():
    # a workload the device rate grid cannot pack sends the reference to its
    # host loop, which the port has not got: it raises, naming the ROADMAP
    env = FleetEnv.heterogeneous(2, seed=0, mix=("iot",), device="cpu")
    cfgr = Configurator(env, METRICS, LEVERS, device="cpu")
    assert "not device-packable" in cfgr.device_loop_reason()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cfgr.run_update()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Configurator(FleetEnv(n=2, backend="torch", device="cpu"), METRICS,
                     LEVERS, safe=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FleetEnv(n=2, backend="torch", device="cpu", faults=[[]] * 2)
