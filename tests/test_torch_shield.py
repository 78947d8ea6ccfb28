"""The safety shield in the port (DESIGN.md §16) against the reference.

* A greedy episode batch on a chaos fleet with ``safe=True`` and the SLO
  reward, the reference's draws injected: the batch as in
  tests/test_torch_faults.py, plus the shield's carry (LKG, radius and
  streak exact, risk f32-allclose) and its counters exactly equal.
* The port's own bitwise laws, on its own Philox draws: a neutral shield
  (radius 64, threshold 2.0, budget 10⁶) replays the shield-off run —
  this fails if the counterfactual pick reads the draws a second time; a
  radius-0 shield leaves the config indices where they began.
* Statistical, pooled over ``chaos_harness.SEED_MATRIX``: the shielded
  fused loop against the reference's shielded host twin (on its numpy
  oracle), and the port's shielded host loop against its fused loop, at
  the reference's ``SHIELD_TOL``.
* The tune launcher's ``--safe`` on the CPU.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chaos_harness import SEED_MATRIX, Tolerances, assert_loop_equivalent  # noqa: E402
from test_torch_faults import (FROZEN, LEVERS, METRICS,  # noqa: E402
                               assert_greedy_batches_equal, _greedy_pair)

from repro.core import faults as ref_faults  # noqa: E402
from repro.core.configurator import Configurator as RefConfigurator  # noqa: E402
from repro.data.workloads import PoissonWorkload  # noqa: E402
from repro.engine import FleetEnv as RefFleetEnv  # noqa: E402
from repro_torch.core import Configurator  # noqa: E402
from repro_torch.core import faults  # noqa: E402
from repro_torch.data.workloads import PoissonWorkload as TPoisson  # noqa: E402
from repro_torch.engine import FleetEnv  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
#: the reference's shield SLO (tests/test_shield.py): these Poisson fleets
#: idle near a 10 s p99, so 12 s separates well- from badly-tuned windows
SLO_MS = 12_000.0
#: the reference's shield tolerance (tests/test_shield.py)
SHIELD_TOL = Tolerances(median_reward=0.45, median_p99=0.25,
                        trim_reward=0.60, median_return=0.45)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reference_compiled_tier(monkeypatch):
    """The reference's compiled CPU tier (see tests/test_torch_slice.py)."""
    monkeypatch.delenv("REPRO_PALLAS_INTERPRET", raising=False)
    monkeypatch.delenv("REPRO_REQUIRE_COMPILED", raising=False)


def test_shielded_greedy_batch_matches_reference_exactly():
    n, steps = 8, 4
    ref_side, port_side = _greedy_pair(
        n, steps=steps, reward_mode="slo", slo_ms=SLO_MS, safe=True,
        shield_kw=dict(trust_radius=1, breach_budget=2))
    assert_greedy_batches_equal(ref_side, port_side, n, steps)
    ref, port = ref_side[1], port_side[1]
    lkg, radius, streak, risk = port._runner._shield
    r_lkg, r_radius, r_streak, r_risk = ref._runner._shield
    for got, want in ((lkg, r_lkg), (radius, r_radius), (streak, r_streak)):
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(risk.numpy(), np.asarray(r_risk), rtol=1e-5,
                               atol=1e-6)
    assert port.shield_counters.as_dict() == ref.shield_counters.as_dict()
    c = port.shield_counters
    assert c.clamped_actions > 0 and c.fallbacks > 0
    assert c.budget_exhaustions > 0
    assert len(set(radius.tolist())) > 1      # the schedule moved apart
    np.testing.assert_array_equal(port._runner._config_idx.numpy(),
                                  np.asarray(ref._runner._config_idx))


# --------------------------------------------------------------------------
# the port's own bitwise laws
# --------------------------------------------------------------------------

def _chaos_fleet(n, seed=0):
    return FleetEnv([TPoisson(10_000, 0.5) for _ in range(n)],
                    seeds=[seed + i for i in range(n)], device="cpu",
                    faults=faults.chaos_scenario(n, seed=seed))


def _cfgr(env, *, device_loop="on", seed=0, **kw):
    return Configurator(env, METRICS, LEVERS, seed=seed, device="cpu",
                        steps_per_episode=3, window_s=240.0,
                        device_loop=device_loop, bin_kw=FROZEN,
                        reward_mode="slo", slo_ms=kw.pop("slo_ms", SLO_MS),
                        **kw)


def _slo_run(safe, shield_kw=None, updates=3, n=6):
    env = _chaos_fleet(n)
    cfgr = _cfgr(env, slo_ms=5_000.0, safe=safe, shield_kw=shield_kw)
    for _ in range(updates):
        cfgr.run_update()
    return cfgr, env


def test_neutral_shield_replays_shield_off_bitwise():
    """A trust region over the whole ladder and thresholds that never fire
    leave an all-True mask: the same draws give the same actions, so
    rewards and the final configs replay the shield-off run bit for bit
    (exploring updates, so the act draws are read)."""
    neutral = dict(trust_radius=64, radius_min=64, radius_max=64,
                   risk_threshold=2.0, breach_budget=10**6)
    off, env_off = _slo_run(False)
    neu, env_neu = _slo_run(True, neutral)
    assert off.agent.exploit_ready() and neu.agent.exploit_ready()
    assert [r.reward for r in off.history] == [r.reward for r in neu.history]
    assert [(r.lever, r.direction) for r in off.history] == \
        [(r.lever, r.direction) for r in neu.history]
    assert env_off.configs == env_neu.configs
    assert torch.equal(off._runner._config_idx, neu._runner._config_idx)
    c = neu.shield_counters
    assert c.clamped_actions == c.fallbacks == c.budget_exhaustions == 0
    assert c.trust_radius == 64.0
    for a, b in zip(off.agent.params.values(), neu.agent.params.values()):
        assert torch.equal(a, b)


def test_zero_radius_shield_confines_to_lkg():
    env = _chaos_fleet(4)
    cfgr = _cfgr(env, slo_ms=5_000.0, safe=True,
                 shield_kw=dict(trust_radius=0, radius_min=0, radius_max=0))
    cfgr.run_update()
    runner = cfgr._runner
    np.testing.assert_array_equal(runner._config_idx.numpy(), runner._idx0)
    assert cfgr.shield_counters.clamped_actions > 0
    assert cfgr.shield_counters.trust_radius == 0.0


def test_safe_mode_requires_slo_reward_and_contracts():
    env = _chaos_fleet(2)
    with pytest.raises(ValueError, match="reward_mode='slo'"):
        Configurator(env, METRICS, LEVERS, device="cpu", safe=True,
                     reward_mode="neg_p99")
    for dl in ("on", "off"):
        cfgr = _cfgr(_chaos_fleet(4), device_loop=dl, safe=True,
                     shield_kw=dict(trust_radius=4, radius_min=1))
        cfgr.run_update()
        cfgr.contract_shield()
        held = (cfgr._runner._shield if dl == "on"
                else cfgr._host_shield[1:])
        assert held[1].tolist() == [1] * 4 and held[2].tolist() == [0] * 4
        assert cfgr.shield_counters.trust_radius == 1.0
    off = _cfgr(_chaos_fleet(2))
    off.contract_shield()                 # no shield: a no-op
    assert off.shield is None


# --------------------------------------------------------------------------
# statistical
# --------------------------------------------------------------------------

_CACHE: dict = {}


def _pooled(side, n=8, updates=2):
    if side not in _CACHE:
        rs, ps, counters = [], [], []
        for s in SEED_MATRIX:
            if side == "reference host":
                env = RefFleetEnv([PoissonWorkload(10_000, 0.5)
                                   for _ in range(n)],
                                  seeds=[s + i for i in range(n)],
                                  backend="numpy",
                                  faults=ref_faults.chaos_scenario(n, seed=s))
                cfgr = RefConfigurator(
                    env, METRICS, LEVERS, seed=s, steps_per_episode=3,
                    window_s=240.0, device_loop="off", bin_kw=FROZEN,
                    mesh="off", reward_mode="slo", slo_ms=SLO_MS, safe=True)
            else:
                cfgr = _cfgr(_chaos_fleet(n, seed=s), seed=s, safe=True,
                             device_loop="on" if side == "fused" else "off")
            for _ in range(updates):
                cfgr.run_update()
            rs.append([r.reward for r in cfgr.history])
            ps.append([r.p99_ms for r in cfgr.history])
            counters.append(cfgr.shield_counters)
        _CACHE[side] = (np.concatenate(rs), np.concatenate(ps), counters)
    return _CACHE[side]


def test_shielded_fused_loop_matches_reference_shielded_host_twin():
    r_ref, p_ref, _ = _pooled("reference host")
    r, p, counters = _pooled("fused")
    assert np.isfinite(r).all() and (p > 0).all()
    assert_loop_equivalent(r_ref, p_ref, r, p, tol=SHIELD_TOL)
    # the shield engaged (a pin between two unshielded runs is vacuous)
    assert sum(c.fallbacks + c.clamped_actions for c in counters) > 0
    assert all(c.trust_radius > 0.0 for c in counters)


def test_shielded_host_loop_matches_shielded_fused_loop():
    r_f, p_f, _ = _pooled("fused")
    r_h, p_h, counters = _pooled("host")
    assert_loop_equivalent(r_f, p_f, r_h, p_h, tol=SHIELD_TOL)
    assert sum(c.fallbacks + c.clamped_actions for c in counters) > 0
    assert all(c.trust_radius > 0.0 for c in counters)


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

def _tune(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.tune", "--device", "cpu",
         *args, "--out", str(tmp_path)], capture_output=True, text=True,
        env=env, timeout=300, cwd=REPO)


def test_tune_launcher_safe(tmp_path):
    out = _tune(["--fleet", "4", "--reward", "slo", "--slo-ms", "12000",
                 "--safe", "--collect", "80", "--updates", "1",
                 "--steps-per-episode", "2"], tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "shield ACTIVE" in out.stdout
    assert "fused device loop (§10): ACTIVE" in out.stdout
    hist = json.loads((tmp_path / "history.json").read_text())
    assert len(hist["history"]) == 4 * 2
    json.loads((tmp_path / "analysis.json").read_text())
    prom = (tmp_path / "metrics.prom").read_text()
    assert "repro_chaos_windows_total 8" in prom
    assert "repro_shield_trust_radius" in prom
    assert "repro_shield_clamped_actions_total" in prom
    bad = _tune(["--fleet", "4", "--safe", "--collect", "80"],
                tmp_path / "bad")
    assert bad.returncode != 0
    assert "--safe needs --reward slo" in bad.stderr
