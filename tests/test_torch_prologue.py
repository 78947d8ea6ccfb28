"""The fused loop's batch prologue derives its static facts once, and again
only when what they read changes (the port's ``DeviceEpisodeRunner``):

* the support check walks the workload roster once while the roster holds
  the same workload objects: three ``run_epoch`` calls walk it once and
  answer twice from the memo (``PROLOGUE_COUNTS``), and a workload
  replaced in the roster is checked again, with the same reason string a
  fresh configurator's check gives, and the reference's;
* with ``batch_interval_s`` tuned the tick budget is clamped to
  ``TICK_BUDGET`` without packing the configs; without it the configs are
  packed as before (``tick_packed`` counts those); ``(T, E)`` equals the
  reference's either way.

The bitwise epoch-versus-sequential tests (tests/test_torch_epoch.py) are
the guard that the outputs are unchanged.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_slice import FROZEN, LEVERS, METRICS  # noqa: E402

from repro.core.configurator import Configurator as RefConfigurator  # noqa: E402
from repro.data.workloads import IoTWorkload as RefIoT  # noqa: E402
from repro.engine import FleetEnv as RefFleetEnv  # noqa: E402
from repro_torch.core import Configurator  # noqa: E402
from repro_torch.core.device_loop import PROLOGUE_COUNTS  # noqa: E402
from repro_torch.data.workloads import IoTWorkload  # noqa: E402
from repro_torch.engine import FleetEnv  # noqa: E402

TUNED = LEVERS + ["batch_interval_s"]
MIX = ("poisson_low", "trapezoid", "yahoo_ads", "switching")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env(n=4, seed=0):
    return FleetEnv.heterogeneous(n, seed=seed, mix=MIX, backend="torch",
                                  device="cpu")


def _cfgr(env, levers=LEVERS, **kw):
    return Configurator(env, METRICS, levers, seed=0, steps_per_episode=2,
                        window_s=240.0, device_loop="on", bin_kw=FROZEN,
                        **kw)


def _delta(before: dict) -> dict:
    return {k: PROLOGUE_COUNTS[k] - v for k, v in before.items()}


@pytest.mark.parametrize("levers", [LEVERS, TUNED],
                         ids=["interval-fixed", "interval-tuned"])
def test_epochs_check_the_roster_once(levers):
    """Three ``run_epoch(2, "summary")``: one walk of the roster, two memo
    hits; the pack is skipped once a batch exactly when the interval is
    tuned, and made once a batch otherwise (the first epoch is all
    warm-up: one segment each)."""
    cfgr = _cfgr(_env(), levers)
    before = dict(PROLOGUE_COUNTS)
    for _ in range(3):
        stats = cfgr.run_epoch(2, records="summary")
        assert len(stats) == 2
    tuned = "batch_interval_s" in levers
    assert _delta(before) == {"support_checked": 1, "support_reused": 2,
                              "tick_pack_skipped": 3 if tuned else 0,
                              "tick_packed": 0 if tuned else 3}


def test_sequential_updates_reuse_the_check():
    """``run_update`` checks support every update; a roster in a new list
    of the same workload objects is the same roster. The interval is not
    tuned, so each update's batch packs the configs for its ticks."""
    cfgr = _cfgr(_env())
    before = dict(PROLOGUE_COUNTS)
    cfgr.run_update()
    cfgr.env.workloads = list(cfgr.env.workloads)
    cfgr.run_update()
    assert _delta(before) == {"support_checked": 1, "support_reused": 1,
                              "tick_pack_skipped": 0, "tick_packed": 2}


def test_replaced_workload_is_checked_again():
    """An ``iot`` workload put into the roster sends the next check to
    the host loop with the string a fresh configurator's check gives (and
    the reference's); the original put back, the loop is supported again."""
    env = _env()
    cfgr = _cfgr(env)
    assert cfgr.device_loop_reason() is None
    assert cfgr.device_loop_reason() is None
    before = dict(PROLOGUE_COUNTS)
    original = env.workloads[2]
    env.workloads[2] = IoTWorkload(seed=3)
    reason = cfgr.device_loop_reason()
    fresh = _cfgr(FleetEnv(env.workloads, backend="torch", device="cpu"))
    assert reason == fresh.device_loop_reason()
    assert reason == ("workloads not device-packable (cluster 2: workload "
                      "'iot' has no device rate law)")
    assert cfgr.device_loop_reason() == reason
    env.workloads[2] = original
    assert cfgr.device_loop_reason() is None
    assert _delta(before) == {"support_checked": 3, "support_reused": 1,
                              "tick_pack_skipped": 0, "tick_packed": 0}

    ref_env = RefFleetEnv.heterogeneous(4, seed=0, mix=MIX, backend="pallas")
    ref_env.workloads[2] = RefIoT(seed=3)
    ref = RefConfigurator(ref_env, METRICS, LEVERS, seed=0, mesh="off",
                          steps_per_episode=2, device_loop="auto")
    assert ref.device_loop_reason() == reason


def test_resized_roster_is_checked_again():
    """A roster one workload longer than the last, and one shorter, is
    another roster each time."""
    env = _env()
    cfgr = _cfgr(env)
    runner = cfgr._device_runner()
    assert runner.supported() is None
    before = dict(PROLOGUE_COUNTS)
    env.workloads.append(IoTWorkload(seed=1))
    assert "cluster 4: workload 'iot'" in runner.supported()
    env.workloads.pop()
    assert runner.supported() is None
    assert _delta(before)["support_checked"] == 2


@pytest.mark.parametrize("levers", [LEVERS, TUNED],
                         ids=["interval-fixed", "interval-tuned"])
def test_tick_budget_matches_reference(levers):
    """``(T, E)`` equals the reference's, which packs the configs either
    way; the port packs them only when the interval is not tuned."""
    env = _env()
    cfgr = _cfgr(env, levers)
    ref_env = RefFleetEnv.heterogeneous(4, seed=0, mix=MIX, backend="pallas")
    ref = RefConfigurator(ref_env, METRICS, levers, seed=0, mesh="off",
                          steps_per_episode=2, window_s=240.0,
                          device_loop="on", bin_kw=FROZEN)
    runner, ref_runner = cfgr._device_runner(), ref._device_runner()
    env.invalidate()
    before = dict(PROLOGUE_COUNTS)
    got = runner._tick_budget()
    assert got == ref_runner._tick_budget()
    tuned = "batch_interval_s" in levers
    assert (env._packed is None) == tuned
    assert _delta(before)["tick_pack_skipped"] == int(tuned)
    assert _delta(before)["tick_packed"] == int(not tuned)
    # the high-water mark holds the budget when the configs' ticks lengthen
    for c, rc in zip(env.configs, ref_env.configs):
        c["batch_interval_s"] = rc["batch_interval_s"] = 60.0
    env.invalidate()
    ref_env.invalidate()
    assert runner._tick_budget() == ref_runner._tick_budget() == got
    assert runner._hw_T == ref_runner._hw_T == got[0]
