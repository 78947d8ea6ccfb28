"""The fused loop with its cluster axis sharded over a fleet mesh
(``Configurator(mesh=...)``, DESIGN.md §11), on gloo ranks on the CPU.

Each test spawns its ranks (``spawn`` start method, a ``FileStore`` in
``tmp_path``), so the pytest process keeps no process group. Against the
port's own unsharded run and against the reference's sharded run:

* a 1-rank mesh replays the unsharded run bit for bit on both window
  kernels (``window_impl`` "kernel" and "scan"), through ``run_epoch`` and
  through ``tune_pipelined``, as the reference's
  ``tests/test_device_loop.py`` pins for its own mesh;
* the range reduce and the cluster gather on 2 ranks against numpy, and
  the checkpoint store writing once and restoring on every rank;
* two greedy ranks fed the reference's draws (``JaxDraws.for_shard``) are
  f32-allclose to the reference's 2-device run (a subprocess with two
  forced host devices);
* two exploring ranks on their own draws: parameters and records equal on
  both ranks, the reward median within 0.15 of the unsharded run's, the
  state handed back whole (reconfigs, a later plain window), per update
  and per epoch;
* shielded chaos (faults, a deploy delay, the SLO reward) on two ranks;
* ``_resolve_mesh``'s three rules;
* the launchers under a ``torchrun``-style environment: the serve cycle
  and the tune pipeline on two ranks, files written by rank 0 only.
"""
import itertools
import json
import os
import queue
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chaos_harness import rel  # noqa: E402

import torch.distributed as dist  # noqa: E402

from repro_torch.core import Configurator  # noqa: E402
from repro_torch.data.workloads import (PoissonWorkload,  # noqa: E402
                                        SwitchingWorkload)
from repro_torch.engine import FleetEnv  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
METRICS = ["latency_p99_ms", "latency_mean_ms", "queue_depth", "device_util",
           "sched_queue_depth"]
LEVERS = ["max_batch_events", "prefetch_depth", "driver_memory_gb",
          "sink_partitions", "backup_tasks"]
MIX = ("poisson_low", "trapezoid", "yahoo_ads", "switching")
FROZEN = dict(split_after=10**9, extend_after=10**9, merge_after=10**9)
#: f32-allclose to the reference (test_torch_slice's batch tolerances)
RTOL, ATOL = 1e-4, 1e-3
#: seconds a spawned group may take
JOIN_S = 240
_GROUPS = itertools.count()


# ----------------------------------------------------------------- harness
def _rank_main(fn, rank, world, store, args, q):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        q.put((rank, fn(rank, world, *args)))
    finally:
        dist.destroy_process_group()


def _spawn(fn, world, tmp_path, *args) -> list:
    """Run ``fn(rank, world, *args)`` on ``world`` gloo ranks; returns
    each rank's result, in rank order."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    store = tmp_path / f"store-{next(_GROUPS)}"
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, str(store), args, q))
             for r in range(world)]
    for p in procs:
        p.start()
    out = {}
    deadline = time.monotonic() + JOIN_S
    try:
        # drain before joining: a rank blocks in put() until its result
        # is read; stop early when a rank died
        while len(out) < world and time.monotonic() < deadline:
            try:
                rank, res = q.get(timeout=1.0)
                out[rank] = res
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
    finally:
        for p in procs:
            p.join(10 if len(out) == world else 0)
            if p.is_alive():
                p.kill()
    assert [p.exitcode for p in procs] == [0] * world, fn.__name__
    return [out[r] for r in range(world)]


def _mesh(world):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", (world,), mesh_dim_names=("fleet",))


def _stable_fleet(n, faults=None, impl="kernel"):
    """Half constant-rate, half regime-switching clusters the default
    config keeps up with (tests/test_device_loop.py's switching fleet)."""
    wls = [PoissonWorkload(10_000, 0.5) if i % 2 == 0 else
           SwitchingWorkload(PoissonWorkload(6_000, 0.5),
                             PoissonWorkload(12_000, 0.5),
                             period_s=700.0 + 60.0 * i) for i in range(n)]
    return FleetEnv(wls, seeds=list(range(n)), device="cpu", faults=faults,
                    window_impl=impl)


def _cfgr(env, mesh, **kw):
    kw = dict(dict(seed=0, steps_per_episode=3, window_s=240.0,
                   device_loop="on", bin_kw=FROZEN), **kw)
    return Configurator(env, METRICS, LEVERS, mesh=mesh, **kw)


def _params(cfgr) -> np.ndarray:
    return torch.cat([p.detach().flatten()
                      for p in cfgr.agent.policy.parameters()]).numpy()


def _run(env, mesh, *, epoch=False, updates=2, pipelined=False, **kw):
    cfgr = _cfgr(env, mesh, **kw)
    if epoch:
        cfgr.run_epoch(updates, records="full")
    elif pipelined:
        cfgr.tune_pipelined(updates, depth=2)
    else:
        for _ in range(updates):
            cfgr.run_update()
    return cfgr


def _summary(cfgr) -> dict:
    env, runner = cfgr.env, cfgr._runner
    return {"rewards": np.array([r.reward for r in cfgr.history]),
            "p99": np.array([r.p99_ms for r in cfgr.history]),
            "configs": [dict(c) for c in env.configs],
            "params": _params(cfgr), "clock": env.clock.copy(),
            "reconfigs": env.reconfigs.tolist(),
            "sharded": runner.mesh is not None}


# ------------------------------------------------------- one rank: bitwise
def _one_rank_twins(rank, world, impl):
    from repro_torch.distribution import sharding as shd

    mesh1 = _mesh(1)
    out = {}
    for mode in ("update", "epoch", "pipelined"):
        kw = dict(epoch=mode == "epoch", pipelined=mode == "pipelined",
                  updates=3)
        plain = _summary(_run(_stable_fleet(8, impl=impl), "off", **kw))
        c0 = shd.COLLECTIVES
        cfgr = _run(_stable_fleet(8, impl=impl), mesh1, **kw)
        sharded = _summary(cfgr)
        assert cfgr._runner.mesh is mesh1 and sharded["sharded"]
        out[mode] = (plain, sharded, shd.COLLECTIVES - c0)
    return out


@pytest.mark.parametrize("impl", ["kernel", "scan"])
def test_one_rank_mesh_replays_the_unsharded_run_bitwise(impl, tmp_path):
    """The mesh plumbing pin: the rank's block is the whole fleet, the
    range reduce and the gather are identities and shard 0 draws the
    unsharded stream, so three updates (sequential, an epoch of three,
    and pipelined at depth 2) must equal the unsharded run bit for bit —
    while every collective still runs: per update 3 range reduces and 1
    gather, plus 1 stream broadcast each time the state is handed back
    (each update; once an epoch or a pipelined call)."""
    (res,) = _spawn(_one_rank_twins, 1, tmp_path, impl)
    for mode, (plain, sharded, n_coll) in res.items():
        assert not plain["sharded"]
        for k in ("rewards", "p99", "params", "clock"):
            assert np.array_equal(plain[k], sharded[k]), (mode, k)
        assert plain["configs"] == sharded["configs"]
        assert plain["reconfigs"] == sharded["reconfigs"] == [9] * 8
        handbacks = 3 if mode == "update" else 1
        assert n_coll == 3 * (3 + 1) + handbacks, (mode, n_coll)


# ------------------------------------------- two greedy ranks vs reference
_REF_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import jax
    from repro.core.configurator import Configurator
    from repro.engine import FleetEnv
    assert jax.device_count() == 2, jax.devices()
    env = FleetEnv.heterogeneous(8, seed=0, mix={mix!r}, backend="pallas")
    cfgr = Configurator(env, {metrics!r}, {levers!r}, seed=0,
                        steps_per_episode=3, window_s=240.0,
                        device_loop="on", bin_kw={frozen!r}, mesh="auto")
    runner = cfgr._device_runner()
    assert runner.mesh is not None and runner.mesh.size == 2
    out = {{"key": np.asarray(env._dev._key), "draws": env._dev._draws}}
    out.update({{"p0_" + k: np.asarray(v)
                for k, v in cfgr.agent.params.items()}})
    _, recs = cfgr.run_fleet_episodes_device(explore=False)
    _, recs2 = runner.run_epoch(2, explore=False)
    recs = recs + recs2
    out["lever"] = np.array([r.lever for r in recs])
    out["direction"] = np.array([r.direction for r in recs])
    out["reward"] = np.array([r.reward for r in recs])
    out["p99"] = np.array([r.p99_ms for r in recs])
    out["rclock"] = np.array([r.clock_s for r in recs])
    out["configs"] = np.array([repr(sorted(c.items()))
                               for c in env.current_configs()])
    out["clock"] = env.clock
    out.update({{"p_" + k: np.asarray(v)
                for k, v in cfgr.agent.params.items()}})
    np.savez(sys.argv[1], **out)
""")


def _greedy_port(rank, world, ref):
    from test_torch_window import JaxDraws

    import jax.numpy as jnp

    env = FleetEnv.heterogeneous(8, seed=0, mix=MIX, device="cpu")
    cfgr = _cfgr(env, "auto")
    assert cfgr._device_runner().mesh.size() == 2
    cfgr.agent.load_reference_params(
        {k[3:]: v for k, v in ref.items() if k.startswith("p0_")})
    env._dev.draws = JaxDraws(jnp.asarray(ref["key"]), int(ref["draws"]))
    _, recs = cfgr.run_fleet_episodes_device(explore=False)
    _, recs2 = cfgr._runner.run_epoch(2, explore=False)
    recs = recs + recs2
    return {"lever": [r.lever for r in recs],
            "direction": [r.direction for r in recs],
            "reward": np.array([r.reward for r in recs]),
            "p99": np.array([r.p99_ms for r in recs]),
            "rclock": np.array([r.clock_s for r in recs]),
            "configs": [repr(sorted(c.items()))
                        for c in env.current_configs()],
            "clock": env.clock.copy(),
            "params": {k: v.detach().numpy()
                       for k, v in cfgr.agent.params.items()}}


def test_two_greedy_ranks_match_the_reference_two_device_run(tmp_path):
    """A greedy episode batch, then a greedy epoch of 2 updates, on 2
    ranks fed the reference's draws, against the reference's fleet
    ``shard_map`` on 2 forced host devices: actions and configs exact,
    rewards, p99, clocks and the replicated update's parameters
    f32-allclose; the two ranks' results identical."""
    # the reference's compiled CPU tier, as the in-process reference tests
    # pin it: tests/test_kernels.py sets REPRO_PALLAS_INTERPRET at import,
    # which every xdist worker inherits
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "REPRO_PALLAS_INTERPRET",
                        "REPRO_REQUIRE_COMPILED")}
    env.update(XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"))
    path = tmp_path / "ref.npz"
    code = _REF_SCRIPT.format(mix=MIX, metrics=METRICS, levers=LEVERS,
                              frozen=FROZEN)
    done = subprocess.run([sys.executable, "-c", code, str(path)], env=env,
                          capture_output=True, text=True, timeout=JOIN_S)
    assert done.returncode == 0, done.stderr[-3000:]
    ref = dict(np.load(path))
    ranks = _spawn(_greedy_port, 2, tmp_path, ref)
    for got in ranks:
        assert got["lever"] == ref["lever"].tolist()
        assert got["direction"] == ref["direction"].tolist()
        assert got["configs"] == ref["configs"].tolist()
        np.testing.assert_allclose(got["reward"], ref["reward"], rtol=RTOL)
        np.testing.assert_allclose(got["p99"], ref["p99"], rtol=RTOL)
        np.testing.assert_allclose(got["rclock"], ref["rclock"], rtol=1e-6)
        np.testing.assert_allclose(got["clock"], ref["clock"], rtol=1e-6)
        for name, (rname, transpose) in {
                "l1.weight": ("w1", True), "l1.bias": ("b1", False),
                "l2.weight": ("w2", True), "l2.bias": ("b2", False)}.items():
            g = got["params"][name]
            np.testing.assert_allclose(g.T if transpose else g,
                                       ref["p_" + rname], rtol=RTOL,
                                       atol=ATOL, err_msg=name)
    for k in ("reward", "p99", "clock"):
        assert np.array_equal(ranks[0][k], ranks[1][k]), k
    for name in ranks[0]["params"]:
        assert np.array_equal(ranks[0]["params"][name],
                              ranks[1]["params"][name])


# ----------------------------------------- two exploring ranks, own draws
def _exploring(rank, world, epoch):
    cfgr = _run(_stable_fleet(16), "auto", epoch=epoch)
    assert cfgr._runner.mesh.size() == 2
    out = _summary(cfgr)
    # the state came back whole: a later plain window runs on it
    stats = cfgr.env.observe_stats(240.0)
    out["observed"] = np.asarray(stats["mean_ms"])
    return out


def _collectives(rank, world):
    from repro_torch.distribution import sharding as shd

    g = dist.group.WORLD
    lo = torch.tensor([1.0, -2.0, float("inf")]) * (rank + 1)
    hi = torch.tensor([-0.0, 5.0, -float("inf")]) * (rank + 1)
    rng = np.random.default_rng(rank)
    parts = [(torch.from_numpy(rng.integers(0, 9, (3, 2))), 0),
             (torch.from_numpy(rng.random((4, 3)).astype(np.float32)), 1),
             (torch.from_numpy(rng.random((3, 2, 5)) < 0.5), 0),
             (torch.from_numpy(rng.random(3).astype(np.float32)), 0)]
    return {"range": [x.numpy() for x in shd.range_reduce(lo, hi, g)],
            "whole": [x.numpy() for x in shd.cluster_gather(parts, 3, g)],
            "parts": [x.numpy() for x, _ in parts]}


def test_range_reduce_and_cluster_gather_across_ranks(tmp_path):
    """The two collectives of the episode on 2 ranks: MIN / MAX of the
    running range as one all-reduce (infinities and signed zeros kept),
    and one all-gather of leaves of mixed dtypes along dim 0 or dim 1,
    each equal to concatenating the ranks' blocks in rank order."""
    a, b = _spawn(_collectives, 2, tmp_path)
    assert np.array_equal(a["range"][0], [1.0, -4.0, np.inf])
    assert np.array_equal(a["range"][1], [0.0, 10.0, -np.inf])
    for x, y in zip(a["range"] + a["whole"], b["range"] + b["whole"]):
        assert np.array_equal(x, y) and x.dtype == y.dtype
    for i, d in enumerate((0, 1, 0, 0)):
        want = np.concatenate([a["parts"][i], b["parts"][i]], axis=d)
        assert a["whole"][i].dtype == want.dtype
        assert np.array_equal(a["whole"][i], want), i


def _store(rank, world, path):
    from repro_torch.checkpoint import CheckpointStore

    store = CheckpointStore(path)
    tree = {"w": torch.arange(6.0).reshape(2, 3) + rank * 0, "n": 3}
    store.save(1, tree)
    store.save_async(2, {"w": tree["w"] + 1, "n": 4})
    store.wait()
    restored = [store.restore(tree, step=s)[0] for s in (1, 2)]
    return {"steps": store.all_steps(),
            "w": [r["w"].numpy() for r in restored]}


def test_checkpoint_store_writes_on_rank_0_and_every_rank_restores(tmp_path):
    """A synchronous and an asynchronous save from 2 ranks: one writer,
    a barrier before any rank reads, every rank restores both."""
    ranks = _spawn(_store, 2, tmp_path, str(tmp_path / "ck"))
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_00000001", "step_00000002"]
    for r in ranks:
        assert r["steps"] == [1, 2]
        assert np.array_equal(r["w"][0], np.arange(6.0).reshape(2, 3))
        assert np.array_equal(r["w"][1], np.arange(6.0).reshape(2, 3) + 1)


@pytest.mark.parametrize("epoch", [False, True], ids=["update", "epoch"])
def test_two_exploring_ranks_stay_in_distribution(epoch, tmp_path):
    """Per-shard streams differ from the unsharded stream by design, so the
    pin is the reference's distributional one (the median within 0.15),
    plus the handback: every cluster reconfigured 2·3 times, a later plain
    window finite and equal on both ranks, parameters and records equal on
    both ranks."""
    ranks = _spawn(_exploring, 2, tmp_path, epoch)
    plain = _summary(_run(_stable_fleet(16), "off", epoch=epoch))
    a, b = ranks
    assert a["sharded"] and b["sharded"] and not plain["sharded"]
    for k in ("rewards", "p99", "params", "clock", "observed"):
        assert np.array_equal(a[k], b[k]), k
    assert a["configs"] == b["configs"]
    assert a["reconfigs"] == [2 * 3] * 16
    assert np.isfinite(a["observed"]).all()
    assert not np.array_equal(a["params"], plain["params"])
    assert rel(np.median(a["rewards"]), np.median(plain["rewards"])) < 0.15, (
        np.median(a["rewards"]), np.median(plain["rewards"]))


# --------------------------------------------------------- shielded chaos
def _chaos(rank, world, mesh):
    from repro_torch.core.faults import (DeployLatencyFault, chaos_scenario,
                                         pack_device_faults,
                                         unpack_device_faults)

    n = 8
    ev = unpack_device_faults(chaos_scenario(n, seed=0))
    faults = pack_device_faults([e + [DeployLatencyFault(1)] for e in ev])
    cfgr = _run(_stable_fleet(n, faults=faults), mesh, reward_mode="slo",
                slo_ms=2_000.0, safe=True)
    runner = cfgr._runner
    out = _summary(cfgr)
    ch, sh = runner.chaos, cfgr.shield_counters
    out["chaos"] = (ch.windows, ch.fault_events, ch.breached_windows)
    out["shield"] = (sh.clamped_actions, sh.fallbacks,
                     sh.budget_exhaustions)
    out["lkg"] = runner._shield[0].numpy()
    out["hist"] = runner._hist.numpy()
    return out


def test_shielded_chaos_on_two_ranks(tmp_path):
    """The fault table, the deploy-history ring (split on its cluster dim)
    and the shield's four per-cluster leaves through the mesh: both ranks
    agree on everything, every cluster ran 2·3 windows, the fault and
    breach counters equal the unsharded run's (every window breaches the
    2 s SLO), and the reward bulk agrees with it."""
    ranks = _spawn(_chaos, 2, tmp_path, "auto")
    plain = _chaos(0, 1, "off")
    a, b = ranks
    assert a["sharded"] and not plain["sharded"]
    for k in ("rewards", "params", "lkg", "hist"):
        assert np.array_equal(a[k], b[k]), k
    assert a["chaos"] == b["chaos"] and a["shield"] == b["shield"]
    assert a["hist"].shape == plain["hist"].shape == (2, 8, a["lkg"].shape[1])
    assert a["chaos"][:2] == plain["chaos"][:2] == (2 * 3 * 8,
                                                    plain["chaos"][1])
    assert a["chaos"][2] == plain["chaos"][2]
    assert np.isfinite(a["rewards"]).all()
    assert rel(np.median(a["rewards"]), np.median(plain["rewards"])) < 0.15


# ------------------------------------------------------- the mesh's rules
def _rules(rank, world):
    from repro_torch.distribution.sharding import fleet_mesh

    out = []
    for opt in ("off", None):
        out.append(_cfgr(_stable_fleet(4), opt)._device_runner().mesh)
    auto = _cfgr(_stable_fleet(4), "auto")._device_runner()
    out.append((auto.mesh.size(), auto._block.lo, auto._block.n,
                auto.graph_reason))
    # "auto" on a fleet the world does not divide runs unsharded
    out.append(_cfgr(_stable_fleet(3), "auto")._device_runner().mesh)
    with pytest.raises(ValueError, match="does not divide the 2-device mesh"):
        _cfgr(_stable_fleet(3), fleet_mesh())._device_runner()
    return out


def test_resolve_mesh_follows_the_reference_rules(tmp_path):
    a, b = _spawn(_rules, 2, tmp_path)
    assert a[:2] == b[:2] == [None, None]
    assert a[2][:3] == (2, 0, 2) and b[2][:3] == (2, 2, 2)
    assert "gloo" in a[2][3]
    assert a[3] is None and b[3] is None
    # without a process group "auto" is one device; a non-mesh is refused
    assert _cfgr(_stable_fleet(4), "auto")._device_runner().mesh is None
    with pytest.raises(TypeError, match="DeviceMesh"):
        _cfgr(_stable_fleet(4), ("data",))


# ----------------------------------------------------- the launchers
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(rank, world, port, module, argv):
    """A launcher's ``main`` as ``torchrun`` starts it: the process group
    comes from the environment."""
    import contextlib
    import importlib
    import io

    dist.destroy_process_group()          # the harness's; main builds its own
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        importlib.import_module(module).main(argv)
    # the harness tears a group down after each rank's result
    dist.barrier()
    return log.getvalue()


def test_serve_launcher_on_two_ranks_writes_from_rank_0(tmp_path):
    """``launch.serve`` under a torchrun environment: the shadow fleet is
    sharded over both ranks, both ranks decide alike, and the one
    ``history.jsonl``, ``metrics.prom`` and checkpoint are rank 0's; a
    resumed run restores it on both ranks."""
    out = tmp_path / "serve"
    argv = ["--cycles", "2", "--quick", "--fleet", "4", "--device", "cpu",
            "--out", str(out)]
    logs = _spawn(_launch, 2, tmp_path, _free_port(),
                  "repro_torch.launch.serve", argv)
    for log in logs:
        assert "cluster axis sharded over 2 devices (§11)" in log
    decisions = [[ln for ln in log.splitlines() if ln.startswith("[cycle")]
                 for log in logs]
    assert decisions[0] == decisions[1] and len(decisions[0]) == 2
    rows = [json.loads(ln) for ln in
            (out / "history.jsonl").read_text().splitlines()]
    assert sorted({r["cycle"] for r in rows}) == [1, 2]
    assert len(rows) == len({(r["cycle"], r["role"]) for r in rows})
    assert "repro_serve_cycles_total 2" in (out / "metrics.prom").read_text()
    assert [p.name for p in (out / "ck").iterdir()] == ["step_00000002"]
    logs = _spawn(_launch, 2, tmp_path, _free_port(),
                  "repro_torch.launch.serve", argv + ["--resume"])
    for log in logs:
        assert "[resume] restored checkpoint step 2 (cycle 2" in log
    assert "repro_serve_cycles_total 4" in (out / "metrics.prom").read_text()


def test_tune_launcher_on_two_ranks_writes_from_rank_0(tmp_path):
    out = tmp_path / "tune"
    argv = ["--device", "cpu", "--fleet", "4", "--collect", "80",
            "--updates", "1", "--steps-per-episode", "2", "--out", str(out)]
    logs = _spawn(_launch, 2, tmp_path, _free_port(),
                  "repro_torch.launch.tune", argv)
    for log in logs:
        assert "cluster axis sharded over 2 devices (§11)" in log
    best = [[ln for ln in log.splitlines() if ln.startswith("[done] best")]
            for log in logs]
    assert best[0] == best[1] and len(best[0]) == 1
    assert sorted(p.name for p in out.iterdir()) == [
        "analysis.json", "history.json", "metrics.prom"]
    hist = json.loads((out / "history.json").read_text())
    assert len(hist["history"]) == 4 * 2
