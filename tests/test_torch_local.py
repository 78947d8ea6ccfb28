"""``repro_torch.engine.LocalEngine`` (the wall-clock tuning environment over
``StreamEngine``) and ``TimeSeriesStore`` against the reference's, on the
CPU.

``TimeSeriesStore`` is a numpy copy: bitwise. ``LocalEngine``'s levers,
engine configs, reboot flags, resets and metric rows are held equal to the
reference's; its windows are real seconds, so an observed window is held
to being sane, not to the reference's numbers. Which way the batch
interval moves the latency is a wall-clock ordering: chip_smoke.py's phase
16 checks it on the card, where the reference's test of it is measured.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.data.workloads import PoissonWorkload as RefPoisson  # noqa: E402
from repro.engine import local as rlocal  # noqa: E402
from repro.monitoring import metrics as rmetrics  # noqa: E402
from repro_torch.data.workloads import PoissonWorkload  # noqa: E402
from repro_torch.engine import LOCAL_LEVERS, LocalEngine  # noqa: E402
from repro_torch.engine import MetricsWindowData  # noqa: E402
from repro_torch.monitoring import REGISTRY, TimeSeriesStore  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")


@pytest.fixture(scope="module")
def envs():
    wl = dict(lam=30.0, event_size_mb=0.5)
    ref = rlocal.LocalEngine(RefPoisson(**wl), seed=0)
    port = LocalEngine(PoissonWorkload(**wl), seed=0, device="cpu")
    return ref, port


def _store_ops(cls):
    """The same appends and reads on a store class: past capacity, windows
    that cut the ring at different points, an empty store."""
    names = [m.name for m in REGISTRY][:7]
    rng = np.random.default_rng(0)
    empty = cls(names, 3, capacity=5)
    out = [empty.window(10.0, 1.0), empty.node_average(10.0, 1.0)]
    st = cls(names, 3, capacity=5)
    for i in range(8):
        v = rng.standard_normal((3, len(names)))
        if i == 6:
            v[1, 2] = np.nan
        st.append(0.5 * i, v)
        out.append(st.window(1.2, 0.5 * i))
    out += [st.window(100.0, 3.5), st.window(0.0, 3.5), st.window(1.0, 10.0),
            st.node_average(1.6, 3.5), st.node_average(100.0, 3.5),
            st.node_average(0.1, 99.0)]
    return out


def test_time_series_store_is_bitwise_the_reference():
    got, want = _store_ops(TimeSeriesStore), _store_ops(rmetrics.TimeSeriesStore)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, dict):
            assert list(g) == list(w)
            for k in w:
                assert np.array_equal(g[k], w[k], equal_nan=True), k
        else:
            assert g.shape == w.shape and np.array_equal(g, w, equal_nan=True)


def test_local_levers_are_the_reference():
    assert [dataclasses.asdict(s) for s in LOCAL_LEVERS] == \
        [dataclasses.asdict(s) for s in rlocal.LOCAL_LEVERS]


def test_config_apply_and_reset_follow_the_reference(envs):
    ref, port = envs
    assert port.current_config() == ref.current_config()
    assert port.metric_names == ref.metric_names
    assert port.n_nodes == ref.n_nodes == 1
    assert port.stabilisation_time() == ref.stabilisation_time() == 0.0
    assert port.engine.jit_compiles == ref.engine.jit_compiles == 1
    c = port.current_config()
    assert dataclasses.asdict(port._econf(c)) == \
        dataclasses.asdict(ref._econf(c))
    steps = [dict(batch_interval_s=0.1, max_batch_events=16),
             dict(attn_chunk=32), dict(attn_chunk=32),
             dict(compute_dtype="bfloat16", warmup_batches=0),
             dict(sink_partitions=3)]
    for change in steps:
        c = {**port.current_config(), **change}
        rp, rr = port.apply_config(c), ref.apply_config(c)
        assert rp["rebooted"] is rr["rebooted"], change
        assert rp["load_s"] >= 0.0
        assert port.current_config() == ref.current_config()
        assert dataclasses.asdict(port.engine.econf) == \
            dataclasses.asdict(ref.engine.econf)
        assert dataclasses.asdict(port.engine.model_cfg) == \
            dataclasses.asdict(ref.engine.model_cfg)
        assert port.engine.jit_compiles == ref.engine.jit_compiles, change
    assert port.engine.params["embed"].dtype == torch.bfloat16
    port.reset()
    ref.reset()
    assert port.current_config() == ref.current_config()
    assert port.current_config()["batch_interval_s"] == 0.5
    assert port.engine.jit_compiles == ref.engine.jit_compiles == 1
    assert port.store._count == ref.store._count == 0


def test_emit_writes_the_reference_rows(envs):
    ref, port = envs
    rng = np.random.default_rng(3)
    lat = 100.0 + 50.0 * rng.random(37)
    pads, services = list(rng.random(4)), list(0.01 * rng.random(4))
    for env in envs:
        env.reset()
        env._clock = lambda: 12.5
        env.engine.jit_time_s = 0.25
    try:
        for args in ((lat, pads, services, 4, 0.5), (lat[:1], [], [], 0, 0.5)):
            ref._emit(*args)
            port._emit(*args)
        assert np.array_equal(port.store.window(100.0, 12.5),
                              ref.store.window(100.0, 12.5))
    finally:
        for env in envs:
            del env._clock


def test_observe_returns_a_sane_window(envs):
    _, port = envs
    port.reset()
    c = {**port.current_config(), "batch_interval_s": 0.05}
    port.apply_config(c)
    w = port.observe(0.4)
    assert isinstance(w, MetricsWindowData)
    assert w.latencies_ms.size > 0 and np.isfinite(w.latencies_ms).all()
    assert 0.0 < w.p99_ms < 60_000 and w.clock_s > 0.0
    assert set(w.per_node) == set(port.metric_names)
    assert w.per_node["jit_compiles"][0] >= 1
    assert w.per_node["latency_p99_ms"][0] == pytest.approx(w.p99_ms)
    assert port.engine.sink.rows and port.store._count == 1


def test_local_engine_needs_a_device_off_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LocalEngine(PoissonWorkload(lam=30.0, event_size_mb=0.5))


def _tune(tmp, *extra):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.tune", "--env", "local",
         "--device", "cpu", "--out", str(tmp), *extra],
        capture_output=True, text=True, timeout=300, cwd=tmp.parent,
        env={**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"})


def test_tune_launcher_runs_the_local_engine(tmp_path):
    r = _tune(tmp_path / "out", "--collect", "8", "--updates", "1",
              "--steps-per-episode", "1", "--episodes", "1", "--window",
              "0.2")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "serial TuningEnv" in r.stdout and "[done] wrote" in r.stdout
    hist = json.loads((tmp_path / "out" / "history.json").read_text())
    assert len(hist["history"]) == 1 and hist["default_p99_ms"] > 0
    analysis = json.loads((tmp_path / "out" / "analysis.json").read_text())
    assert analysis["ranked_levers"]


def test_tune_launcher_device_loop_on_exits_with_the_serial_reason(tmp_path):
    r = _tune(tmp_path / "out", "--device-loop", "on", "--collect", "8")
    assert r.returncode != 0
    assert "serial TuningEnv" in r.stderr and "[collect]" not in r.stdout


#: the kernel's order (the mirror) against the plain version, max
#: |difference| over max(1, max |plain|), as tests/test_torch_lasso.py
LASSO_TOL = 1e-4


def test_lasso_path_at_the_local_shape_follows_the_plain_version(envs):
    """``analyse`` on the local engine hands the Lasso path 16 rows of 24
    features (the 12 levers and their squares): more features than rows.
    Its inputs, taken at the ``lasso_cd`` wrapper (the plain version on the
    CPU), go through the kernel's own order, which the kernel is bitwise
    equal to: within LASSO_TOL of what the path got, entry order equal."""
    from unittest import mock

    from repro_torch.core import AutoTuner
    from repro_torch.core import lasso as lasso_mod
    from repro_torch.kernels import lasso_cd as lc

    port = envs[1]
    port.reset()
    tuner = AutoTuner(port, seed=0, window_s=0.1, top_levers=5)
    tuner.collect(16, windows_per_cluster=8)
    launch, path = lasso_mod.lasso_cd, []

    def spy(xtx, xty, w0, lams, n, *, epochs):
        out = launch(xtx, xty, w0, lams, n, epochs=epochs)
        path.append(((xtx, xty, w0, lams, n, epochs), out))
        return out

    with mock.patch.object(lasso_mod, "lasso_cd", spy):
        tuner.analyse()
    port.reset()
    assert len(path) == 1
    (A, b, w0, lams, n, epochs), plain = path[0]
    assert (n, A.shape[0], epochs) == (16.0, 2 * len(LOCAL_LEVERS), 60)
    got, counts = lc.lasso_cd_mirror(A, b, w0, lams, n, epochs=epochs)
    g, w = got.numpy(), plain.numpy()
    assert np.count_nonzero(w[-1]) > 1 and counts["terms"] > 0
    assert np.abs(g - w).max() / max(1.0, np.abs(w).max()) <= LASSO_TOL
    lam = lams.numpy()
    assert lasso_mod.entry_order(g, lam)[0] == lasso_mod.entry_order(w, lam)[0]
