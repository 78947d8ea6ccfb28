"""The benchmark's files on the CPU: every cell's data found by name, a cell
added as new files only, the contract's shape of ``BENCHMARK.json``, the
frozen copies against the program they were copied from, the no-JAX rule
and the run's refusal without a card.

    python -m pytest -q tunebench/tests
"""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from tunebench import run as R  # noqa: E402
from tunebench.harness.bench import Cell, load_json  # noqa: E402
from tunebench.harness.trace import Trace  # noqa: E402

BENCH = load_json(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _fake_trace(**shapes) -> Trace:
    """Two updates: three kernels, one of them the window kernel, a graph
    launch and a kernel launch on the host, in a 1 ms traced window (the same
    chunks took 0.8 ms untraced, which no reader uses)."""
    dev = [("fleet_tick_warp_kernel<32, 1, 2>", 0, 100_000),
           ("elementwise", 200_000, 300_000),
           ("index", 400_000, 100_000)]
    host = [("cudaGraphLaunch", 0, 10_000), ("cudaLaunchKernel", 0, 5_000)]
    return Trace(device=dev, host=host, start_ns=0, end_ns=1_000_000,
                 updates=2, chunks=1,
                 shapes=shapes or dict(T=48, S=32, K=32, N=1024,
                                       fmult=False, steps=5),
                 untraced_s=8e-4)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    c = Cell(cell, ROOT)
    assert c.config["name"] == c.spec["config"]
    assert set(c.limits) == {"loss_gap", "grad1_gap", "change_gap"}
    assert {m["name"] for m in c.end_to_end()} >= {"setup_s"}
    assert len(c.end_to_end()) >= 2 and c.per_layer()
    for m in c.per_layer():
        value = c.reader(m["name"])(_fake_trace())
        assert value is None or np.isfinite(value)


def test_readers_on_a_known_trace():
    c = Cell(CELLS[0], ROOT)
    tr = _fake_trace()
    # 0.4 ms busy in the 1 ms traced window
    assert c.reader("device_idle_pct")(tr) == pytest.approx(60.0)
    assert c.reader("device_launches_per_update")(tr) == 1.5
    assert c.reader("body_device_ms_per_update")(tr) == pytest.approx(0.2)
    assert c.reader("host_launch_calls_per_update")(tr) == 1.0
    # 16.707584 MB (eight grids) at 3.35 TB/s over 0.1 ms
    assert c.reader("fleet_tick_roofline_pct")(tr) == pytest.approx(
        100 * 16.707584e6 / 3.35e12 / 1e-4)
    assert c.reader("update_roofline_pct")(tr) == pytest.approx(
        100 * 5 * 16.707584e6 / 3.35e12 / 5e-4)
    empty = Trace(device=[], host=[], start_ns=0, end_ns=1, updates=1,
                  chunks=1, shapes=tr.shapes, untraced_s=1.0)
    assert c.reader("fleet_tick_roofline_pct")(empty) is None
    assert c.reader("device_idle_pct")(empty) is None


def test_new_cell_is_new_files_only(tmp_path):
    """A configuration, a traffic mix, limits and a per-layer metric added
    as files (and entries) to a copy are found with no other edit."""
    shutil.copytree(ROOT / "tunebench", tmp_path / "tunebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    here = tmp_path / "tunebench"
    cfg = load_json(here / "configs" / "paper_fleet1024.json")
    cfg["name"], cfg["clusters"] = "tiny_fleet", 8
    (here / "configs" / "tiny_fleet.json").write_text(json.dumps(cfg))
    traffic = load_json(here / "traffic" / "epoch.json")
    traffic["updates_per_chunk"] = 2
    (here / "traffic" / "epoch_k2.json").write_text(json.dumps(traffic))
    (here / "limits" / "tiny_fleet.epoch_k2.json").write_text(
        json.dumps({"loss_gap": 1.0, "grad1_gap": 1.0, "change_gap": 1.0}))
    (here / "metrics" / "chunks_traced.py").write_text(
        "def read(trace):\n    return float(trace.chunks)\n")
    bench["configs"].append({"name": "tiny_fleet", "source": "x",
                             "file": "tunebench/configs/tiny_fleet.json",
                             "reduced": ["clusters"], "why": "x"})
    bench["workloads"].append({"name": "tiny_fleet.epoch_k2",
                               "config": "tiny_fleet",
                               "traffic": "epoch_k2", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "chunks_traced", "unit": "chunks",
                               "better": "higher", "source": "device_trace",
                               "layer": "outer iteration", "moves":
                               "windows_per_s",
                               "workloads": ["tiny_fleet.epoch_k2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = Cell("tiny_fleet.epoch_k2", tmp_path)
    assert c.config["clusters"] == 8
    assert c.traffic["updates_per_chunk"] == 2
    assert [m["name"] for m in c.per_layer()] == ["chunks_traced"]
    assert c.reader("chunks_traced")(_fake_trace()) == 1.0
    # the shipped cells are untouched by the addition
    assert "chunks_traced" not in [m["name"]
                                   for m in Cell(CELLS[0], tmp_path).per_layer()]


def test_benchmark_json_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["tunebench"]
    assert BENCH["command"] == ["python3", "tunebench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("tunebench/")
        assert (ROOT / c["file"]).exists()
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        names.add(c["name"])
    assert len({c["source"] for c in BENCH["configs"]}) == len(names)
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert (ROOT / "tunebench" / "metrics" / f"{m['name']}.py").exists()
        layers.setdefault(m["layer"], m["layer"])
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"| {layer} |" in perf, layer


def test_frozen_costs_give_perf_figures():
    from tunebench.costs.fleet_scan import scan_cost
    from tunebench.costs.fleet_tick import episode_ticks, head, lanes
    from tunebench.costs.fleet_tick import window_cost

    assert window_cost(48, 32, 32, 1024)[0] == 16_904_192
    assert scan_cost(48, 1024)[0] == 3_010_560
    T = episode_ticks(240.0, 10.0)
    assert (T, lanes(T), head(lanes(T), T)) == (48, 32, 32)
    T = episode_ticks(240.0, 0.5)
    assert (T, lanes(T), head(lanes(T), T)) == (1024, 8, 120)


@pytest.mark.parametrize("cell", CELLS)
def test_cells_launch_the_tick_budget(cell):
    """Both configurations tune ``batch_interval_s``, so every window runs
    the fused loop's clamped budget of 192 ticks, 8 lanes and a 24-deep
    head, with the fault multiplier where the fleet has faults."""
    from tunebench.harness.inputs import make_inputs

    c = Cell(cell, ROOT)
    c.config["clusters"] = 8
    shapes = R.launch_shapes(c.config, c.traffic,
                             make_inputs(c.config, c.traffic, 1, "cpu"))
    assert (shapes["T"], shapes["S"], shapes["K"]) == (192, 8, 24)
    assert shapes["fmult"] == (c.config["faults"] is not None)


@pytest.mark.parametrize("T", [8, 48, 192, 768, 1024, 3328])
def test_frozen_costs_equal_the_program_today(T):
    from repro_torch.engine.fleet_torch import lane_budget, p99_depth
    from repro_torch.kernels import fleet_scan, fleet_tick

    from tunebench.costs import fleet_scan as fs
    from tunebench.costs import fleet_tick as ft

    S = lane_budget(T)
    K = fleet_tick.head_budget(S, p99_depth(T, S))
    assert (ft.lanes(T), ft.head(ft.lanes(T), T)) == (S, K)
    for fm in (False, True):
        assert ft.window_cost(T, S, K, 1024, fm) == fleet_tick.window_cost(
            T, S, K, 1024, fm)
        assert fs.scan_cost(T, 1024, fm) == fleet_scan.scan_cost(T, 1024, fm)


def test_frozen_data_equal_the_program_today():
    from repro_torch.engine.levers import LEVER_SPECS
    from repro_torch.engine.simcluster import _emission_constants
    from repro_torch.monitoring.metrics import REGISTRY

    from tunebench.reference.tuner_ref import load_emission, load_levers

    levers = load_levers()
    assert [lv["name"] for lv in levers] == [s.name for s in LEVER_SPECS]
    for lv, s in zip(levers, LEVER_SPECS):
        assert (lv["kind"], lv["lo"], lv["hi"], tuple(lv["choices"]),
                lv["default"], lv["reboot"], lv["group"]) == (
            s.kind, s.lo, s.hi, tuple(s.choices), s.default, s.reboot,
            s.group)
    emc, mine = _emission_constants(), load_emission()
    assert mine["metrics"] == [m.name for m in REGISTRY]
    for a, b in (("W", "W"), ("scale", "scale"), ("noise", "noise_v"),
                 ("bias", "bias"), ("is_driver", "is_driver")):
        np.testing.assert_array_equal(np.asarray(mine[a]), emc[b])


def test_no_jax_check_compares_whole_top_level_names(monkeypatch):
    for name in ("repro_torch", "repro_torch.core", "jaxtyping", "reprox"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert R.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert R.forbidden_modules() == ["jax", "repro"]


def test_run_without_a_card_exits_nonzero_and_prints_nothing():
    proc = subprocess.run(
        [sys.executable, "tunebench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    if proc.returncode == 0:
        pytest.skip("a CUDA card is present")
    assert proc.stdout == ""
    assert "CUDA" in proc.stderr
