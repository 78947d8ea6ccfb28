"""What decides ``correct``, on the CPU at a size a test run holds: the plain
reference against the program for both configurations, a whole run's
result line, the control and the planted faults coming out not correct,
and (on a card) the control at a cell's own size.

    python -m pytest -q tunebench/tests
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from tunebench import run as R  # noqa: E402
from tunebench.harness import correct as C  # noqa: E402
from tunebench.harness.bench import Cell  # noqa: E402
from tunebench.harness.faults import PLANTS  # noqa: E402
from tunebench.harness.inputs import make_inputs  # noqa: E402
from tunebench.harness.system import build  # noqa: E402

CELLS = ["paper_fleet1024.epoch", "chaos_fleet1024.epoch_shielded"]
#: clusters of the CPU runs (at most 256: each node draws its own noise)
SMALL = {"paper_fleet1024.epoch": 16, "chaos_fleet1024.epoch_shielded": 16}


def _small(cell_name: str) -> Cell:
    cell = Cell(cell_name, ROOT)
    cell.config["clusters"] = SMALL[cell_name]
    cell.traffic["warm_chunks"] = 2     # the two that capture
    return cell


def _first_updates(cell, seed, device="cpu"):
    inputs = make_inputs(cell.config, cell.traffic, seed, device)
    cfgr = build(cell.config, cell.traffic, inputs, device)
    prog = C.to_host(C.program_first_updates(cfgr, cell.traffic))
    return inputs, prog


@pytest.mark.parametrize("cell_name", CELLS)
def test_reference_equals_the_program_on_the_cpu(cell_name):
    """On the CPU the program's kernels are their plain versions and its
    programs run eagerly: the reference takes the same steps bit for bit."""
    cell = _small(cell_name)
    inputs, prog = _first_updates(cell, 2 ** 31 + 17)
    ref = C.reference_first_updates(cell.config, cell.traffic, inputs, "cpu")
    assert prog["losses"] == ref["losses"]
    for k in ref["params"]:
        assert torch.equal(prog["params"][k], ref["params"][k]), k
        assert torch.equal(prog["nu1"][k], ref["nu1"][k]), k
    nums = C.compare(prog, ref, cell.config)
    assert nums["loss_gap"] == 0.0 and nums["change_gap"] == 0.0
    assert nums["grad1_gap"] < 1e-7


def test_whole_run_prints_one_contract_line():
    cell = _small(CELLS[0])
    res = R.run_cell(cell, 3, 0.5, False, "cpu", log=lambda s: None)
    line = json.dumps(res)
    assert "\n" not in line
    back = json.loads(line)
    assert list(back)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(back)
    assert back["correct"] is True and back["attempted"] >= 1
    assert set(back["metrics"]) == {"windows_per_s", "chunk_p95_ms",
                                    "setup_s"}
    for c in back["checks"].values():
        assert c["value"] <= c["limit"]


def test_traced_run_reads_its_metrics():
    """The ``--trace 1`` path on the CPU: untraced and traced chunks, the
    readers, the breakdown (no device rows here: the device metrics read
    nothing)."""
    cell = _small(CELLS[0])
    res = R.run_cell(cell, 3, 0.5, True, "cpu", log=lambda s: None)
    names = {m["name"] for m in cell.per_layer()}
    assert set(res["metrics"]) <= names
    assert "host_launch_calls_per_update" in res["metrics"]
    assert "device_idle_pct" not in res["metrics"]
    assert res["device"]["window_s"] > 0 and res["correct"] is True
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell_name", CELLS)
def test_control_is_not_correct(cell_name):
    """The reference with its policy network in bfloat16, in the program's
    place, fails the cell's limits."""
    cell = _small(cell_name)
    inputs = make_inputs(cell.config, cell.traffic, 5, "cpu")
    ref = C.reference_first_updates(cell.config, cell.traffic, inputs, "cpu")
    ctl = C.reference_first_updates(cell.config, cell.traffic, inputs, "cpu",
                                    policy_dtype=torch.bfloat16)
    nums = C.compare(ctl, ref, cell.config)
    assert any(nums[k] > cell.limits[k] for k in nums), nums


@pytest.mark.parametrize("plant", sorted(PLANTS))
@pytest.mark.parametrize("cell_name", CELLS)
def test_planted_fault_is_not_correct(cell_name, plant):
    """A whole run with the timed path broken underneath reads false."""
    cell = _small(cell_name)
    res = R.run_cell(cell, 7, 0.2, False, "cpu", log=lambda s: None,
                     plant=plant)
    assert res["correct"] is False, res["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell_name", CELLS)
def test_control_fails_at_the_cells_size_on_the_card(cell_name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = Cell(cell_name, ROOT)
    for seed in (11, 12, 13):
        inputs = make_inputs(cell.config, cell.traffic, seed, "cuda")
        ref = C.reference_first_updates(cell.config, cell.traffic, inputs,
                                        "cuda")
        ctl = C.reference_first_updates(cell.config, cell.traffic, inputs,
                                        "cuda", policy_dtype=torch.bfloat16)
        nums = C.compare(ctl, ref, cell.config)
        assert any(nums[k] > cell.limits[k] for k in nums), nums
