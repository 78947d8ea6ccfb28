"""The dry-run on an LM mesh (``launch.dryrun``, ``cell_costs(mesh=)``), on
the ``fake`` process group and the meta device, as
``tests/test_dryrun_small.py`` runs the reference's on 8 forced host
devices: its four cells on a (2, 4) ("data", "model") mesh, in one child
process (``run_mesh_cells``), so the pytest process keeps no group.

* all four cells run, the train cell moves collective bytes (its FSDP
  gathers and gradient reduce-scatters), every cell has a dominant term;
* the decode at batch 1 runs split-K (zamba2) and the one at batch 8 does
  not (rwkv6), as the reference's ``make_decode_step`` decides;
* the costs are per device: a column-split matmul on a (1, 4) mesh counts a
  quarter of its unsplit FLOPs, and its output block's bytes;
* ``--mesh local`` keeps the one-device records exactly (pinned from the
  parent commit's run: smollm-135m's three cells).
"""
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

CELLS = (
    ("smollm_135m", InputShape("t", 128, 8, "train")),
    ("qwen2_moe_a2p7b", InputShape("p", 128, 4, "prefill")),
    ("zamba2_2p7b", InputShape("d", 256, 1, "decode")),   # batch 1: split-K
    ("rwkv6_7b", InputShape("d", 256, 8, "decode")),
)
#: smollm-135m's one-device records as the parent commit wrote them
#: (``run_cell(..., save=False)`` without ``compile_s``)
PARENT = {
    "decode_32k": dict(flops=324337139712.0, hbm_bytes=511296104216.0,
                       bytes_per_device={"argument": 96905794692,
                                         "output": 516, "temp": 3524378116,
                                         "peak": 100430173324}),
    "train_4k": dict(flops=2033546755571712.0, hbm_bytes=305783169720028.0,
                     bytes_per_device={"argument": 819672964,
                                       "output": 807090056,
                                       "temp": 1398425309568,
                                       "peak": 1400052072588}),
}


def _cell(arch, shape, *, mesh):
    """A reduced config's costs on ``mesh``, with its step's split-K flag."""
    from repro_torch.distribution.steps import make_step_for_cell

    cfg = configs.get(arch, reduced=True)
    rec = dryrun.cell_costs(cfg, shape, mesh=mesh)
    rec["split_k"] = make_step_for_cell(cfg, shape, mesh=mesh,
                                        device="meta").meta.get("split_k")
    return rec


def _column_matmul(*, mesh):
    """(FLOPs, bytes) of x (8, 16) @ w (16, 32) with w split by columns on
    the model axis, and of the same product unsplit, as the cost mode
    counts them."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    x = torch.empty(8, 16, device="meta")
    w = torch.empty(16, 32, device="meta")
    one = dryrun._CostMode()
    with one:
        x @ w
    dx = distribute_tensor(x, mesh, [Replicate(), Replicate()],
                           src_data_rank=None)
    dw = distribute_tensor(w, mesh, [Replicate(), Shard(1)],
                           src_data_rank=None)
    split = dryrun._CostMode(dryrun._groups(mesh))
    with split:
        out = dx @ dw
    return (split.flops, split.hbm_bytes, one.flops, one.hbm_bytes,
            tuple(out.to_local().shape), sum(split.coll["counts"].values()))


@pytest.fixture(scope="module")
def recs():
    jobs = [(_cell, (arch, shape), {}) for arch, shape in CELLS]
    out = dryrun.run_mesh_cells((2, 4), ("data", "model"), jobs,
                                timeout_s=600)
    for (arch, _), rec in zip(CELLS, out):
        assert not isinstance(rec, str), f"{arch}:\n{rec}"
    return dict(zip((a for a, _ in CELLS), out))


def test_all_four_cells_run_on_a_2x4_mesh(recs):
    for arch, rec in recs.items():
        assert rec["status"] == "ok" and rec["chips"] == 8, arch
        assert rec["flops"] > 0 and rec["hbm_bytes"] > 0, arch
        mem = rec["bytes_per_device"]
        assert mem["peak"] == mem["argument"] + mem["output"] + mem["temp"]
        assert mem["argument"] > 0, arch


def test_train_cell_moves_collective_bytes(recs):
    coll = recs["smollm_135m"]["collectives"]
    assert recs["smollm_135m"]["collective_bytes"] > 0
    assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0
    assert coll["counts"]["all-gather"] > 0
    assert set(coll["by_axis"]) <= {"data", "model"}
    assert sum(coll["by_axis"].values()) == pytest.approx(
        recs["smollm_135m"]["collective_bytes"])


def test_decode_splits_k_only_when_the_batch_cannot_split(recs):
    assert recs["zamba2_2p7b"]["split_k"] is True
    assert recs["rwkv6_7b"]["split_k"] is False
    # the split-K decode gathers its softmax partials over the data axis
    assert recs["zamba2_2p7b"]["collectives"]["by_axis"].get("data", 0) > 0


def test_each_cell_has_a_dominant_term(recs):
    for arch, rec in recs.items():
        terms = {k: rec[f"t_{k}_s"] for k in ("compute", "memory",
                                              "collective")}
        assert rec["dominant"] == max(terms, key=terms.get), arch
        assert rec["mfu_bound"] > 0 and rec["useful_ratio"] > 0, arch


def test_costs_count_each_rank_s_block():
    (res,) = dryrun.run_mesh_cells((1, 4), ("data", "model"),
                                   [(_column_matmul, (), {})], timeout_s=300)
    assert not isinstance(res, str), res
    flops, nbytes, flops1, nbytes1, local, n_coll = res
    assert flops == flops1 / 4 == 2 * 8 * 16 * 8
    assert local == (8, 8) and n_coll == 0
    # x whole, a quarter of w read, a quarter of the output written
    assert nbytes == 4 * (8 * 16 + 16 * 8 + 8 * 8)
    assert nbytes1 == 4 * (8 * 16 + 16 * 32 + 8 * 32)


def test_the_one_device_sweep_keeps_its_records(tmp_path):
    for shape, want in PARENT.items():
        rec = dryrun.run_cell("smollm_135m", shape, tmp_path, save=False)
        assert rec["mesh"] == "1x1" and rec["chips"] == 1
        for key, value in want.items():
            assert rec[key] == value, (shape, key, rec[key], value)
        assert rec["collectives"] == {
            **{k: 0 for k in dryrun._COLLECTIVES},
            "counts": {k: 0 for k in dryrun._COLLECTIVES}}
    assert not list(Path(tmp_path).iterdir())


def test_axis_rates_charge_nvlink_only_within_a_node():
    rates = dryrun.axis_rates({"data": 16, "model": 16})
    assert rates == {"data": dryrun.IB_BW, "model": dryrun.IB_BW}
    rates = dryrun.axis_rates({"data": 2, "model": 4})
    assert rates["model"] == dryrun.NVLINK_BW * dryrun.NVLINK_LINKS
    assert rates["data"] == dryrun.IB_BW
    t = dryrun.roofline_terms(0.0, 0.0, {
        **{k: 0 for k in dryrun._COLLECTIVES}, "all-gather": 150e9,
        "by_axis": {"data": 50e9, "model": 100e9}}, 8, rates)
    assert t["t_collective_s"] == pytest.approx(1.0 + 100e9 / 450e9)
    assert t["dominant"] == "collective"
