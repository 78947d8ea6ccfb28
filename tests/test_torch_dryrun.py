"""``repro_torch.launch.dryrun``, ``launch.mesh`` and
``distribution.steps.make_step_for_cell`` against ``repro.launch.dryrun`` on
the CPU.

The plain-Python pieces (the HLO parser, ``model_flops``, ``roofline_terms``
at equal peaks, ``_depth_probe_points``) must equal the reference's exactly.
The port's own counting runs on the ``meta`` device: its FLOPs are held to
``FlopCounterMode``'s on every reduced architecture, its bytes and live
memory to hand counts of small programs, and the depth extrapolation to
the full-depth count at reduced configs, all exact.

Importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to force 512 host
devices. JAX is initialised first (so the flag cannot take effect) and the
variable is restored, so later test files in the same worker still see one
device.
"""
import ast
import dataclasses
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.distribution import (make_decode_step,  # noqa: E402
                                      make_prefill_step, make_step_for_cell)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import (make_local_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models import lm  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402


def _import_reference_dryrun():
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return ref


ref = _import_reference_dryrun()
REPO = Path(__file__).resolve().parent.parent

HLO = """
  %ag = bf16[8,256]{1,0} all-gather(%x), replica_groups={{0,1}}, dimensions={0}
  ROOT %ar = f32[128]{0} all-reduce(%y), to_apply=%sum
  %rs = (f32[64]{0}, f32[64]{0}) reduce-scatter(%a, %b), dimensions={0}
  %noise = f32[2]{0} add(%p, %q)
  ROOT %a2a = (bf16[4,4]{1,0}, s8[16]{0}, pred[3]{0}) all-to-all(%u, %v, %w)
  %cp.1 = u32[7,3]{1,0} collective-permute(%z), source_target_pairs={{0,1}}
  %ag2 = f32[] all-gather(%s)
"""


def test_collective_parser_matches_reference():
    assert dryrun.collective_bytes_from_hlo(HLO) == \
        ref.collective_bytes_from_hlo(HLO)
    out = dryrun.collective_bytes_from_hlo(HLO)
    # the tuple is split at every comma, so a multi-dimensional member
    # (bf16[4,4]) counts 0, in the reference as in the copy
    assert out["all-to-all"] == 16 + 3
    assert out["counts"]["all-gather"] == 2
    for s in ("bf16[8,128,256]{2,1,0}", "f32[]", "c128[3]", "weird[2,2]",
              "not a shape", "u8[0]"):
        assert dryrun._shape_bytes(s) == ref._shape_bytes(s), s
    assert dryrun._DTYPE_BYTES == ref._DTYPE_BYTES
    assert dryrun._COLLECTIVES == ref._COLLECTIVES


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_model_flops_match_reference(arch):
    for name, shape in configs.SHAPES.items():
        assert dryrun.model_flops(configs.get(arch), shape) == \
            ref.model_flops(ref_configs.get(arch), ref_configs.SHAPES[name])


def test_depth_probe_points_match_reference():
    for arch in configs.ARCH_IDS:
        for reduced in (False, True):
            assert dryrun._depth_probe_points(configs.get(arch, reduced)) == \
                ref._depth_probe_points(ref_configs.get(arch, reduced))


def test_roofline_terms_match_reference_at_equal_peaks(monkeypatch):
    for mod in (dryrun, ref):
        monkeypatch.setattr(mod, "PEAK_FLOPS", 100e12)
        monkeypatch.setattr(mod, "HBM_BW", 2e12)
    monkeypatch.setattr(ref, "ICI_BW", 30e9)
    monkeypatch.setattr(ref, "ICI_LINKS", 6)
    monkeypatch.setattr(dryrun, "NVLINK_BW", 30e9)
    monkeypatch.setattr(dryrun, "NVLINK_LINKS", 6)
    coll = ref.collective_bytes_from_hlo(HLO)
    for flops, hbm in ((1e15, 1e9), (1e9, 1e13), (1e6, 1e3), (0.0, 0.0)):
        for c in (coll, {k: 0 for k in ref._COLLECTIVES}):
            assert dryrun.roofline_terms(flops, hbm, c, 1) == \
                ref.roofline_terms(flops, hbm, c, 256)


def test_h100_peaks():
    assert (dryrun.PEAK_FLOPS, dryrun.HBM_BW) == (989e12, 3.35e12)
    assert dryrun.NVLINK_BW * dryrun.NVLINK_LINKS == 450e9


# ---------------------------------------------------------------------------
# counting on the meta device
# ---------------------------------------------------------------------------

def _count(fn, *args):
    mode = dryrun._CostMode()
    mode.track(args)
    with mode:
        out = fn(*args)
    return mode, out


def test_bytes_follow_what_each_op_touches():
    meta = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt,  # noqa: E731
                                                   device="meta")
    x, y = meta(64, 32), meta(64, 32)
    mode, _ = _count(lambda a, b: (a.t(), a.view(32, 64), a[:4], a + b), x, y)
    assert mode.hbm_bytes == 3 * 64 * 32 * 4          # the add alone
    cache, src = meta(2, 128, 4, 8), meta(2, 1, 4, 8)
    at = torch.empty(1, dtype=torch.int64, device="meta")
    mode, _ = _count(lambda c, s, i: c.index_copy_(1, i, s), cache, src, at)
    assert mode.hbm_bytes == 8 + 2 * src.numel() * 4  # index, src, its rows
    mode, _ = _count(lambda c, s: c[:, :1].copy_(s), cache, src)
    assert mode.hbm_bytes == 2 * src.numel() * 4
    b = meta(1, 32)
    mode, _ = _count(lambda a, v: a * v.expand(64, 32), x, b)
    assert mode.hbm_bytes == (2 * 64 * 32 + 32) * 4   # a broadcast row once
    mode, _ = _count(lambda: torch.empty(10, device="meta").fill_(1.0))
    assert mode.hbm_bytes == 40


def test_live_bytes_keep_what_autograd_saves():
    x = torch.empty(1000, 1000, device="meta", requires_grad=True)
    mode = dryrun._CostMode()
    assert mode.track(x) == 4_000_000
    with mode:
        y = (x * 2).sin()              # sin saves x * 2 for its backward
        assert mode.live == 12_000_000
        g, = torch.autograd.grad(y.sum(), x)
    del y
    assert mode.live == 8_000_000      # x and its gradient
    # at the peak, five 4 MB tensors (x, x * 2, y, cos(x * 2) and its product
    # with the incoming gradient) and two f32 scalars (the sum, its seed)
    assert mode.peak == 20_000_008
    assert mode.track([x, x.t(), g[0]]) == 0


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_meta_flops_equal_flop_counter_mode(arch):
    base = configs.get(arch, reduced=True)
    for remat, shape in (("none", InputShape("t", 64, 2, "train")),
                         ("block", InputShape("t", 64, 2, "train")),
                         ("none", InputShape("p", 64, 2, "prefill")),
                         ("none", InputShape("d", 128, 2, "decode"))):
        cfg = dataclasses.replace(base, remat=remat)
        bundle = dryrun._bundle(cfg, shape)
        flops, hbm, coll, mem = dryrun._cost_triple(bundle)
        with FlopCounterMode(display=False) as fc:
            bundle.fn(*bundle.arg_specs)
        assert flops == fc.get_total_flops() > 0, (arch, shape.kind, remat)
        assert hbm > 0 and coll["counts"] == {k: 0 for k in dryrun._COLLECTIVES}
        assert mem["argument"] == sum(
            t.numel() * t.element_size() for t in tree_leaves(bundle.arg_specs)
            if t is not None)
        assert mem["peak"] == mem["argument"] + mem["output"] + mem["temp"]
        assert mem["temp"] >= 0


# (family, arch, config overrides): at least three units of depth, so the
# extrapolation is not the second probe itself; whisper's encoder as deep as
# its decoder, as the probes assume (whisper-large-v3 is 32 / 32)
EXTRAPOLATED = {
    "dense": ("qwen2_7b", {}, True),
    "hybrid": ("zamba2_2p7b", dict(num_layers=6, hybrid_period=2), False),
    "moe": ("qwen2_moe_a2p7b", {}, False),
    "audio": ("whisper_large_v3", dict(encoder_layers=4), False),
}


@pytest.mark.parametrize("family", EXTRAPOLATED)
def test_depth_extrapolation_equals_the_full_depth_count(family):
    """FLOPs, bytes and argument bytes exact for every family; the peak
    exact where every unit adds the same live bytes at the peak (dense),
    and the sum of its parts everywhere."""
    arch, over, peak_exact = EXTRAPOLATED[family]
    cfg = dataclasses.replace(configs.get(arch, reduced=True), **over)
    assert dryrun._depth_probe_points(cfg)[2] >= 3
    for shape in (InputShape("t", 64, 2, "train"),
                  InputShape("p", 64, 2, "prefill"),
                  InputShape("d", 128, 2, "decode")):
        ext = dryrun.layer_delta_costs(cfg, shape)
        flops, hbm, _, mem = dryrun._cost_triple(dryrun._bundle(cfg, shape))
        assert (ext["flops"], ext["hbm_bytes"]) == (flops, hbm), shape.kind
        got = ext["memory"]
        assert got["argument"] == mem["argument"]
        assert got["peak"] == got["argument"] + got["output"] + got["temp"]
        if peak_exact:
            assert got == mem, shape.kind
        assert ext["probe"]["n_units"] == dryrun._depth_probe_points(cfg)[2]


def test_train_flops_are_three_forwards_and_block_remat_recomputes_bmm():
    """The train step's FLOPs are 3x the forward's (forward, and twice that
    backward) under remat "none"; "block" keeps the weight matmuls' outputs
    (mm, addmm) and recomputes the rest, so its batched products (attention)
    run 4x and the weight products 3x, to the FLOP."""
    shape = InputShape("t", 64, 2, "train")
    base = configs.get("smollm_135m", reduced=True)
    fwd, _ = _count(lambda p, b: lm.forward_train(p, base, b),
                    *dryrun._bundle(base, shape).arg_specs[::2])
    assert set(fwd.flops_by_op) == {"aten.mm", "aten.bmm"}
    for remat, mult in (("none", {"aten.mm": 3, "aten.bmm": 3}),
                        ("block", {"aten.mm": 3, "aten.bmm": 4})):
        cfg = dataclasses.replace(base, remat=remat)
        bundle = dryrun._bundle(cfg, shape)
        step, _ = _count(bundle.fn, *bundle.arg_specs)
        assert dict(step.flops_by_op) == {
            op: mult[op] * n for op, n in fwd.flops_by_op.items()}, remat
    cfg = dataclasses.replace(base, remat="none")
    assert dryrun._cost_triple(dryrun._bundle(cfg, shape))[0] == \
        3 * fwd.flops


# ---------------------------------------------------------------------------
# the cell record, meshes and the launcher
# ---------------------------------------------------------------------------

def _reference_record_keys():
    """The keys of the reference's ok record, in order, read from its
    source: ``rec = dict(...)``, then ``rec.update(...)`` with
    ``roofline_terms``' keys for ``**terms``."""
    keys, nested = [], {}
    for node in ast.walk(ast.parse(inspect.getsource(ref.run_cell))):
        call = None
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and [getattr(t, "id", None) for t in node.targets] == ["rec"]:
            call = node.value
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "update" and getattr(node.func.value, "id", "") == "rec":
            call = node
        for kw in call.keywords if call else ():
            if kw.arg is None:                          # **terms
                keys += list(ref.roofline_terms(1.0, 1.0, {}, 1))
                continue
            keys.append(kw.arg)
            if isinstance(kw.value, ast.Dict):
                nested[kw.arg] = [k.value for k in kw.value.keys]
    return list(dict.fromkeys(keys)), nested


def test_record_has_the_reference_keys_on_one_device(tmp_path):
    keys, nested = _reference_record_keys()
    rec = dryrun.run_cell("smollm_135m", "decode_32k", tmp_path, save=False)
    assert list(rec) == keys
    assert list(rec["bytes_per_device"]) == nested["bytes_per_device"]
    assert (rec["mesh"], rec["chips"], rec["status"]) == ("1x1", 1, "ok")
    assert rec["t_compute_s"] == rec["flops"] / 989e12
    assert rec["t_memory_s"] == rec["hbm_bytes"] / 3.35e12
    assert rec["t_collective_s"] == 0.0 and rec["dominant"] == "memory"
    assert rec["probe"]["n_units"] == 30
    skip = dryrun.run_cell("smollm_135m", "long_500k", tmp_path)
    assert list(skip) == ["arch", "shape", "mesh", "status", "why"]
    assert skip["status"] == "skip" and "long_500k" in skip["why"]
    assert not list(tmp_path.iterdir())


def test_meshes_and_expert_parallelism_raise_naming_item_7(tmp_path):
    """The production meshes are DeviceMeshes over a process group of
    their size (the dry-run joins a ``fake`` group in a child for them);
    described without one they keep the reference's axes and names.
    Expert parallelism needs a mesh."""
    from repro_torch.launch.mesh import PRODUCTION, Mesh, mesh_name

    single = Mesh(*PRODUCTION[False])
    assert single.shape == {"data": 16, "model": 16}
    multi = Mesh(*PRODUCTION[True])
    assert (multi.axis_names, multi.device_count, multi.name) == (
        ("pod", "data", "model"), 512, "2x16x16")
    assert mesh_name(Mesh((1, 1), ("data", "model"))) == "1x1"
    for make in (make_production_mesh, lambda: make_local_mesh(2, 1)):
        with pytest.raises(RuntimeError, match="process group"):
            make()
    with pytest.raises(ValueError, match="--ep"):
        dryrun.run_cell("smollm_135m", "decode_32k", tmp_path, ep=True)
    rec = dryrun.run_cell("smollm_135m", "decode_32k", tmp_path, save=False,
                          fsdp=False)
    assert rec["mesh"] == "1x1"
    assert dryrun.main(["--ep", "--out", str(tmp_path)]) == 2
    assert not list(tmp_path.iterdir())
    assert dryrun.main(["--mesh", "single", "--arch", "smollm_135m",
                        "--shape", "decode_32k", "--out",
                        str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "smollm_135m__decode_32k__16x16.json")
                     .read_text())
    assert (rec["mesh"], rec["chips"], rec["status"]) == ("16x16", 256, "ok")
    assert rec["collective_bytes"] > 0 and rec["dominant"]


def test_main_writes_one_file_a_cell(tmp_path, capsys):
    assert dryrun.main(["--arch", "smollm_135m", "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "dry-run: 3 ok, 1 skip, 0 FAIL" in out
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == [f"smollm_135m__{s}__1x1.json"
                     for s in ("decode_32k", "prefill_32k", "train_4k")]
    rec = json.loads((tmp_path / files[2]).read_text())
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["chips"]) == (
        "smollm_135m", "train_4k", "1x1", 1)
    assert rec["flops"] > rec["model_flops"] > 0


def test_importing_the_dry_run_touches_neither_jax_nor_xla_flags():
    code = (
        "import os, sys\n"
        "sys.path.insert(0, {src!r})\n"
        "before = os.environ.get('XLA_FLAGS')\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.mesh\n"
        "assert os.environ.get('XLA_FLAGS') == before\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
        "assert not bad, bad\n"
        "print('clean')\n").format(src=str(REPO / "src"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
    assert "512" not in os.environ.get("XLA_FLAGS", "")


def test_make_step_for_cell_dispatches_the_three_kinds():
    cfg = configs.get("qwen2_7b", reduced=True)
    train = make_step_for_cell(cfg, InputShape("t", 16, 4, "train"),
                               device="meta", accum_steps=2)
    assert train.meta["accum_steps"] == 2
    moments = tree_leaves([train.arg_specs[1]["mu"], train.arg_specs[1]["nu"]])
    assert {t.dtype for t in moments} == {torch.bfloat16}
    pre = make_step_for_cell(cfg, InputShape("p", 16, 4, "prefill"),
                             device="meta", mesh=None)
    want = make_prefill_step(cfg, InputShape("p", 16, 4, "prefill"),
                             device="meta")
    assert pre.meta == want.meta
    dec = make_step_for_cell(cfg, InputShape("d", 64, 4, "decode"),
                             device="meta")
    assert dec.meta["split_k"] is False
    assert dec.meta["max_seq"] == make_decode_step(
        cfg, InputShape("d", 64, 4, "decode"), device="meta").meta["max_seq"]
    # a mesh is a DeviceMesh (tests/test_torch_lm_mesh_dryrun.py runs the
    # steps on one), not a description; expert parallelism needs one
    from repro_torch.launch.mesh import Mesh

    for kw, err in ((dict(mesh=Mesh((16, 16), ("data", "model"))),
                     TypeError), (dict(ep=True), ValueError)):
        with pytest.raises(err):
            make_step_for_cell(cfg, InputShape("d", 64, 4, "decode"),
                               device="meta", **kw)
