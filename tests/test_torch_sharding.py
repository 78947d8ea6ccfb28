"""The port's sharding rules (``repro_torch.distribution.sharding``) against
the reference's (``repro.distribution.sharding``), exactly.

The LM rules are plain Python over configurations and shapes, so each is
held equal on the same inputs: ``pad_config_for_mesh`` for every
architecture at several TP sizes, ``padding_flops_ratio``,
``param_pspecs`` leaf by leaf for every architecture (FSDP and TP-only,
with and without expert parallelism) on the port's meta-device trees
against ``jax.eval_shape`` of the reference's, ``batch_pspecs``,
``state_pspecs`` with and without split-K for every ported architecture,
``dp_axes_for`` and ``MeshSpec.for_mesh`` on stub meshes. A port spec is a
tuple of per-dimension entries; the reference's ``PartitionSpec`` writes a
one-axis tuple as its name, which the comparison normalises.

The fleet part: the episode table against ``fleet_episode_specs``' in/out
specs, with and without the deploy ring and the shield, and the
``fleet_mesh`` rules without a process group.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.data import synthetic as ref_synth  # noqa: E402
from repro.distribution import sharding as ref_sh  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.distribution import sharding as sh  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402


def _norm(entry):
    return entry[0] if isinstance(entry, tuple) and len(entry) == 1 else entry


def _ref_specs(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {ref_sh._path_str(p): tuple(s) for p, s in flat}


def _port_specs(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: type(x) is tuple)[0]
    return {ref_sh._path_str(p): tuple(_norm(e) for e in s) for p, s in flat}


def _assert_same_specs(got, want):
    g, w = _port_specs(got), _ref_specs(want)
    assert w and sorted(g) == sorted(w)
    for path in w:
        assert g[path] == w[path], (path, g[path], w[path])


class _StubMesh:
    """The two attributes the rules read: axis name -> size, and the
    names in order."""

    def __init__(self, **sizes):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_pad_config_for_mesh_matches_reference(arch):
    for tp in (1, 2, 8, 16):
        cfg_r, cfg_p = ref_configs.get(arch), configs.get(arch)
        if cfg_p.family == "ssm" and cfg_p.num_heads % tp:
            with pytest.raises(ValueError, match="not divisible"):
                sh.pad_config_for_mesh(cfg_p, tp)
            continue
        want = ref_sh.pad_config_for_mesh(cfg_r, tp)
        got = sh.pad_config_for_mesh(cfg_p, tp)
        assert (got is cfg_p) == (want is cfg_r)
        assert got.__dict__ == want.__dict__, (arch, tp)
        assert sh.padding_flops_ratio(cfg_p, got) == \
            ref_sh.padding_flops_ratio(cfg_r, want)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_pspecs_match_reference_leaf_by_leaf(arch):
    """At tp 16 (the production model axis) on the padded config, for
    FSDP+TP and TP-only, and with expert parallelism for the MoE
    families."""
    cfg_r = ref_sh.pad_config_for_mesh(ref_configs.get(arch), 16)
    cfg_p = sh.pad_config_for_mesh(configs.get(arch), 16)
    want_tree = jax.eval_shape(lambda: rlm.init_params(
        cfg_r, jax.random.PRNGKey(0), max_seq=4096))
    got_tree = lm.init_params(cfg_p, None, 4096, device="meta")
    for ep in ((False, True) if cfg_p.family == "moe" else (False,)):
        for fsdp in (True, False):
            for ms_r, ms_p in ((ref_sh.MeshSpec(), sh.MeshSpec()),
                               (ref_sh.MeshSpec(data=("pod", "data")),
                                sh.MeshSpec(data=("pod", "data")))):
                _assert_same_specs(
                    sh.param_pspecs(cfg_p, got_tree, ms_p, ep=ep, fsdp=fsdp),
                    ref_sh.param_pspecs(cfg_r, want_tree, ms_r, ep=ep,
                                        fsdp=fsdp))


def test_param_pspecs_raise_on_an_unruled_large_leaf():
    cfg = configs.get("smollm_135m")
    fake = {"mystery_big": torch.empty((2048, 2048), device="meta")}
    with pytest.raises(ValueError, match="no sharding rule"):
        sh.param_pspecs(cfg, fake, sh.MeshSpec())
    # TP-only layouts may replicate it, as in the reference
    assert sh.param_pspecs(cfg, fake, sh.MeshSpec(), fsdp=False) == \
        {"mystery_big": (None, None)}


@pytest.mark.parametrize("arch", [a for a in configs.ARCH_IDS
                                  if configs.get(a).family in lm.PORTED])
def test_state_and_batch_pspecs_match_reference(arch):
    """Decode-state specs with and without split-K (the sequence-sharded
    KV of long-context decode) and the batch specs, on each package's own
    state and batch trees."""
    cfg_r, cfg_p = ref_configs.get(arch), configs.get(arch)
    B, S = 8, 1024
    want_state = jax.eval_shape(lambda: rlm.init_decode_state(cfg_r, B, S))
    got_state = lm.init_decode_state(cfg_p, B, S, device="meta")
    for dp in (("data",), ("pod", "data"), ()):
        for split_k in (False, True):
            _assert_same_specs(
                sh.state_pspecs(cfg_p, got_state, sh.MeshSpec(), dp,
                                shard_kv_seq=split_k),
                ref_sh.state_pspecs(cfg_r, want_state, ref_sh.MeshSpec(), dp,
                                    shard_kv_seq=split_k))
        _assert_same_specs(
            sh.batch_pspecs(cfg_p, synthetic.batch_spec(cfg_p, B, 64), dp),
            ref_sh.batch_pspecs(cfg_r, ref_synth.batch_spec(cfg_r, B, 64),
                                dp))


def test_dp_axes_and_meshspec_match_reference():
    stub = _StubMesh(pod=2, data=16, model=16)
    ms_r = ref_sh.MeshSpec(data=("pod", "data"))
    ms_p = sh.MeshSpec(data=("pod", "data"))
    for batch in range(1, 130):
        assert sh.dp_axes_for(batch, stub, ms_p) == \
            ref_sh.dp_axes_for(batch, stub, ms_r)
    assert sh.tp_size(stub, ms_p) == 16 and sh.dp_size(stub, ms_p) == 32
    for mesh in (Mesh((4, 2), ("data", "model")), Mesh((2, 16, 16),
                                             ("pod", "data", "model")),
                 _StubMesh(fleet=8)):
        got, want = sh.MeshSpec.for_mesh(mesh), ref_sh.MeshSpec.for_mesh(mesh)
        assert (got.data, got.model, got.expert) == \
            (want.data, want.model, want.expert)


def _dims(specs, ax):
    """A reference spec tuple as cluster dims: the index of the fleet axis
    in each PartitionSpec, None when it is replicated."""
    return tuple(next((i for i, a in enumerate(s) if a == ax), None)
                 for s in specs)


@pytest.mark.parametrize("r_max,shield", [(0, False), (2, False), (0, True),
                                          (1, True)])
def test_fleet_episode_table_matches_reference_specs(r_max, shield):
    mesh = _StubMesh(fleet=4)     # the reference reads axis_names[0]
    (ins_r, (carry_r, outs_r)) = ref_sh.fleet_episode_specs(mesh, r_max,
                                                            shield)
    ins, (carry, outs) = sh.fleet_episode_specs(r_max, shield)
    assert ins == _dims(ins_r, "fleet")
    assert carry == _dims(carry_r, "fleet")
    assert outs == _dims((outs_r,), "fleet")[0] == 0
    names = sh.episode_carry_leaves(r_max, shield)
    assert len(names) == len(carry)
    assert tuple(sh.cluster_dim(n) for n in names) == carry
    assert sh.FLEET_AXIS == ref_sh.FLEET_AXIS


def test_fleet_mesh_is_none_without_a_process_group():
    assert not torch.distributed.is_initialized()
    assert sh.fleet_mesh() is None and sh.fleet_mesh(4) is None
    assert sh.is_writer()
    sh.barrier()          # nothing to wait for
    assert sh.init_from_env("cpu") == "cpu"
    assert np.all([p.dim == 0 for p in sh.fleet_sharding(None)])
