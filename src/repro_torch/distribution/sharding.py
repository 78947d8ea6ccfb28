"""Sharding rules and the fleet mesh: the port of
``repro.distribution.sharding``.

Two halves, as in the reference (DESIGN.md §4, §11):

* **The fleet axis.** The fused tuning loop shards its cluster axis over a
  1-D ``DeviceMesh`` (axis ``"fleet"``) of a ``torch.distributed`` process
  group: every rank holds the whole fleet, runs the episode on its
  contiguous block of clusters, and the only cross-cluster coupling (the
  heat-map running range) is a MIN/MAX all-reduce each step
  (``range_reduce``, the reference's ``pmin``/``pmax``). The episode ends
  with one all-gather of the per-cluster carry and outputs
  (``cluster_gather``), so the update runs replicated on the whole batch.
  ``fleet_episode_specs`` is the one table of which episode leaves are
  per-cluster and which are replicated.
* **The LM mesh** (DESIGN.md §4): the rules as plain functions over
  configurations and shapes (``MeshSpec``, ``dp_axes_for``,
  ``pad_config_for_mesh``, ``padding_flops_ratio``, ``param_pspecs``,
  ``batch_pspecs``, ``state_pspecs``), and what places tensors by them:
  ``placements_for`` / ``distribute_tree`` (DTensor placements of a spec)
  and ``make_shard_fn`` (the models' ``shard(name, x)`` hook). A mesh is a
  ``torch.distributed`` ``DeviceMesh`` (axis names ``mesh_dim_names``) or a
  description with ``.shape`` (axis name -> size) and ``.axis_names``, such
  as ``repro_torch.launch.mesh.Mesh``; ``axis_sizes`` reads either. Each
  spec is a tuple with one entry per tensor dimension: an axis name, a
  tuple of names, or None, which is what the reference's ``PartitionSpec``
  holds.

  Parameters are FSDP+TP: the hook's ``"weights"`` entry gathers a layer's
  leaves to their TP-only layout where the layer uses them (an all-gather
  over the data axes, whose backward is the gradients' reduce-scatter: the
  per-layer all-gather GSPMD inserts for the reference, ZeRO-3). A matmul
  is never left to DTensor with a weight still sharded on its contracting
  dimension.
"""
from __future__ import annotations

import dataclasses
import math
import os
import re
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.utils import round_up

PyTree = Any


@dataclass(frozen=True)
class MeshSpec:
    """Which mesh axes play which role."""

    data: tuple[str, ...] = ("data",)   # DP/FSDP axes (may include "pod")
    model: str = "model"                # TP axis
    expert: Optional[str] = None        # EP axis (optional, defaults to TP-MoE)

    @staticmethod
    def for_mesh(mesh) -> "MeshSpec":
        names = axis_names(mesh)
        data = tuple(n for n in names if n in ("pod", "data"))
        return MeshSpec(data=data, model="model" if "model" in names else names[-1])


def axis_names(mesh) -> tuple[str, ...]:
    """The axis names of a ``DeviceMesh`` or of a mesh description."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> dict[str, int]:
    """Axis name -> size, in axis order, of a ``DeviceMesh``
    (``mesh_dim_names``, ``size(i)``) or of a description whose ``.shape``
    maps names to sizes (``jax.sharding.Mesh.shape``)."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}
    return dict(mesh.shape)


# ---------------------------------------------------------------------------
# The fleet axis (DESIGN.md §11)
# ---------------------------------------------------------------------------

#: axis name of the 1-D cluster-sharding mesh (the fused fleet loop)
FLEET_AXIS = "fleet"

#: fleet-mesh collectives issued (``range_reduce``, ``cluster_gather``,
#: ``broadcast_state``); a call made while a CUDA graph captures counts in
#: ``CAPTURED`` instead, and the graph's owner adds what it holds to
#: ``COLLECTIVES`` at every replay (``repro_torch.core.graphs.Program``)
COLLECTIVES = 0
CAPTURED = 0


def _count() -> None:
    global COLLECTIVES, CAPTURED
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        CAPTURED += 1
    else:
        COLLECTIVES += 1


def fleet_mesh(n_devices: Optional[int] = None):
    """1-D ``DeviceMesh`` (axis ``"fleet"``) over the initialised process
    group's ranks; None when no process group is initialised or the mesh
    would have one rank — the fused loop then stays a plain one-device
    program. ``n_devices`` caps the mesh at the first ranks; it must cover
    the world, since every rank runs the episode SPMD."""
    if not dist.is_available() or not dist.is_initialized():
        return None
    world = dist.get_world_size()
    n = world if n_devices is None else min(int(n_devices), world)
    if n <= 1:
        return None
    if n != world:
        raise ValueError(f"a fleet mesh of {n} ranks in a world of {world}: "
                         "every rank runs the episode")
    from torch.distributed.device_mesh import init_device_mesh

    # the mesh's device type follows the backend: NCCL ranks own a card
    # each, gloo ranks may share one (their tensors can still be CUDA)
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, (n,), mesh_dim_names=(FLEET_AXIS,))


def fleet_sharding(mesh):
    """Cluster-axis placement for fleet tensors (leading N axis): dim 0
    sharded over the fleet mesh."""
    from torch.distributed.tensor import Shard

    return (Shard(0),)


#: the fused episode program's arguments, in the reference's order
#: (``DeviceEpisodeRunner._episode_fn``'s ``program``), and the shield's
#: four carried leaves, appended when the configurator is safe
EPISODE_ARGS = ("params", "key", "config_idx", "backlog", "sfree", "clock",
                "last_service", "reconfigs", "lo", "hi", "per_node", "wl",
                "f", "tabs", "kind_code", "n_valid", "reboot_f", "rejit_f",
                "mc", "emitF", "ft", "delays", "hist")
SHIELD_LEAVES = ("lkg", "radius", "streak", "risk")
#: the episode's carry (its first output), before the ring and the shield
CARRY_LEAVES = ("config_idx", "backlog", "sfree", "clock", "last_service",
                "reconfigs", "lo", "hi", "per_node")

#: leaf -> the dimension that is the cluster axis (None: replicated). The
#: deploy-history ring is (R_max+1, N, L); every other per-cluster leaf
#: leads with N.
_CLUSTER_DIM = dict(
    params=None, key=None, config_idx=0, backlog=0, sfree=0, clock=0,
    last_service=0, reconfigs=0, lo=None, hi=None, per_node=0, wl=0, f=None,
    tabs=None, kind_code=None, n_valid=None, reboot_f=None, rejit_f=None,
    mc=0, emitF=0, ft=0, delays=0, hist=1, lkg=0, radius=0, streak=0,
    risk=0)


def fleet_episode_specs(r_max: int, shield: bool = False
                        ) -> tuple[tuple, tuple]:
    """The in/out table of the fused episode — ONE definition shared by the
    per-update episode, the epoch body (which runs the same episode inside
    its update) and the state handback. Each entry is the leaf's cluster
    dimension, or None for a replicated leaf, in the reference's
    ``shard_map`` order: the inputs ``EPISODE_ARGS`` (+ the shield's four
    leaves when ``shield``), then ``(carry, outputs)``: the carry
    ``CARRY_LEAVES``, the history ring when ``r_max`` > 0 and the shield's
    leaves; every per-step output leads with N."""
    sh = SHIELD_LEAVES if shield else ()
    ins = EPISODE_ARGS + sh
    carry = episode_carry_leaves(r_max, shield)
    return (tuple(_CLUSTER_DIM[n] for n in ins),
            (tuple(_CLUSTER_DIM[n] for n in carry), 0))


def episode_carry_leaves(r_max: int, shield: bool = False) -> tuple:
    """The names of the episode carry's leaves, in its layout."""
    return (CARRY_LEAVES + (("hist",) if r_max else ())
            + (SHIELD_LEAVES if shield else ()))


def cluster_dim(name: str) -> Optional[int]:
    """The cluster dimension of the episode leaf ``name`` (None:
    replicated)."""
    return _CLUSTER_DIM[name]


def range_reduce(lo: torch.Tensor, hi: torch.Tensor,
                 group) -> tuple[torch.Tensor, torch.Tensor]:
    """The fleet-global running range across the shards: elementwise MIN of
    ``lo`` and MAX of ``hi`` over the group's ranks, as ONE all-reduce
    (MIN of ``lo`` and of ``-hi``; negation is exact, so the result is the
    reference's ``pmin``/``pmax`` bit for bit)."""
    m = lo.shape[0]
    buf = torch.cat([lo, -hi])
    _count()
    dist.all_reduce(buf, op=dist.ReduceOp.MIN, group=group)
    return buf[:m], -buf[m:]


def cluster_gather(parts: Sequence[tuple[torch.Tensor, int]], n_local: int,
                   group) -> list[torch.Tensor]:
    """All-gather per-cluster tensors along their cluster axis in ONE
    collective: each ``(tensor, dim)`` holds this rank's ``n_local``
    clusters on ``dim``; the result holds the whole fleet's, rank blocks in
    rank order, in the tensor's dtype. The tensors travel as one byte
    matrix of a row per cluster."""
    world = dist.get_world_size(group)
    rows, metas = [], []
    for x, d in parts:
        x = x.movedim(d, 0) if d else x
        metas.append((x.shape, x.dtype, d))
        rows.append(x.reshape(n_local, -1).contiguous().view(torch.uint8))
    send = torch.cat(rows, dim=1)
    recv = torch.empty((world * n_local, send.shape[1]), dtype=torch.uint8,
                       device=send.device)
    _count()
    # the same collective under its newer name where torch has it
    gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
    gather(recv, send, group=group)
    out, col = [], 0
    for row, (shape, dtype, d) in zip(rows, metas):
        w = row.shape[1]
        x = recv[:, col:col + w].contiguous().view(dtype).reshape(
            (world * n_local,) + tuple(shape[1:]))
        out.append(x.movedim(0, d) if d else x)
        col += w
    return out


def broadcast_state(state: torch.Tensor, group, device) -> torch.Tensor:
    """Rank 0's copy of a uint8 CPU ``state`` (a generator's), on every
    rank of ``group``; the payload travels on ``device`` (a card for
    NCCL)."""
    buf = state.to(device)
    _count()
    dist.broadcast(buf, group_src=0, group=group)
    return buf.cpu()


def init_from_env(device: Optional[str] = None):
    """Join the process group a launcher (``torchrun``) describes in the
    environment (``WORLD_SIZE`` > 1, ``RANK``, ``LOCAL_RANK``,
    ``MASTER_ADDR`` / ``MASTER_PORT``). NCCL with the card ``LOCAL_RANK``
    names, or gloo when ``device`` is ``"cpu"``. Returns the device this
    rank runs on: ``device`` itself outside such a launch."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return device
    if device is not None and torch.device(device).type == "cpu":
        dist.init_process_group("gloo")
        return device
    card = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    torch.cuda.set_device(card)
    dist.init_process_group("nccl", device_id=card)
    return str(card)


def is_writer() -> bool:
    """True on the rank that writes files: rank 0 of an initialised process
    group, or the only process."""
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank of the default group (nothing without one)."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


# ---------------------------------------------------------------------------
# LM meshes: axis sizes
# ---------------------------------------------------------------------------


def tp_size(mesh, ms: MeshSpec) -> int:
    return axis_sizes(mesh)[ms.model]


def dp_size(mesh, ms: MeshSpec) -> int:
    sizes = axis_sizes(mesh)
    return int(math.prod(sizes[a] for a in ms.data))


def dp_axes_for(batch: int, mesh, ms: MeshSpec) -> tuple[str, ...]:
    """Largest suffix-product of data axes that divides `batch`.

    E.g. batch=32 on ("pod","data")=(2,16) -> both axes; batch=8 -> ("data",)
    only if 8 % 16 == 0 fails -> (); batch=1 -> ().
    """
    sizes = axis_sizes(mesh)
    axes: tuple[str, ...] = ()
    prod = 1
    for a in reversed(ms.data):
        if batch % (prod * sizes[a]) == 0:
            axes = (a,) + axes
            prod *= sizes[a]
        else:
            break
    return axes


# ---------------------------------------------------------------------------
# Config padding
# ---------------------------------------------------------------------------


def pad_config_for_mesh(cfg: ModelConfig, tp: int) -> ModelConfig:
    """Pad head/vocab dims so every TP-sharded dim divides the model axis."""
    changes: dict = {}
    nkv = cfg.num_kv_heads
    nq = cfg.num_heads
    if cfg.family != "ssm":  # attention heads
        nkv_p = round_up(nkv, tp) if nkv else nkv
        step = max(nkv_p, tp)
        nq_p = round_up(nq, step)
        if (nq_p, nkv_p) != (nq, nkv):
            changes.update(num_heads=nq_p, num_kv_heads=nkv_p,
                           head_dim=cfg.resolved_head_dim)
    elif nq % tp:
        raise ValueError(f"{cfg.name}: wkv heads {nq} not divisible by tp={tp}")
    if cfg.vocab_size % tp:
        changes.update(vocab_size=round_up(cfg.vocab_size, tp),
                       vocab_true=cfg.vocab_true or cfg.vocab_size)
    return dataclasses.replace(cfg, **changes) if changes else cfg


def padding_flops_ratio(cfg: ModelConfig, padded: ModelConfig) -> float:
    """Rough useful/compiled FLOPs ratio attributable to head+vocab padding."""
    if cfg is padded:
        return 1.0
    base = cfg.param_count()
    pad = dataclasses.replace(padded, vocab_true=0).param_count()
    return base / max(pad, 1)


# ---------------------------------------------------------------------------
# Parameter shardings (path-pattern rules)
# ---------------------------------------------------------------------------

# (regex on "a/b/c" path, spec WITHOUT the leading layer-stack dim)
_RULES: Sequence[tuple[str, tuple]] = (
    (r"embed$", ("model", "data")),
    (r"lm_head$", ("data", "model")),
    (r"enc_pos$", (None, "model")),  # 1500 frames not data-divisible; shard d
    (r"dec_pos$", ("data", None)),   # seq dim sharded (gathered on use)
    # attention
    (r"attn/w[qkv]$|xattn/w[qkv]$", ("data", "model")),
    (r"attn/wo$|xattn/wo$", ("model", "data")),
    (r"attn/b[qkv]$|xattn/b[qkv]$", ("model",)),
    # dense mlp / shared expert
    (r"(mlp|shared)/w[gu]$", ("data", "model")),
    (r"(mlp|shared)/wd$", ("model", "data")),
    (r"shared_gate$", ("data", None)),
    # moe (TP-MoE layout: expert dim replicated, hidden dim TP)
    (r"moe/router$", ("data", None)),
    (r"moe/w[gu]$", (None, "data", "model")),
    (r"moe/wd$", (None, "model", "data")),
    # mamba2
    (r"mamba/(z_proj|x_proj|dt_proj)$", ("data", "model")),
    (r"mamba/(B_proj|C_proj)$", ("data", None)),
    (r"mamba/conv_x_[wb]$", (None, "model")),
    (r"mamba/conv_[BC]_[wb]$", (None, None)),
    (r"mamba/out_proj$", ("model", "data")),
    (r"mamba/(A_log|D|dt_bias)$", (None,)),
    # rwkv6
    (r"mix_\w+$", (None, None)),  # token-shift mixes (5|2, d): tiny, replicated
    (r"(?:^|/)(wr|wk|wv|wg|cm_k|cm_r)$", ("data", "model")),
    (r"(?:^|/)(wo|cm_v)$", ("model", "data")),
    (r"w_lora_a$", ("data", None)),
    (r"w_lora_b$", (None, "model")),
    (r"(w_bias|u_bonus)$", ("model",)),
    # norms and anything small
    (r"scale$", (None,)),
)

_EP_OVERRIDES: Sequence[tuple[str, tuple]] = (
    (r"moe/w[gu]$", ("model", "data", None)),
    (r"moe/wd$", ("model", None, "data")),
)


def _map_with_path(fn, tree: PyTree, path: tuple = ()) -> PyTree:
    """``fn(path, leaf)`` over a tree of dicts, lists, tuples and
    NamedTuples (None is an empty subtree, as in JAX), keeping the
    containers; ``path`` holds the dict keys, field names and indices."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, getattr(tree, f), path + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def _spec_of(path: str, ndim: int, stacked: bool, ms: MeshSpec,
             ep: bool) -> tuple:
    rules = list(_EP_OVERRIDES) + list(_RULES) if ep else _RULES
    for pat, logical in rules:
        if re.search(pat, path):
            spec = tuple(
                ms.data if a == "data" else (ms.model if a == "model" else None)
                for a in logical
            )
            if stacked and len(spec) == ndim - 1:
                spec = (None,) + spec
            if len(spec) != ndim:  # e.g. biases under a rule written for 2D
                spec = (None,) * (ndim - len(spec)) + spec[-ndim:] if ndim else ()
            return spec
    return (None,) * ndim


def param_pspecs(cfg: ModelConfig, params_shape: PyTree, ms: MeshSpec,
                 ep: bool = False, fsdp: bool = True) -> PyTree:
    """Spec tree matching a params tree (tensors of any device, ``meta``
    included: only ``.shape`` is read).

    ``fsdp=False`` drops the data-axis factor (TP-only sharding): inference
    steps have no optimizer state to shard, and replicating weights across
    the data axis removes every per-layer weight all-gather.

    Safety: any leaf with >= 2^20 elements must hit a non-replicated rule —
    silently replicating a big tensor is how dry-runs "pass" while lying.
    """
    stacked = cfg.scan_layers

    def one(pstr, leaf):
        is_stacked = stacked and pstr.startswith(("layers", "enc_layers"))
        spec = _spec_of(pstr, len(leaf.shape), is_stacked, ms, ep)
        if not fsdp:
            spec = tuple(None if s in (ms.data, "data") or
                         (isinstance(s, tuple) and set(s) <= set(ms.data))
                         else s for s in spec)
        n = math.prod(leaf.shape)
        if n >= 1 << 20 and fsdp and all(s is None for s in spec):
            raise ValueError(f"large param {pstr} {tuple(leaf.shape)} has no "
                             "sharding rule")
        return spec

    return _map_with_path(one, params_shape)


# ---------------------------------------------------------------------------
# Batch / decode-state shardings
# ---------------------------------------------------------------------------


def _n(ax):
    """Normalise axis spec: empty tuple -> None."""
    return None if ax == () else ax


def batch_pspecs(cfg: ModelConfig, batch_tree: PyTree,
                 dp: tuple[str, ...]) -> PyTree:
    dp = _n(dp)

    def one(name, leaf):
        if name in ("patch_embeds", "frames"):
            return (dp, None, None)
        return (dp,) + (None,) * (len(leaf.shape) - 1)

    return _map_with_path(one, batch_tree)


def state_pspecs(cfg: ModelConfig, state_shape: PyTree, ms: MeshSpec,
                 dp: tuple[str, ...], *, shard_kv_seq: bool = False) -> PyTree:
    """DecodeState shardings. ``shard_kv_seq`` = split-K long-context mode:
    KV caches shard the sequence dim over the data axes instead of batch."""
    m = ms.model
    seq_ax = _n(dp) if shard_kv_seq else None
    bat_ax = None if shard_kv_seq else _n(dp)

    def one(name, leaf):
        nd = len(leaf.shape)
        if name in ("kv_k", "kv_v"):          # (L, B, S, nkv, hd)
            return (None, bat_ax, seq_ax, m, None)
        if name in ("cross_k", "cross_v"):    # (L, B, F, nkv, hd)
            return (None, bat_ax, None, m, None)
        if name == "pos":
            return ()
        if name.endswith("ssm"):              # (L, B, nh, hd, ns)
            return (None, bat_ax, m, None, None)
        if name.endswith("wkv"):              # (L, B, H, hd, hd)
            return (None, bat_ax, m, None, None)
        if name.endswith("conv_x"):           # (L, B, 3, d_in)
            return (None, bat_ax, None, m)
        if "shift" in name:                   # (L, B, 1, d)
            return (None, bat_ax, None, m)
        if name.startswith("conv"):           # conv_B / conv_C (L, B, 3, ns)
            return (None, bat_ax, None, None)
        return (None,) * nd

    return _map_with_path(one, state_shape)


# ---------------------------------------------------------------------------
# DTensor placements of the specs
# ---------------------------------------------------------------------------


def placements_for(spec: tuple, mesh) -> list:
    """The DTensor placements (one a mesh axis) of a spec (one entry a
    tensor dim): ``Shard(d)`` on each mesh axis that tensor dim ``d``
    names, ``Replicate()`` on the others. A dim that names several axes,
    such as ``("pod", "data")``, is split over them with the first-named
    axis major, as JAX's ``NamedSharding`` splits it; DTensor splits in
    mesh-axis order, so the names must come in that order. An axis of
    size one holds the whole dim: it stays ``Replicate()`` (DTensor
    refuses to reshape a dim it counts as split, even over one rank)."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    sizes = axis_sizes(mesh)
    out = [Replicate()] * len(names)
    for d, s in enumerate(spec):
        if s is None:
            continue
        axes = s if isinstance(s, tuple) else (s,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec} names {axes} out of the mesh's "
                             f"axis order {names}")
        for i in idx:
            if sizes[names[i]] > 1:   # a block of one rank is the whole
                out[i] = Shard(d)
    return out


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        s is None or isinstance(s, (str, tuple)) for s in x)


def _map_specs(fn, tree: PyTree, specs: PyTree) -> PyTree:
    """``fn(leaf, spec)`` over a tree and its spec tree (a spec is a tuple
    of axis entries, so it is a leaf here, not a container)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_specs(fn, getattr(tree, f),
                                       getattr(specs, f))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_specs(fn, v, s) for v, s in zip(tree, specs))
    assert _is_spec(specs), specs
    return fn(tree, specs)


def distribute_tree(tree: PyTree, specs: PyTree, mesh) -> PyTree:
    """Every tensor of ``tree`` as a DTensor placed by its spec. Each rank
    already holds the whole tree (drawn from the same seed, read from the
    same file, or on the ``meta`` device) and keeps its own block, with no
    communication."""
    from torch.distributed.tensor import distribute_tensor

    return _map_specs(
        lambda t, s: distribute_tensor(t, mesh, placements_for(s, mesh),
                                       src_data_rank=None),
        tree, specs)


def mesh_zeros(shape, dtype, spec: tuple, mesh, device) -> torch.Tensor:
    """A DTensor of zeros of global ``shape`` placed by ``spec``: each rank
    allocates only its own block."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    pl = placements_for(spec, mesh)
    local, _ = compute_local_shape_and_global_offset(shape, mesh, pl)
    return DTensor.from_local(torch.zeros(local, dtype=dtype, device=device),
                              mesh, pl, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def whole(tree: PyTree) -> PyTree:
    """``tree`` (or one leaf) with every DTensor gathered into a plain
    tensor, the whole of it on every rank (a collective: every rank of the
    mesh calls it); other leaves as they are."""
    from torch.distributed.tensor import DTensor

    def one(x):
        return x.full_tensor() if isinstance(x, DTensor) else x
    return _map_with_path(lambda _, x: one(x), tree)


def block_index(mesh, dims: Sequence[int]) -> int:
    """This rank's block of a dim split over the mesh dims ``dims``, the
    first of them major (``placements_for``'s order): the block's offset
    is this index times the block's length."""
    block = 0
    for i in dims:
        block = block * mesh.size(i) + mesh.get_local_rank(i)
    return block


def drop_nondividing(spec: tuple, shape, mesh) -> tuple:
    """``spec`` with every entry whose axes' sizes multiply to a number
    that does not divide its dim set to None: the reference's rule for an
    axis that does not divide a dim (an unpadded config's kv heads, an
    odd batch)."""
    sizes = axis_sizes(mesh)
    out = []
    for dim, s in zip(shape, spec):
        axes = () if s is None else s if isinstance(s, tuple) else (s,)
        n = math.prod(sizes[a] for a in axes)
        out.append(s if n and dim % n == 0 else None)
    return tuple(out)


def even_placements(placements, shape, mesh) -> list:
    """A DTensor's ``placements`` with every ``Shard(d)`` whose mesh axis
    does not divide ``shape[d]`` made ``Replicate()``: ``drop_nondividing``
    on placements. ``shape`` may count a dim in whole units (heads, not
    head-dim elements), so that a block holds whole units."""
    from torch.distributed.tensor import Replicate

    return [Replicate() if p.is_shard() and shape[p.dim] % mesh.size(i)
            else p for i, p in enumerate(placements)]


def tp_only(x, mesh_dims: Sequence[int]):
    """A DTensor regathered over the mesh dims ``mesh_dims`` (the data
    axes), and over any axis that splits a dim unevenly (qwen2-moe's 60
    experts over a model axis of 16 under ``ep``, ``even_placements``):
    its placements there become ``Replicate()``, the others stay. A plain
    tensor is returned as it is."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    pl = list(x.placements)
    new = [Replicate() if i in mesh_dims else p for i, p in
           enumerate(even_placements(pl, x.shape, mesh))]
    if new == pl:
        return x
    return x.redistribute(mesh, new)


class ShardFn:
    """The models' ``shard(name, x)`` hook on a mesh (``make_shard_fn``).

    Activation names redistribute ``x`` to the reference's table (below);
    ``"weights"`` regathers a tree of parameter DTensors to their TP-only
    layout (``tp_only`` over the data axes); any other name, and any plain
    tensor, passes through."""

    def __init__(self, mesh, ms: MeshSpec, dp: tuple[str, ...]):
        self.mesh, self.ms, self.dp = mesh, ms, tuple(dp)
        names = axis_names(mesh)
        self.data_dims = tuple(names.index(a) for a in ms.data
                               if a in names)
        m, d = ms.model, _n(self.dp)
        # the reference's table; ``act_moe_ff`` is written for the port's
        # (E, B·C, m) expert activations, the reference's (B, E, C, m)
        self.table = {
            "act_btd": (d, None, None),
            "act_btd_dec": (d, None, None),
            "act_heads": (d, None, m, None),
            "act_kv_heads": (d, None, m, None),
            "act_ff": (d, None, m),
            "act_ssm": (d, None, m),
            "act_moe_ff": (None, d, m),
            "logits": (d, None, m),
        }

    def spec(self, name: str, shape) -> Optional[tuple]:
        """The table's spec for ``name`` at ``shape``, each axis that does
        not divide its dimension dropped (the reference's rule); None for
        a name not in the table."""
        spec = self.table.get(name)
        return None if spec is None else drop_nondividing(spec, shape,
                                                          self.mesh)

    def __call__(self, name: str, x):
        from torch.distributed.tensor import DTensor

        if name == "weights":
            return _map_with_path(lambda _, t: tp_only(t, self.data_dims), x)
        spec = self.spec(name, getattr(x, "shape", ()))
        if spec is None or not isinstance(x, DTensor):
            return x
        pl = placements_for(spec + (None,) * (x.ndim - len(spec)), self.mesh)
        if tuple(pl) == tuple(x.placements):
            return x
        return x.redistribute(self.mesh, pl)


def make_shard_fn(mesh, ms: MeshSpec, dp: tuple[str, ...]) -> ShardFn:
    """Returns the ``shard(name, x)`` hook the model layers call (see
    ``ShardFn``)."""
    return ShardFn(mesh, ms, dp)


def opt_state_specs(opt_state: PyTree, pspecs: PyTree) -> PyTree:
    """The optimizer state's specs: the moment trees (``mu``, ``nu``)
    mirror the parameters' specs, every other leaf (``count``) is
    replicated (the reference's ``_opt_state_specs``)."""
    return {k: (pspecs if k in ("mu", "nu") else
                _map_with_path(lambda _, t: (None,) * t.ndim, v))
            for k, v in opt_state.items()}
