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
* **The LM rules**, as plain functions over configurations and shapes:
  ``MeshSpec``, ``dp_axes_for``, ``pad_config_for_mesh``,
  ``padding_flops_ratio``, ``param_pspecs``, ``batch_pspecs`` and
  ``state_pspecs``. A mesh is anything with ``.shape`` (axis name -> size)
  and ``.axis_names``, such as ``repro_torch.launch.mesh.Mesh``. Each spec
  is a tuple with one entry per tensor dimension: an axis name, a tuple of
  names, or None, which is what the reference's ``PartitionSpec`` holds.
  Placing tensors by these specs (``make_shard_fn`` and DTensor
  placements in the steps) waits for ROADMAP queue 1, item 7.2.
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
        names = tuple(mesh.axis_names)
        data = tuple(n for n in names if n in ("pod", "data"))
        return MeshSpec(data=data, model="model" if "model" in names else names[-1])


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
    return mesh.shape[ms.model]


def dp_size(mesh, ms: MeshSpec) -> int:
    return int(math.prod(mesh.shape[a] for a in ms.data))


def dp_axes_for(batch: int, mesh, ms: MeshSpec) -> tuple[str, ...]:
    """Largest suffix-product of data axes that divides `batch`.

    E.g. batch=32 on ("pod","data")=(2,16) -> both axes; batch=8 -> ("data",)
    only if 8 % 16 == 0 fails -> (); batch=1 -> ().
    """
    axes: tuple[str, ...] = ()
    prod = 1
    for a in reversed(ms.data):
        if batch % (prod * mesh.shape[a]) == 0:
            axes = (a,) + axes
            prod *= mesh.shape[a]
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
