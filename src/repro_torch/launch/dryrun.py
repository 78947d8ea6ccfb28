"""Dry-run of the port: trace every (architecture × input shape) cell's
step on the ``meta`` device and extract its roofline terms, on one device
or on the reference's production meshes. The port of
``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both [--ep]

Results land in ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``
(``--out``; ``<mesh>`` is ``1x1``, ``16x16`` or ``2x16x16``), one record a
cell with the reference's keys. Nothing here allocates device memory or
needs a card: the step runs on ``meta`` tensors, which carry shapes and
dtypes and no data, and importing the module touches no device. Unlike the
reference it sets no ``XLA_FLAGS``: there is no compiler to force devices
on.

``--mesh local`` (the default) runs one device. ``--mesh single`` /
``multi`` / ``both`` run the 16x16 and / or 2x16x16 meshes
(``launch.mesh.make_production_mesh``): a child process per mesh joins a
``fake`` process group of 256 or 512 ranks (collectives that move
nothing), builds the ``DeviceMesh`` and runs each cell's sharded step
(``make_step_for_cell(mesh=)``, ``--ep`` the expert-parallel MoE layout)
on meta DTensors, as rank 0; the caller keeps no process group.

What a cell counts (``_cost_triple``), in one pass of the step under a
``TorchDispatchMode``:

* ``flops``: the operations ``torch.utils.flop_counter`` has formulas for
  (matmul-class ops: ``mm``, ``addmm``, ``bmm``, ``baddbmm``, convolutions,
  attention), counted as ``FlopCounterMode`` counts them. XLA's
  ``cost_analysis``, which the reference reads, also counts elementwise
  work; this count does not.
* ``hbm_bytes``: the bytes every dispatched op reads and writes, each
  tensor argument read once and each result written once. View and
  metadata ops move nothing; an in-place op counts what it touches (an
  ``index_copy_`` into a cache the rows it writes). PyTorch runs eagerly,
  so this is the traffic the port's program really moves, with no fusion.
* memory: the live storage bytes, each storage counted once however many
  views it has and freed when its last reference dies (so the tensors that
  autograd saves stay counted through the backward), and their peak.
* collectives, on a mesh: every ``_c10d_functional`` collective the
  DTensors issue (their redistributes, the split-K decode's gathers) by
  the reference's kinds (``all-gather``, ``all-reduce``,
  ``reduce-scatter``, ``all-to-all``, ``collective-permute``) and their
  ``counts``, which ``CommDebugMode`` counts alongside; the bytes are each
  collective's result, as ``collective_bytes_from_hlo`` sums them, and
  ``by_axis`` splits them by the mesh axis whose group ran them.

Every count is **per device**, as the reference's ``roofline_terms``
reads its terms: the mode sees the ops each rank runs on its own blocks
(a DTensor op is handed on to DTensor, whose local ops the mode then
counts; the shape propagation DTensor runs on fake tensors is not
counted), so a matmul on a weight split four ways counts a quarter of its
FLOPs, and memory is the rank's own blocks.

As in the reference, the terms come from depth probes
(``layer_delta_costs``): the step at 1 and 2 units of depth
(``_depth_probe_points``), extrapolated to the full depth. On the meta
device that is about time, not accuracy: a pass costs its Python dispatch,
and at production shapes rwkv6-7b's ``wkv6_chunked`` loop alone makes
1024 chunks a layer. The argument bytes are summed exactly from the full
depth's argument specs.

Hardware model (NVIDIA H100 SXM, data sheet, dense, at its 700 W limit):
989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s of HBM3, NVLink 4 at 18
links of 25 GB/s a direction (450 GB/s a card, within a node of 8), and
between nodes one ConnectX-7 NDR InfiniBand port of 400 Gb/s (50 GB/s) a
card (the DGX H100 / HGX H100 reference design: 8 cards a node, a NIC a
card). A mesh is laid out row-major over nodes of 8 ranks, so an axis
whose ranks stay within one node (the innermost axis of at most 8) is
charged the NVLink rate, and any other axis (the 16-wide model axis, whose
ring spans two nodes; the data and pod axes, whose ranks are 16 apart) the
InfiniBand rate (``axis_rates``).
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import re
import sys
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

#: NVIDIA H100 SXM (data sheet; dense, no sparsity, at 700 W)
PEAK_FLOPS = 989e12        # bf16 tensor-core FLOP/s
HBM_BW = 3.35e12           # HBM3 bytes/s
NVLINK_BW = 25e9           # bytes/s per NVLink 4 link, per direction
NVLINK_LINKS = 18          # NVLink 4 links of one H100 SXM
IB_BW = 50e9               # bytes/s: one NDR 400 Gb/s port a card
NODE_GPUS = 8              # cards of one NVLink node (DGX / HGX H100)

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


def _shape_bytes(shape_str: str) -> int:
    """'bf16[8,128,256]{...}' -> byte count. Tuples handled by the caller."""
    m = re.match(r"(\w+)\[([\d,]*)\]", shape_str)
    if not m:
        return 0
    dt, dims = m.groups()
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES.get(dt, 4)


def collective_bytes_from_hlo(hlo: str) -> dict:
    """Sum result bytes of every collective op in optimised HLO, by kind
    (the reference's parser; the port has no HLO of its own until the
    LM mesh, and keeps the parser for the records it reads).

    Matches lines like:
      %ag = bf16[2,512]{1,0} all-gather(%x), replica_groups=...
      ROOT %ar = (f32[...], f32[...]) all-reduce(...)
    """
    out = {k: 0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}
    for line in hlo.splitlines():
        line = line.strip()
        m = re.match(
            r"(?:ROOT )?%?[\w.\-]+ = (\([^)]*\)|\S+) (all-gather|all-reduce|"
            r"reduce-scatter|all-to-all|collective-permute)", line)
        if not m:
            continue
        shapes, kind = m.groups()
        if shapes.startswith("("):
            total = sum(_shape_bytes(s.strip()) for s in shapes[1:-1].split(","))
        else:
            total = _shape_bytes(shapes)
        out[kind] += total
        counts[kind] += 1
    out["counts"] = counts
    return out


def axis_rates(sizes: dict) -> dict:
    """Mesh axis -> the bytes/s a card moves its collectives at (the module
    docstring's layout): NVLink for the innermost axis when it fits in a
    node, InfiniBand for every other axis."""
    names = list(sizes)
    return {a: (NVLINK_BW * NVLINK_LINKS
                if i == len(names) - 1 and sizes[a] <= NODE_GPUS else IB_BW)
            for i, a in enumerate(names)}


def roofline_terms(flops: float, hbm_bytes: float, coll: dict, chips: int,
                   rates: dict | None = None) -> dict:
    """All inputs are PER-DEVICE quantities, so each term divides by one
    card's peak; ``chips`` is kept only for bookkeeping, as in the
    reference. The collective term charges each axis's bytes
    (``coll["by_axis"]``) at its rate (``rates``, from ``axis_rates``);
    bytes with no axis run over every NVLink of the card."""
    coll_bytes = sum(v for k, v in coll.items() if k in _COLLECTIVES)
    t_compute = flops / PEAK_FLOPS
    t_memory = hbm_bytes / HBM_BW
    by_axis = coll.get("by_axis") or {}
    rates = rates or {}
    t_collective = sum(b / rates.get(a, NVLINK_BW * NVLINK_LINKS)
                       for a, b in by_axis.items())
    t_collective += (coll_bytes - sum(by_axis.values())) / (
        NVLINK_BW * NVLINK_LINKS)
    dominant = max(
        ("compute", t_compute), ("memory", t_memory), ("collective", t_collective),
        key=lambda kv: kv[1],
    )[0]
    return dict(
        t_compute_s=t_compute, t_memory_s=t_memory, t_collective_s=t_collective,
        collective_bytes=coll_bytes, dominant=dominant,
    )


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE); D = tokens processed.

    For decode steps D = global_batch (one token each). The embedding
    table is excluded (a gather does no matmul FLOPs; the lm_head matmul is
    counted via its own weights unless tied)."""
    n = cfg.active_param_count()
    if not cfg.tie_embeddings:
        n -= cfg.vocab_size * cfg.d_model
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens  # forward only
    return 2.0 * n * shape.global_batch  # decode: 1 token per sequence


# ---------------------------------------------------------------------------
# counting one pass on the meta device
# ---------------------------------------------------------------------------

#: allocations that write nothing
_NO_WRITE = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                       "new_empty_strided"})
#: in-place ops that overwrite their first argument without reading it
_OVERWRITE = frozenset({"copy_", "fill_", "zero_"})
#: in-place ops that touch their first argument only where they scatter:
#: name -> (the argument that sizes the touched part, whether it also
#: reads the old values there)
_SCATTER = {"index_copy_": ("source", False), "index_add_": ("source", True),
            "index_put_": ("values", None), "_index_put_impl_": ("values", None),
            "scatter_": ("src", False), "scatter_add_": ("src", True),
            "scatter_reduce_": ("src", True)}


def _tensors(tree) -> list:
    """The tensors of ``tree``, each DTensor as its own rank's block."""
    from torch.distributed.tensor import DTensor

    return [t.to_local() if isinstance(t, DTensor) else t
            for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


#: ``_c10d_functional`` collectives -> the reference's kinds
_FUNCOL = {"all_gather_into_tensor": "all-gather",
           "all_gather_into_tensor_coalesced": "all-gather",
           "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
           "reduce_scatter_tensor": "reduce-scatter",
           "reduce_scatter_tensor_coalesced": "reduce-scatter",
           "all_to_all_single": "all-to-all"}


def _nbytes(t: torch.Tensor) -> int:
    """The bytes a tensor's elements span, a broadcast (stride 0) axis
    once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _op_bytes(func, args, kwargs, out) -> int:
    """The bytes one op reads and writes (see the module docstring)."""
    outs = _tensors(out)
    name = func._schema.name.split("::")[-1]
    if not outs or name in _NO_WRITE:
        return 0
    schema = func._schema.arguments
    written = {a.name for a in schema
               if a.alias_info is not None and a.alias_info.is_write}
    bound = dict(zip((a.name for a in schema), args)) | kwargs
    ins = _tensors([v for k, v in bound.items() if k not in written])
    if not written and {_key(o) for o in outs} <= {_key(t) for t in ins}:
        return 0                                  # a view or an alias
    read = sum(_nbytes(t) for t in ins)
    if name in _SCATTER:
        arg, rmw = _SCATTER[name]
        self = bound["self"]
        touched = bound[arg].numel() * self.element_size()
        if rmw is None:
            rmw = bool(bound.get("accumulate", False))
        return read + touched * (2 if rmw else 1)
    if written and name not in _OVERWRITE:
        read += sum(_nbytes(t) for t in _tensors(
            [bound[k] for k in written if k in bound]))
    return read + sum(_nbytes(o) for o in outs)


class _CostMode(TorchDispatchMode):
    """Counts what the ops dispatched under it do: FLOPs by
    ``torch.utils.flop_counter``'s formulas (``flops_by_op`` by op), the
    bytes they read and write, and the live storage bytes with their
    peak."""

    def __init__(self, groups: dict | None = None):
        super().__init__()
        self.groups = groups or {}   # process-group name -> mesh axis
        self.coll = {k: 0 for k in _COLLECTIVES}
        self.coll["counts"] = {k: 0 for k in _COLLECTIVES}
        self.coll["by_axis"] = {}
        self.flops = 0
        self.flops_by_op: collections.Counter = collections.Counter()
        self.hbm_bytes = 0
        self.live = 0
        self.peak = 0
        self._sizes: dict[int, int] = {}

    def track(self, tree) -> int:
        """Count the storages of ``tree``'s tensors as live until they die;
        returns the bytes of those not counted yet."""
        new = 0
        for t in _tensors(tree):
            s = t.untyped_storage()
            if s._cdata in self._sizes:
                continue
            n = s.nbytes()
            self._sizes[s._cdata] = n
            new += n
            weakref.finalize(s, self._free, s._cdata).atexit = False
        self.live += new
        self.peak = max(self.peak, self.live)
        return new

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # DTensor runs it on the blocks
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            return out                   # DTensor's shape propagation
        ns, _, name = func._schema.name.partition("::")
        kind = _FUNCOL.get(name) if ns == "_c10d_functional" else None
        if kind is not None:
            n = sum(_nbytes(t) for t in _tensors(out))
            self.coll[kind] += n
            self.coll["counts"][kind] += 1
            axis = next((self.groups[a] for a in args
                         if isinstance(a, str) and a in self.groups), None)
            if axis is not None:
                by = self.coll["by_axis"]
                by[axis] = by.get(axis, 0) + n
            self.track(out)
            return out
        if self.groups and name in _NO_WRITE:
            # on a mesh an allocation counts from its first write: DTensor's
            # sharding propagation allocates global-shape tensors it never
            # writes
            return out
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            n = int(count(*args, **kwargs, out_val=out))
            self.flops += n
            self.flops_by_op[str(func._overloadpacket)] += n
        self.hbm_bytes += _op_bytes(func, args, kwargs, out)
        self.track(out)
        return out


def _storage_bytes(tree) -> int:
    """The bytes of the distinct storages of ``tree``'s tensors."""
    return sum({_key(t): t.untyped_storage().nbytes()
                for t in _tensors(tree)}.values())


def _groups(mesh) -> dict:
    """Process-group name -> axis name of each axis of a ``DeviceMesh``."""
    if mesh is None:
        return {}
    return {mesh.get_group(i).group_name: n
            for i, n in enumerate(mesh.mesh_dim_names)}


def _cost_triple(bundle, mesh=None) -> tuple[float, float, dict, dict]:
    """(flops, hbm_bytes, collective-bytes-by-kind, memory) of one call of
    ``bundle.fn`` on its meta-device ``arg_specs`` (the reference's triple
    from XLA's cost analysis, and the memory that its compiled executable's
    ``memory_analysis`` gives): memory is ``{"argument", "output", "temp",
    "peak"}``, the arguments' storages, the results' new storages, and the
    peak of live storage bytes over the call, ``peak = argument + output +
    temp``. On a mesh every quantity is rank 0's (the module docstring);
    ``CommDebugMode``'s count of the collectives must agree with the
    mode's."""
    args = bundle.arg_specs
    mode = _CostMode(_groups(mesh))
    argument = mode.track(args)
    if mesh is None:
        with mode:
            out = bundle.fn(*args)
        coll = {k: mode.coll[k] for k in _COLLECTIVES}
        coll["counts"] = mode.coll["counts"]
    else:
        from torch.distributed.tensor.debug import CommDebugMode

        comm = CommDebugMode()
        with comm, mode:
            out = bundle.fn(*args)
        coll = mode.coll
        if comm.get_total_counts() != sum(coll["counts"].values()):
            raise RuntimeError(f"CommDebugMode counted "
                               f"{comm.get_total_counts()} collectives, the "
                               f"cost mode {coll['counts']}")
    arg_keys = {_key(t) for t in _tensors(args)}
    output = _storage_bytes([t for t in _tensors(out)
                             if _key(t) not in arg_keys])
    mem = dict(argument=argument, output=output,
               temp=mode.peak - argument - output, peak=mode.peak)
    return float(mode.flops), float(mode.hbm_bytes), coll, mem


def _depth_probe_points(cfg) -> tuple[int, int, int]:
    """(L1, L2, n_units): probe depths + how many delta-units the full model
    holds. Hybrids probe one/two periods; enc-dec scale together."""
    if cfg.family == "hybrid" and cfg.hybrid_period:
        p = cfg.hybrid_period
        return p, 2 * p, cfg.num_layers // p
    return 1, 2, cfg.num_layers


def _bundle(cfg, shape, **kw):
    from repro_torch.distribution.steps import make_step_for_cell

    return make_step_for_cell(cfg, shape, device="meta", **kw)


def _ext_coll(c1: dict, c2: dict, ext) -> dict:
    coll = {k: ext(c1[k], c2[k]) for k in _COLLECTIVES}
    coll["counts"] = {k: ext(c1["counts"][k], c2["counts"][k])
                      for k in _COLLECTIVES}
    if "by_axis" in c1:
        axes = list(dict.fromkeys(list(c1["by_axis"]) + list(c2["by_axis"])))
        coll["by_axis"] = {a: ext(c1["by_axis"].get(a, 0),
                                  c2["by_axis"].get(a, 0)) for a in axes}
    return coll


def layer_delta_costs(cfg, shape, **step_kw) -> dict:
    """Whole-model costs extrapolated from 1-unit vs 2-unit probes at full
    width: FLOPs, bytes, and the output / temp / peak memory; the argument
    bytes are the full depth's, summed from its argument specs."""
    L1, L2, n_units = _depth_probe_points(cfg)

    def probe(n_layers):
        over = dict(num_layers=n_layers)
        if cfg.encoder_layers:
            over["encoder_layers"] = n_layers
        return _cost_triple(_bundle(dataclasses.replace(cfg, **over), shape,
                                    **step_kw), step_kw.get("mesh"))

    f1, b1, c1, m1 = probe(L1)
    f2, b2, c2, m2 = probe(L2)
    scale = n_units - 1
    ext = lambda a, b: a + scale * (b - a)  # noqa: E731
    coll = _ext_coll(c1, c2, ext)
    argument = _storage_bytes(_bundle(cfg, shape, **step_kw).arg_specs)
    output, temp = ext(m1["output"], m2["output"]), ext(m1["temp"], m2["temp"])
    mem = dict(argument=argument, output=output, temp=temp,
               peak=argument + output + temp)
    return dict(flops=ext(f1, f2), hbm_bytes=ext(b1, b2), collectives=coll,
                memory=mem,
                probe=dict(L1=L1, L2=L2, n_units=n_units,
                           f1=f1, f2=f2, b1=b1, b2=b2,
                           peak1=m1["peak"], peak2=m2["peak"]))


def cell_costs(cfg, shape, *, accum: int = 1, roofline: bool = True,
               mesh=None, ep: bool = False, fsdp: bool = True) -> dict:
    """One cell's costs and roofline terms, per device: the record of
    ``run_cell`` from ``status`` on, for a config and shape given
    directly, on one device or over ``mesh`` (a ``DeviceMesh``; ``ep`` and
    ``fsdp=False`` as the steps take them; ``fsdp`` applies to inference
    cells only, as in the reference). ``compile_s`` is the wall of the
    meta-device passes (nothing is compiled)."""
    from repro_torch.distribution.sharding import axis_sizes

    kw = {"accum_steps": accum} if accum > 1 else {}
    if mesh is not None:
        kw["mesh"] = mesh
        if ep:
            kw["ep"] = True
        if not fsdp and shape.kind != "train":
            kw["fsdp"] = False
    t0 = time.perf_counter()
    if roofline:
        delta = layer_delta_costs(cfg, shape, **kw)
    else:
        f, b, c, m = _cost_triple(_bundle(cfg, shape, **kw), mesh)
        delta = dict(flops=f, hbm_bytes=b, collectives=c, memory=m,
                     probe=None)
    dt = time.perf_counter() - t0
    coll, flops, hbm_bytes = (delta["collectives"], delta["flops"],
                              delta["hbm_bytes"])
    sizes = axis_sizes(mesh) if mesh is not None else {}
    chips = 1
    for n in sizes.values():
        chips *= n
    terms = roofline_terms(flops, hbm_bytes, coll, chips, axis_rates(sizes))
    mflops = model_flops(cfg, shape)
    peak_step = max(terms["t_compute_s"], terms["t_memory_s"],
                    terms["t_collective_s"])
    return dict(
        status="ok",
        chips=chips,
        compile_s=round(dt, 1),
        flops=flops,
        hbm_bytes=hbm_bytes,
        model_flops=mflops,
        useful_ratio=(mflops / (flops * chips)) if flops else 0.0,
        mfu_bound=mflops / (chips * PEAK_FLOPS) / peak_step if peak_step else 0.0,
        bytes_per_device=delta["memory"],
        collectives=coll,
        probe=delta["probe"],
        **terms,
    )


def run_cell(arch: str, shape_name: str, out_dir: Path, *, mesh=None,
             ep: bool = False, accum: int = 1, save: bool = True,
             roofline: bool = True, overrides: dict | None = None,
             fsdp: bool = True) -> dict:
    """The reference's record of one (arch × shape) cell: ``cell_costs``
    of the config, with ``overrides`` (attn_chunk, remat, dtype, ...)
    applied, on one device (``mesh`` None: ``"1x1"``, ``chips`` 1) or over
    a ``DeviceMesh`` in the calling process's group (``run_mesh_cells``
    runs the production meshes in a child). ``ep`` needs a mesh;
    ``fsdp`` (the reference's TP-only inference layout when False) has
    no effect on one device."""
    from repro_torch import configs
    from repro_torch.launch.mesh import Mesh, mesh_name

    if ep and mesh is None:
        raise ValueError("--ep shards the experts over a mesh's model "
                         "axis; one device has none")
    cfg = configs.get(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = configs.SHAPES[shape_name]
    ok, why = configs.shape_applicable(cfg, shape)
    name = mesh_name(mesh if mesh is not None else Mesh((1, 1),
                                                        ("data", "model")))
    rec = dict(arch=arch, shape=shape_name, mesh=name, status="skip",
               why=why)
    if not ok:
        return rec
    rec.update(cell_costs(cfg, shape, accum=accum, roofline=roofline,
                          mesh=mesh, ep=ep, fsdp=fsdp))
    if save:
        out_dir.mkdir(parents=True, exist_ok=True)
        tag = "__".join((configs.canonical(arch), shape_name, name))
        (out_dir / f"{tag}.json").write_text(json.dumps(rec, indent=2))
    return rec


def _mesh_child(sizes, names, jobs, q) -> None:
    """A child's work (``run_mesh_cells``): join a ``fake`` group of
    prod(sizes) ranks as rank 0, build the mesh, run each job's cell and
    put ``(index, record or the error's text)`` on ``q``."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import device_mesh

    n = 1
    for k in sizes:
        n *= k
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        mesh = device_mesh(tuple(sizes), tuple(names))
        for i, (fn, args, kw) in enumerate(jobs):
            try:
                q.put((i, fn(*args, mesh=mesh, **kw)))
            except Exception:  # reported to the caller, cell by cell
                q.put((i, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def run_mesh_cells(sizes: tuple, names: tuple, jobs: list,
                   timeout_s: float = 3600.0) -> list:
    """Run ``jobs`` — ``(fn, args, kwargs)``, each called as
    ``fn(*args, mesh=mesh, **kwargs)`` — in ONE child process on a
    ``fake`` process group of a ``sizes`` mesh named ``names``; returns
    their results in order (a failed job's traceback text in its place).
    The caller keeps no process group."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    proc = ctx.Process(target=_mesh_child,
                       args=(tuple(sizes), tuple(names), jobs, q))
    proc.start()
    out = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) < len(jobs) and time.monotonic() < deadline:
            try:
                i, res = q.get(timeout=1.0)
                out[i] = res
            except queue.Empty:
                if proc.exitcode is not None:
                    break
    finally:
        proc.join(10 if len(out) == len(jobs) else 0)
        if proc.is_alive():
            proc.kill()
            proc.join()
    return [out.get(i, f"the mesh child ended (exit {proc.exitcode}) "
                       "before this cell") for i in range(len(jobs))]


def _print_record(tag: str, rec: dict) -> None:
    mem = rec["bytes_per_device"]
    coll = rec["collectives"]
    by_kind = "  ".join(f"{k} {coll[k] / 1e9:.3f}GB" for k in _COLLECTIVES
                        if coll[k])
    print(
        f"[ ok ] {tag}: passes {rec['compile_s']}s  "
        f"flops {rec['flops']:.4g}  bytes {rec['hbm_bytes']:.4g}  "
        f"args {mem['argument'] / 1e9:.3f} GB  "
        f"peak {mem['peak'] / 1e9:.3f} GB  "
        f"t_comp {rec['t_compute_s']*1e3:.3f}ms  "
        f"t_mem {rec['t_memory_s']*1e3:.3f}ms  "
        f"t_coll {rec['t_collective_s']*1e3:.3f}ms  "
        f"dom={rec['dominant']}  useful={rec['useful_ratio']:.3f}"
        + (f"  coll: {by_kind}" if by_kind else ""),
        flush=True,
    )


def main(argv=None):
    from repro_torch import configs
    from repro_torch.launch.mesh import PRODUCTION, Mesh

    ap = argparse.ArgumentParser(description="dry-run on the meta device")
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="local",
                    choices=["local", "single", "multi", "both"],
                    help="local: one device; single: 16x16; multi: "
                         "2x16x16; both: the two production meshes")
    ap.add_argument("--ep", action="store_true", help="expert-parallel MoE layout")
    ap.add_argument("--accum", type=int, default=1, help="grad-accum microbatches")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)
    if args.ep and args.mesh == "local":
        print("dry-run: --ep shards the experts over a production mesh's "
              "model axis; give --mesh single|multi|both", file=sys.stderr,
              flush=True)
        return 2

    archs = list(configs.ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = list(configs.SHAPES) if args.shape == "all" else [args.shape]
    out_dir = Path(args.out)
    meshes = {"local": [None], "single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    n_ok = n_skip = n_fail = 0
    for multi in meshes:
        cells = [(a, s) for a in archs for s in shapes]
        if multi is None:
            name = "1x1"
            results = []
            for arch, shape in cells:
                try:
                    results.append(run_cell(arch, shape, out_dir,
                                            accum=args.accum))
                except Exception:  # a dry-run failure is a bug in the system
                    results.append(traceback.format_exc())
        else:
            sizes, names = PRODUCTION[multi]
            name = Mesh(sizes, names).name
            # roofline probes are single-pod only, as in the reference; the
            # multi-pod pass proves the "pod" axis shards and fits
            jobs = [(run_cell, (arch, shape, out_dir),
                     dict(ep=args.ep, accum=args.accum, roofline=not multi))
                    for arch, shape in cells]
            results = run_mesh_cells(sizes, names, jobs)
        for (arch, shape), rec in zip(cells, results):
            tag = f"{arch} × {shape} × {name}"
            if isinstance(rec, str):
                n_fail += 1
                print(f"[FAIL] {tag}:\n{rec}", flush=True)
            elif rec["status"] == "skip":
                n_skip += 1
                print(f"[skip] {tag}: {rec['why']}", flush=True)
            else:
                n_ok += 1
                _print_record(tag, rec)
    print(f"\ndry-run: {n_ok} ok, {n_skip} skip, {n_fail} FAIL", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
