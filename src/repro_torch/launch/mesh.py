"""Production and local meshes: the port of ``repro.launch.mesh``.

Functions, not module-level constants, as in the reference: importing this
module touches no device state. ``make_production_mesh`` and
``make_local_mesh`` return ``torch.distributed`` ``DeviceMesh``es over the
process group in place, with the reference's axis names and sizes; the
group's world size must be the mesh's device count. The mesh's device type
follows the group's backend: ``cuda`` under NCCL (a card a rank), ``cpu``
under gloo and under the ``fake`` group the dry-run traces production
meshes on. ``Mesh`` describes a mesh without a process group (the axis
sizes and names, with the ``.shape`` mapping of ``jax.sharding.Mesh``,
which ``distribution.sharding``'s rules read as they read a
``DeviceMesh``); ``mesh_name`` is the dry-run's file tag of either.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

#: the reference's meshes: 16x16 = 256 chips a pod, 2 pods = 512
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


@dataclass(frozen=True)
class Mesh:
    """Axis sizes and names of a device mesh, outermost axis first."""
    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{len(self.axis_sizes)} axis sizes for "
                             f"{len(self.axis_names)} axis names")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in axis order (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def device_count(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def name(self) -> str:
        return mesh_name(self)


def mesh_name(mesh) -> str:
    """``"16x16"``, ``"2x16x16"``, ``"1x1"``: the axis sizes of a
    ``DeviceMesh`` or a ``Mesh``, outermost first (the dry-run's file
    tag)."""
    sizes = mesh.axis_sizes if isinstance(mesh, Mesh) else tuple(
        mesh.size(i) for i in range(mesh.ndim))
    return "x".join(str(s) for s in sizes)


def device_mesh(sizes: tuple[int, ...], names: tuple[str, ...]):
    """A ``DeviceMesh`` of ``sizes`` over the initialised process group,
    ranks in row-major order; raises unless the group's world size is
    the product of the sizes."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = math.prod(sizes)
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(f"a {mesh_name(Mesh(sizes, names))} mesh needs "
                           f"an initialised process group of {n} ranks")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"a {mesh_name(Mesh(sizes, names))} mesh needs a "
                         f"world of {n} ranks, not {world}")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, tuple(sizes), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 ("data", "model") = 256 devices; 2x16x16 ("pod", "data",
    "model") = 512 when ``multi_pod``."""
    return device_mesh(*PRODUCTION[multi_pod])


def make_local_mesh(data: int = 1, model: int = 1):
    """A small ("data", "model") mesh (tests, the train launcher)."""
    return device_mesh((data, model), ("data", "model"))
