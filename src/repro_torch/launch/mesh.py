"""Production and local mesh descriptions: the port of ``repro.launch.mesh``.

Functions, not module-level constants, as in the reference: importing this
module touches no device state. Until the LM mesh is ported (ROADMAP
queue 1, item 7.2) these are no ``DeviceMesh``es: each function returns a
frozen ``Mesh`` that names the axes and their sizes, with the ``.shape``
mapping of ``jax.sharding.Mesh`` (which ``distribution.sharding``'s rules
read). The port's steps accept a
mesh of one device as the same thing as ``mesh=None``; any larger mesh
raises.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


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
        """``"16x16"``, ``"2x16x16"``, ``"1x1"``: the dry-run's file tag."""
        return "x".join(str(s) for s in self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 chips per pod; 2 pods = 512 chips when multi_pod."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def make_local_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A small ("data", "model") mesh (tests, one card)."""
    return Mesh((data, model), ("data", "model"))
