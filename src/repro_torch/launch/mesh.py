"""Device meshes: the production shapes, and a local mesh for one host.

Functions, not module-level constants: importing this module touches no
device and no process group.  Single pod: 16 x 16 = 256 ranks
``(data, model)``; multi-pod: 2 x 16 x 16 = 512 ranks with a pure
data-parallel ``pod`` axis outermost, as in the JAX package.

The sharding rules (:mod:`repro_torch.distributed.sharding`) resolve on
axis names and sizes alone, so they take an :class:`AbstractMesh` (no
devices, no process group) as well as a ``DeviceMesh``.  A ``DeviceMesh``
needs the default process group to be initialized with one rank per mesh
element, by the caller (``torch.distributed.init_process_group``: its
address, world size and rank).  On one card only the 1 x 1 mesh is real;
the production meshes exist off a cluster only under PyTorch's fake
process group (``torch.testing._internal.distributed.fake_pg``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

from ..device import DeviceLike, resolve_device


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, without devices."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of an :class:`AbstractMesh` or a
    ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The production mesh's axes: 16 x 16 ``(data, model)``, or
    2 x 16 x 16 ``(pod, data, model)``."""
    if multi_pod:
        return AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    return AbstractMesh(("data", "model"), (16, 16))


def _device_mesh(device_type: str, mesh: AbstractMesh):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, mesh.axis_sizes,
                            mesh_dim_names=mesh.axis_names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production mesh as a ``DeviceMesh``: the default process group
    must hold 256 (or 512) ranks, which off a cluster means the fake
    backend."""
    return _device_mesh(device_type, production_mesh(multi_pod=multi_pod))


def make_local_mesh(data: int = 1, model: int = 1,
                    device: DeviceLike = None):
    """A ``(data, model)`` ``DeviceMesh`` over the default process group's
    ``data * model`` ranks, on the card unless ``device`` is ``"cpu"``
    (then over gloo)."""
    dev = resolve_device(device)
    return _device_mesh(dev.type, AbstractMesh(("data", "model"),
                                               (data, model)))
