"""Production mesh definition (counterpart of ``repro/launch/mesh.py``): a
function, so importing it creates nothing.  The meshes are virtual
(``dist/mesh.py``): building one allocates no memory; a block is made only
when a tensor is cut onto it."""
from __future__ import annotations

from ..dist.mesh import VirtualMesh

__all__ = ["make_production_mesh", "data_axes", "SINGLE_POD_SHAPE",
           "MULTI_POD_SHAPE"]

SINGLE_POD_SHAPE = (16, 16)            # 256 chips: ("data", "model")
MULTI_POD_SHAPE = (2, 16, 16)          # 512 chips: ("pod", "data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> VirtualMesh:
    shape = MULTI_POD_SHAPE if multi_pod else SINGLE_POD_SHAPE
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return VirtualMesh(shape, axes, device)


def data_axes(multi_pod: bool):
    return ("pod", "data") if multi_pod else ("data",)
