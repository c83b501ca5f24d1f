"""The production mesh's shape, without its devices.

The port's counterpart of ``repro/launch/mesh.py``. The reference builds a
``jax.sharding.Mesh`` of 256 chips (16 × 16, a v5e pod) or 512 (two pods,
a leading ``pod`` axis), and the dry-run lowers onto it. One card holds no
such mesh, so the port keeps its shape alone: the axis names and sizes,
over which the sharding rules (``launch/shardings.py``) and the plan
arithmetic of ``launch/dryrun.py`` are computed exactly as the reference
computes them. The ``pod`` axis extends the vertical layer: work sharded
along it never communicates during SpMV or forward-backward.
"""
from __future__ import annotations

import math

__all__ = ["production_mesh_shape", "mesh_size", "mesh_label"]


def production_mesh_shape(multi_pod: bool = False) -> dict[str, int]:
    """``{axis: size}`` in the mesh's axis order: ``data`` × ``model`` =
    16 × 16, or ``pod`` × ``data`` × ``model`` = 2 × 16 × 16."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def mesh_size(mesh_shape: dict[str, int]) -> int:
    """The chips of the mesh."""
    return math.prod(mesh_shape.values())


def mesh_label(mesh_shape: dict[str, int]) -> str:
    """``16x16`` or ``2x16x16``, as the reference's records name a mesh."""
    return "x".join(str(n) for n in mesh_shape.values())
