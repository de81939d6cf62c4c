"""Production and smoke meshes (the reference's ``launch/mesh.py``).

Functions, never module-level constants, so importing this module queries
no device.  ``make_production_mesh`` asks for the reference's 16 x 16 (or
2 x 16 x 16) device mesh and raises where fewer CUDA devices are visible,
as the reference raises outside its 512-device dry run.
``make_smoke_mesh`` takes the first visible CUDA devices, or, given
``device``, repeats that one device at every coordinate (how one card
stands in for a mesh).
"""
from __future__ import annotations

import math

import torch

from repro_torch.runtime.compat import Mesh, make_mesh, make_topology_mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        raise RuntimeError(f"mesh {shape} needs {need} devices but only {have} present")
    if have == need:
        return make_topology_mesh(shape, axes)
    return make_mesh([f"cuda:{i}" for i in range(need)], axes, shape=shape)


def make_smoke_mesh(shape=(1, 1), axes=("data", "model"), device=None) -> Mesh:
    if device is not None:
        return make_mesh([device] * math.prod(shape), axes, shape=shape)
    return make_topology_mesh(shape, axes)
