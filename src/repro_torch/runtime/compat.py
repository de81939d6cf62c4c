"""Device meshes for the port's sharded paths.

The reference builds its meshes here (``make_mesh`` over an array of JAX
devices, ``make_topology_mesh`` over the visible ones) and runs each
sharded body under ``shard_map``.  The port keeps that single-controller
structure in one process: a :class:`Mesh` is a grid of ``torch.device``s
with one name per axis, and a sharded function is a Python loop over the
mesh's coordinates that hands each its own tensors.  A device may repeat,
so a ``("data", "model")`` mesh of 2 x 4 may hold ``cuda:0`` eight times,
or ``cpu`` (the reference's fake host devices play that part).  A
collective is ``gather``: every shard's tensor onto one device, in shard
order, where the caller reduces them in that order, so a combine is
deterministic; ``split`` hands each shard of a one-axis mesh its slice of
a tensor.  Under a cost counter (``counter``: ``launch/roofline.py``'s
``CostCounter``) each call records one collective of the reference's
kind (``all-gather``, ``all-reduce``, ...) and the bytes it moves, the
counterpart of the collectives the reference's roofline read from HLO.

``shard_map`` and ``axis_size`` have no counterpart here: the loop over
the coordinates is the shard map, and ``mesh.shape[axis]`` the axis size.
"""
from __future__ import annotations

import dataclasses
import itertools
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A grid of devices: ``devices`` in row-major order over axes
    ``axis_names`` of sizes ``dims``.  ``devices[0]`` is the lead device,
    where everything outside a sharded function runs."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...]
    dims: tuple[int, ...]

    def __post_init__(self):
        if len(self.dims) != len(self.axis_names) or math.prod(self.dims) != len(self.devices):
            raise ValueError(f"mesh of {len(self.devices)} devices does not fill axes {self.axis_names} "
                             f"of sizes {self.dims}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"mesh axis names repeat: {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in axis order (the reference's ``mesh.shape``)."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    def coords(self):
        """Every coordinate (one index per axis), in row-major order: the
        order of ``devices``."""
        return itertools.product(*(range(n) for n in self.dims))

    def index(self, coord) -> int:
        """The row-major position of ``coord`` in ``devices``."""
        flat = 0
        for c, n in zip(coord, self.dims):
            flat = flat * n + c
        return flat

    def device(self, coord) -> torch.device:
        return self.devices[self.index(coord)]

    def axis_devices(self, axis: str, **at: int) -> tuple[torch.device, ...]:
        """The devices along ``axis``, every other axis held at its
        coordinate in ``at`` (0 where not given)."""
        a = self.axis_names.index(axis)
        base = [at.get(name, 0) for name in self.axis_names]
        return tuple(self.device(base[:a] + [i] + base[a + 1:]) for i in range(self.dims[a]))

    def submesh(self, **at: int) -> "Mesh":
        """The mesh with each axis named in ``at`` held at that coordinate:
        the same axis names, those axes of size 1."""
        ranges = [range(at[n], at[n] + 1) if n in at else range(d) for n, d in zip(self.axis_names, self.dims)]
        return Mesh(tuple(self.device(c) for c in itertools.product(*ranges)), self.axis_names,
                    tuple(len(r) for r in ranges))


def make_mesh(devices, axis_names=("data",), shape=None) -> Mesh:
    """A mesh over ``devices`` (``torch.device``s or their names, repeats
    allowed): a nested list (or array) whose nesting gives the axes, as
    the reference's ``np.asarray(devices)`` does, or a flat list reshaped
    to ``shape`` (a flat list needs no ``shape`` for one axis)."""
    axis_names = tuple(axis_names)
    arr = np.empty(0, dtype=object)
    if len(devices):
        arr = np.asarray(devices, dtype=object)
    if shape is not None:
        arr = arr.reshape(tuple(shape))
    if arr.size == 0:
        raise ValueError("make_mesh: no devices")
    if arr.ndim != len(axis_names):
        raise ValueError(f"make_mesh: devices of shape {arr.shape} for axes {axis_names}")
    return Mesh(tuple(torch.device(d) for d in arr.reshape(-1)), axis_names, tuple(arr.shape))


def make_topology_mesh(shape, axes) -> Mesh:
    """A mesh of ``shape`` over the visible CUDA devices in enumeration
    order (the reference's ``jax.make_mesh``).  Raises when there are fewer
    than it needs; a mesh that repeats a device is built only through an
    explicit ``make_mesh`` list."""
    need = math.prod(shape)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        raise RuntimeError(f"mesh {tuple(shape)} needs {need} CUDA devices but only {have} are visible; "
                           "repeat a device through make_mesh to stand in for more")
    return make_mesh([f"cuda:{i}" for i in range(need)], axes, shape=shape)


def counter():
    """The innermost cost counter active on this thread (a dispatch mode
    with ``record_collective``, ``launch/roofline.py``'s ``CostCounter``),
    or None.  It is looked up on torch's own mode stack, so nothing here
    holds it."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    for mode in reversed(_get_current_dispatch_mode_stack()):
        if hasattr(mode, "record_collective"):
            return mode
    return None


def gather(tensors, device, kind: str = "all-gather") -> list[torch.Tensor]:
    """Each shard's tensor on ``device`` (one device, or a list of one per
    tensor), in shard order (a tensor already there is passed through, not
    copied).  ``kind`` names the collective the caller's reduction over the
    gathered tensors stands for (``all-reduce``, ``reduce-scatter``,
    ``all-to-all``), which a cost counter records with the tensors' bytes."""
    tensors = list(tensors)
    if (c := counter()) is not None:
        c.record_collective(kind, tensors)
    devices = device if isinstance(device, (list, tuple)) else [device] * len(tensors)
    return [t.to(d) for t, d in zip(tensors, devices)]


def split(x, mesh: Mesh, dim: int) -> list[torch.Tensor]:
    """``x`` cut along ``dim`` into ``mesh.size`` equal slices, each on its
    shard's device (a view where the device is ``x``'s), or ``x`` as given
    when it is already the list of those slices.  Raises on an uneven
    split.  A cost counter records the cut as one ``all-to-all`` of the
    slices' bytes."""
    if isinstance(x, (list, tuple)):
        if len(x) != mesh.size or len({t.shape[dim] for t in x}) != 1:
            raise ValueError(f"{len(x)} slices for {mesh.size} shards, or of unequal lengths along dim {dim}")
        return list(x)
    if x.shape[dim] % mesh.size:
        raise ValueError(f"size {x.shape[dim]} along dim {dim} does not split over {mesh.size} shards")
    return gather(torch.chunk(x, mesh.size, dim=dim), list(mesh.devices), "all-to-all")
