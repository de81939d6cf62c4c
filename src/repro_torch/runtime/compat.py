"""Device meshes for the port's sharded paths.

The reference builds its meshes here (``make_mesh`` over an array of JAX
devices) and runs each sharded body under ``shard_map``.  The port keeps
that single-controller structure in one process: a :class:`Mesh` is one
named axis over a list of ``torch.device``s, and a sharded function is a
Python loop over ``mesh.devices`` that hands each shard its own tensors.
A device may repeat, so four shards may all lie on ``cuda:0`` or on
``cpu`` (the reference's fake host devices play that part).  A collective
is ``gather``: every shard's tensor onto the lead device, in shard order,
where the caller reduces them in that order, so a combine is
deterministic; ``split`` hands each shard its slice of a tensor.

``shard_map`` and ``axis_size`` have no counterpart here: the loop over
``mesh.devices`` is the shard map, and ``mesh.size`` the axis size.
Meshes of more than one axis (the reference's ``("data", "model")``) and
``make_topology_mesh`` come with the sharded training slice.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One named axis over ``devices``; ``devices[0]`` is the lead device,
    where everything outside a sharded function runs."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis_names[0]: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        return self.devices[0]


def make_mesh(devices, axis_names=("data",)) -> Mesh:
    """A one-axis mesh over ``devices`` (``torch.device``s or their names,
    repeats allowed)."""
    axis_names = tuple(axis_names)
    if len(axis_names) != 1:
        raise NotImplementedError(f"make_mesh: one mesh axis is ported, not {axis_names}")
    devs = tuple(torch.device(d) for d in devices)
    if not devs:
        raise ValueError("make_mesh: no devices")
    return Mesh(devs, axis_names)


def gather(tensors, device) -> list[torch.Tensor]:
    """Each shard's tensor on ``device``, in shard order (a tensor already
    there is passed through, not copied)."""
    return [t.to(device) for t in tensors]


def split(x, mesh: Mesh, dim: int) -> list[torch.Tensor]:
    """``x`` cut along ``dim`` into ``mesh.size`` equal slices, each on its
    shard's device (a view where the device is ``x``'s), or ``x`` as given
    when it is already the list of those slices.  Raises on an uneven
    split."""
    if isinstance(x, (list, tuple)):
        if len(x) != mesh.size or len({t.shape[dim] for t in x}) != 1:
            raise ValueError(f"{len(x)} slices for {mesh.size} shards, or of unequal lengths along dim {dim}")
        return list(x)
    if x.shape[dim] % mesh.size:
        raise ValueError(f"size {x.shape[dim]} along dim {dim} does not split over {mesh.size} shards")
    return [t.to(d) for t, d in zip(torch.chunk(x, mesh.size, dim=dim), mesh.devices)]
