"""Logical-axis -> mesh-axis rules, partition specs and placements.

The rules are the reference's (t5x / MaxText style), with the same dedup
and divisibility filter: ``embed``-type weight dims go over ``data``
(FSDP), heads / mlp / vocab / experts over ``model``, the activations'
batch over ``data`` (``("pod", "data")`` in the multi-pod regime).  A
``PartitionSpec`` is data: a tuple with one entry per dimension, each an
axis name, a tuple of them or ``None``; ``spec_to_pspec`` and ``make_pspecs``
(``models/params.py``), ``ShardingPolicy.spec`` and ``lm.cache_pspecs``
give the same tuples as the reference.

What the mesh changes here.  The reference runs its model under GSPMD,
where a sharding is a layout constraint and does not change values; its
dense layers have no tensor-parallel code.  Values change in two places
only: the MoE layer's ``shard_map`` (each shard's capacity and its local
load-balance loss, averaged over the shards) and the data axis (the batch
is split; the gradient is still that of the one global loss).  So the
port computes the dense layers once per data shard, on that shard's
first device, and the ``model`` axis carries only the experts
(``models/moe.py``).  The model functions take the policy (``pol=``) for
that layer alone; ``ShardingPolicy.shard`` is therefore not called inside
them.

A placement (``device_put(x, NamedSharding(mesh, spec))``, the counterpart
of ``jax.device_put``) is a :class:`ShardedTensor`: the sharding and each
mesh coordinate's block on that coordinate's device.  Blocks on one
device are views of a single copy there, so a mesh that repeats
``cuda:0`` holds a tensor once.  ``full()`` puts the blocks back together
on the lead device.  Every step is a tensor op, so gradients flow through
a placement and back.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.runtime.compat import Mesh


def base_rules(multi_pod: bool) -> dict[str, Any]:
    batch = ("pod", "data") if multi_pod else ("data",)
    return {
        # weights
        "layers": None,
        "stack": None,
        "vocab": "model",
        "embed": "data",
        "heads": "model",
        "kv_heads": "model",
        "ssm_heads": "model",
        "mlp": "model",
        "experts": "model",
        "expert_in": "data",
        "expert_mlp": None,
        "head_dim": None,
        "norm": None,
        "conv": None,
        "state": None,
        "dt": "model",
        # activations
        "act_batch": batch,
        "act_seq": None,
        "act_heads": "model",
        "act_kv_heads": "model",
        "act_embed": None,
        "act_vocab": "model",
        "act_ff": "model",
        # kv / ssm cache (defaults; overridden per shape)
        "cache_batch": batch,
        "cache_kv": "model",
        "cache_seq": None,
    }


class PartitionSpec(tuple):
    """One entry per dimension: a mesh axis name, a tuple of them (the
    first the major one) or ``None`` (replicated); missing trailing
    entries are ``None``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def resolve(rules: dict, logical, shape=None, axis_sizes: dict[str, int] | None = None) -> PartitionSpec:
    """The reference's mapping of logical axes to mesh axes: a mesh axis
    is used at most once per spec, and with ``axis_sizes`` (and ``shape``)
    a mesh axis that does not divide its dimension is dropped."""
    used: set[str] = set()
    entries = []
    for d, ax in enumerate(logical):
        m = rules.get(ax) if ax is not None else None
        if m is None:
            entries.append(None)
            continue
        free = []
        fac = 1
        for a in ((m,) if isinstance(m, str) else tuple(m)):
            if a in used:
                continue
            if shape is not None and axis_sizes:
                sz = axis_sizes.get(a, 1)
                if shape[d] % (fac * sz) != 0:
                    continue
                fac *= sz
            free.append(a)
        if not free:
            entries.append(None)
            continue
        used.update(free)
        entries.append(tuple(free) if len(free) > 1 else free[0])
    return PartitionSpec(*entries)


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: Mesh
    spec: PartitionSpec

    def blocks_along(self, ndim: int) -> list[int]:
        """How many blocks each of ``ndim`` dimensions is cut into."""
        spec = self._entries(ndim)
        return [math.prod(self.mesh.shape[a] for a in entry_axes(e)) for e in spec]

    def block_index(self, coord, ndim: int) -> tuple[int, ...]:
        """The block (one index per dimension) that coordinate ``coord`` holds."""
        pos = dict(zip(self.mesh.axis_names, coord))
        out = []
        for e in self._entries(ndim):
            i = 0
            for a in entry_axes(e):
                i = i * self.mesh.shape[a] + pos[a]
            out.append(i)
        return tuple(out)

    def _entries(self, ndim: int) -> tuple:
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} has more entries than the {ndim} dims")
        for a in (a for e in self.spec for a in entry_axes(e)):
            if a not in self.mesh.shape:
                raise ValueError(f"spec {self.spec} names axis {a!r}, not one of the mesh's {self.mesh.axis_names}")
        return tuple(self.spec) + (None,) * (ndim - len(self.spec))


@dataclasses.dataclass(frozen=True)
class ShardedTensor:
    """A tensor placed on a mesh: ``blocks[i]`` is the block of the i-th
    coordinate in ``mesh.coords()`` order, on that coordinate's device."""

    sharding: NamedSharding
    shape: tuple[int, ...]
    blocks: tuple[torch.Tensor, ...]

    def block(self, coord) -> torch.Tensor:
        return self.blocks[self.sharding.mesh.index(coord)]

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default the mesh's lead), from the
        first coordinate that holds each block."""
        return assemble(self.sharding, zip(self.sharding.mesh.coords(), self.blocks), device)


def assemble(sharding: NamedSharding, coord_blocks, device=None) -> torch.Tensor:
    """The tensor whose blocks under ``sharding`` are given as ``(coord,
    block)`` pairs, put together on ``device`` (default the mesh's lead);
    the first pair for each block is taken.  The gather at the end of a
    shard map."""
    device = sharding.mesh.lead if device is None else torch.device(device)
    grid: dict[tuple, torch.Tensor] = {}
    ndim = None
    for coord, blk in coord_blocks:
        ndim = blk.ndim
        grid.setdefault(sharding.block_index(coord, ndim), blk)
    counts = sharding.blocks_along(ndim)

    def cat(prefix: tuple, d: int) -> torch.Tensor:
        if d == ndim:
            return grid[prefix].to(device)
        parts = [cat(prefix + (i,), d + 1) for i in range(counts[d])]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=d)

    return cat((), 0)


def device_put(x, sharding: NamedSharding) -> ShardedTensor:
    """``x`` (a tensor, array or ``ShardedTensor``) placed per ``sharding``:
    each coordinate's block on its device, a view of one copy per device.
    Raises where a dimension does not divide into its blocks."""
    if isinstance(x, ShardedTensor):
        x = x.full()
    x = torch.as_tensor(x)
    mesh = sharding.mesh
    counts = sharding.blocks_along(x.ndim)
    for d, n in enumerate(counts):
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of size {x.shape[d]} does not split into {n} blocks ({sharding.spec})")
    copies: dict[torch.device, torch.Tensor] = {}
    blocks = []
    for coord in mesh.coords():
        dev = mesh.device(coord)
        if dev not in copies:
            copies[dev] = x.to(dev)
        blk = copies[dev]
        for d, (i, n) in enumerate(zip(sharding.block_index(coord, x.ndim), counts)):
            if n > 1:
                step = x.shape[d] // n
                blk = blk.narrow(d, i * step, step)
        blocks.append(blk)
    return ShardedTensor(sharding, tuple(x.shape), tuple(blocks))


@dataclasses.dataclass
class ShardingPolicy:
    """Resolved rules for one (arch, shape, mesh) cell."""

    rules: dict[str, Any]
    mesh: Mesh | None = None

    def spec(self, *axes: str | None, shape: tuple | None = None) -> PartitionSpec:
        sizes = dict(self.mesh.shape) if self.mesh is not None else {}
        return resolve(self.rules, axes, shape, sizes)

    def shard(self, x, *axes: str | None):
        """``x`` placed per the rules for its logical ``axes`` when a mesh is
        set (a ``ShardedTensor``), else ``x``.  The reference's layout
        constraint; the port's model functions do not call it."""
        if self.mesh is None:
            return x
        return device_put(x, NamedSharding(self.mesh, self.spec(*axes, shape=tuple(x.shape))))


def make_policy(
    mesh: Mesh | None,
    *,
    multi_pod: bool = False,
    shape_kind: str = "train",
    global_batch: int = 0,
    seq_len: int = 0,
    long_context: bool = False,
) -> ShardingPolicy:
    rules = base_rules(multi_pod)
    if mesh is not None:
        dp = 1
        for ax in ("pod", "data"):
            if ax in mesh.shape:
                dp *= mesh.shape[ax]
        # batch too small to shard over the full DP extent -> keep replicated
        if global_batch and global_batch < dp:
            rules["act_batch"] = None
            rules["cache_batch"] = None
            if long_context or seq_len >= 1 << 17:
                # long-context decode: shard the KV cache over `data` instead
                rules["cache_seq"] = "data"
                rules["act_seq"] = "data"
    return ShardingPolicy(rules=rules, mesh=mesh)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def data_shards(pol: ShardingPolicy, batch_size: int) -> list[tuple[tuple, ShardingPolicy]]:
    """The data shards of a batch of ``batch_size`` rows under ``pol``: per
    shard, the coordinate of its first device and the policy it runs its
    rows under (the mesh with every axis but ``model`` held at the shard's
    coordinate).  When the rules leave the batch whole (``act_batch``
    replicated, or the batch not divisible), one shard: the lead, under
    ``pol`` itself."""
    mesh = pol.mesh
    spec = pol.spec("act_batch", shape=(batch_size,))
    lead = (0,) * len(mesh.axis_names)
    if spec[0] is None:
        return [(lead, pol)]
    out = []
    for coord in mesh.coords():
        if any(c for a, c in zip(mesh.axis_names, coord) if a not in entry_axes(spec[0])):
            continue  # a replica of a block over the other axes
        fixed = {a: c for a, c in zip(mesh.axis_names, coord) if a != "model"}
        out.append((coord, ShardingPolicy(rules=pol.rules, mesh=mesh.submesh(**fixed))))
    return out

