"""Distributed flash-decode: one-token attention over a KV cache whose
sequence dim is split over a mesh's shards.

Each shard computes the ``(o, m, l)`` softmax partials of its slice
through ``kernels/decode_attention``'s flash-decode kernel (its plain
version on the CPU), and ``combine_partials`` merges them on the lead
device into the exact global attention.

``combine_partials`` is the one cross-shard merge: the sharded paged
engine's attention (``models/layers._paged_attn_sharded``) uses it too.
Its bit-parity contract: when a query row's keys all lie on one shard
(the block pool's row affinity) and every other shard contributes the
exact-zero triple ``m = -1e30, l = 0, o = 0``, the combine returns the
owner's ``o / l`` bitwise: the max over ``{m, -1e30, ...}`` is ``m``, the
owner's scale is ``exp(0) = 1.0`` exactly, the others' underflow to
``+0.0``, and adding ``+0.0`` in the sums keeps the owner's bits.  So an
N-shard run equals the 1-shard run of the same partials form bit for bit.

The shards are the devices of a ``runtime.compat.Mesh`` (one process, one
controller; several shards may share a device): the reference's
``shard_map`` body runs once per shard, and its ``pmax`` / ``psum`` become
a gather onto the lead device and a reduction in shard order.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.ops import combine_partials as merge_partials
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.runtime.compat import Mesh, gather, split


def combine_partials(os, ms, ls):
    """Merge per-shard flash-softmax partials (lists in shard order, on any
    devices) on the first one's device.  ``o``: a shard's un-normalised
    weighted values, ``m``: its row max (a row that saw no key carries
    ``-1e30``), ``l``: its partition sum, the reduced key dim kept at size
    1 on ``m`` and ``l``.  Returns the exact global ``softmax @ V`` (the
    shape of ``o``): ``kernels/decode_attention``'s merge, in shard order."""
    dev = os[0].device
    return merge_partials(gather(os, dev), gather(ms, dev), gather(ls, dev))


def dist_decode_attention(q, k_cache, v_cache, lengths, mesh: Mesh):
    """q (B, H, dh); k_cache / v_cache (B, S, KV, dh) whose sequence dim is
    split evenly over ``mesh``'s shards (or the lists of their per-shard
    slices); lengths (B,) global valid lengths.  Shard ``s`` attends its
    slice's first ``clip(lengths - s * shard_len, 0, shard_len)``
    positions; a shard holding none of a row's positions gives exact-zero
    partials (the kernel's exact-zero empty-row rule), so a row of length
    0 gives 0.  Returns (B, H, dh) in q's dtype on the lead device."""
    ks, vs = split(k_cache, mesh, 1), split(v_cache, mesh, 1)
    b, h, dh = q.shape
    parts = []
    for s, dev in enumerate(mesh.devices):
        shard_len = ks[s].shape[1]
        local = torch.clamp(lengths.to(dev) - s * shard_len, 0, shard_len)
        parts.append(decode_attention(q.to(dev), ks[s], vs[s], local, return_partials=True, empty_zero=True))
    out = combine_partials(*map(list, zip(*parts)))  # (B, KV, G, dh) f32
    return out.reshape(b, h, dh).to(q.dtype)
