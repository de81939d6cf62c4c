"""Input stand-ins per (arch x shape) cell: ``meta`` tensors of the
reference's shapes and dtypes, each beside the partition spec the port's
``ShardingPolicy`` resolves for it (a meta tensor carries no sharding, so
the two travel as a ``Placed`` pair).  Nothing is allocated.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import lm as LM
from repro_torch.runtime.sharding import PartitionSpec, ShardingPolicy


class Placed(NamedTuple):
    """A ``meta`` tensor and its partition spec (None without a mesh)."""

    tensor: torch.Tensor
    pspec: PartitionSpec | None


def _sds(shape, dtype, pol: ShardingPolicy, *axes) -> Placed:
    pspec = pol.spec(*axes, shape=shape) if pol.mesh is not None else None
    return Placed(torch.empty(shape, dtype=dtype, device="meta"), pspec)


def _filter_pspec(pspec, shape, sizes) -> PartitionSpec:
    """Drop mesh axes that don't divide the dim (the reference's
    NamedSharding divisibility)."""
    entries = []
    for d, e in enumerate(pspec):
        if e is None:
            entries.append(None)
            continue
        cand = (e,) if isinstance(e, str) else tuple(e)
        keep, fac = [], 1
        for a in cand:
            sz = sizes.get(a, 1)
            if shape[d] % (fac * sz) == 0:
                keep.append(a)
                fac *= sz
        entries.append(tuple(keep) if len(keep) > 1 else (keep[0] if keep else None))
    entries += [None] * (len(shape) - len(entries))
    return PartitionSpec(*entries)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, pol: ShardingPolicy) -> dict:
    """The step kind's batch as ``Placed`` stand-ins."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        if cfg.family == "encoder":
            return {
                "frames": _sds((b, s, cfg.d_model), torch.bfloat16, pol, "act_batch", "act_seq", "act_embed"),
                "mask": _sds((b, s), torch.bool, pol, "act_batch", "act_seq"),
                "targets": _sds((b, s), torch.int32, pol, "act_batch", "act_seq"),
            }
        batch = {
            "tokens": _sds((b, s), torch.int32, pol, "act_batch", "act_seq"),
            "targets": _sds((b, s), torch.int32, pol, "act_batch", "act_seq"),
        }
        if cfg.frontend == "patches":
            batch["patch_embeds"] = _sds(
                (b, cfg.n_patches, cfg.d_model), torch.bfloat16, pol, "act_batch", None, "act_embed"
            )
        return batch
    if shape.kind == "prefill":
        if cfg.family == "encoder":
            return {"frames": _sds((b, s, cfg.d_model), torch.bfloat16, pol, "act_batch", "act_seq", "act_embed")}
        batch = {"tokens": _sds((b, s), torch.int32, pol, "act_batch", "act_seq")}
        if cfg.frontend == "patches":
            batch["patch_embeds"] = _sds(
                (b, cfg.n_patches, cfg.d_model), torch.bfloat16, pol, "act_batch", None, "act_embed"
            )
        return batch
    # decode: one new token against a seq_len cache
    return {"tokens": _sds((b, 1), torch.int32, pol, "act_batch", None)}


def _zip_tree(fn, tree, other):
    """``fn`` over the leaves of a nested dict / tuple ``tree``, with
    ``other``'s leaf at the same place."""
    if isinstance(tree, dict):
        return {k: _zip_tree(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_zip_tree(fn, v, o) for v, o in zip(tree, other))
    return fn(tree, other)


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, pol: ShardingPolicy):
    """The decode cache (``lm.init_cache``'s tree of ``meta`` tensors in
    bf16) with each leaf's partition spec, filtered for divisibility."""
    abstract = LM.init_cache(cfg, shape.global_batch, shape.seq_len, dtype=torch.bfloat16, device="meta")
    if pol.mesh is None:
        return _zip_tree(lambda a, _: Placed(a, None), abstract, abstract)
    sizes = dict(pol.mesh.shape)
    return _zip_tree(lambda a, s: Placed(a, _filter_pspec(s, a.shape, sizes)), abstract, LM.cache_pspecs(cfg, pol))
