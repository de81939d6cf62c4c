"""Dense causal LM over a paged KV cache: the two serving steps.

``mixed_step`` is the unified engine step (any mix of prompt chunks and
decode rows, one pass over the layer stack); ``decode_step`` is one
decode token per row.  Both read and write attention K/V through block
tables over the pool that ``init_paged_cache`` builds.

Parameters keep the JAX package's tree: ``blocks`` holds one scan
period's ``pos{j}`` subtrees stacked on a leading ``n_blocks`` axis, so
``params.from_reference`` maps the reference's tree one to one.  The
layer loop is a Python loop over that axis; the cache keeps the same
stacked layout and each layer updates its slice in place.

Only dense all-attention configs are ported so far: MoE, Mamba and the
hybrid families raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.params import ParamSpec, map_tree


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.n_experts or any(
        cfg.mixer_kind(i) != "attn" for i in range(cfg.n_layers)
    ):
        raise NotImplementedError(
            f"{cfg.name}: only dense all-attention models are ported so far "
            "(MoE, Mamba and hybrid families come with the model-families slice)"
        )


def _position_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    s: dict[str, Any] = {"mixer_norm": ParamSpec((d,), ("norm",), "ones"), "attn": L.attn_specs(cfg)}
    if cfg.d_ff > 0:
        s["ffn_norm"] = ParamSpec((d,), ("norm",), "ones")
        s["mlp"] = L.mlp_specs(cfg)
    return s


def _stack(spec: ParamSpec, n: int) -> ParamSpec:
    return ParamSpec(
        (n,) + spec.shape, ("layers",) + spec.axes, spec.init, spec.scale,
        tuple(d + 1 for d in spec.fan_in_dims),
    )


def param_specs(cfg: ModelConfig) -> dict:
    _check_dense(cfg)
    block = {f"pos{j}": _position_specs(cfg) for j in range(cfg.scan_period)}
    specs = {
        "embed": L.embed_specs(cfg),
        "blocks": map_tree(lambda s: _stack(s, cfg.n_blocks), block),
        "final_norm": ParamSpec((cfg.d_model,), ("norm",), "ones"),
    }
    if head := L.head_specs(cfg):
        specs["head"] = head
    return specs


def init_paged_cache(cfg: ModelConfig, n_pool_blocks: int, block_size: int,
                     dtype=torch.bfloat16, device="cuda") -> dict:
    """Paged K/V: per period position ``{"k", "v"}`` leaves of shape
    ``(n_blocks, n_pool_blocks, block_size, kv, hd)``.  The caller keeps
    one pool index (the last) as the trash block that unallocated table
    entries and dead lanes point at."""
    _check_dense(cfg)
    shape = (cfg.n_blocks, n_pool_blocks, block_size, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {
        f"pos{j}": {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
        }
        for j in range(cfg.scan_period)
    }


def _layer_params(params, i: int, j: int):
    return map_tree(lambda t: t[i], params["blocks"][f"pos{j}"])


def _ffn(cfg, pp, h):
    if "ffn_norm" not in pp:
        return h
    return h + L.mlp_apply(cfg, pp["mlp"], L.rmsnorm(h, pp["ffn_norm"], cfg.norm_eps))


def mixed_step(cfg: ModelConfig, params, tokens, cache, block_tables, q_start, q_len,
               block_size: int):
    """Unified engine step.  ``tokens`` (B, W): row ``b`` carries
    ``q_len[b]`` live tokens from absolute position ``q_start[b]`` (a
    decode row has ``q_len == 1``, an idle slot ``q_len == 0``).  Earlier
    positions must already be in the pool blocks of ``block_tables``.
    Returns logits (B, W, V); ``cache`` is updated in place."""
    b, w = tokens.shape
    h = L.embed_apply(cfg, params["embed"], tokens)
    q_start = q_start.to(torch.int32)
    q_len = q_len.to(torch.int32)
    positions = q_start[:, None] + torch.arange(w, dtype=torch.int32, device=tokens.device)[None, :]
    for i in range(cfg.n_blocks):
        for j in range(cfg.scan_period):
            pp = _layer_params(params, i, j)
            c = cache[f"pos{j}"]
            x = L.rmsnorm(h, pp["mixer_norm"], cfg.norm_eps)
            h = h + L.attn_mixed_paged(
                cfg, pp["attn"], x, c["k"][i], c["v"][i], positions, block_tables, block_size, q_len
            )
            h = _ffn(cfg, pp, h)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return L.head_apply(cfg, params, h)


def decode_step(cfg: ModelConfig, params, cache, tokens, pos, block_tables, block_size: int):
    """One decode token per row.  ``tokens`` (B, 1); ``pos`` (B,) write
    positions (row ``b`` attends ``[0, pos[b]]``).  Returns logits
    (B, 1, V); ``cache`` is updated in place."""
    h = L.embed_apply(cfg, params["embed"], tokens)
    pos = pos.to(torch.int32)
    for i in range(cfg.n_blocks):
        for j in range(cfg.scan_period):
            pp = _layer_params(params, i, j)
            c = cache[f"pos{j}"]
            x = L.rmsnorm(h, pp["mixer_norm"], cfg.norm_eps)
            h = h + L.attn_decode_paged(
                cfg, pp["attn"], x, c["k"][i], c["v"][i], pos, block_tables, block_size
            )
            h = _ffn(cfg, pp, h)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return L.head_apply(cfg, params, h)
