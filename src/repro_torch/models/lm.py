"""Dense causal LM: full forward, prefill and the serving steps.

``forward`` is the whole-sequence pass; ``prefill`` runs it over a prompt
batch and fills the contiguous cache ``init_cache`` builds, and
``decode_step`` without block tables then decodes from those per-row
stripes (the contiguous engine and the lock-step baseline).
``mixed_step`` is the paged unified engine step (any mix of prompt
chunks and decode rows, one pass over the layer stack), and
``decode_step`` with block tables decodes one token per row through the
pool that ``init_paged_cache`` builds.  Whole-sequence attention runs
through ``kernels/flash_attention``.

Parameters keep the JAX package's tree: ``blocks`` holds one scan
period's ``pos{j}`` subtrees stacked on a leading ``n_blocks`` axis, so
``params.from_reference`` maps the reference's tree one to one.  The
layer loop is a Python loop over that axis; the cache keeps the same
stacked layout and each layer updates its slice in place.

Only dense all-attention configs are ported so far: MoE, Mamba and the
hybrid families raise ``NotImplementedError``.  The encoders
(``dual_encoder``, ``cross_encoder``) declare their own trees with
``_stack_specs`` and run their layers through ``encoder_stack``.
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


def _stack_specs(tree, n: int):
    """Every ParamSpec of ``tree`` stacked on a leading ``n``-long "layers" axis."""
    return map_tree(
        lambda p: ParamSpec(
            (n,) + p.shape, ("layers",) + p.axes, p.init, p.scale, tuple(d + 1 for d in p.fan_in_dims),
        ),
        tree,
    )


def param_specs(cfg: ModelConfig) -> dict:
    _check_dense(cfg)
    block = {f"pos{j}": _position_specs(cfg) for j in range(cfg.scan_period)}
    specs = {
        "embed": L.embed_specs(cfg),
        "blocks": _stack_specs(block, cfg.n_blocks),
        "final_norm": ParamSpec((cfg.d_model,), ("norm",), "ones"),
    }
    if head := L.head_specs(cfg):
        specs["head"] = head
    return specs


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype=torch.bfloat16, device="cuda") -> dict:
    """Contiguous K/V: per period position ``{"k", "v"}`` leaves of shape
    ``(n_blocks, batch, cache_len, kv, hd)``, one stripe per row."""
    _check_dense(cfg)
    shape = (cfg.n_blocks, batch, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {
        f"pos{j}": {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
        }
        for j in range(cfg.scan_period)
    }


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


def _embed_tokens(cfg: ModelConfig, params, tokens):
    _check_dense(cfg)
    if cfg.frontend == "patches":
        raise NotImplementedError(f"{cfg.name}: the patch-embedding frontend is not ported yet")
    return L.embed_apply(cfg, params["embed"], tokens)


def _positions(shape, device):
    """(B, S) absolute positions 0..S-1 of a whole-sequence pass."""
    return torch.arange(shape[1], device=device)[None, :].expand(shape[0], shape[1])


def forward(cfg: ModelConfig, params, batch):
    """Full causal forward.  ``batch["tokens"]`` (B, S) -> ``(logits
    (B, S, V), aux)``; ``aux`` is the MoE auxiliary loss, 0 for dense."""
    tokens = batch["tokens"]
    h = _embed_tokens(cfg, params, tokens)
    positions = _positions(tokens.shape, tokens.device)
    for i in range(cfg.n_blocks):
        for j in range(cfg.scan_period):
            pp = _layer_params(params, i, j)
            x = L.rmsnorm(h, pp["mixer_norm"], cfg.norm_eps)
            h = _ffn(cfg, pp, h + L.attn_apply(cfg, pp["attn"], x, positions))
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return L.head_apply(cfg, params, h), torch.zeros((), device=tokens.device)


def prefill(cfg: ModelConfig, params, batch, cache_len: int | None = None):
    """Process a prompt batch and build its contiguous decode cache
    (``cache_len`` positions per row, default the prompt length; the
    prompt's K/V fill ``[0, S)``).  Returns ``(logits (B, S, V), cache)``."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    h = _embed_tokens(cfg, params, tokens)
    positions = _positions(tokens.shape, tokens.device)
    cache = init_cache(cfg, b, cache_len or s, dtype=L.torch_dtype(cfg.dtype), device=tokens.device)
    for i in range(cfg.n_blocks):
        for j in range(cfg.scan_period):
            pp = _layer_params(params, i, j)
            c = cache[f"pos{j}"]
            x = L.rmsnorm(h, pp["mixer_norm"], cfg.norm_eps)
            q, k, v = L.attn_qkv(cfg, pp["attn"], x, positions)
            o = L.attention_core(cfg, q, k, v, causal=cfg.causal)
            c["k"][i, :, :s] = k.to(c["k"].dtype)
            c["v"][i, :, :s] = v.to(c["v"].dtype)
            h = _ffn(cfg, pp, h + L._out_proj(o, pp["attn"]["wo"]))
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return L.head_apply(cfg, params, h), cache


def encoder_stack(cfg: ModelConfig, params, h):
    """The encoders' bidirectional layer stack: ``params["blocks"]`` holds
    one layer's tree stacked over ``n_layers``.  h (B, S, d) -> final-normed
    (B, S, d)."""
    positions = _positions(h.shape, h.device)
    for i in range(cfg.n_layers):
        bp = map_tree(lambda t: t[i], params["blocks"])
        x = L.rmsnorm(h, bp["mixer_norm"], cfg.norm_eps)
        h = h + L.attn_apply(cfg, bp["attn"], x, positions, causal=False)
        h = _ffn(cfg, bp, h)
    return L.rmsnorm(h, params["final_norm"], cfg.norm_eps)


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


def decode_step(cfg: ModelConfig, params, cache, tokens, pos, block_tables=None,
                block_size: int = 0):
    """One decode token per row.  ``tokens`` (B, 1); ``pos`` a scalar write
    position or (B,) per-row positions (row ``b`` attends ``[0, pos[b]]``).
    Without ``block_tables`` the cache is ``init_cache``'s contiguous
    stripes; with them (per-row ``pos``) it is ``init_paged_cache``'s pool.
    Returns logits (B, 1, V); ``cache`` is updated in place."""
    h = L.embed_apply(cfg, params["embed"], tokens)
    pos = torch.as_tensor(pos, device=tokens.device).to(torch.int32)
    for i in range(cfg.n_blocks):
        for j in range(cfg.scan_period):
            pp = _layer_params(params, i, j)
            c = cache[f"pos{j}"]
            x = L.rmsnorm(h, pp["mixer_norm"], cfg.norm_eps)
            if block_tables is None:
                o = L.attn_decode(cfg, pp["attn"], x, c["k"][i], c["v"][i], pos)
            else:
                o = L.attn_decode_paged(cfg, pp["attn"], x, c["k"][i], c["v"][i], pos, block_tables, block_size)
            h = _ffn(cfg, pp, h + o)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return L.head_apply(cfg, params, h)
