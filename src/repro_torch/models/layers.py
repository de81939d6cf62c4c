"""Transformer layers of the dense decoder: RMSNorm, RoPE, GQA attention
through the paged KV pool, SwiGLU MLP, embedding and head.

Plain functions on tensors with the JAX package's layouts (activations
``(B, S, d)``, heads ``(B, S, H, hd)``, weights ``wq (d, H, hd)`` ...).
Parameters are stored f32 and cast to the activation dtype at each
matmul; norms, RoPE and softmax run in f32.

The paged attention functions update the KV pool IN PLACE (the JAX
package returns a new pool): the fresh K/V of every live lane is
scattered into its pool slot first, then attention reads the pool alone,
through ``kernels/chunked_prefill`` (mixed steps) or
``kernels/decode_attention`` (decode steps).  On CUDA tensors those ops
launch the hand-written kernels; on CPU tensors they run their plain
versions.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.chunked_prefill.ops import mixed_prefill_attention
from repro_torch.kernels.decode_attention.ops import paged_decode_attention
from repro_torch.models.params import ParamSpec

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


# --------------------------------------------------------------------- #
# norms / rope
# --------------------------------------------------------------------- #


def rmsnorm(x, scale, eps: float):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float):
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) * 2.0 / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(hd, theta), device=x.device)
    angles = positions.float()[..., None] * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# --------------------------------------------------------------------- #
# attention
# --------------------------------------------------------------------- #


def attn_specs(cfg: ModelConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    s = {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head_dim"), "fan_in", fan_in_dims=(0,)),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim"), "fan_in", fan_in_dims=(0,)),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim"), "fan_in", fan_in_dims=(0,)),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "embed"), "fan_in", fan_in_dims=(0, 1)),
    }
    if cfg.qk_norm:
        s["q_norm"] = ParamSpec((hd,), ("norm",), "ones")
        s["k_norm"] = ParamSpec((hd,), ("norm",), "ones")
    return s


def _proj(x, w):
    """x (B, S, d) @ w (d, H, hd) -> (B, S, H, hd) in x's dtype."""
    d, h, hd = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * hd)).reshape(*x.shape[:-1], h, hd)


def _out_proj(o, wo):
    """o (B, S, H, hd) @ wo (H, hd, d) -> (B, S, d)."""
    h, hd, d = wo.shape
    return o.reshape(*o.shape[:-2], h * hd) @ wo.to(o.dtype).reshape(h * hd, d)


def attn_qkv(cfg: ModelConfig, p, x, positions):
    """Project + qk-norm + rope.  x: (B, S, d) -> q, k, v."""
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta), v


def attn_mixed_paged(cfg: ModelConfig, p, x, k_pool, v_pool, positions, block_tables,
                     block_size: int, q_len):
    """Unified mixed prefill + decode attention against the paged pool.

    ``x`` (B, W, d): row ``b`` carries ``q_len[b]`` live lanes at absolute
    positions ``positions[b] = q_start[b] + lane``.  Live lanes' K/V land
    in ``pool[table[pos // bs], pos % bs]`` first (dead lanes write the
    trash block, the pool's last index); then every lane attends through
    the pool.  Returns ``(B, W, d)``; the pools are updated in place."""
    b, w = x.shape[0], x.shape[1]
    q, k_new, v_new = attn_qkv(cfg, p, x, positions)
    s_pad = block_tables.shape[1] * block_size
    lane = torch.arange(w, device=x.device)
    live = lane[None, :] < q_len[:, None]  # (B, W)
    pos_c = torch.clamp(positions, max=s_pad - 1).long()
    rows = torch.arange(b, device=x.device)[:, None]
    bid = torch.where(live, block_tables.long()[rows, pos_c // block_size], k_pool.shape[0] - 1)
    off = pos_c % block_size
    k_pool[bid, off] = k_new.to(k_pool.dtype)
    v_pool[bid, off] = v_new.to(v_pool.dtype)
    q_start = positions[:, 0]
    desc = torch.stack(
        [torch.arange(b, device=x.device), q_start, q_len, q_start + q_len], dim=1
    ).to(torch.int32)
    out = mixed_prefill_attention(q, k_pool, v_pool, block_tables, desc)  # (B, W, H, hd)
    return _out_proj(out, p["wo"])


def attn_decode_paged(cfg: ModelConfig, p, x, k_pool, v_pool, pos, block_tables, block_size: int):
    """One-token decode against the paged pool.  ``x`` (B, 1, d); ``pos``
    (B,) per-row write positions; row ``b`` then attends ``[0, pos[b]]``.
    Returns ``(B, 1, d)``; the pools are updated in place."""
    b = x.shape[0]
    q, k_new, v_new = attn_qkv(cfg, p, x, pos[:, None])
    s_pad = block_tables.shape[1] * block_size
    pos_c = torch.clamp(pos, max=s_pad - 1).long()
    rows = torch.arange(b, device=x.device)
    bid = block_tables.long()[rows, pos_c // block_size]
    off = pos_c % block_size
    k_pool[bid, off] = k_new[:, 0].to(k_pool.dtype)
    v_pool[bid, off] = v_new[:, 0].to(v_pool.dtype)
    out = paged_decode_attention(q[:, 0], k_pool, v_pool, block_tables, pos + 1)[:, None]
    return _out_proj(out, p["wo"])


# --------------------------------------------------------------------- #
# SwiGLU MLP, embeddings, head
# --------------------------------------------------------------------- #


def mlp_specs(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "wg": ParamSpec((d, f), ("embed", "mlp"), "fan_in", fan_in_dims=(0,)),
        "wu": ParamSpec((d, f), ("embed", "mlp"), "fan_in", fan_in_dims=(0,)),
        "wd": ParamSpec((f, d), ("mlp", "embed"), "fan_in", fan_in_dims=(0,)),
    }


def mlp_apply(cfg: ModelConfig, p, x):
    dt = x.dtype
    h = F.silu(x @ p["wg"].to(dt)) * (x @ p["wu"].to(dt))
    return h @ p["wd"].to(dt)


def embed_specs(cfg: ModelConfig) -> dict:
    return {"tok": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"), "normal")}


def head_specs(cfg: ModelConfig) -> dict:
    if cfg.tie_embeddings:
        return {}
    return {"w": ParamSpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"), "fan_in", fan_in_dims=(0,))}


def embed_apply(cfg: ModelConfig, p, tokens):
    """Token ids -> embeddings in ``cfg.dtype``.  An id outside
    ``[0, vocab_size)`` raises: the model has no row for it."""
    if tokens.numel() and bool(((tokens < 0) | (tokens >= cfg.vocab_size)).any()):
        bad = tokens[(tokens < 0) | (tokens >= cfg.vocab_size)]
        raise ValueError(
            f"token id {int(bad[0])} outside the model's vocabulary [0, {cfg.vocab_size})"
        )
    return p["tok"][tokens.long()].to(torch_dtype(cfg.dtype))


def head_apply(cfg: ModelConfig, params, x):
    w = params["embed"]["tok"].T if cfg.tie_embeddings else params["head"]["w"]
    return (x @ w.to(x.dtype)).to(torch_dtype(cfg.logit_dtype))
