"""Transformer layers: RMSNorm, RoPE, GQA attention (dense, over a
contiguous cache, and through the paged KV pool), SwiGLU MLP, embedding
and head.

Plain functions on tensors with the JAX package's layouts (activations
``(B, S, d)``, heads ``(B, S, H, hd)``, weights ``wq (d, H, hd)`` ...).
Parameters are stored f32 and cast to the activation dtype at each
matmul; norms, RoPE and softmax run in f32.

Dense attention (``attention_core``: prefill, forward, the encoders) goes
through ``kernels/flash_attention``.  The cache-writing attention
functions update their cache IN PLACE (the JAX package returns a new
one): ``attn_decode`` writes each row's fresh K/V into its contiguous
stripe, then attends through ``kernels/decode_attention``'s contiguous
flash-decode; the paged functions scatter every token's K/V into its
pool slot first, then attend through ``kernels/chunked_prefill`` (mixed
steps, on the live tokens packed onto one axis) or
``kernels/decode_attention``'s paged kernel (decode steps).  A
sharded pool (a list of per-shard pools, one per device of a
``runtime.compat.Mesh``) runs the distributed dispatch instead, decode as
its one-lane case: ``_paged_attn_sharded``.
A layer with a sliding window (``ModelConfig.attn_window``) hands it to
both paged kernels; the paths without one (whole-sequence attention,
contiguous decode, the sharded pool) refuse it (``refuse_window``).
RoPE is the layer's: YaRN's frequencies and scale on the full layers of a
config that sets ``yarn_factor`` (``yarn_freqs``), else ``rope_theta``'s.
On CUDA tensors the kernel ops launch the hand-written kernels; on CPU
tensors they run their plain versions.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.chunked_prefill.ops import mixed_prefill_attention, mixed_prefill_partials
from repro_torch.kernels.decode_attention.ops import decode_attention, paged_decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.params import ParamSpec
from repro_torch.runtime import trace
from repro_torch.serving.dist_decode import combine_partials

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


def yarn_freqs(head_dim: int, theta: float, factor: float, original_max: int, beta_fast: float,
               beta_slow: float) -> np.ndarray:
    """YaRN's inverse frequencies (HF ``_compute_yarn_parameters``, with
    its truncation): the pairs whose wavelength is short against
    ``original_max`` (index below the floor of beta_fast's correction dim)
    keep ``theta``'s frequency, those past the ceil of beta_slow's are
    divided by ``factor``, and a linear ramp blends the two between.
    Worked in f64, returned in f32."""
    def corr_dim(rotations: float) -> float:
        return head_dim * math.log(original_max / (rotations * 2 * math.pi)) / (2 * math.log(theta))

    low = max(math.floor(corr_dim(beta_fast)), 0)
    high = min(math.ceil(corr_dim(beta_slow)), head_dim - 1)
    if low == high:
        high += 0.001
    ramp = np.clip((np.arange(head_dim // 2, dtype=np.float64) - low) / (high - low), 0.0, 1.0)
    extrapolation = 1.0 - ramp  # the share of the original frequency
    base = 1.0 / theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim)
    return (base / factor * ramp + base * extrapolation).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device, yarn: tuple | None = None) -> torch.Tensor:
    """``rope_freqs`` (``yarn_freqs`` with ``yarn``'s first four numbers)
    on ``device``, uploaded once: a host-to-device copy waits for the
    stream to drain, so one a layer would hold the host to the device's
    pace at every layer of every step."""
    freqs = rope_freqs(head_dim, theta) if yarn is None else yarn_freqs(head_dim, theta, *yarn[:4])
    return torch.as_tensor(freqs, device=device)


def apply_rope(x, positions, theta: float, yarn: tuple | None = None):
    """x: (..., S, H, hd); positions: broadcastable to (..., S).  ``yarn``:
    ``(factor, original_max, beta_fast, beta_slow, attn_factor)``
    (``ModelConfig.rope_yarn``): YaRN's frequencies, with cos and sin
    scaled by ``attn_factor``."""
    hd = x.shape[-1]
    freqs = _rope_freqs_on(hd, theta, x.device, yarn)
    angles = positions.float()[..., None] * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    if yarn is not None:
        cos, sin = cos * yarn[4], sin * yarn[4]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# --------------------------------------------------------------------- #
# attention cores  (q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd))
# --------------------------------------------------------------------- #


def _gqa_logits(q, k):
    """f32 logits (B, KV, G, Sq, Sk); query head h reads KV head h // G."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    return torch.einsum("bqkgd,bskd->bkgqs", q.reshape(b, sq, kv, h // kv, hd).float(), k.float())


def _gqa_out(probs, v, out_dtype):
    b, kv, g, sq, _ = probs.shape
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, kv * g, v.shape[-1]).to(out_dtype)


def _causal_mask(sq: int, sk: int, q_offset, device):
    return (q_offset + torch.arange(sq, device=device))[:, None] >= torch.arange(sk, device=device)[None, :]


def naive_attention(q, k, v, *, causal: bool, q_offset=0):
    """Materialised ``Sq x Sk`` logits: the plain oracle."""
    logits = _gqa_logits(q, k) / np.sqrt(q.shape[-1])
    if causal:
        mask = _causal_mask(q.shape[1], k.shape[1], q_offset, q.device)
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    return _gqa_out(torch.softmax(logits, dim=-1), v, q.dtype)


def flash_jnp_attention(q, k, v, *, causal: bool, chunk: int, q_offset=0):
    """Online softmax over KV chunks of ``chunk`` positions, in plain
    tensor ops: the oracle of the reference's chunked path."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if sk % chunk:
        raise ValueError(f"flash_jnp_attention: Sk={sk} is not a multiple of chunk={chunk}")
    g = h // kv
    m = torch.full((b, kv, g, sq), -torch.inf, device=q.device)
    l = torch.zeros((b, kv, g, sq), device=q.device)
    acc = torch.zeros((b, kv, g, sq, hd), device=q.device)
    for c0 in range(0, sk, chunk):
        kc, vc = k[:, c0 : c0 + chunk], v[:, c0 : c0 + chunk]
        logits = _gqa_logits(q, kc) / np.sqrt(hd)
        if causal:
            mask = _causal_mask(sq, sk, q_offset, q.device)[:, c0 : c0 + chunk]
            logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p.to(vc.dtype), vc).float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)


def attention_core(cfg: ModelConfig, q, k, v, *, causal: bool, q_offset=0):
    """Dense attention through ``kernels/flash_attention``: the kernel for
    CUDA tensors, its plain version for CPU tensors, whatever
    ``cfg.attn_impl`` names (the reference picks between its oracles and
    its Pallas kernel by it; they compute the same function)."""
    return flash_attention(q, k, v, causal=causal, q_offset=q_offset)


# --------------------------------------------------------------------- #
# attention block
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


def attn_qkv(cfg: ModelConfig, p, x, positions, layer: int = 0):
    """Project + qk-norm + rope (layer ``layer``'s: YaRN on a full layer of
    a YaRN config).  x: (B, S, d) -> q, k, v."""
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    yarn = cfg.rope_yarn(layer)
    return apply_rope(q, positions, cfg.rope_theta, yarn), apply_rope(k, positions, cfg.rope_theta, yarn), v


def refuse_window(cfg: ModelConfig, what: str, positions: int | None = None) -> None:
    """Raise where ``what`` attends over whole prefixes and ``cfg`` has
    windowed layers: from a window's length on, it would compute another
    model.  With ``positions`` (the most a query's prefix may hold), only
    where the window could bite."""
    if cfg.window > 0 and (positions is None or positions > cfg.window):
        raise ValueError(
            f"{cfg.name}: {what} has no sliding window, and this model's windowed layers see only the last "
            f"{cfg.window} positions" + ("" if positions is None else f" (here up to {positions})")
            + ": serve it on the paged engine"
        )


def attn_apply(cfg: ModelConfig, p, x, positions, *, causal=None, layer: int = 0):
    """Self-attention over the whole sequence (no cache).  x: (B, S, d)."""
    causal = cfg.causal if causal is None else causal
    q, k, v = attn_qkv(cfg, p, x, positions, layer)
    return _out_proj(attention_core(cfg, q, k, v, causal=causal), p["wo"])


def attn_decode(cfg: ModelConfig, p, x, k_cache, v_cache, pos):
    """Single-token decode over contiguous caches.  x: (B, 1, d); caches
    (B, S, KV, hd), written IN PLACE; ``pos``: a scalar write position, or
    (B,) per-row positions for ragged batches (each row writes its own
    slot, which must lie below S, and attends to its own prefix
    ``[0, pos]``), through ``kernels/decode_attention`` with ``lengths =
    pos + 1``.  Returns (B, 1, d)."""
    refuse_window(cfg, "contiguous decode")
    b = x.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    per_row = pos.dim() == 1
    positions = pos[:, None] if per_row else pos.expand(b, 1)
    q, k_new, v_new = attn_qkv(cfg, p, x, positions)
    if per_row:
        rows = torch.arange(b, device=x.device)
        k_cache[rows, pos.long()] = k_new[:, 0].to(k_cache.dtype)
        v_cache[rows, pos.long()] = v_new[:, 0].to(v_cache.dtype)
    else:
        k_cache[:, int(pos)] = k_new[:, 0].to(k_cache.dtype)
        v_cache[:, int(pos)] = v_new[:, 0].to(v_cache.dtype)
    lengths = (pos + 1).expand(b)  # row b attends [0, pos[b]]
    out = decode_attention(q[:, 0], k_cache, v_cache, lengths)[:, None]  # (B, 1, H, hd)
    return _out_proj(out, p["wo"])


def _paged_attn_sharded(q, k_new, v_new, k_pools, v_pools, block_tables, block, offset, desc, mesh=None):
    """Distributed write-then-attend over a sharded block pool, on packed
    lanes.

    ``k_pools`` / ``v_pools``: one pool per shard, ``(n_local + 1,
    block_size, KV, hd)`` on that shard's device, its trash block at local
    index ``n_local``.  ``block_tables`` (B, n_t) and ``block`` (N,) hold
    GLOBAL block ids: block ``b`` is local block ``b % n_local`` of shard
    ``b // n_local``, and the global trash id ``n_shards * n_local``
    belongs to no shard.  ``q`` (N, H, hd), ``k_new`` / ``v_new`` (N, KV,
    hd) and ``desc`` (R, 5) are a packed step's (``lm.Lanes``); token
    ``t``'s K/V go to ``offset[t]`` of ``block[t]``.

    Each shard scatters only the tokens whose target block it owns (every
    other token lands in its local trash) and runs the ``mixed_prefill``
    partials over its own table entries, ``owned = (tables // n_local) ==
    s``, the others pointed at its trash and masked to exact zeros.  The
    pool's row affinity puts all of a row's blocks on one shard, so
    ``dist_decode.combine_partials`` on the lead device (q's) passes the
    owner's partials through bitwise: an N-shard run equals the 1-shard
    run bit for bit.  Only q, the fresh tokens and the per-shard tables go
    to a shard's device, and only ``(o, m, l)`` comes back.  ``mesh``,
    when given, must list the pools' devices.

    Returns ``(N, H, hd)`` in q's dtype (the ``wo`` projection is the
    caller's); the pools are updated in place."""
    devices = [t.device for t in k_pools]
    if mesh is not None and list(mesh.devices) != devices:
        raise ValueError(f"sharded pool on {devices}, mesh over {list(mesh.devices)}")
    n, h, dh = q.shape
    n_local = k_pools[0].shape[0] - 1
    tables, bid_g, off = block_tables.long(), block.long(), offset.long()
    parts = []
    for s, (dev, kp, vp) in enumerate(zip(devices, k_pools, v_pools)):
        mine = (bid_g // n_local) == s
        bid = torch.where(mine, bid_g % n_local, n_local).to(dev)
        owned = (tables // n_local) == s
        loc_tbl = torch.where(owned, tables % n_local, n_local).to(dev)
        kp[bid, off.to(dev)] = k_new.to(dev, kp.dtype)
        vp[bid, off.to(dev)] = v_new.to(dev, vp.dtype)
        parts.append(mixed_prefill_partials(q.to(dev), kp, vp, loc_tbl, desc.to(dev), owned=owned.to(dev)))
    out = combine_partials(*map(list, zip(*parts)))  # (N, KV, G, hd) f32 on q's device
    return out.reshape(n, h, dh).to(q.dtype)


def attn_mixed_paged(cfg: ModelConfig, p, x, k_pool, v_pool, lanes, block_tables, mesh=None, layer: int = 0):
    """Unified mixed prefill + decode attention against the paged pool, on
    a packed step's live tokens.

    ``x`` (N, d): the tokens ``lanes`` (an ``lm.Lanes``) lays out, row
    after row, each at its absolute position ``lanes.pos``.  Their K/V
    land in ``pool[lanes.block, lanes.offset]`` first; then every token
    attends through the pool, over the last ``cfg.attn_window(layer)`` of
    its positions on a windowed layer.  A sharded pool (lists of per-shard
    pools, over ``mesh``) runs ``_paged_attn_sharded``, which has no
    window.  Returns ``(N, d)``; the pools are updated in place."""
    q, k_new, v_new = attn_qkv(cfg, p, x, lanes.pos, layer)
    if isinstance(k_pool, list):
        refuse_window(cfg, "the sharded pool's attention")
        out = _paged_attn_sharded(q, k_new, v_new, k_pool, v_pool, block_tables, lanes.block, lanes.offset,
                                  lanes.desc, mesh)
        return _out_proj(out, p["wo"])
    k_pool[lanes.block, lanes.offset] = k_new.to(k_pool.dtype)
    v_pool[lanes.block, lanes.offset] = v_new.to(v_pool.dtype)
    out = mixed_prefill_attention(q, k_pool, v_pool, block_tables, lanes.desc, window=cfg.attn_window(layer))
    return _out_proj(out, p["wo"])


def attn_decode_paged(cfg: ModelConfig, p, x, k_pool, v_pool, pos, block_tables, block_size: int,
                      mesh=None, layer: int = 0):
    """One-token decode against the paged pool.  ``x`` (B, 1, d); ``pos``
    (B,) per-row write positions; row ``b`` then attends ``[0, pos[b]]``,
    or its last ``cfg.attn_window(layer)`` positions on a windowed layer.
    On a sharded pool decode is the one-lane case of the distributed mixed
    dispatch (a free slot's all-trash table matches no shard, so its
    discarded lane gives exact zeros).  Returns ``(B, 1, d)``; the pools
    are updated in place."""
    b = x.shape[0]
    q, k_new, v_new = attn_qkv(cfg, p, x, pos[:, None], layer)
    s_pad = block_tables.shape[1] * block_size
    pos_c = torch.clamp(pos, max=s_pad - 1).long()
    rows = torch.arange(b, device=x.device)
    bid = block_tables.long()[rows, pos_c // block_size]
    off = pos_c % block_size
    if isinstance(k_pool, list):
        refuse_window(cfg, "the sharded pool's attention")
        one = torch.ones_like(pos)
        desc = torch.stack([rows.to(pos.dtype), pos, one, pos + 1, rows.to(pos.dtype)], dim=1)
        out = _paged_attn_sharded(q[:, 0], k_new[:, 0], v_new[:, 0], k_pool, v_pool, block_tables, bid, off, desc,
                                  mesh)
        return _out_proj(out[:, None], p["wo"])
    k_pool[bid, off] = k_new[:, 0].to(k_pool.dtype)
    v_pool[bid, off] = v_new[:, 0].to(v_pool.dtype)
    out = paged_decode_attention(q[:, 0], k_pool, v_pool, block_tables, pos + 1, window=cfg.attn_window(layer))
    return _out_proj(out[:, None], p["wo"])


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
    if tokens.numel():
        out_of_range = ((tokens < 0) | (tokens >= cfg.vocab_size)).any()
        # a meta tensor holds no ids, so there is nothing to read back: the
        # check's device ops above still run, only the host read is skipped
        if out_of_range.device.type != "meta" and bool(trace.to_host(out_of_range, "model.token_check")):
            bad = tokens[(tokens < 0) | (tokens >= cfg.vocab_size)]
            raise ValueError(
                f"token id {int(bad[0])} outside the model's vocabulary [0, {cfg.vocab_size})"
            )
    return p["tok"][tokens.long()].to(torch_dtype(cfg.dtype))


def head_apply(cfg: ModelConfig, params, x):
    w = params["embed"]["tok"].T if cfg.tie_embeddings else params["head"]["w"]
    return (x @ w.to(x.dtype)).to(torch_dtype(cfg.logit_dtype))
