"""Mamba2 / SSD (state-space duality) mixer, chunked form.

The SSD formulation (Dao & Gu, arXiv:2405.21060) splits the sequence into
chunks of ``cfg.ssd_chunk`` positions: the intra-chunk term is a masked
"attention" computed by ``kernels/ssd_scan`` (the hand-written kernel on
the card, its plain version on the CPU), and the inter-chunk term is a
recurrence over the ``(H, hd, ds)`` state carried by a Python loop over
the chunks.  Decode is the O(1) recurrent step in plain torch.  All state
math is f32.

Functions mirror the JAX package's ``models/mamba2.py`` with its layouts:
activations ``(B, S, d)``, heads ``(B, S, H, hd)``, groups ``(B, S, G,
ds)``, the three depthwise-conv states ``(B, W - 1, C)`` and the SSM
state ``(B, H, hd, ds)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan.ops import ssd_chunk
from repro_torch.models.params import ParamSpec


def mamba_specs(cfg: ModelConfig) -> dict:
    d, di = cfg.d_model, cfg.d_inner
    g, ds, h, w = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads, cfg.conv_width
    return {
        "wz": ParamSpec((d, di), ("embed", "mlp"), "fan_in", fan_in_dims=(0,)),
        "wx": ParamSpec((d, di), ("embed", "mlp"), "fan_in", fan_in_dims=(0,)),
        "wB": ParamSpec((d, g * ds), ("embed", None), "fan_in", fan_in_dims=(0,)),
        "wC": ParamSpec((d, g * ds), ("embed", None), "fan_in", fan_in_dims=(0,)),
        "wdt": ParamSpec((d, h), ("embed", "dt"), "fan_in", fan_in_dims=(0,)),
        "conv_x": ParamSpec((w, di), ("conv", "mlp"), "fan_in", fan_in_dims=(0,)),
        "conv_B": ParamSpec((w, g * ds), ("conv", None), "fan_in", fan_in_dims=(0,)),
        "conv_C": ParamSpec((w, g * ds), ("conv", None), "fan_in", fan_in_dims=(0,)),
        "A_log": ParamSpec((h,), ("dt",), "zeros"),
        "D": ParamSpec((h,), ("dt",), "ones"),
        "dt_bias": ParamSpec((h,), ("dt",), "zeros"),
        "norm": ParamSpec((di,), ("mlp",), "ones"),
        "wo": ParamSpec((di, d), ("mlp", "embed"), "fan_in", fan_in_dims=(0,)),
    }


def _causal_conv(x, kernel, state=None):
    """Depthwise causal conv along the sequence.  x (B, S, C); kernel
    (W, C); state (B, W - 1, C) history or None (zero history).  Returns
    ``(y, new_state)``."""
    w = kernel.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], w - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)  # (B, S + W - 1, C)
    y = sum(xp[:, i : i + x.shape[1], :] * kernel[i] for i in range(w))
    new_state = xp[:, -(w - 1) :, :] if w > 1 else state
    return y, new_state


def _project(p, x):
    dt_ = x.dtype
    return tuple(x @ p[k].to(dt_) for k in ("wz", "wx", "wB", "wC", "wdt"))


def _heads(t, rep: int):
    """Group rows (B, L, G, ds) -> one row per head (B, L, G * rep, ds),
    head ``h`` reading group ``h // rep``; a single group is an expanded
    view (head stride 0), never a copy."""
    b, l, g, ds = t.shape
    if g == 1:
        return t.expand(b, l, rep, ds)
    return t.repeat_interleave(rep, dim=2)


def _ssd_chunked(cfg: ModelConfig, xh, Bh, Ch, dt, a, init_state=None):
    """Chunked SSD.  xh (B, S, H, hd); Bh, Ch (B, S, G, ds); dt (B, S, H)
    f32 (post-softplus); a (H,) negative.  Returns ``(y (B, S, H, hd) f32,
    final_state (B, H, hd, ds) f32)``."""
    b, s, h, hd = xh.shape
    g, ds = Bh.shape[2], Bh.shape[3]
    l = min(cfg.ssd_chunk, s)
    s_orig = s
    if s % l:  # pad: dt = 0 rows decay by exp(0) = 1 and contribute nothing
        pad = l - s % l
        xh, Bh, Ch = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xh, Bh, Ch))
        dt = F.pad(dt, (0, 0, 0, pad))
        s = s + pad
    rep = h // g
    state = init_state if init_state is not None else torch.zeros((b, h, hd, ds), dtype=torch.float32, device=xh.device)
    ys = []
    for c0 in range(0, s, l):
        xc, bc, cc, dtc = xh[:, c0 : c0 + l], Bh[:, c0 : c0 + l], Ch[:, c0 : c0 + l], dt[:, c0 : c0 + l]
        y_intra, st_c, dec = ssd_chunk(xc, _heads(bc, rep), _heads(cc, rep), dtc, a)
        # inter-chunk: the carried state read by C_i, decayed to position i
        cum = torch.cumsum(dtc * a, dim=1)  # (B, L, H), inclusive
        y_inter = torch.einsum("bigs,bgrps->bigrp", cc.float(), state.reshape(b, g, rep, hd, ds))
        y_inter = y_inter.reshape(b, l, h, hd) * torch.exp(cum)[..., None]
        state = state * dec[:, :, None, None] + st_c
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1)[:, :s_orig], state


def _gated_norm(cfg: ModelConfig, p, y, z, out_dtype):
    """Gated per-head RMSNorm (over hd only).  y (..., H, hd) f32; z
    (..., H * hd)."""
    h, hd = cfg.ssm_heads, cfg.ssm_head_dim
    gated = y * F.silu(z.float()).reshape(y.shape)
    var = torch.mean(gated * gated, dim=-1, keepdim=True)
    scale = p["norm"].float().reshape(h, hd)
    return (gated * torch.rsqrt(var + cfg.norm_eps) * scale).to(out_dtype)


def mamba_apply(cfg: ModelConfig, p, x, *, init=None):
    """Full-sequence forward.  x (B, S, d).  ``init``: optional
    ``(conv_states, ssm_state)`` to start from.  Returns ``(out (B, S, d),
    ((conv_x, conv_B, conv_C), ssm_state))``."""
    b, s, _ = x.shape
    h, hd, g, ds = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state
    z, xin, B, C, dt_raw = _project(p, x)
    cst = init[0] if init else (None, None, None)
    xin, cs_x = _causal_conv(xin, p["conv_x"].to(xin.dtype), cst[0])
    B, cs_b = _causal_conv(B, p["conv_B"].to(B.dtype), cst[1])
    C, cs_c = _causal_conv(C, p["conv_C"].to(C.dtype), cst[2])
    xin, B, C = F.silu(xin), F.silu(B), F.silu(C)

    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    a = -torch.exp(p["A_log"].float())  # (H,)
    xh = xin.reshape(b, s, h, hd)
    y, ssm_state = _ssd_chunked(
        cfg, xh, B.reshape(b, s, g, ds), C.reshape(b, s, g, ds), dt, a,
        init_state=init[1] if init else None,
    )
    y = y + xh.float() * p["D"].float()[None, None, :, None]
    y = _gated_norm(cfg, p, y, z, x.dtype)
    out = y.reshape(b, s, cfg.d_inner) @ p["wo"].to(x.dtype)
    return out, ((cs_x, cs_b, cs_c), ssm_state)


def mamba_decode(cfg: ModelConfig, p, x, conv_states, ssm_state):
    """Single-token recurrent step.  x (B, 1, d); conv_states three
    (B, W - 1, C); ssm_state (B, H, hd, ds) f32.  Returns ``(out (B, 1, d),
    conv_states, ssm_state)``."""
    b = x.shape[0]
    h, hd, g, ds = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state
    z, xin, B, C, dt_raw = _project(p, x)
    xin, cs_x = _causal_conv(xin, p["conv_x"].to(xin.dtype), conv_states[0])
    B, cs_b = _causal_conv(B, p["conv_B"].to(B.dtype), conv_states[1])
    C, cs_c = _causal_conv(C, p["conv_C"].to(C.dtype), conv_states[2])
    xin, B, C = F.silu(xin), F.silu(B), F.silu(C)

    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())[:, 0]  # (B, H)
    a = -torch.exp(p["A_log"].float())
    da = torch.exp(dt * a)  # (B, H)
    xh = xin.float().reshape(b, h, hd)
    Bh = B.float().reshape(b, g, ds).repeat_interleave(h // g, dim=1)  # (B, H, ds)
    Ch = C.float().reshape(b, g, ds).repeat_interleave(h // g, dim=1)
    ssm_state = ssm_state * da[:, :, None, None] + (dt[:, :, None] * xh)[..., None] * Bh[:, :, None, :]
    y = torch.einsum("bhps,bhs->bhp", ssm_state, Ch) + xh * p["D"].float()[None, :, None]
    y = _gated_norm(cfg, p, y, z[:, 0], x.dtype)
    out = y.reshape(b, 1, cfg.d_inner) @ p["wo"].to(x.dtype)
    return out, (cs_x, cs_b, cs_c), ssm_state


def mamba_reference(cfg: ModelConfig, p, x):
    """Sequential-recurrence oracle (no chunking): ``mamba_decode`` one
    position at a time from zero state."""
    b, s, _ = x.shape
    g, ds, w = cfg.ssm_groups, cfg.ssm_state, cfg.conv_width
    state = torch.zeros((b, cfg.ssm_heads, cfg.ssm_head_dim, ds), dtype=torch.float32, device=x.device)
    conv = tuple(
        torch.zeros((b, w - 1, c), dtype=x.dtype, device=x.device) for c in (cfg.d_inner, g * ds, g * ds)
    )
    outs = []
    for t in range(s):
        o, conv, state = mamba_decode(cfg, p, x[:, t : t + 1], conv, state)
        outs.append(o)
    return torch.cat(outs, dim=1)
