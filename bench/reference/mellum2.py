"""Plain PyTorch forward pass of Mellum2-12B-A2.5B, for checking.

Written from the published config (JetBrains/Mellum2-12B-A2.5B-Instruct,
``config.json``) and run in float32 with TF32 off: the Qwen3-style
decoder block of ``models.py`` (RMSNorm before attention and the FFN,
grouped-query attention, rotary positions on the two halves of each
head, a final RMSNorm and an untied head) with

- ``layer_types``: layer i attends through a sliding window when
  ``i % full_every != full_offset`` (Mellum2: i % 4 != 3), full causal
  attention otherwise.  HF's mask: key j is visible to query i when
  ``i - window < j <= i``;
- ``rope_parameters`` by layer kind: the windowed layers rotate at the
  plain frequencies of ``rope_theta``; the full layers at YaRN's (HF
  ``_compute_yarn_parameters`` with truncation: the correction dims'
  floor and ceil, a linear ramp between them, the frequencies above it
  divided by the factor), with cos and sin both scaled by the attention
  factor;
- every FFN the routed experts of ``models.moe_block`` (softmax over the
  experts, top k, the k gates renormalised, no shared expert), reused by
  import.

Departures, each as the served program has it, listed in PERF.md: no
per-head q/k norm (the config has no key for one; the configuration
lists it under ``assumed``); the catalog's unconfirmed MTP head is left
out.  Attention runs in blocks of query rows, each scoring every key up
to its last row under the mask, so the reference costs what full
attention costs: it is a yardstick, not a windowed kernel.

Weights as ``models.py`` takes them: per layer a stacked leading axis
over the ``blocks/pos{j}`` of one period of ``full_every`` layers.
Nothing of the program is imported.
"""
from __future__ import annotations

import math

import torch

from reference import models as R

F32 = R.F32


def yarn_inv_freq(head_dim: int, theta: float, factor: float, original_max: int, beta_fast: float,
                  beta_slow: float) -> torch.Tensor:
    """YaRN's inverse frequencies in f64 (HF's formula, with truncation)."""
    def corr_dim(rotations):
        return head_dim * math.log(original_max / (rotations * 2 * math.pi)) / (2 * math.log(theta))

    low = max(math.floor(corr_dim(beta_fast)), 0)
    high = min(math.ceil(corr_dim(beta_slow)), head_dim - 1)
    if low == high:
        high += 0.001
    pos_freqs = theta ** (torch.arange(0, head_dim, 2, dtype=torch.float64) / head_dim)
    ramp = ((torch.arange(head_dim // 2, dtype=torch.float64) - low) / (high - low)).clamp(0, 1)
    extrapolation_share = 1 - ramp
    return (1 / (factor * pos_freqs)) * (1 - extrapolation_share) + (1 / pos_freqs) * extrapolation_share


def rope(x, positions, inv: torch.Tensor, scale: float = 1.0):
    """x (..., S, H, hd) rotated at the inverse frequencies ``inv`` (hd / 2)."""
    half = x.shape[-1] // 2
    ang = positions.double()[:, None] * inv.to(x.device)[None, :]
    cos = (torch.cos(ang) * scale).float()[:, None, :]
    sin = (torch.sin(ang) * scale).float()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def window_of(cfg: dict, i: int) -> int:
    """Layer ``i``'s window (0: full attention)."""
    w = cfg.get("window", 0)
    every = cfg.get("full_every", 0)
    if w <= 0 or (every and i % every == cfg.get("full_offset", 0)):
        return 0
    return w


def attention(q, k, v, window: int, prec, block: int = 1024):
    """Causal attention, over the last ``window`` keys of each query when
    ``window`` > 0, in blocks of ``block`` query rows (each block's scores
    against every key up to its last row, masked).  q (1, S, H, hd), k
    and v (1, S, KV, hd) -> (1, S, H * hd)."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    k, v = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
    qh, kh, vh = prec.round(q, -1).permute(0, 2, 1, 3), prec.round(k, -1).permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    outs = []
    for a in range(0, s, block):
        e = min(s, a + block)
        scores = qh[:, :, a:e] @ kh[:, :, :e].transpose(-1, -2) / math.sqrt(hd)
        i = torch.arange(a, e, device=q.device)[:, None]
        j = torch.arange(e, device=q.device)[None, :]
        mask = j <= i
        if window > 0:
            mask = mask & (j > i - window)
        probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
        outs.append(prec.round(probs, -1) @ prec.round(vh[:, :, :e], -2))
    return torch.cat(outs, dim=2).permute(0, 2, 1, 3).reshape(b, s, h * hd)


def attn_block(cfg: dict, p, x, positions, layer: int, prec):
    q, k, v = (R._proj(x, p[n], prec) for n in ("wq", "wk", "wv"))
    window = window_of(cfg, layer)
    if window == 0 and cfg.get("yarn_factor", 0) > 0:
        inv = yarn_inv_freq(q.shape[-1], cfg["rope_theta"], cfg["yarn_factor"], cfg["yarn_original_max"],
                            cfg["yarn_beta_fast"], cfg["yarn_beta_slow"])
        scale = cfg.get("yarn_attn_factor") or 1.0
    else:
        hd = q.shape[-1]
        inv = 1.0 / (cfg["rope_theta"] ** (torch.arange(hd // 2, dtype=torch.float64) * 2.0 / hd))
        scale = 1.0
    q, k = rope(q, positions, inv, scale), rope(k, positions, inv, scale)
    o = attention(q, k, v, window, prec)
    h, hd, d = p["wo"].shape
    return prec.mm(o, p["wo"].reshape(h * hd, d))


def decoder_logits(cfg: dict, params, tokens: torch.Tensor, n_last: int, prec=F32):
    """Causal LM over one sequence ``tokens`` (S,); the logits (n_last, V)
    of its last ``n_last`` positions, layer by layer."""
    eps = cfg["norm_eps"]
    h = params["embed"]["tok"][tokens.long()].float()[None]
    positions = torch.arange(tokens.shape[0], device=tokens.device)
    period = len(params["blocks"])
    for i in range(cfg["n_layers"]):
        p = R._layer(params["blocks"][f"pos{i % period}"], i // period)
        h = h + attn_block(cfg, p["attn"], R.rmsnorm(h, p["mixer_norm"], eps), positions, i, prec)
        x = R.rmsnorm(h, p["ffn_norm"], eps)
        h = h + (R.moe_block(cfg, p["moe"], x, prec) if "moe" in p else R.swiglu(p["mlp"], x, prec))
    h = R.rmsnorm(h[0, -n_last:], params["final_norm"], eps)
    w = params["embed"]["tok"].T if cfg.get("tie_embeddings") else params["head"]["w"]
    return prec.mm(h, w)
