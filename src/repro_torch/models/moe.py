"""Mixture-of-Experts FFN with top-k routing: the single-device (tp=1) path.

``moe_specs`` declares the JAX package's tree: a router ``(d, E_pad)``
and stacked expert weights ``wg``/``wu`` ``(E_pad, d, f)``, ``wd``
``(E_pad, f, d)``, the expert count padded to a multiple of ``tp_hint``
(16 by default, so qwen2-moe's 60 experts are allocated as 64) so that
``params.from_reference`` maps the tree one to one; padded experts are
never routed.  With ``n_shared_experts`` a dense SwiGLU of
``n_shared_experts * f`` hidden units runs beside the routed experts,
scaled by a sigmoid gate.

``moe_apply`` routes every token in f32 (softmax over the real experts,
top-k, gates renormalised), sorts the (token, expert) pairs by expert id
(stable, so a token's pairs keep its order), keeps the first
``_capacity`` of them (at ``capacity_slack >= 1`` every pair), runs each
expert's SwiGLU over its contiguous group of rows, and adds each token's
gated contributions into a zero tensor of the activations' dtype.  The
JAX package's grouped product is XLA's ``ragged_dot``, not a Pallas
kernel, so here it stays on stock matmuls: a loop over the experts whose
group is not empty, their sizes read on the host (one device sync per
MoE layer per step).  Each expert's weights are cast to the activation
dtype one expert at a time, never the whole stacked leaf.  The combine is
deterministic: each token's kept contributions are gathered into a
``(T, k, d)`` buffer in expert order and summed in that order, the order
in which the reference's scatter-add adds them (``index_add_`` on the
card would sum in an order that changes from run to run).

``moe_reference`` is the dense oracle: every expert over every token,
weighted by the token's gate for it.  The expert-parallel paths of the
JAX package (``shard_map``, all-to-all) come with the multi-device slice.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import mlp_apply, mlp_specs
from repro_torch.models.params import ParamSpec


def padded_experts(cfg: ModelConfig, tp: int) -> int:
    return int(math.ceil(cfg.n_experts / tp) * tp)


def moe_specs(cfg: ModelConfig, tp_hint: int = 16) -> dict:
    d, f = cfg.d_model, cfg.resolved_moe_d_ff
    e_pad = padded_experts(cfg, tp_hint)
    s = {
        "router": ParamSpec((d, e_pad), ("embed", "experts"), "fan_in", fan_in_dims=(0,)),
        "wg": ParamSpec((e_pad, d, f), ("experts", "expert_in", "expert_mlp"), "fan_in", fan_in_dims=(1,)),
        "wu": ParamSpec((e_pad, d, f), ("experts", "expert_in", "expert_mlp"), "fan_in", fan_in_dims=(1,)),
        "wd": ParamSpec((e_pad, f, d), ("experts", "expert_mlp", "expert_in"), "fan_in", fan_in_dims=(1,)),
    }
    if cfg.n_shared_experts:
        s["shared"] = mlp_specs(cfg, d_ff=cfg.n_shared_experts * f)
        s["shared_gate"] = ParamSpec((d, 1), ("embed", None), "fan_in", fan_in_dims=(0,))
    return s


def _route(cfg: ModelConfig, router_w, x2d):
    """Top-k routing in f32.  x2d (T, d) -> gates (T, k), ids (T, k),
    probs (T, E_pad); padded experts get probability 0."""
    logits = x2d.float() @ router_w.float()
    e_pad = logits.shape[-1]
    valid = torch.arange(e_pad, device=x2d.device) < cfg.n_experts
    logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.topk(probs, cfg.moe_top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)  # renormalise
    return gates, ids, probs


def _aux_loss(cfg: ModelConfig, probs, ids):
    """Switch-style load-balance loss over the tokens given."""
    e = probs.shape[-1]
    me = probs.mean(dim=0)
    ce = torch.bincount(ids.reshape(-1), minlength=e).float()
    ce = ce / torch.clamp(ce.sum(), min=1.0)
    return e * torch.sum(me * ce)


def _capacity(cfg: ModelConfig, t_loc: int, tp: int) -> int:
    cap = int(math.ceil(t_loc * cfg.moe_top_k / tp * cfg.capacity_slack))
    cap = max(cap, cfg.moe_top_k)
    return int(math.ceil(cap / 8) * 8)


def _expert_compute(wg, wu, wd, xbuf, group_sizes):
    """SwiGLU of each expert over its contiguous group of ``xbuf`` rows
    (``group_sizes`` per expert, summing to the rows), in ``xbuf``'s dtype."""
    dt = xbuf.dtype
    y = torch.empty((xbuf.shape[0], wd.shape[-1]), dtype=dt, device=xbuf.device)
    start = 0
    for e, g in enumerate(group_sizes.tolist()):  # the one host sync of the layer
        if g == 0:
            continue
        xe = xbuf[start : start + g]
        h = F.silu(xe @ wg[e].to(dt)) * (xe @ wu[e].to(dt))
        y[start : start + g] = h @ wd[e].to(dt)
        start += g
    return y


def _local_moe_single(cfg: ModelConfig, cap: int, p, x2d):
    """The routed experts over x2d (T, d) at capacity ``cap`` -> (out (T, d)
    in x2d's dtype, aux loss)."""
    t, d = x2d.shape
    k = cfg.moe_top_k
    e_pad = p["router"].shape[-1]
    gates, ids, probs = _route(cfg, p["router"], x2d)
    flat_ids = ids.reshape(-1)
    order = torch.argsort(flat_ids, stable=True)[:cap]
    sel_e = flat_ids[order]
    sel_t = torch.div(order, k, rounding_mode="floor")  # the pair's token
    sel_g = gates.reshape(-1)[order]
    with record_function("moe_expert_loop"):  # the profiler's name for the loop's device time
        y = _expert_compute(p["wg"], p["wu"], p["wd"], x2d[sel_t], torch.bincount(sel_e, minlength=e_pad))
    contrib = (y * sel_g[:, None].to(y.dtype)).to(x2d.dtype)
    # each token's kept contributions in expert order (its k ids are
    # distinct), dropped pairs as zeros, summed left to right from the first
    slots = torch.zeros((t * k, d), dtype=x2d.dtype, device=x2d.device)
    slots[order] = contrib
    by_expert = torch.argsort(ids, dim=1)
    slots = torch.gather(slots.view(t, k, d), 1, by_expert[:, :, None].expand(t, k, d))
    out = slots[:, 0]
    for j in range(1, k):
        out = out + slots[:, j]
    return out, _aux_loss(cfg, probs, ids)


def moe_apply(cfg: ModelConfig, p, x):
    """x (B, S, d) -> (out (B, S, d), aux loss): the routed experts at the
    capacity of B * S tokens, plus the gated shared experts."""
    b, s, d = x.shape
    out, aux = _local_moe_single(cfg, _capacity(cfg, b * s, 1), p, x.reshape(b * s, d))
    out = out.reshape(b, s, d)
    if cfg.n_shared_experts:
        shared = mlp_apply(cfg, p["shared"], x)
        gate = torch.sigmoid((x @ p["shared_gate"].to(x.dtype)).float())
        out = out + shared * gate.to(x.dtype)
    return out, aux


def moe_reference(cfg: ModelConfig, p, x):
    """Dense oracle of the routed experts: every real expert over every
    token, weighted by the token's gate for it (0 where not routed)."""
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    gates, ids, probs = _route(cfg, p["router"], x2d)
    dt = x2d.dtype
    out = torch.zeros_like(x2d)
    for e in range(cfg.n_experts):
        w = torch.where(ids == e, gates, torch.zeros_like(gates)).sum(-1)
        h = F.silu(x2d @ p["wg"][e].to(dt)) * (x2d @ p["wu"][e].to(dt))
        out = out + (h @ p["wd"][e].to(dt)) * w[:, None].to(dt)
    return out.reshape(b, s, d), _aux_loss(cfg, probs, ids)
