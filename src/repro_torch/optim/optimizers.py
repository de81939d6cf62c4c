"""Optimizers as pure functions over the port's parameter trees (nested
dicts of tensors): AdamW, Adafactor, SGD with momentum.

The reference's arithmetic, in f32: the global-norm clip first, then the
moments, the bias corrections and (AdamW) the decoupled weight decay
applied to the f32 master weights, each leaf cast back to its dtype.
``torch.optim.AdamW`` is not used: it decays the weights before the
update, the reference after computing it.  ``init`` builds a state tree
that mirrors the parameter tree; ``update(grads, state, params, lr)``
returns ``(new_params, new_state, grad_norm)`` and allocates the new
trees (call it under ``torch.no_grad``).  Adafactor factors the second
moment of every >= 2-D leaf whose last two dims are both at least
``min_dim_factored`` into row and column means.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.models.params import leaves, map_tree

f32 = torch.float32


def _leaves(tree):
    return (t for _, t in leaves(tree))


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params, lr) -> (new_params, new_state, grad_norm)
    name: str = "opt"


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(f32))) for x in _leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """Every leaf scaled by min(1, max_norm / the global norm); returns
    ``(clipped grads, the norm before clipping)``."""
    g = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-9), max=1.0)
    return map_tree(lambda x: (x * scale).to(x.dtype), grads), g


def adamw(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=1.0) -> Optimizer:
    def init(params):
        some = next(_leaves(params))
        return {
            "mu": map_tree(lambda p: torch.zeros_like(p, dtype=f32), params),
            "nu": map_tree(lambda p: torch.zeros_like(p, dtype=f32), params),
            "count": torch.zeros((), dtype=torch.int32, device=some.device),
        }

    def update(grads, state, params, lr):
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        c = state["count"] + 1
        mu = map_tree(lambda g, m: b1 * m + (1 - b1) * g.to(f32), grads, state["mu"])
        nu = map_tree(lambda g, v: b2 * v + (1 - b2) * torch.square(g.to(f32)), grads, state["nu"])
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=f32, device=c.device), c.to(f32))
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=f32, device=c.device), c.to(f32))

        def upd(p, m, v):
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            return (p.to(f32) - lr * (step + weight_decay * p.to(f32))).to(p.dtype)

        new_params = map_tree(upd, params, mu, nu)
        return new_params, {"mu": mu, "nu": nu, "count": c}, gnorm

    return Optimizer(init, update, "adamw")


def adafactor(eps=1e-30, clip_norm=1.0, weight_decay=0.0, min_dim_factored=128) -> Optimizer:
    """Factored second moment for >= 2-D leaves whose trailing dims are
    large; no first moment (memory O(rows + cols) per matrix)."""

    def factored(p):
        return p.dim() >= 2 and p.shape[-1] >= min_dim_factored and p.shape[-2] >= min_dim_factored

    def init(params):
        def mk(p):
            if factored(p):
                return {
                    "vr": torch.zeros(p.shape[:-1], dtype=f32, device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=f32, device=p.device),
                }
            return {"v": torch.zeros_like(p, dtype=f32)}

        some = next(_leaves(params))
        return {"v": map_tree(mk, params), "count": torch.zeros((), dtype=torch.int32, device=some.device)}

    def update(grads, state, params, lr):
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        c = state["count"] + 1
        decay = 1.0 - (c.to(f32) + 1.0) ** -0.8

        def upd(p, g, v):
            g = g.to(f32)
            g2 = torch.square(g) + eps
            if "vr" in v:
                vr = decay * v["vr"] + (1 - decay) * g2.mean(-1)
                vc = decay * v["vc"] + (1 - decay) * g2.mean(-2)
                denom = vr[..., None] * vc[..., None, :] / torch.clamp(vr.mean(-1)[..., None, None], min=eps)
                step = g * torch.rsqrt(denom + eps)
                nv = {"vr": vr, "vc": vc}
            else:
                nv = {"v": decay * v["v"] + (1 - decay) * g2}
                step = g * torch.rsqrt(nv["v"] + eps)
            # update clipping (RMS <= 1)
            rms = torch.sqrt(torch.mean(torch.square(step)) + eps)
            step = step / torch.clamp(rms, min=1.0)
            newp = p.to(f32) - lr * (step + weight_decay * p.to(f32))
            return newp.to(p.dtype), nv

        outs = map_tree(upd, params, grads, state["v"])
        new_params = map_tree(lambda o: o[0], outs)
        new_v = map_tree(lambda o: o[1], outs)
        return new_params, {"v": new_v, "count": c}, gnorm

    return Optimizer(init, update, "adafactor")


def sgdm(momentum=0.9, clip_norm=1.0) -> Optimizer:
    def init(params):
        return {"mu": map_tree(lambda p: torch.zeros_like(p, dtype=f32), params)}

    def update(grads, state, params, lr):
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        mu = map_tree(lambda g, m: momentum * m + g.to(f32), grads, state["mu"])
        new_params = map_tree(lambda p, m: (p.to(f32) - lr * m).to(p.dtype), params, mu)
        return new_params, {"mu": mu}, gnorm

    return Optimizer(init, update, "sgdm")


def get_optimizer(name: str, **kw) -> Optimizer:
    return {"adamw": adamw, "adafactor": adafactor, "sgdm": sgdm}[name](**kw)


def cosine_schedule(base_lr: float, warmup: int, total: int, min_frac: float = 0.1):
    """Linear warm-up over ``warmup`` steps, then a cosine from ``base_lr``
    to ``min_frac * base_lr`` at ``total``; ``lr(step)`` is a Python float
    computed in f32, as the reference computes it."""
    one = np.float32

    def lr(step) -> float:
        step = one(step)
        if step < warmup:
            return float(one(base_lr) * step / one(max(warmup, 1)))
        frac = np.clip((step - one(warmup)) / one(max(total - warmup, 1)), one(0.0), one(1.0))
        cos = one(base_lr) * (one(min_frac) + one((1 - min_frac) * 0.5) * (one(1) + np.cos(one(math.pi) * frac)))
        return float(cos)

    return lr
