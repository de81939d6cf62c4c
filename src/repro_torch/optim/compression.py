"""Gradient compression for the federation's update exchange: int8
quantisation with one per-tensor scale, and error feedback (the residual
of each step added back at the next, so the quantisation bias cancels
over steps).  The reference's arithmetic, in f32, over nested dicts of
tensors."""
from __future__ import annotations

import torch

from repro_torch.models.params import map_tree

f32 = torch.float32


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x -> (int8 q, f32 scale): scale = max |x| / 127 (+ 1e-12), q the
    rounded x / scale (half to even) clipped to [-127, 127]."""
    scale = torch.max(torch.abs(x.to(f32))) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x.to(f32) / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(f32) * scale


def init_error_feedback(params):
    return map_tree(lambda p: torch.zeros(p.shape, dtype=f32, device=p.device), params)


def compress_with_ef(grads, ef_state):
    """Returns (a tree of (q, scale) pairs, the new error-feedback tree):
    each leaf quantises grad + residual, and keeps what quantisation lost."""

    def one(g, e):
        target = g.to(f32) + e
        q, s = quantize_int8(target)
        return (q, s), target - dequantize_int8(q, s)

    outs = map_tree(one, grads, ef_state)
    return map_tree(lambda o: o[0], outs), map_tree(lambda o: o[1], outs)


def decompress(comp):
    return map_tree(lambda qs: dequantize_int8(*qs), comp)
