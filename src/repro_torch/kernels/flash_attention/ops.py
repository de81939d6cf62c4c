"""Dense flash attention: grouped-query attention over contiguous
``(B, S, heads, head_dim)`` tensors, causal or not.

``flash_attention`` launches the hand-written kernel
(``kernels/csrc/flash_attention.cu``) for CUDA tensors and runs
``flash_attention_plain`` for CPU tensors; anything else raises.
``launches`` counts kernel launches.  Query position ``i`` sees key
position ``j`` iff the call is non-causal or ``i >= j`` (top-left
aligned); query head ``h`` reads KV head ``h // (H // KV)``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

launches = 0

_HEAD_DIMS = (16, 32, 64, 128)


def flash_attention_plain(q, k, v, *, causal: bool):
    """Materialised softmax in f32.  q (B, Sq, H, dh); k, v (B, Sk, KV, dh)
    -> (B, Sq, H, dh) in q's dtype."""
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    qr = q.float().reshape(b, sq, kv, h // kv, dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qr, k.float()) / math.sqrt(dh)
    if causal:
        mask = torch.arange(sq, device=q.device)[:, None] >= torch.arange(sk, device=q.device)[None, :]
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, sq, h, dh).to(q.dtype)


def _in_place(t) -> bool:
    """Whether the kernel can read ``t`` through its strides: head_dim
    contiguous and, in bf16, the pointer and every stride that is ever
    stepped (of a dimension longer than 1) a multiple of 16 bytes."""
    if t.stride(-1) != 1:
        return False
    if t.dtype != torch.bfloat16:
        return True
    return t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1)


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """Full-sequence attention.  A non-zero ``q_offset`` raises: the
    kernel serves whole-sequence prefill and the encoders, and decode goes
    through ``layers.attn_decode``."""
    if q_offset:
        raise ValueError(f"flash_attention: q_offset={q_offset}; only full-sequence attention (0) is supported")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: tensor on {q.device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}")
    b, sq, h, dh = q.shape
    _, sk, kv, dh_k = k.shape
    if (
        v.shape != k.shape or k.shape[0] != b or dh_k != dh or dh not in _HEAD_DIMS
        or kv == 0 or h % kv
    ):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention: dtypes {q.dtype} / {k.dtype} / {v.dtype}")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError(f"flash_attention: tensors on {q.device} and {t.device}")
    # read in place through the strides; only head_dim must be contiguous,
    # and for bf16 (16-byte copies) every pointer and stride 16-byte aligned
    # (a fresh copy: a contiguous view at an odd offset stays unaligned)
    q, k, v = (t if _in_place(t) else t.clone(memory_format=torch.contiguous_format) for t in (q, k, v))
    out = torch.empty((b, sq, h, dh), dtype=q.dtype, device=q.device)
    if b == 0 or sq == 0:
        return out
    lib = _build.load("flash_attention")
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, sk, h, kv, dh,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(causal), int(q.dtype == torch.bfloat16),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
    )
    _build.check(err, "flash_attention")
    global launches
    launches += 1
    return out
