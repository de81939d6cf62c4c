"""Paged flash-decode: one new token per row against the block pool.

``paged_decode_attention`` launches the hand-written kernel
(``kernels/csrc/paged_decode.cu``) for CUDA tensors and runs
``paged_decode_attention_plain`` for CPU tensors; anything else raises.
``launches`` counts kernel launches.  Row ``b`` attends the first
``lengths[b]`` positions of ``block_tables[b]``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

launches = 0

_HEAD_DIMS = (16, 32, 64, 128)
_MAX_GROUP = 16


def paged_decode_attention_plain(q, k_pool, v_pool, block_tables, lengths):
    """Gather each row's contiguous view from its table, dense masked
    softmax.  q (B, H, dh); pools (n_pool, bs, KV, dh); block_tables
    (B, n_t); lengths (B,) -> (B, H, dh) in q's dtype."""
    b, h, dh = q.shape
    bs, kv = k_pool.shape[1], k_pool.shape[2]
    tbl = block_tables.long()
    s_pad = tbl.shape[1] * bs
    k_view = k_pool[tbl].reshape(b, s_pad, kv, dh).float()
    v_view = v_pool[tbl].reshape(b, s_pad, kv, dh).float()
    qr = q.float().reshape(b, kv, h // kv, dh)
    logits = torch.einsum("bkgd,bskd->bkgs", qr, k_view) / math.sqrt(dh)
    valid = torch.arange(s_pad, device=q.device)[None, None, None, :] < lengths.long()[:, None, None, None]
    logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_view)
    return out.reshape(b, h, dh).to(q.dtype)


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths):
    """Single-token attention through a block table over a shared KV pool."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, block_tables, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: tensor on {q.device}")
    b, h, dh = q.shape
    n_pool, bs, kv, dh_k = k_pool.shape
    if (
        v_pool.shape != k_pool.shape or dh_k != dh or h % kv or dh not in _HEAD_DIMS
        or h // kv > _MAX_GROUP or block_tables.dim() != 2 or block_tables.shape[0] != b
        or lengths.shape != (b,)
    ):
        raise ValueError(
            f"paged_decode_attention: q {tuple(q.shape)}, pools {tuple(k_pool.shape)}, "
            f"tables {tuple(block_tables.shape)}, lengths {tuple(lengths.shape)}"
        )
    if not (q.dtype == k_pool.dtype == v_pool.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"paged_decode_attention: dtypes {q.dtype} / {k_pool.dtype} / {v_pool.dtype}")
    for t in (k_pool, v_pool, block_tables, lengths):
        if t.device != q.device:
            raise ValueError(f"paged_decode_attention: tensors on {q.device} and {t.device}")
    q = q.contiguous()
    k_pool, v_pool = k_pool.contiguous(), v_pool.contiguous()
    tables = block_tables.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = _build.load("paged_decode")
    err = lib.paged_decode_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), b, h, kv, dh, bs, tables.shape[1],
        int(q.dtype == torch.bfloat16),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
    )
    _build.check(err, "paged_decode_attention")
    global launches
    launches += 1
    return out
