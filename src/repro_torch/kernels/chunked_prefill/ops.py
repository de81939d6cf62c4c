"""Unified chunked-prefill attention over the paged KV pool.

``mixed_prefill_attention`` launches the hand-written kernel
(``kernels/csrc/mixed_prefill.cu``) for CUDA tensors and runs
``mixed_prefill_attention_plain`` for CPU tensors; anything else raises.
``launches`` counts kernel launches.

Descriptor contract (one row per ``desc[r] = (slot, q_start, q_len,
kv_len)``): lane ``j`` of row ``r`` attends pool position ``kpos`` of
``block_tables[slot]`` iff ``kpos <= q_start + j`` and ``kpos < kv_len``;
lanes ``j >= q_len`` output exactly 0.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

launches = 0

_HEAD_DIMS = (16, 32, 64, 128)


def mixed_prefill_attention_plain(q, k_pool, v_pool, block_tables, desc):
    """Gather each row's contiguous pool view, dense masked softmax, and
    re-zero probabilities under the mask (dead lanes give exact 0).

    q (R, W, H, dh); pools (n_pool, bs, KV, dh); block_tables (B, n_t);
    desc (R, 4) -> (R, W, H, dh) in q's dtype."""
    r, w, h, dh = q.shape
    bs, kv = k_pool.shape[1], k_pool.shape[2]
    desc = desc.long()
    tbl = block_tables.long()[desc[:, 0]]  # (R, n_t)
    s_pad = tbl.shape[1] * bs
    k_view = k_pool[tbl].reshape(r, s_pad, kv, dh).float()
    v_view = v_pool[tbl].reshape(r, s_pad, kv, dh).float()
    qr = q.float().reshape(r, w, kv, h // kv, dh)
    logits = torch.einsum("rwkgd,rskd->rkgws", qr, k_view) / math.sqrt(dh)
    lane = torch.arange(w, device=q.device)
    kpos = torch.arange(s_pad, device=q.device)
    qpos = desc[:, 1][:, None] + lane[None, :]  # (R, W)
    valid = (
        (kpos[None, None, :] <= qpos[:, :, None])
        & (kpos[None, None, :] < desc[:, 3][:, None, None])
        & (lane[None, :, None] < desc[:, 2][:, None, None])
    )  # (R, W, S)
    vb = valid[:, None, None]
    logits = torch.where(vb, logits, torch.full_like(logits, -1e30))
    p = torch.softmax(logits, dim=-1)
    p = torch.where(vb, p, torch.zeros_like(p))
    out = torch.einsum("rkgws,rskd->rwkgd", p, v_view)
    return out.reshape(r, w, h, dh).to(q.dtype)


def mixed_prefill_attention(q, k_pool, v_pool, block_tables, desc):
    """Ragged mixed prefill/decode attention through a block table (see
    the module docstring for the descriptor contract)."""
    if q.device.type == "cpu":
        return mixed_prefill_attention_plain(q, k_pool, v_pool, block_tables, desc)
    if q.device.type != "cuda":
        raise ValueError(f"mixed_prefill_attention: tensor on {q.device}")
    r, w, h, dh = q.shape
    n_pool, bs, kv, dh_k = k_pool.shape
    if (
        v_pool.shape != k_pool.shape or dh_k != dh or h % kv or dh not in _HEAD_DIMS
        or desc.shape != (r, 4) or block_tables.dim() != 2
    ):
        raise ValueError(
            f"mixed_prefill_attention: q {tuple(q.shape)}, pools {tuple(k_pool.shape)}, "
            f"tables {tuple(block_tables.shape)}, desc {tuple(desc.shape)}"
        )
    if not (q.dtype == k_pool.dtype == v_pool.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"mixed_prefill_attention: dtypes {q.dtype} / {k_pool.dtype} / {v_pool.dtype}")
    for t in (k_pool, v_pool, block_tables, desc):
        if t.device != q.device:
            raise ValueError(f"mixed_prefill_attention: tensors on {q.device} and {t.device}")
    q = q.contiguous()
    k_pool, v_pool = k_pool.contiguous(), v_pool.contiguous()
    tables = block_tables.to(torch.int32).contiguous()
    desc = desc.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if r == 0 or w == 0:
        return out
    lib = _build.load("mixed_prefill")
    err = lib.mixed_prefill_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
        desc.data_ptr(), out.data_ptr(), r, w, h, kv, dh, bs, tables.shape[1],
        int(q.dtype == torch.bfloat16),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
    )
    _build.check(err, "mixed_prefill_attention")
    global launches
    launches += 1
    return out
