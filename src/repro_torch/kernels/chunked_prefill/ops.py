"""Unified chunked-prefill attention over the paged KV pool.

``mixed_prefill_attention`` launches the hand-written kernel
(``kernels/csrc/mixed_prefill.cu``: bf16 on the tensor cores, f32 on the
CUDA cores) for CUDA tensors, runs ``mixed_prefill_attention_plain`` for
CPU tensors and returns an empty output for ``meta`` tensors; anything
else raises.  ``mixed_prefill_partials`` is the
same walk stopped before the normalisation, the per-shard half of the
sharded engine's dispatch: f32 ``(o, m, l)`` over the keys of the blocks
an ``owned`` mask marks (``mixed_prefill_partials_plain`` on the CPU).
``launches`` counts the launches of both forms; ``cost`` is one call's
FLOPs and bytes, which a cost counter records (``_build.counted``).

Descriptor contract (one row per ``desc[r] = (slot, q_start, q_len,
kv_len[, q_off])``): lane ``j`` of row ``r`` attends pool position
``kpos`` of ``block_tables[slot]`` iff ``kpos <= q_start + j`` and ``kpos
< kv_len``, and with ``window > 0`` also ``kpos > q_start + j - window``
(its own position and the ``window - 1`` before it).  Two layouts of the
lanes, one kernel body:

* packed (the serving path): q ``(N, H, dh)`` and ``desc`` ``(R, 5)``;
  row ``r``'s ``q_len`` lanes lie back to back from lane ``q_off`` of the
  one lane axis, the rows in ``q_off`` order and disjoint.  The output is
  ``(N, H, dh)``; a lane that is no row's is not written by the kernel
  (0 from the plain version);
* padded: q ``(R, W, H, dh)`` and ``desc`` ``(R, 4)``, the case ``q_off
  = r * W``; lanes ``j >= q_len`` output exactly 0.

Serving only: an input that requires grad under grad mode raises, since
the kernel has no backward and would cut the autograd graph silently.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

launches = 0

_HEAD_DIMS = (16, 32, 64, 128)


def _as_padded(q, desc):
    """A packed call as the padded one: q (N, H, dh) laid out as (R, W, H,
    dh), W the longest row, and each (row, lane)'s packed index and
    whether the lane is live (R, W)."""
    desc = desc.long()
    q_len, q_off = desc[:, 2], desc[:, 4]
    w = int(q_len.max()) if len(desc) else 0
    lane = torch.arange(w, device=q.device)
    live = lane[None, :] < q_len[:, None]
    idx = torch.where(live, q_off[:, None] + lane[None, :], 0)
    return q[idx], idx, live


def _as_packed(out_pad, idx, live, n: int, fill: float = 0.0):
    """The live lanes of a padded (R, W, ...) output at their packed
    indices of an (N, ...) tensor, ``fill`` elsewhere."""
    out = torch.full((n,) + out_pad.shape[2:], fill, dtype=out_pad.dtype, device=out_pad.device)
    out[idx[live]] = out_pad[live]
    return out


def mixed_prefill_attention_plain(q, k_pool, v_pool, block_tables, desc, window: int = 0):
    """Gather each row's contiguous pool view, dense masked softmax, and
    re-zero probabilities under the mask (dead lanes give exact 0).

    Padded: q (R, W, H, dh), desc (R, 4) -> (R, W, H, dh); packed: q (N,
    H, dh), desc (R, 5) -> (N, H, dh), in q's dtype.  Pools (n_pool, bs,
    KV, dh); block_tables (B, n_t); ``window`` > 0 masks every key more
    than ``window - 1`` positions before a lane's own."""
    if q.dim() == 3:
        qp, idx, live = _as_padded(q, desc)
        out = mixed_prefill_attention_plain(qp, k_pool, v_pool, block_tables, desc[:, :4], window)
        return _as_packed(out, idx, live, q.shape[0])
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
    if window > 0:
        valid = valid & (kpos[None, None, :] > qpos[:, :, None] - window)
    vb = valid[:, None, None]
    logits = torch.where(vb, logits, torch.full_like(logits, -1e30))
    p = torch.softmax(logits, dim=-1)
    p = torch.where(vb, p, torch.zeros_like(p))
    out = torch.einsum("rkgws,rskd->rwkgd", p, v_view)
    return out.reshape(r, w, h, dh).to(q.dtype)


def mixed_prefill_partials_plain(q, k_pool, v_pool, block_tables, desc, owned=None):
    """Flash-softmax partials of ``mixed_prefill_attention_plain``: the
    same mask (and, with ``owned`` (B, n_t) bool, only the positions of
    the table entries it marks), stopped before the normalisation.
    Returns f32 ``o`` (R, KV, G, W, dh), the un-normalised weighted
    values, and ``m``, ``l`` (R, KV, G, W, 1), each row's max logit and
    partition sum; packed (q (N, H, dh), desc (R, 5)), ``o`` (N, KV, G,
    dh) and ``m``, ``l`` (N, KV, G, 1).  A row that sees no key gives
    exactly ``m = -1e30``, ``l = 0``, ``o = 0``; ``owned=None`` means
    every entry is owned."""
    if q.dim() == 3:
        qp, idx, live = _as_padded(q, desc)
        parts = mixed_prefill_partials_plain(qp, k_pool, v_pool, block_tables, desc[:, :4], owned)
        n = q.shape[0]
        return tuple(_as_packed(t.permute(0, 3, 1, 2, 4), idx, live, n, fill)
                     for t, fill in zip(parts, (0.0, -1e30, 0.0)))
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
    if owned is not None:
        own_pos = torch.repeat_interleave(owned.bool()[desc[:, 0]], bs, dim=1)  # (R, s_pad)
        valid = valid & own_pos[:, None, :]
    vb = valid[:, None, None]  # (R, 1, 1, W, S)
    logits = torch.where(vb, logits, torch.full_like(logits, -1e30))
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.where(vb, torch.exp(logits - m), torch.zeros_like(logits))  # all-masked rows: l and o exactly 0
    return torch.einsum("rkgws,rskd->rkgwd", e, v_view), m, e.sum(dim=-1, keepdim=True)


def _lanes(q, desc):
    """(R, W, N) of a call: W the padded form's lanes a row, 0 packed; N
    the lanes of q's lane axis."""
    if q.dim() == 3:
        return desc.shape[0], 0, q.shape[0]
    return q.shape[0], q.shape[1], q.shape[0] * q.shape[1]


def _check_mixed(name, q, k_pool, v_pool, block_tables, desc) -> None:
    """The shapes, dtypes and devices both forms of the kernel take; raises."""
    r, w, _ = _lanes(q, desc)
    h, dh = q.shape[-2:]
    n_pool, bs, kv, dh_k = k_pool.shape
    if (
        v_pool.shape != k_pool.shape or dh_k != dh or h % kv or dh not in _HEAD_DIMS
        or q.dim() not in (3, 4) or desc.shape != (r, 5 if w == 0 else 4) or block_tables.dim() != 2
    ):
        raise ValueError(
            f"{name}: q {tuple(q.shape)}, pools {tuple(k_pool.shape)}, "
            f"tables {tuple(block_tables.shape)}, desc {tuple(desc.shape)}"
        )
    if not (q.dtype == k_pool.dtype == v_pool.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: dtypes {q.dtype} / {k_pool.dtype} / {v_pool.dtype}")
    for t in (k_pool, v_pool, block_tables, desc):
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {q.device} and {t.device}")


def _aligned(*ts):
    """bf16 is read with 16-byte copies: a fresh copy of a tensor at an
    unaligned pointer (a contiguous view at an odd offset stays unaligned)."""
    return tuple(
        t if t.is_contiguous() and t.data_ptr() % 16 == 0 else t.clone(memory_format=torch.contiguous_format)
        for t in ts
    )


def _reach(q0: int, ql: int, kl: int, window: int) -> tuple[int, int]:
    """The pool positions ``[lo, hi)`` a row's lanes can see."""
    hi = min(kl, q0 + ql) if ql > 0 else 0
    return (max(0, q0 - window + 1) if window > 0 else 0), hi


def _seen(q0: int, j: int, kl: int, window: int) -> int:
    """Keys lane ``j`` of a row from ``q0`` sees."""
    n = min(q0 + j + 1, kl)
    return max(0, n - max(0, q0 + j + 1 - window)) if window > 0 else n


def cost(q, k_pool, v_pool, block_tables, desc, owned=None, partials: bool = False,
         desc_host=None, tables_host=None, window: int = 0):
    """(FLOPs by dtype, bytes) of one call: q of the live lanes, the K/V of
    the pool positions the rows reach, the descriptors and the table
    entries (and ``owned`` mask bytes) read once, every lane's output (the
    f32 ``(o, m, l)`` with ``partials``) written once; Q.K and P.V over
    each live lane's visible keys.  ``desc_host`` (the descriptors as a
    list of ``(slot, q_start, q_len, kv_len[, q_off])``) is what the data
    needs, and with ``tables_host`` (the tables as lists) a position that
    several rows' entries alias is read once; None takes every lane live
    and seeing its whole table span, all the shapes tell (packed: the N
    lanes spread over the R rows).  ``window`` > 0 counts only the keys
    inside each lane's window, and the positions and table entries from
    the row's lowest lane's window start on."""
    r, w, lanes = _lanes(q, desc)
    h, dh = q.shape[-2:]
    bs, kv = k_pool.shape[1], k_pool.shape[2]
    span = block_tables.shape[1] * bs
    if desc_host is None:
        desc_host = [(i, 0, lanes // r + (i < lanes % r), span) for i in range(r)]
        if window > 0:
            flops = sum(4 * h * dh * _seen(q0, j, kl, window) for _, q0, ql, kl in desc_host for j in range(ql))
        else:
            flops = 4 * h * dh * lanes * span
    else:
        desc_host = [d[:4] for d in desc_host]
        flops = sum(4 * h * dh * _seen(q0, j, kl, window) for _, q0, ql, kl in desc_host for j in range(ql))
    n_q = sum(ql for _, _, ql, _ in desc_host)
    reach = [_reach(q0, ql, kl, window) for _, q0, ql, kl in desc_host]
    if tables_host is None:
        positions = sum(max(0, hi - lo) for lo, hi in reach)
    else:
        positions = len({(tables_host[d[0]][p // bs], p % bs) for d, (lo, hi) in zip(desc_host, reach)
                         for p in range(lo, hi)})
    es = q.element_size()
    out = lanes * h * (dh + 2) * 4 if partials else lanes * h * dh * es
    entry = 5 if owned is not None else 4
    nbytes = (n_q * h * dh * es + out + 2 * positions * kv * dh * es + r * (5 if w == 0 else 4) * 4
              + sum(-(-hi // bs) - lo // bs for lo, hi in reach if hi > lo) * entry)
    return _build.flops((flops, q.dtype)), nbytes


def mixed_prefill_partials(q, k_pool, v_pool, block_tables, desc, owned=None):
    """The partials form of ``mixed_prefill_attention`` (see
    ``mixed_prefill_partials_plain`` for the contract): the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    _build.refuse_grad("mixed_prefill_partials", q, k_pool, v_pool)
    return _build.counted(
        "mixed_prefill", lambda: cost(q, k_pool, v_pool, block_tables, desc, owned, partials=True),
        lambda: _partials(q, k_pool, v_pool, block_tables, desc, owned))


def _partials(q, k_pool, v_pool, block_tables, desc, owned):
    if q.device.type == "cpu":
        return _build.fresh(mixed_prefill_partials_plain(q, k_pool, v_pool, block_tables, desc, owned))
    if q.device.type not in ("meta", "cuda"):
        raise ValueError(f"mixed_prefill_partials: tensor on {q.device}")
    r, w, n = _lanes(q, desc)
    h, dh = q.shape[-2:]
    kv = k_pool.shape[2]
    lead = (n, kv, h // kv) if w == 0 else (r, kv, h // kv, w)
    f32 = dict(dtype=torch.float32, device=q.device)
    o = torch.empty(lead + (dh,), **f32)
    m, l = (torch.empty(lead + (1,), **f32) for _ in range(2))
    if q.device.type == "meta":
        return o, m, l
    _check_mixed("mixed_prefill_partials", q, k_pool, v_pool, block_tables, desc)
    if owned is not None and (owned.shape != block_tables.shape or owned.device != q.device):
        raise ValueError(f"mixed_prefill_partials: owned {tuple(owned.shape)} on {owned.device}, "
                         f"tables {tuple(block_tables.shape)}")
    q, k_pool, v_pool = _aligned(q, k_pool, v_pool)
    tables = block_tables.to(torch.int32).contiguous()
    desc = desc.to(torch.int32).contiguous()
    own = None if owned is None else owned.to(torch.uint8).contiguous()
    if r == 0 or n == 0:
        return o, m, l
    lib = _build.load("mixed_prefill")
    err = lib.mixed_prefill_partials_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(), desc.data_ptr(),
        0 if own is None else own.data_ptr(), o.data_ptr(), m.data_ptr(), l.data_ptr(),
        r, w, n, h, kv, dh, k_pool.shape[1], tables.shape[1], int(q.dtype == torch.bfloat16),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
    )
    _build.check(err, "mixed_prefill_partials")
    global launches
    launches += 1
    return o, m, l


def mixed_prefill_attention(q, k_pool, v_pool, block_tables, desc, window: int = 0):
    """Ragged mixed prefill/decode attention through a block table (see
    the module docstring for the descriptor contract); ``window`` > 0: a
    sliding window of that many keys."""
    _build.refuse_grad("mixed_prefill_attention", q, k_pool, v_pool)
    if window < 0:
        raise ValueError(f"mixed_prefill_attention: window={window}")
    return _build.counted("mixed_prefill", lambda: cost(q, k_pool, v_pool, block_tables, desc, window=window),
                          lambda: _attention(q, k_pool, v_pool, block_tables, desc, window))


def _attention(q, k_pool, v_pool, block_tables, desc, window: int):
    if q.device.type == "cpu":
        return _build.fresh(mixed_prefill_attention_plain(q, k_pool, v_pool, block_tables, desc, window))
    if q.device.type == "meta":
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.device.type != "cuda":
        raise ValueError(f"mixed_prefill_attention: tensor on {q.device}")
    _check_mixed("mixed_prefill_attention", q, k_pool, v_pool, block_tables, desc)
    r, w, n = _lanes(q, desc)
    h, dh = q.shape[-2:]
    kv, bs = k_pool.shape[2], k_pool.shape[1]
    q, k_pool, v_pool = _aligned(q, k_pool, v_pool)
    tables = block_tables.to(torch.int32).contiguous()
    desc = desc.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if r == 0 or n == 0:
        return out
    lib = _build.load("mixed_prefill")
    err = lib.mixed_prefill_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
        desc.data_ptr(), out.data_ptr(), r, w, n, h, kv, dh, bs, tables.shape[1], window,
        int(q.dtype == torch.bfloat16),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
    )
    _build.check(err, "mixed_prefill_attention")
    global launches
    launches += 1
    return out
