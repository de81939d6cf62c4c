"""Flash-decode: one new token per row, against a contiguous cache or
through block tables into the paged pool.

``decode_attention`` (contiguous ``(B, S, KV, dh)`` cache, kernel
``kernels/csrc/flash_decode.cu``) and ``paged_decode_attention`` (block
pool, kernel ``kernels/csrc/paged_decode.cu``) launch their hand-written
kernels for CUDA tensors, run their plain versions for CPU tensors and
return empty outputs for ``meta`` tensors; anything else raises.
``flash_decode_launches`` and ``launches`` count the launches of the two
kernels; ``decode_cost`` and ``paged_cost`` are one call's FLOPs and
bytes, which a cost counter records (``_build.counted``).  Row ``b``
attends its first ``lengths[b]`` positions (through a block table with
``window > 0``, only the last ``window`` of them).  ``combine_partials`` merges the ``(o, m, l)``
partials of disjoint cache shards.

Both kernels split each row's positions over blocks of ``SPLIT`` (one
body, ``kernels/csrc/decode_split.cuh``) and merge the splits' f32
partials in a second launch, into scratch the wrappers allocate.

Serving only: an input that requires grad under grad mode raises, since
the kernel has no backward and would cut the autograd graph silently.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

launches = 0  # paged_decode kernel
flash_decode_launches = 0  # flash_decode kernel

_HEAD_DIMS = (16, 32, 64, 128)
_MAX_GROUP = 16
SPLIT = 64  # positions per block of both kernels (PS in decode_split.cuh)


def _check_decode(name, q, k, v, lengths) -> None:
    """The shapes, dtypes and devices both decode kernels take; raises."""
    b, h, dh = q.shape
    kv, dh_k = k.shape[2], k.shape[3]
    if (
        v.shape != k.shape or dh_k != dh or kv == 0 or h % kv or dh not in _HEAD_DIMS
        or h // kv > _MAX_GROUP or lengths.shape != (b,)
    ):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"lengths {tuple(lengths.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: dtypes {q.dtype} / {k.dtype} / {v.dtype}")
    for t in (k, v, lengths):
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {q.device} and {t.device}")


def _split_scratch(b, kv, g, dh, cap, device, n_split: int | None = None):
    """The splits' f32 partials: o (B, KV, n_split, G, dh), m and l
    (B, KV, n_split, G), n_split = ceil(cap / SPLIT) unless given."""
    n_split = -(-cap // SPLIT) if n_split is None else n_split
    o = torch.empty((b, kv, n_split, g, dh), dtype=torch.float32, device=device)
    m, l = (torch.empty((b, kv, n_split, g), dtype=torch.float32, device=device) for _ in range(2))
    return n_split, o, m, l


def decode_attention_plain(q, k_cache, v_cache, lengths, return_partials: bool = False,
                           empty_zero: bool = False):
    """Dense masked softmax in f32.  q (B, H, dh); caches (B, S, KV, dh);
    row ``b`` attends positions ``< lengths[b]``.  Returns (B, H, dh) in
    q's dtype, or with ``return_partials`` the un-normalised f32 partials
    ``(o (B, KV, G, dh), m (B, KV, G, 1), l (B, KV, G, 1))``.  A row with
    ``lengths[b] == 0`` has every logit at -1e30, so its weights are
    uniform: mean(V), or ``m = -1e30, l = S, o = sum(V)``; with
    ``empty_zero`` its weights are zeroed under the mask instead: 0, or
    ``m = -1e30, l = 0, o = 0`` (what a cache shard holding none of the
    row's positions contributes to a combine)."""
    b, h, dh = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    qr = q.float().reshape(b, kv, h // kv, dh)
    logits = torch.einsum("bkgd,bskd->bkgs", qr, k_cache.float()) / math.sqrt(dh)
    valid = torch.arange(s, device=q.device)[None, None, None, :] < lengths.long()[:, None, None, None]
    logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    if return_partials:
        m = logits.amax(dim=-1, keepdim=True)
        p = torch.exp(logits - m)
        if empty_zero:
            p = torch.where(valid, p, torch.zeros_like(p))
        return torch.einsum("bkgs,bskd->bkgd", p, v_cache.float()), m, p.sum(dim=-1, keepdim=True)
    p = torch.softmax(logits, dim=-1)
    if empty_zero:
        p = torch.where(valid, p, torch.zeros_like(p))
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(b, h, dh).to(q.dtype)


def combine_partials(o, m, l):
    """Merge lists of ``(o, m, l)`` partials from disjoint cache shards
    into the normalised output (B, KV, G, dh) f32."""
    m_g = torch.stack(m).amax(dim=0)
    l_g = sum(li * torch.exp(mi - m_g) for mi, li in zip(m, l))
    o_g = sum(oi * torch.exp(mi - m_g) for mi, oi in zip(m, o))
    return o_g / torch.clamp(l_g, min=1e-30)


def _partials_shapes(b, h, kv, dh):
    return (b, kv, h // kv, dh), (b, kv, h // kv, 1), (b, kv, h // kv, 1)


def decode_cost(q, k_cache, v_cache, lengths, return_partials: bool = False, lengths_host=None):
    """(FLOPs by dtype, bytes) of one ``decode_attention`` call: q, the
    K/V of the positions read and the lengths read once, the output (or
    the f32 partials) written once; Q.K and P.V over those positions.
    ``lengths_host`` (the lengths as a list) is what the data needs; None
    takes every row's whole cache, all the shapes tell (a meta tensor has
    no lengths to read)."""
    b, h, dh = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    n = b * s if lengths_host is None else sum(lengths_host)
    es = q.element_size()
    out = b * h * (dh + 2) * 4 if return_partials else b * h * dh * es
    return _build.flops((4 * n * h * dh, q.dtype)), es * (b * h * dh + 2 * n * kv * dh) + 4 * b + out


def decode_attention(q, k_cache, v_cache, lengths, return_partials: bool = False,
                     empty_zero: bool = False):
    """Single-token attention over a contiguous cache.  The caches are
    read in place through their batch / sequence / head strides when
    head_dim is contiguous and the pointer and strides are 16-byte
    multiples, else from a contiguous copy.  An empty row follows the
    mean rule, or with ``empty_zero`` the exact-zero rule (see
    ``decode_attention_plain``)."""
    _build.refuse_grad("decode_attention", q, k_cache, v_cache)
    return _build.counted(
        "flash_decode", lambda: decode_cost(q, k_cache, v_cache, lengths, return_partials),
        lambda: _decode(q, k_cache, v_cache, lengths, return_partials, empty_zero))


def _decode(q, k_cache, v_cache, lengths, return_partials: bool, empty_zero: bool):
    if q.device.type == "cpu":
        return _build.fresh(decode_attention_plain(q, k_cache, v_cache, lengths, return_partials, empty_zero))
    if q.device.type == "meta":
        if return_partials:
            return tuple(torch.empty(sh, dtype=torch.float32, device=q.device)
                         for sh in _partials_shapes(*q.shape[:2], k_cache.shape[2], q.shape[2]))
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: tensor on {q.device}")
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape[0] != q.shape[0] or k_cache.shape[1] == 0:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k {tuple(k_cache.shape)}")
    _check_decode("decode_attention", q, k_cache, v_cache, lengths)
    b, h, dh = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    q = q.contiguous()
    k_cache, v_cache = (t if _build.aligned16(t) else t.clone(memory_format=torch.contiguous_format)
                        for t in (k_cache, v_cache))
    lengths = lengths.to(torch.int32).contiguous()
    if return_partials:  # (o, m, l), f32
        result = tuple(torch.empty(sh, dtype=torch.float32, device=q.device) for sh in _partials_shapes(b, h, kv, dh))
        ptrs = (0, *(t.data_ptr() for t in result))
    else:
        result = torch.empty_like(q)
        ptrs = (result.data_ptr(), 0, 0, 0)
    if b:
        n_split, *scratch = _split_scratch(b, kv, h // kv, dh, s, q.device)
        lib = _build.load("flash_decode")
        err = lib.flash_decode_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(), *ptrs,
            *(t.data_ptr() for t in scratch), b, h, kv, dh, s, n_split,
            *k_cache.stride()[:3], *v_cache.stride()[:3], int(return_partials), int(empty_zero),
            int(q.dtype == torch.bfloat16), ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
        )
        _build.check(err, "decode_attention")
        global flash_decode_launches
        flash_decode_launches += 1
    return result


def paged_decode_attention_plain(q, k_pool, v_pool, block_tables, lengths, window: int = 0):
    """Gather each row's contiguous view from its table, dense masked
    softmax.  q (B, H, dh); pools (n_pool, bs, KV, dh); block_tables
    (B, n_t); lengths (B,) -> (B, H, dh) in q's dtype.  ``window`` > 0:
    row ``b`` sees only its last ``window`` positions."""
    b, n_t = block_tables.shape
    bs, kv, dh = k_pool.shape[1:]
    tbl = block_tables.long()
    k_view = k_pool[tbl].reshape(b, n_t * bs, kv, dh)
    v_view = v_pool[tbl].reshape(b, n_t * bs, kv, dh)
    if window <= 0:
        return decode_attention_plain(q, k_view, v_view, lengths)
    g = q.shape[1] // kv
    qr = q.float().reshape(b, kv, g, dh)
    logits = torch.einsum("bkgd,bskd->bkgs", qr, k_view.float()) / math.sqrt(dh)
    pos = torch.arange(n_t * bs, device=q.device)[None, :]
    ln = lengths.long()[:, None]
    valid = ((pos < ln) & (pos >= ln - window))[:, None, None, :]
    p = torch.softmax(torch.where(valid, logits, torch.full_like(logits, -1e30)), dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_view.float())
    return out.reshape(b, kv * g, dh).to(q.dtype)


def _window_splits(cap: int, window: int) -> int:
    """Splits of a windowed row: the ``SPLIT``-aligned blocks that ``window``
    consecutive positions can touch, no more than the cache has."""
    n_split = -(-cap // SPLIT)
    return min(n_split, (window - 1) // SPLIT + 2) if window > 0 else n_split


def paged_cost(q, k_pool, v_pool, block_tables, lengths, lengths_host=None, window: int = 0):
    """(FLOPs by dtype, bytes) of one ``paged_decode_attention`` call: q,
    the K/V of the positions read, the table entries they reach and the
    lengths read once, the output written once; Q.K and P.V over those
    positions.  ``lengths_host`` (the lengths as a list) is what the data
    needs; None takes every table entry's whole block.  ``window`` > 0
    counts a row's last ``window`` positions and their entries alone."""
    b, h, dh = q.shape
    bs, kv = k_pool.shape[1], k_pool.shape[2]
    lens = [block_tables.shape[1] * bs] * b if lengths_host is None else lengths_host
    lo = [max(0, n - window) if window > 0 else 0 for n in lens]
    es = q.element_size()
    read = sum(n - s for n, s in zip(lens, lo))
    entries = sum(-(-n // bs) - s // bs for n, s in zip(lens, lo) if n > s)
    nbytes = 2 * b * h * dh * es + 2 * read * kv * dh * es + entries * 4 + b * 4
    return _build.flops((4 * read * h * dh, q.dtype)), nbytes


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths, window: int = 0):
    """Single-token attention through a block table over a shared KV pool.
    A row with ``lengths[b] == 0`` gives 0 (the plain version gives mean(V)
    over the table's span, as ``decode_attention_plain``).  ``window`` > 0:
    each row sees its last ``window`` positions, and the kernel splits
    only those."""
    _build.refuse_grad("paged_decode_attention", q, k_pool, v_pool)
    if window < 0:
        raise ValueError(f"paged_decode_attention: window={window}")
    return _build.counted("paged_decode",
                          lambda: paged_cost(q, k_pool, v_pool, block_tables, lengths, window=window),
                          lambda: _paged(q, k_pool, v_pool, block_tables, lengths, window))


def _paged(q, k_pool, v_pool, block_tables, lengths, window: int):
    if q.device.type == "cpu":
        return _build.fresh(paged_decode_attention_plain(q, k_pool, v_pool, block_tables, lengths, window))
    if q.device.type == "meta":
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: tensor on {q.device}")
    b, h, dh = q.shape
    bs, kv = k_pool.shape[1], k_pool.shape[2]
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError(
            f"paged_decode_attention: q {tuple(q.shape)}, tables {tuple(block_tables.shape)}"
        )
    _check_decode("paged_decode_attention", q, k_pool, v_pool, lengths)
    if block_tables.device != q.device:
        raise ValueError(f"paged_decode_attention: tensors on {q.device} and {block_tables.device}")
    q = q.contiguous()
    # the pools are read with 16-byte copies (a fresh copy if unaligned)
    k_pool, v_pool = (
        t if t.is_contiguous() and t.data_ptr() % 16 == 0 else t.clone(memory_format=torch.contiguous_format)
        for t in (k_pool, v_pool)
    )
    tables = block_tables.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if b == 0:
        return out
    n_t = tables.shape[1]
    n_split, o_part, m_part, l_part = _split_scratch(b, kv, h // kv, dh, n_t * bs, q.device,
                                                     _window_splits(n_t * bs, window))
    lib = _build.load("paged_decode")
    err = lib.paged_decode_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), o_part.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
        b, h, kv, dh, bs, n_t, n_split, window, int(q.dtype == torch.bfloat16),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
    )
    _build.check(err, "paged_decode_attention")
    global launches
    launches += 1
    return out
