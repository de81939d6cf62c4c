"""The port's kernel ops on the CPU (their plain PyTorch versions) against
the reference Pallas kernels in interpret mode and the reference oracles.

Tolerances: top-k scores 1e-5 and ids exact (inputs are integer-valued,
so every score is exact and the ties built in are true ties); attention
2e-5 in f32 and 2e-2 in bf16, and the SSD chunk terms 1e-4, as
tests/test_kernels.py holds the reference; dead lanes and poisoned trash
blocks are held bitwise.
"""
import ctypes
import re
from types import SimpleNamespace

import jax.numpy as jnp

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.chunked_prefill.kernel import mixed_prefill_attention_pallas  # noqa: E402
from repro.kernels.chunked_prefill.ref import mixed_prefill_attention_ref  # noqa: E402
from repro.kernels.decode_attention.kernel import combine_partials as r_combine_partials  # noqa: E402
from repro.kernels.decode_attention.kernel import decode_attention_pallas  # noqa: E402
from repro.kernels.decode_attention.kernel import paged_decode_attention_pallas  # noqa: E402
from repro.kernels.decode_attention.ref import decode_attention_ref, paged_decode_attention_ref  # noqa: E402
from repro.kernels.flash_attention.kernel import flash_attention_pallas  # noqa: E402
from repro.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro.kernels.retrieval_topk.kernel import retrieval_topk_pallas  # noqa: E402
from repro.kernels.retrieval_topk.ref import retrieval_topk_ref  # noqa: E402
from repro.kernels.ssd_scan.kernel import ssd_chunk_pallas  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_chunk_ref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from _lanes import pack_rows  # noqa: E402
from repro_torch.kernels.chunked_prefill import ops as cp_ops  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.retrieval_topk import ops as rt_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ss_ops  # noqa: E402

T = torch.as_tensor


# ---------------- retrieval top-k ----------------
@pytest.mark.parametrize(
    "q,n,d,k",
    [
        (5, 100, 16, 4), (9, 257, 32, 8), (1, 50, 8, 8), (12, 300, 16, 1),
        # lists longer than 32, odd D, k = N: what the card's kernel now takes too
        (3, 130, 7, 40), (2, 70, 13, 70), (5, 200, 33, 33),
    ],
)
def test_retrieval_topk_plain_matches_pallas_and_ref(q, n, d, k):
    rng = np.random.default_rng(q * n)
    base = rng.integers(-3, 4, size=(n // 2 + 1, d)).astype(np.float32)
    cs = np.concatenate([base, base[::-1]])[:n]  # duplicate rows: exact ties
    qs = rng.integers(-2, 3, size=(q, d)).astype(np.float32)
    s, i = rt_ops.retrieval_topk(T(qs), T(cs), k)  # CPU tensors -> plain version
    s_p, i_p = retrieval_topk_pallas(jnp.asarray(qs), jnp.asarray(cs), k, bq=8, bn=64)
    s_r, i_r = retrieval_topk_ref(jnp.asarray(qs), jnp.asarray(cs), k)
    for s_x, i_x in ((s_p, i_p), (s_r, i_r)):
        np.testing.assert_allclose(s.numpy(), np.asarray(s_x), rtol=0, atol=1e-5)
        assert np.array_equal(i.numpy(), np.asarray(i_x))
    assert s.dtype == torch.float32 and i.dtype == torch.int32


@pytest.mark.parametrize("n", [1, 127, 128, 129, 147, 5000, 1 << 20])
@pytest.mark.parametrize("q_blocks,n_sm", [(1, 132), (4, 132), (1, 8)])
def test_retrieval_topk_split_plan_covers_every_row_once(n, q_blocks, n_sm):
    """The partial kernel's splits: each a multiple of 256 rows (of every
    tile the kernel walks), together covering rows 0 .. n-1 once, none
    empty."""
    splits, rows = rt_ops._split_plan(n, q_blocks, n_sm)
    assert rows % rt_ops._SPLIT_ROWS == 0 and rt_ops._SPLIT_ROWS == 256
    bounds = [(s * rows, min(n, (s + 1) * rows)) for s in range(splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    assert all(lo < hi for lo, hi in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))


def test_retrieval_topk_batch_rows_independent():
    rng = np.random.default_rng(1)
    cs = T(rng.standard_normal((200, 32)).astype(np.float32))
    qs = T(rng.standard_normal((7, 32)).astype(np.float32))
    s, i = rt_ops.retrieval_topk(qs, cs, 8)
    for r in range(7):
        s1, i1 = rt_ops.retrieval_topk(qs[r : r + 1], cs, 8)
        np.testing.assert_allclose(s1[0].numpy(), s[r].numpy(), rtol=0, atol=1e-5)
        assert torch.equal(i1[0], i[r])


def _shifted(t):
    """``t``'s values in a view whose data pointer is one element past an
    aligned one."""
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype)
    v = flat[1:].view(t.shape)
    v.copy_(t)
    return v


@pytest.mark.parametrize("dtype,d", [(torch.float32, 3), (torch.float32, 8), (torch.bfloat16, 770), (torch.bfloat16, 16)])
def test_retrieval_topk_rows16_pads_d_with_zero_columns(dtype, d):
    """The rows the card's kernel reads: 16-byte aligned, D padded to a
    multiple of 16 bytes with zero columns (each adds fmaf(0, 0, s) = s to
    a score), the values unchanged; aligned rows are read in place."""
    rng = np.random.default_rng(d)
    t = T(rng.standard_normal((5, d))).to(dtype)
    vec = 16 // t.element_size()
    d_pad = -(-d // vec) * vec
    if d_pad == d:
        assert rt_ops._rows16(t, d_pad) is t
    for src in (t, _shifted(t)):
        out = rt_ops._rows16(src, d_pad)
        assert out.shape == (5, d_pad) and out.dtype == dtype and out.data_ptr() % 16 == 0
        assert torch.equal(out[:, :d], t) and not out[:, d:].any()


@pytest.mark.parametrize("expand", [False, True])
def test_ssd_chunk_rows16_copies_unaligned_rows(expand):
    """x and B as the card's kernel reads them: in place where every row is
    16-byte aligned, else a copy, an expanded group staying expanded."""
    _, bb, _, _, _ = _ssd_args(7, 2, 24, 4, 16, 8)
    t = T(bb[:, :, :1]).expand(2, 24, 4, 8) if expand else T(bb)
    assert ss_ops._rows16(t) is t
    u = _shifted(t[:, :, :1]).expand(t.shape) if expand else _shifted(t)
    assert not _build.aligned16(u)
    out = ss_ops._rows16(u)
    assert _build.aligned16(out) and torch.equal(out, t) and (out.stride(2) == 0) == expand


@pytest.mark.parametrize("l", [1, 64, 65, 300])
@pytest.mark.parametrize("expand", [False, True])
def test_ssd_chunk_scores_scratch_per_group(l, expand):
    """One group of C . B^T tiles when B and C are both expanded over the
    heads, else one per head; n (n + 1) / 2 causal 64 x 64 tiles each."""
    b = torch.zeros((2, l, 1 if expand else 4, 8))
    b = b.expand(2, l, 4, 8) if expand else b
    groups, cbt = ss_ops._scores_scratch(b, b, 2, l, 4)
    n_t = -(-l // 64)
    assert groups == (1 if expand else 4)
    assert cbt.shape == (2, groups, n_t * (n_t + 1) // 2, 64, 64) and cbt.dtype == torch.float32


def test_ops_refuse_other_devices():
    """A device that is neither the CPU, CUDA nor ``meta`` raises (a
    stand-in that only names its device: no such tensor can be made on a
    CPU build)."""
    other = SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError):
        rt_ops.retrieval_topk(other, other, 1)
    with pytest.raises(ValueError):
        cp_ops.mixed_prefill_attention(other, None, None, None, None)
    with pytest.raises(ValueError):
        da_ops.paged_decode_attention(other, None, None, None, None)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(other, other, other)
    with pytest.raises(ValueError):
        da_ops.decode_attention(other, None, None, None)
    with pytest.raises(ValueError):
        ss_ops.ssd_chunk(other, None, None, None, None)


# ---------------- mixed prefill attention ----------------
def _mixed_case(rng, b, w, h, kv, dh, bs, n_t):
    """Random pool, disjoint shuffled tables, and a descriptor mix of
    decode rows, cold and warm fill chunks, a COW-style boundary row and
    a zero-length (all-dead) row."""
    n_pool = b * n_t + 1
    q = rng.standard_normal((b, w, h, dh)).astype(np.float32)
    kp = rng.standard_normal((n_pool, bs, kv, dh)).astype(np.float32)
    vp = rng.standard_normal((n_pool, bs, kv, dh)).astype(np.float32)
    tables = rng.permutation(n_pool - 1)[: b * n_t].reshape(b, n_t).astype(np.int32)
    cap = n_t * bs
    desc = np.zeros((b, 4), np.int32)
    for i in range(b):
        kind = i % 5
        if kind == 0:
            q0 = int(rng.integers(0, cap))
            desc[i] = (i, q0, 1, q0 + 1)
        elif kind == 1:
            ql = int(rng.integers(1, w + 1))
            desc[i] = (i, 0, ql, ql)
        elif kind == 2:
            q0 = int(rng.integers(1, cap - 1))
            ql = int(rng.integers(1, min(w, cap - q0) + 1))
            desc[i] = (i, q0, ql, q0 + ql)
        elif kind == 3:
            kl = int(rng.integers(1, cap + 1))
            desc[i] = (i, kl - 1, 1, kl)
        else:
            desc[i] = (i, int(rng.integers(0, cap)), 0, int(rng.integers(1, cap)))
    return q, kp, vp, tables, desc


@pytest.mark.parametrize(
    "b,w,h,kv,dh,bs,n_t", [(5, 6, 8, 4, 32, 16, 4), (6, 4, 4, 4, 16, 4, 3), (3, 8, 16, 2, 64, 8, 2)]
)
def test_mixed_prefill_plain_matches_pallas_and_ref(b, w, h, kv, dh, bs, n_t):
    rng = np.random.default_rng(b * w + n_t)
    args = _mixed_case(rng, b, w, h, kv, dh, bs, n_t)
    o = cp_ops.mixed_prefill_attention(*map(T, args)).numpy()
    o_p = np.asarray(mixed_prefill_attention_pallas(*map(jnp.asarray, args)))
    o_r = np.asarray(mixed_prefill_attention_ref(*map(jnp.asarray, args)))
    np.testing.assert_allclose(o, o_p, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(o, o_r, rtol=2e-5, atol=2e-5)
    dead = np.arange(w)[None, :] >= args[4][:, 2][:, None]
    assert (o[dead] == 0).all()


@pytest.mark.parametrize(
    "b,w,h,kv,dh,bs,n_t", [(5, 6, 8, 4, 32, 16, 4), (6, 4, 4, 4, 16, 4, 3), (3, 8, 16, 2, 64, 8, 2)]
)
def test_mixed_prefill_packed_plain_matches_ref_at_live_lanes(b, w, h, kv, dh, bs, n_t):
    """The packed form (the rows' live lanes back to back, at offsets that
    are no multiple of a tile; a zero-length row carries no lane) gives
    the reference's padded output at every live lane."""
    rng = np.random.default_rng(b * w + n_t)
    args = _mixed_case(rng, b, w, h, kv, dh, bs, n_t)
    qp, d5, rows, lanes = pack_rows(args[0], args[4])
    assert (d5[:, 2] == 1).any() and (d5[:, 4] % 2).any()
    o = cp_ops.mixed_prefill_attention(*map(T, (qp, *args[1:4], d5))).numpy()
    o_r = np.asarray(mixed_prefill_attention_ref(*map(jnp.asarray, args)))
    assert o.shape == qp.shape
    np.testing.assert_allclose(o, o_r[rows, lanes], rtol=2e-5, atol=2e-5)


def test_mixed_prefill_trash_poison_never_leaks():
    rng = np.random.default_rng(3)
    b, w, h, kv, dh, bs = 2, 4, 4, 2, 16, 8
    q = rng.standard_normal((b, w, h, dh)).astype(np.float32)
    kp = rng.standard_normal((7, bs, kv, dh)).astype(np.float32)
    vp = rng.standard_normal((7, bs, kv, dh)).astype(np.float32)
    tables = np.array([[0, 1, 6], [2, 3, 6]], np.int32)
    desc = np.array([[0, 8, 4, 12], [1, 10, 1, 11]], np.int32)
    base = cp_ops.mixed_prefill_attention(*map(T, (q, kp, vp, tables, desc)))
    kp2, vp2 = kp.copy(), vp.copy()
    for a in (kp2, vp2):
        a[6] = 1e4
        a[1, 4:] = -1e4
        a[3, 3:] = -1e4
    poisoned = cp_ops.mixed_prefill_attention(*map(T, (q, kp2, vp2, tables, desc)))
    assert torch.equal(base, poisoned)


# ---------------- paged decode attention ----------------
@pytest.mark.parametrize("b,h,kv,dh,bs,n_t", [(2, 8, 4, 32, 16, 4), (3, 4, 4, 16, 32, 2), (1, 16, 2, 64, 8, 8)])
def test_paged_decode_plain_matches_pallas_and_ref(b, h, kv, dh, bs, n_t):
    rng = np.random.default_rng(b * h + n_t)
    n_pool = b * n_t + 1
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    kp = rng.standard_normal((n_pool, bs, kv, dh)).astype(np.float32)
    vp = rng.standard_normal((n_pool, bs, kv, dh)).astype(np.float32)
    tables = rng.permutation(n_pool - 1)[: b * n_t].reshape(b, n_t).astype(np.int32)
    lens = rng.integers(1, n_t * bs + 1, size=b).astype(np.int32)
    args = (q, kp, vp, tables, lens)
    o = da_ops.paged_decode_attention(*map(T, args)).numpy()
    o_p = np.asarray(paged_decode_attention_pallas(*map(jnp.asarray, args)))
    o_r = np.asarray(paged_decode_attention_ref(*map(jnp.asarray, args)))
    np.testing.assert_allclose(o, o_p, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(o, o_r, rtol=2e-5, atol=2e-5)


def test_paged_decode_trash_poison_never_leaks():
    rng = np.random.default_rng(3)
    b, h, kv, dh, bs = 2, 4, 2, 16, 8
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    kp = rng.standard_normal((7, bs, kv, dh)).astype(np.float32)
    vp = rng.standard_normal((7, bs, kv, dh)).astype(np.float32)
    tables = np.array([[0, 1, 6], [2, 3, 6]], np.int32)
    lens = np.array([2 * bs, bs + 3], np.int32)
    base = da_ops.paged_decode_attention(*map(T, (q, kp, vp, tables, lens)))
    kp2, vp2 = kp.copy(), vp.copy()
    for a in (kp2, vp2):
        a[6] = 1e4
        a[3, 4:] = -1e4
    poisoned = da_ops.paged_decode_attention(*map(T, (q, kp2, vp2, tables, lens)))
    assert torch.equal(base, poisoned)


# ---------------- dense flash attention ----------------
def _qkv(seed, b, sq, sk, h, kv, dh):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, sq, h, dh)).astype(np.float32),
        rng.standard_normal((b, sk, kv, dh)).astype(np.float32),
        rng.standard_normal((b, sk, kv, dh)).astype(np.float32),
    )


@pytest.mark.parametrize("sq,sk,h,kv,dh", [(32, 32, 4, 4, 16), (64, 64, 8, 2, 32), (128, 128, 4, 1, 64)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_pallas_and_ref(sq, sk, h, kv, dh, causal, dtype):
    """The reference sweep's shapes (tests/test_kernels.py)."""
    args = _qkv(sq + h, 2, sq, sk, h, kv, dh)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    o = fa_ops.flash_attention(*(T(a).to(tdt) for a in args), causal=causal)
    assert o.dtype == tdt and o.shape == (2, sq, h, dh)
    ja = [jnp.asarray(a, jdt) for a in args]
    o_p = flash_attention_pallas(*ja, causal=causal, bq=16, bk=16)
    o_r = flash_attention_ref(*ja, causal=causal)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    for o_x in (o_p, o_r):
        np.testing.assert_allclose(o.float().numpy(), np.asarray(o_x, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize(
    "b,sq,sk,h,kv,dh",
    [(3, 24, 24, 4, 2, 16), (2, 40, 40, 4, 4, 64), (2, 24, 40, 8, 2, 32), (1, 1, 7, 2, 1, 128), (2, 65, 65, 12, 12, 64)],
)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_ragged_matches_ref(b, sq, sk, h, kv, dh, causal):
    """Lengths the path gives the kernel (24-token queries, 40-token
    chunks) and others off any tile multiple, which the reference's Pallas
    wrapper cannot take (it asserts Sq % bq == 0 and Sk % bk == 0)."""
    args = _qkv(sq * sk + h, b, sq, sk, h, kv, dh)
    o = fa_ops.flash_attention(*map(T, args), causal=causal)
    o_r = flash_attention_ref(*map(jnp.asarray, args), causal=causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_r), rtol=2e-5, atol=2e-5)


def test_flash_attention_rejects_q_offset():
    q, k, v = map(T, _qkv(0, 1, 4, 4, 2, 2, 16))
    with pytest.raises(ValueError, match="q_offset"):
        fa_ops.flash_attention(q, k, v, causal=True, q_offset=3)
    assert torch.equal(fa_ops.flash_attention(q, k, v, q_offset=0), fa_ops.flash_attention_plain(q, k, v, causal=True))


# ---------------- contiguous flash-decode ----------------
def _decode_args(seed, b, s, h, kv, dh, lens=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    kc = rng.standard_normal((b, s, kv, dh)).astype(np.float32)
    vc = rng.standard_normal((b, s, kv, dh)).astype(np.float32)
    if lens is None:
        lens = rng.integers(1, s + 1, size=b)
    return q, kc, vc, np.asarray(lens, np.int32)


@pytest.mark.parametrize("b,s,h,kv,dh,bs", [(2, 64, 8, 4, 32, 16), (4, 128, 4, 4, 16, 32), (1, 256, 16, 2, 64, 64)])
def test_decode_attention_plain_matches_pallas_and_ref(b, s, h, kv, dh, bs):
    """The reference sweep's shapes (tests/test_kernels.py): the
    normalised output against the Pallas kernel (interpret mode) and the
    oracle, and the (o, m, l) partials against the Pallas partials."""
    args = _decode_args(b * s, b, s, h, kv, dh)
    o = da_ops.decode_attention(*map(T, args))
    assert o.shape == (b, h, dh) and o.dtype == torch.float32
    ja = [jnp.asarray(a) for a in args]
    for o_x in (decode_attention_pallas(*ja, bs=bs), decode_attention_ref(*ja)):
        np.testing.assert_allclose(o.numpy(), np.asarray(o_x), rtol=2e-5, atol=2e-5)
    parts = da_ops.decode_attention(*map(T, args), return_partials=True)
    parts_p = decode_attention_pallas(*ja, bs=bs, return_partials=True)
    for got, want in zip(parts, parts_p):
        assert tuple(got.shape) == tuple(want.shape)
    o_t, m_t, l_t = (t.numpy() for t in parts)
    o_p, m_p, l_p = (np.asarray(t) for t in parts_p)
    np.testing.assert_allclose(m_t, m_p, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(l_t, l_p, rtol=2e-5, atol=0)
    np.testing.assert_allclose(o_t / l_t, o_p / l_p, rtol=2e-5, atol=2e-5)


def test_decode_attention_empty_row_matches_pallas():
    """A row with lengths 0: the TPU kernel masks all S logits to -1e30 and
    weighs them equally (m = -1e30, l = S, o = sum V), so the answer is
    mean(V), which the oracle's softmax also gives."""
    b, s, h, kv, dh = 3, 64, 8, 4, 32
    args = _decode_args(9, b, s, h, kv, dh, lens=[0, 17, 0])
    ja = [jnp.asarray(a) for a in args]
    o = da_ops.decode_attention(*map(T, args)).numpy()
    o_t, m_t, l_t = (t.numpy() for t in da_ops.decode_attention(*map(T, args), return_partials=True))
    o_p, m_p, l_p = (np.asarray(t) for t in decode_attention_pallas(*ja, bs=16, return_partials=True))
    mean_v = np.repeat(args[2].mean(axis=1), h // kv, axis=1)  # (B, H, dh)
    for r in (0, 2):
        assert (m_t[r] == -1e30).all() and (m_p[r] == -1e30).all()
        assert (l_t[r] == s).all() and (l_p[r] == s).all()
        np.testing.assert_allclose(o_t[r], o_p[r], rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(o[r], mean_v[r], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(o, np.asarray(decode_attention_ref(*ja)), rtol=2e-5, atol=2e-5)


def _kernel_split_partials(q, kc, vc, lens, ps):
    """The partials of the split kernels (``csrc/decode_split.cuh``, the
    TPU's empty-row rule): one per ``ps`` positions of the cache, the last
    split ragged; a split wholly past a non-empty row's length is
    ``(o 0, m -1e30, l 0)``, every other one (each split of an empty row
    too) the partials of its positions."""
    parts = []
    for s0 in range(0, kc.shape[1], ps):
        o, m, l = da_ops.decode_attention(T(q), T(kc[:, s0 : s0 + ps]), T(vc[:, s0 : s0 + ps]),
                                          T(np.clip(lens - s0, 0, ps)), return_partials=True)
        past = T((lens > 0) & (lens <= s0))[:, None, None, None]
        parts.append((torch.where(past, 0.0, o), torch.where(past, -1e30, m), torch.where(past, 0.0, l)))
    return parts


@pytest.mark.parametrize("form", ["shards", "kernel_splits"])
def test_decode_partials_combine_equals_monolithic(form):
    """Partials of disjoint pieces of the cache, combined, equal attention
    over the whole cache (tests/test_kernels.py); the port's combine
    equals the reference's on the same partials.  ``shards``: 4 sequence
    shards, a row leaving its last shard empty.  ``kernel_splits``: the
    split kernels' form, 64-position splits of S = 272 (the last of 16)
    over rows of length 0, 64, 65 and 272, merged as the combine launch
    merges them (M = max m_s, l = sum l_s e^(m_s - M), o likewise), also
    against the monolithic partials and the Pallas kernel."""
    if form == "shards":
        b, s, h, kv, dh, shards = 2, 128, 8, 4, 32, 4
        q, kc, vc, _ = _decode_args(7, b, s, h, kv, dh)
        lens = np.array([s, 77], np.int32)  # row 1 leaves its last shard empty
        step = s // shards
        parts = [
            da_ops.decode_attention(T(q), T(kc[:, i * step : (i + 1) * step]), T(vc[:, i * step : (i + 1) * step]),
                                    T(np.clip(lens - i * step, 0, step)), return_partials=True)
            for i in range(shards)
        ]
    else:
        b, s, h, kv, dh = 4, 272, 8, 4, 32
        q, kc, vc, lens = _decode_args(8, b, s, h, kv, dh, lens=[0, 64, 65, 272])
        parts = _kernel_split_partials(q, kc, vc, lens, da_ops.SPLIT)
        assert len(parts) == 5 and parts[-1][0].shape == (b, kv, h // kv, dh)
    full = da_ops.decode_attention(*map(T, (q, kc, vc, lens)))
    combined = da_ops.combine_partials(*zip(*parts))
    np.testing.assert_allclose(combined.reshape(b, h, dh).numpy(), full.numpy(), rtol=2e-5, atol=2e-5)
    r_comb = r_combine_partials(*([jnp.asarray(t.numpy()) for t in xs] for xs in zip(*parts)))
    np.testing.assert_allclose(combined.numpy(), np.asarray(r_comb), rtol=2e-5, atol=2e-5)
    if form == "kernel_splits":
        o_s, m_s, l_s = (torch.stack(xs) for xs in zip(*parts))
        m_g = m_s.amax(dim=0)
        w = torch.exp(m_s - m_g)
        merged = ((o_s * w).sum(dim=0), m_g, (l_s * w).sum(dim=0))
        ja = [jnp.asarray(a) for a in (q, kc, vc, lens)]
        np.testing.assert_allclose(combined.reshape(b, h, dh).numpy(), np.asarray(decode_attention_pallas(*ja)),
                                   rtol=2e-5, atol=2e-5)
        mono = da_ops.decode_attention(*map(T, (q, kc, vc, lens)), return_partials=True)
        pallas = [np.asarray(t) for t in decode_attention_pallas(*ja, return_partials=True)]
        for o_x, m_x, l_x in ((t.numpy() for t in mono), pallas):
            np.testing.assert_allclose(merged[1].numpy(), m_x, rtol=2e-5, atol=2e-5)
            np.testing.assert_allclose(merged[2].numpy(), l_x, rtol=2e-5, atol=0)
            np.testing.assert_allclose((merged[0] / merged[2]).numpy(), o_x / l_x, rtol=2e-5, atol=2e-5)
        assert (merged[1][0] == -1e30).all() and (merged[2][0] == s).all()  # the empty row: mean V


# ---------------- SSD chunk ----------------
def _ssd_args(seed, b, l, h, hd, ds):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, hd)).astype(np.float32)
    bb = rng.standard_normal((b, l, h, ds)).astype(np.float32)
    cc = rng.standard_normal((b, l, h, ds)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)  # softplus
    a = (-np.exp(rng.standard_normal(h))).astype(np.float32)
    return x, bb, cc, dt, a


@pytest.mark.parametrize("b,l,h,hd,ds", [(1, 16, 2, 8, 8), (2, 32, 4, 16, 8), (2, 64, 2, 32, 16)])
def test_ssd_chunk_plain_matches_pallas_and_ref(b, l, h, hd, ds):
    """The reference sweep's shapes (tests/test_kernels.py), at its 1e-4."""
    args = _ssd_args(l, b, l, h, hd, ds)
    outs = ss_ops.ssd_chunk(*map(T, args))
    shapes = [(b, l, h, hd), (b, h, hd, ds), (b, h)]
    ja = [jnp.asarray(a) for a in args]
    for ref_outs in (ssd_chunk_pallas(*ja), ssd_chunk_ref(*ja)):
        for got, want, shape in zip(outs, ref_outs, shapes):
            assert tuple(got.shape) == shape and got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_ssd_chunk_expanded_group_view_equals_materialised():
    """One group shared by all heads as a head-stride-0 view gives the
    materialised rows' answer bitwise."""
    x, bb, cc, dt, a = _ssd_args(4, 2, 24, 4, 16, 8)
    b1, c1 = T(bb[:, :, :1]).expand(2, 24, 4, 8), T(cc[:, :, :1]).expand(2, 24, 4, 8)
    assert b1.stride(2) == 0
    view = ss_ops.ssd_chunk(T(x), b1, c1, T(dt), T(a))
    mat = ss_ops.ssd_chunk(T(x), b1.contiguous(), c1.contiguous(), T(dt), T(a))
    for got, want in zip(view, mat):
        assert torch.equal(got, want)


# ---------------- the C entry points against their ctypes signatures ----------------
_KIND = {ctypes.c_void_p: "pointer", ctypes.c_int: "int", ctypes.c_longlong: "long long"}


def _c_kind(param: str) -> str:
    """The ctypes kind a C parameter declaration needs."""
    if "*" in param:
        return "pointer"
    words = param.replace("const", " ").split()[:-1]  # the type, without the name
    if words == ["long", "long"]:
        return "long long"
    if words == ["int"]:
        return "int"
    raise AssertionError(f"unexpected C parameter type in {param!r}")


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_entry_points_match_their_ctypes_signatures(name):
    """Every ``extern "C"`` entry point of ``csrc/<name>.cu`` has its
    ``_build.SIGNATURES`` entry, parameter for parameter: a pointer passed
    as ``c_int`` would be cut to 32 bits, an int passed as a pointer read
    as garbage."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    found = {
        fn: [_c_kind(p) for p in params.split(",")]
        for fn, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src)
    }
    assert found, f"no extern \"C\" entry point in {name}.cu"
    want = {fn: [_KIND[t] for t in argtypes] for fn, argtypes in _build.SIGNATURES[name].items()}
    assert found == want
