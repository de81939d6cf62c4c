"""The port's kernel ops on the CPU (their plain PyTorch versions) against
the reference Pallas kernels in interpret mode and the reference oracles.

Tolerances: top-k scores 1e-5 and ids exact (inputs are integer-valued,
so every score is exact and the ties built in are true ties); attention
2e-5 in f32, as tests/test_kernels.py holds the reference; dead lanes and
poisoned trash blocks are held bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.chunked_prefill.kernel import mixed_prefill_attention_pallas  # noqa: E402
from repro.kernels.chunked_prefill.ref import mixed_prefill_attention_ref  # noqa: E402
from repro.kernels.decode_attention.kernel import paged_decode_attention_pallas  # noqa: E402
from repro.kernels.decode_attention.ref import paged_decode_attention_ref  # noqa: E402
from repro.kernels.retrieval_topk.kernel import retrieval_topk_pallas  # noqa: E402
from repro.kernels.retrieval_topk.ref import retrieval_topk_ref  # noqa: E402
from repro_torch.kernels.chunked_prefill import ops as cp_ops  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.retrieval_topk import ops as rt_ops  # noqa: E402

T = torch.as_tensor


# ---------------- retrieval top-k ----------------
@pytest.mark.parametrize("q,n,d,k", [(5, 100, 16, 4), (9, 257, 32, 8), (1, 50, 8, 8), (12, 300, 16, 1)])
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


def test_retrieval_topk_batch_rows_independent():
    rng = np.random.default_rng(1)
    cs = T(rng.standard_normal((200, 32)).astype(np.float32))
    qs = T(rng.standard_normal((7, 32)).astype(np.float32))
    s, i = rt_ops.retrieval_topk(qs, cs, 8)
    for r in range(7):
        s1, i1 = rt_ops.retrieval_topk(qs[r : r + 1], cs, 8)
        np.testing.assert_allclose(s1[0].numpy(), s[r].numpy(), rtol=0, atol=1e-5)
        assert torch.equal(i1[0], i[r])


def test_ops_refuse_other_devices():
    meta = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError):
        rt_ops.retrieval_topk(meta, meta, 1)
    with pytest.raises(ValueError):
        cp_ops.mixed_prefill_attention(
            torch.empty((1, 1, 2, 16), device="meta"), None, None, None, None
        )
    with pytest.raises(ValueError):
        da_ops.paged_decode_attention(torch.empty((1, 2, 16), device="meta"), None, None, None, None)


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
