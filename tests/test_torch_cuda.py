"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips when no CUDA device is present (decided
inside the ``cuda_device`` fixture, never at import).  On a machine with
the card and without JAX run them with

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: f32 2e-5 (the kernel sums in another order than the plain
version's batched products), bf16 2e-2, top-k ids exact on inputs with
exact integer-valued scores; the SSD chunk terms at rtol = atol = 1e-4,
the reference's own SSD tolerance (tests/test_kernels.py), since its
outputs reach the hundreds.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.chunked_prefill import ops as cp_ops  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.retrieval_topk import ops as rt_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ss_ops  # noqa: E402
from _lanes import pack_rows  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype):
    return 2e-2 if dtype == torch.bfloat16 else 2e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q,n,d,k", [(1, 50, 16, 8), (5, 1000, 64, 4), (33, 5000, 256, 8), (16, 70000, 256, 32)])
def test_retrieval_topk_matches_plain(cuda_device, q, n, d, k, dtype):
    g = torch.Generator(device="cpu").manual_seed(q * n)
    qs = torch.randn(q, d, generator=g).to(dtype).to(cuda_device)
    cs = torch.randn(n, d, generator=g).to(dtype).to(cuda_device)
    s, i = rt_ops.retrieval_topk(qs, cs, k)
    s_p, i_p = rt_ops.retrieval_topk_plain(qs, cs, k)
    torch.cuda.synchronize()
    tol = _tol(dtype)
    np.testing.assert_allclose(s.cpu().numpy(), s_p.cpu().numpy(), rtol=tol, atol=tol)
    # ids are right up to near-ties: the score of every returned id matches
    full = qs.float() @ cs.float().T
    got = torch.gather(full, 1, i.long())
    np.testing.assert_allclose(got.cpu().numpy(), s_p.cpu().numpy(), rtol=tol, atol=tol)


def test_retrieval_topk_ties_and_batch_independence(cuda_device):
    rng = np.random.default_rng(0)
    base = rng.integers(-3, 4, size=(300, 32)).astype(np.float32)
    cs = np.concatenate([base, base[::-1], base[:77]])  # exact duplicate rows
    qs = rng.integers(-2, 3, size=(20, 32)).astype(np.float32)
    ct, qt = torch.as_tensor(cs, device=cuda_device), torch.as_tensor(qs, device=cuda_device)
    s, i = rt_ops.retrieval_topk(qt, ct, 8)
    s_p, i_p = rt_ops.retrieval_topk_plain(qt.cpu(), ct.cpu(), 8)
    assert torch.equal(s.cpu(), s_p) and torch.equal(i.cpu(), i_p)
    for r in (0, 7, 19):
        s1, i1 = rt_ops.retrieval_topk(qt[r : r + 1], ct, 8)
        assert torch.equal(s1[0], s[r]) and torch.equal(i1[0], i[r])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q", [5, 33])
@pytest.mark.parametrize("d", [3, 770, 1100])
@pytest.mark.parametrize("k", [33, 100, "N"])
def test_retrieval_topk_any_k_and_d(cuda_device, k, d, q, dtype):
    """Lists longer than 32 (kept in the partial output), D not a multiple
    of 4 (the wrapper pads the rows with zero columns to 16 bytes) and D
    past 1024."""
    n = 700
    k = n if k == "N" else k
    g = torch.Generator(device="cpu").manual_seed(d * q + k)
    # unit-norm rows, as the embedders hand them over: scores in [-1, 1]
    qs = torch.nn.functional.normalize(torch.randn(q, d, generator=g), dim=1).to(dtype).to(cuda_device)
    cs = torch.nn.functional.normalize(torch.randn(n, d, generator=g), dim=1).to(dtype).to(cuda_device)
    s, i = rt_ops.retrieval_topk(qs, cs, k)
    s_p, _ = rt_ops.retrieval_topk_plain(qs, cs, k)
    torch.cuda.synchronize()
    np.testing.assert_allclose(s.cpu().numpy(), s_p.cpu().numpy(), rtol=2e-5, atol=2e-5)
    got = torch.gather(qs.float() @ cs.float().T, 1, i.long())
    np.testing.assert_allclose(got.cpu().numpy(), s_p.cpu().numpy(), rtol=2e-5, atol=2e-5)
    assert all(len(set(row)) == k for row in i.cpu().tolist())  # every id once


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_retrieval_topk_batch_independence_unaligned_d(cuda_device, dtype):
    """D = 770: every score is still one in-order chain, whatever the batch."""
    g = torch.Generator(device="cpu").manual_seed(770)
    qs = torch.randn(20, 770, generator=g).to(dtype).to(cuda_device)
    cs = torch.randn(3000, 770, generator=g).to(dtype).to(cuda_device)
    s, i = rt_ops.retrieval_topk(qs, cs, 8)
    for r in (0, 7, 19):
        s1, i1 = rt_ops.retrieval_topk(qs[r : r + 1], cs, 8)
        assert torch.equal(s1[0], s[r]) and torch.equal(i1[0], i[r])


def _shifted(t):
    """``t``'s values in a view whose data pointer is one element past a
    16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    v = flat[1:].view(t.shape)
    v.copy_(t)
    return v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_retrieval_topk_unaligned_rows_equal_aligned(cuda_device, dtype):
    """A corpus whose rows are not 16-byte aligned (copied by the wrapper
    before the kernel's 16-byte copies read it) scores bitwise as its
    aligned copy."""
    g = torch.Generator(device="cpu").manual_seed(9)
    qs = torch.randn(20, 256, generator=g).to(dtype).to(cuda_device)
    cs = torch.randn(3000, 256, generator=g).to(dtype).to(cuda_device)
    cs_u = _shifted(cs)
    assert cs_u.data_ptr() % 16
    s, i = rt_ops.retrieval_topk(qs, cs, 8)
    s_u, i_u = rt_ops.retrieval_topk(qs, cs_u, 8)
    assert torch.equal(s, s_u) and torch.equal(i, i_u)


def _mixed_case(rng, b, w, h, kv, dh, bs, n_t, dtype, device):
    n_pool = b * n_t + 1
    q = torch.as_tensor(rng.standard_normal((b, w, h, dh)), dtype=torch.float32)
    kp = torch.as_tensor(rng.standard_normal((n_pool, bs, kv, dh)), dtype=torch.float32)
    vp = torch.as_tensor(rng.standard_normal((n_pool, bs, kv, dh)), dtype=torch.float32)
    tables = torch.as_tensor(rng.permutation(n_pool - 1)[: b * n_t].reshape(b, n_t), dtype=torch.int32)
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
    to = lambda t: t.to(dtype).to(device)  # noqa: E731
    return to(q), to(kp), to(vp), tables.to(device), torch.as_tensor(desc, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,w,h,kv,dh,bs,n_t", [(5, 6, 8, 4, 32, 16, 4), (6, 4, 4, 4, 16, 4, 3), (8, 256, 16, 8, 128, 32, 9)]
)
def test_mixed_prefill_matches_plain(cuda_device, b, w, h, kv, dh, bs, n_t, dtype):
    rng = np.random.default_rng(b * w + n_t)
    args = _mixed_case(rng, b, w, h, kv, dh, bs, n_t, dtype, cuda_device)
    o = cp_ops.mixed_prefill_attention(*args)
    o_p = cp_ops.mixed_prefill_attention_plain(*args)
    torch.cuda.synchronize()
    tol = _tol(dtype)
    np.testing.assert_allclose(o.float().cpu().numpy(), o_p.float().cpu().numpy(), rtol=tol, atol=tol)
    dead = torch.arange(w, device=cuda_device)[None, :] >= args[4][:, 2:3]
    assert (o[dead] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,w,h,kv,dh,bs,n_t", [(5, 6, 8, 4, 32, 16, 4), (6, 4, 4, 4, 16, 4, 3), (8, 256, 16, 8, 128, 32, 9)]
)
def test_mixed_prefill_packed_matches_plain_and_padded(cuda_device, b, w, h, kv, dh, bs, n_t, dtype):
    """The packed form: the rows' live lanes back to back, at offsets that
    are no multiple of a tile, one-lane rows and a zero-length row among
    them; against its plain version, and bitwise the padded form's output
    at every live lane (one kernel body)."""
    rng = np.random.default_rng(b * w + n_t)
    args = _mixed_case(rng, b, w, h, kv, dh, bs, n_t, dtype, cuda_device)
    qp, d5, rows, lanes = pack_rows(args[0], args[4])
    o = cp_ops.mixed_prefill_attention(qp, *args[1:4], d5)
    o_p = cp_ops.mixed_prefill_attention_plain(qp, *args[1:4], d5)
    pad = cp_ops.mixed_prefill_attention(*args)
    torch.cuda.synchronize()
    tol = _tol(dtype)
    np.testing.assert_allclose(o.float().cpu().numpy(), o_p.float().cpu().numpy(), rtol=tol, atol=tol)
    assert torch.equal(o, pad[torch.as_tensor(rows), torch.as_tensor(lanes)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mixed_prefill_packed_at_the_serving_mix(cuda_device, dtype):
    """qwen3-4b's admission step: H = 32, KV = 8, dh = 128, bs = 32, one
    fill of 1,057 lanes beside 31 decode rows, packed at 1,088 lanes; the
    plain version within tolerance, the padded form bitwise."""
    rng = np.random.default_rng(27)
    b, w, h, kv, dh, bs, n_t = 32, 1057, 32, 8, 128, 32, 35
    n_pool = b * n_t + 1
    q = torch.as_tensor(rng.standard_normal((b, w, h, dh)), dtype=torch.float32).to(dtype).to(cuda_device)
    kp, vp = (torch.as_tensor(rng.standard_normal((n_pool, bs, kv, dh)), dtype=torch.float32).to(dtype)
              .to(cuda_device) for _ in range(2))
    tables = torch.as_tensor(rng.permutation(n_pool - 1)[: b * n_t].reshape(b, n_t), dtype=torch.int32,
                             device=cuda_device)
    desc = np.array([(i, int(p), 1, int(p) + 1) for i, p in enumerate(rng.integers(1057, 1120, size=b))], np.int32)
    desc[5] = (5, 0, 1057, 1057)
    desc = torch.as_tensor(desc, device=cuda_device)
    qp, d5, rows, lanes = pack_rows(q, desc)
    assert qp.shape[0] == 1088
    o = cp_ops.mixed_prefill_attention(qp, kp, vp, tables, d5)
    o_p = cp_ops.mixed_prefill_attention_plain(qp, kp, vp, tables, d5)
    pad = cp_ops.mixed_prefill_attention(q, kp, vp, tables, desc)
    torch.cuda.synchronize()
    tol = _tol(dtype)
    np.testing.assert_allclose(o.float().cpu().numpy(), o_p.float().cpu().numpy(), rtol=tol, atol=tol)
    assert torch.equal(o, pad[torch.as_tensor(rows), torch.as_tensor(lanes)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,dh,bs,n_t", [(2, 8, 4, 32, 16, 4), (3, 4, 4, 16, 32, 2), (8, 16, 8, 128, 32, 9)])
def test_paged_decode_matches_plain(cuda_device, b, h, kv, dh, bs, n_t, dtype):
    rng = np.random.default_rng(b * h + n_t)
    n_pool = b * n_t + 1
    q = torch.as_tensor(rng.standard_normal((b, h, dh)), dtype=dtype, device=cuda_device)
    kp = torch.as_tensor(rng.standard_normal((n_pool, bs, kv, dh)), dtype=dtype, device=cuda_device)
    vp = torch.as_tensor(rng.standard_normal((n_pool, bs, kv, dh)), dtype=dtype, device=cuda_device)
    tables = torch.as_tensor(rng.permutation(n_pool - 1)[: b * n_t].reshape(b, n_t), dtype=torch.int32, device=cuda_device)
    lens = torch.as_tensor(rng.integers(1, n_t * bs + 1, size=b), dtype=torch.int32, device=cuda_device)
    o = da_ops.paged_decode_attention(q, kp, vp, tables, lens)
    o_p = da_ops.paged_decode_attention_plain(q, kp, vp, tables, lens)
    torch.cuda.synchronize()
    tol = _tol(dtype)
    np.testing.assert_allclose(o.float().cpu().numpy(), o_p.float().cpu().numpy(), rtol=tol, atol=tol)


def test_kernels_trash_poison_never_leaks(cuda_device):
    rng = np.random.default_rng(3)
    b, w, h, kv, dh, bs = 2, 4, 4, 2, 16, 8
    q = torch.as_tensor(rng.standard_normal((b, w, h, dh)), dtype=torch.float32, device=cuda_device)
    kp = torch.as_tensor(rng.standard_normal((7, bs, kv, dh)), dtype=torch.float32, device=cuda_device)
    vp = torch.as_tensor(rng.standard_normal((7, bs, kv, dh)), dtype=torch.float32, device=cuda_device)
    tables = torch.tensor([[0, 1, 6], [2, 3, 6]], dtype=torch.int32, device=cuda_device)
    desc = torch.tensor([[0, 8, 4, 12], [1, 10, 1, 11]], dtype=torch.int32, device=cuda_device)
    lens = torch.tensor([2 * bs, bs + 3], dtype=torch.int32, device=cuda_device)
    base_m = cp_ops.mixed_prefill_attention(q, kp, vp, tables, desc)
    base_d = da_ops.paged_decode_attention(q[:, 0], kp, vp, tables, lens)
    kp2, vp2 = kp.clone(), vp.clone()
    for t in (kp2, vp2):
        t[6] = 1e4
        t[1, 4:] = -1e4
        t[3, 3:] = -1e4
    assert torch.equal(cp_ops.mixed_prefill_attention(q, kp2, vp2, tables, desc), base_m)
    kp3, vp3 = kp.clone(), vp.clone()
    for t in (kp3, vp3):
        t[6] = 1e4
        t[3, 4:] = -1e4
    assert torch.equal(da_ops.paged_decode_attention(q[:, 0], kp3, vp3, tables, lens), base_d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize(
    "b,sq,sk,h,kv,dh",
    [
        (2, 32, 32, 4, 4, 16), (2, 64, 64, 8, 2, 32), (2, 128, 128, 4, 1, 64),  # the reference sweep
        (3, 24, 24, 12, 12, 64), (5, 40, 40, 12, 12, 64), (2, 24, 40, 8, 2, 32),  # ragged path lengths
        (2, 65, 65, 16, 8, 128), (1, 1, 7, 2, 1, 128), (4, 100, 100, 16, 8, 128),
    ],
)
def test_flash_attention_matches_plain(cuda_device, b, sq, sk, h, kv, dh, causal, dtype):
    rng = np.random.default_rng(b * sq + sk * h + dh)
    q = torch.as_tensor(rng.standard_normal((b, sq, h, dh)), dtype=dtype, device=cuda_device)
    k = torch.as_tensor(rng.standard_normal((b, sk, kv, dh)), dtype=dtype, device=cuda_device)
    v = torch.as_tensor(rng.standard_normal((b, sk, kv, dh)), dtype=dtype, device=cuda_device)
    o = fa_ops.flash_attention(q, k, v, causal=causal)
    o_p = fa_ops.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert o.dtype == dtype and o.shape == (b, sq, h, dh)
    tol = _tol(dtype)
    np.testing.assert_allclose(o.float().cpu().numpy(), o_p.float().cpu().numpy(), rtol=tol, atol=tol)


def test_flash_attention_reads_strided_views(cuda_device):
    """q, k, v sliced out of one fused (B, S, H + 2 KV, dh) projection are
    read in place through their strides and give the contiguous answer."""
    rng = np.random.default_rng(7)
    b, s, h, kv, dh = 3, 50, 8, 2, 64
    qkv = torch.as_tensor(rng.standard_normal((b, s, h + 2 * kv, dh)), dtype=torch.float32, device=cuda_device)
    q, k, v = qkv[:, :, :h], qkv[:, :, h : h + kv], qkv[:, :, h + kv :]
    assert not q.is_contiguous()
    for causal in (True, False):
        o = fa_ops.flash_attention(q, k, v, causal=causal)
        o_c = fa_ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal)
        torch.cuda.synchronize()
        assert torch.equal(o, o_c)
        np.testing.assert_allclose(
            o.cpu().numpy(), fa_ops.flash_attention_plain(q, k, v, causal=causal).cpu().numpy(),
            rtol=2e-5, atol=2e-5,
        )


@pytest.mark.parametrize(
    "b,s,h,kv,dh,causal",
    [(256, 64, 12, 12, 64, False), (147, 40, 12, 12, 64, False), (8, 256, 16, 8, 128, True),
     (8, 256, 64, 8, 128, True)],
    ids=["rerank", "chunk-index", "admit-prefill", "jamba-admit-prefill"],
)
def test_flash_attention_bf16_path_shapes(cuda_device, b, s, h, kv, dh, causal):
    """The four shapes the path gives the tensor-core kernel (jamba's: 8
    query heads per KV head, so a 64-row tile holds 8 positions)."""
    rng = np.random.default_rng(b + s + dh)
    q, k, v = (
        torch.as_tensor(rng.standard_normal((b, s, n, dh)), dtype=torch.bfloat16, device=cuda_device)
        for n in (h, kv, kv)
    )
    o = fa_ops.flash_attention(q, k, v, causal=causal)
    o_p = fa_ops.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    np.testing.assert_allclose(o.float().cpu().numpy(), o_p.float().cpu().numpy(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("g", [1, 2, 8])
@pytest.mark.parametrize("s", [1, 7, 8, 9, 40, 63, 64, 65, 100])
def test_flash_attention_bf16_tile_edges(cuda_device, s, g, dh, causal):
    """Sequence lengths around the 64-row and 64-key tiles, every head dim
    and group size: ragged rows are not stored and ragged keys not scored."""
    b, kv = 2, 2
    rng = np.random.default_rng(s * 31 + g * 7 + dh)
    q = torch.as_tensor(rng.standard_normal((b, s, kv * g, dh)), dtype=torch.bfloat16, device=cuda_device)
    k = torch.as_tensor(rng.standard_normal((b, s, kv, dh)), dtype=torch.bfloat16, device=cuda_device)
    v = torch.as_tensor(rng.standard_normal((b, s, kv, dh)), dtype=torch.bfloat16, device=cuda_device)
    o = fa_ops.flash_attention(q, k, v, causal=causal)
    o_p = fa_ops.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    np.testing.assert_allclose(o.float().cpu().numpy(), o_p.float().cpu().numpy(), rtol=2e-2, atol=2e-2)


def test_flash_attention_bf16_reads_strided_views(cuda_device):
    """bf16 q, k, v sliced out of one fused (B, S, H + 2 KV, dh) projection
    are read in place and give the contiguous call's answer bitwise; a view
    whose strides are not 16-byte multiples is copied first, same answer."""
    rng = np.random.default_rng(8)
    b, s, h, kv, dh = 3, 70, 8, 2, 64
    qkv = torch.as_tensor(rng.standard_normal((b, s, h + 2 * kv, dh)), dtype=torch.bfloat16, device=cuda_device)
    q, k, v = qkv[:, :, :h], qkv[:, :, h : h + kv], qkv[:, :, h + kv :]
    assert not q.is_contiguous()
    odd = torch.as_tensor(rng.standard_normal((b, s * 3 + 1, kv, dh)), dtype=torch.bfloat16, device=cuda_device)
    k_odd = odd[:, 1 : 1 + 3 * s : 3]  # sequence stride 3 * kv * dh, offset of one position: still aligned
    for causal in (True, False):
        o = fa_ops.flash_attention(q, k, v, causal=causal)
        o_c = fa_ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal)
        o_odd = fa_ops.flash_attention(q, k_odd, v, causal=causal)
        o_odd_c = fa_ops.flash_attention(q.contiguous(), k_odd.contiguous(), v.contiguous(), causal=causal)
        torch.cuda.synchronize()
        assert torch.equal(o, o_c) and torch.equal(o_odd, o_odd_c)
        np.testing.assert_allclose(
            o.float().cpu().numpy(), fa_ops.flash_attention_plain(q, k, v, causal=causal).float().cpu().numpy(),
            rtol=2e-2, atol=2e-2,
        )
    # a head_dim of 16 at an offset of 8 elements: 16 bytes is aligned, 8 is not
    w = torch.as_tensor(rng.standard_normal((b, s, 2, 24)), dtype=torch.bfloat16, device=cuda_device)
    q8 = w[:, :, :, 4:20]  # pointer 8 bytes past an aligned one
    assert q8.data_ptr() % 16 == 8
    k8, v8 = (torch.as_tensor(rng.standard_normal((b, s, 1, 16)), dtype=torch.bfloat16, device=cuda_device) for _ in range(2))
    assert torch.equal(fa_ops.flash_attention(q8, k8, v8), fa_ops.flash_attention(q8.contiguous(), k8, v8))


def _paged_case(rng, device, b, h, kv, dh, bs, n_t, lens, dtype):
    n_pool = b * n_t + 1
    q = torch.as_tensor(rng.standard_normal((b, h, dh)), dtype=dtype, device=device)
    kp = torch.as_tensor(rng.standard_normal((n_pool, bs, kv, dh)), dtype=dtype, device=device)
    vp = torch.as_tensor(rng.standard_normal((n_pool, bs, kv, dh)), dtype=dtype, device=device)
    tables = rng.permutation(n_pool - 1)[: b * n_t].reshape(b, n_t)
    for r, n in enumerate(lens):  # entries past the length point at the trash block, as in the engine
        tables[r, -(-n // bs):] = n_pool - 1
    return (q, kp, vp, torch.as_tensor(tables, dtype=torch.int32, device=device),
            torch.as_tensor(lens, dtype=torch.int32, device=device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "h,kv,dh,bs,n_t",
    [(16, 8, 128, 32, 9), (8, 2, 64, 16, 20), (32, 2, 32, 8, 40), (4, 4, 16, 64, 5)],
)
def test_paged_decode_split_edges(cuda_device, h, kv, dh, bs, n_t, dtype):
    """Lengths on either side of the 64-position splits (5 splits a row)
    at group sizes 1 to 16."""
    lens = [1, 63, 64, 65, 288]
    args = _paged_case(np.random.default_rng(h * dh + bs), cuda_device, len(lens), h, kv, dh, bs, n_t, lens, dtype)
    assert -(-n_t * bs // da_ops.SPLIT) > 1
    o = da_ops.paged_decode_attention(*args)
    o_p = da_ops.paged_decode_attention_plain(*args)
    torch.cuda.synchronize()
    tol = _tol(dtype)
    np.testing.assert_allclose(o.float().cpu().numpy(), o_p.float().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_trash_poison_and_empty_row(cuda_device, dtype):
    """Positions at or past a row's length and the trash block behind its
    unused table entries never reach the output (bitwise), and a row of
    length 0 gives an exact 0."""
    lens = [288, 17, 0, 65, 1]
    bs, n_t = 32, 9
    q, kp, vp, tables, ln = _paged_case(np.random.default_rng(9), cuda_device, len(lens), 16, 8, 128, bs, n_t, lens, dtype)
    base = da_ops.paged_decode_attention(q, kp, vp, tables, ln)
    kp2, vp2 = kp.clone(), vp.clone()
    for t in (kp2, vp2):
        t[-1] = 1e4  # the trash block
        t[tables[1, 0].long(), 17:] = -1e4  # past row 1's length 17
        t[tables[3, 2].long(), 1:] = -1e4  # past row 3's length 65
    poisoned = da_ops.paged_decode_attention(q, kp2, vp2, tables, ln)
    torch.cuda.synchronize()
    assert torch.equal(poisoned, base)
    assert bool((base[2] == 0).all())
    live = [0, 1, 3, 4]
    o_p = da_ops.paged_decode_attention_plain(q, kp, vp, tables, ln)
    tol = _tol(dtype)
    np.testing.assert_allclose(base[live].float().cpu().numpy(), o_p[live].float().cpu().numpy(), rtol=tol, atol=tol)


# ---------------- contiguous flash-decode ----------------
def _decode_case(rng, device, b, s, h, kv, dh, dtype):
    q = torch.as_tensor(rng.standard_normal((b, h, dh)), dtype=dtype, device=device)
    k = torch.as_tensor(rng.standard_normal((b, s, kv, dh)), dtype=dtype, device=device)
    v = torch.as_tensor(rng.standard_normal((b, s, kv, dh)), dtype=dtype, device=device)
    lens = rng.integers(1, s + 1, size=b)
    lens[0] = s
    return q, k, v, torch.as_tensor(lens, dtype=torch.int32, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,s,h,kv,dh",
    [(2, 64, 8, 4, 32), (4, 128, 4, 4, 16), (1, 256, 16, 2, 64),  # the reference sweep
     (8, 272, 16, 8, 128), (3, 100, 16, 8, 128), (2, 33, 32, 2, 64),  # serving shape, S off 64
     (8, 272, 64, 8, 128)],  # jamba's decode: 8 query heads per KV head
)
def test_flash_decode_matches_plain(cuda_device, b, s, h, kv, dh, dtype):
    q, k, v, lens = _decode_case(np.random.default_rng(b * s + h + dh), cuda_device, b, s, h, kv, dh, dtype)
    o = da_ops.decode_attention(q, k, v, lens)
    o_p = da_ops.decode_attention_plain(q, k, v, lens)
    torch.cuda.synchronize()
    assert o.dtype == dtype and o.shape == (b, h, dh)
    tol = _tol(dtype)
    np.testing.assert_allclose(o.float().cpu().numpy(), o_p.float().cpu().numpy(), rtol=tol, atol=tol)
    # partials: the running max, the sum and the normalised output
    o_k, m_k, l_k = da_ops.decode_attention(q, k, v, lens, return_partials=True)
    o_q, m_q, l_q = da_ops.decode_attention_plain(q, k, v, lens, return_partials=True)
    torch.cuda.synchronize()
    assert o_k.shape == (b, kv, h // kv, dh) and m_k.shape == l_k.shape == (b, kv, h // kv, 1)
    np.testing.assert_allclose(m_k.cpu().numpy(), m_q.cpu().numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(l_k.cpu().numpy(), l_q.cpu().numpy(), rtol=2e-5, atol=0)
    np.testing.assert_allclose((o_k / l_k).cpu().numpy(), (o_q / l_q).cpu().numpy(), rtol=2e-5, atol=2e-5)


def test_flash_decode_partials_combine_and_strided_cache(cuda_device):
    """4 sequence shards combined == the monolithic answer; a cache read
    through the strides of a wider buffer == the contiguous cache."""
    b, s, h, kv, dh, shards = 8, 272, 16, 8, 128, 4
    rng = np.random.default_rng(11)
    q = torch.as_tensor(rng.standard_normal((b, h, dh)), dtype=torch.float32, device=cuda_device)
    buf = torch.as_tensor(rng.standard_normal((b, s, 2, kv, dh)), dtype=torch.float32, device=cuda_device)
    k, v = buf[:, :, 0], buf[:, :, 1]
    assert not k.is_contiguous()
    lens = torch.as_tensor([272, 17, 200, 64, 250, 131, 99, 1], dtype=torch.int32, device=cuda_device)
    full = da_ops.decode_attention(q, k, v, lens)
    assert torch.equal(full, da_ops.decode_attention(q, k.contiguous(), v.contiguous(), lens))
    step = s // shards
    parts = [
        da_ops.decode_attention(q, k[:, i * step : (i + 1) * step], v[:, i * step : (i + 1) * step],
                                torch.clamp(lens - i * step, 0, step), return_partials=True)
        for i in range(shards)
    ]
    combined = da_ops.combine_partials(*zip(*parts)).reshape(b, h, dh)
    torch.cuda.synchronize()
    np.testing.assert_allclose(combined.cpu().numpy(), full.cpu().numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        full.cpu().numpy(), da_ops.decode_attention_plain(q, k, v, lens).cpu().numpy(), rtol=2e-5, atol=2e-5
    )


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_empty_row_is_mean_of_v(cuda_device, dtype):
    """lengths[b] == 0: every logit is masked, the TPU kernel weighs all S
    positions equally (m = -1e30, l = S, o = sum V), so the answer is mean(V)."""
    b, s, h, kv, dh = 3, 70, 8, 4, 64
    q, k, v, _ = _decode_case(np.random.default_rng(5), cuda_device, b, s, h, kv, dh, dtype)
    lens = torch.as_tensor([0, 9, 0], dtype=torch.int32, device=cuda_device)
    o = da_ops.decode_attention(q, k, v, lens)
    o_k, m_k, l_k = da_ops.decode_attention(q, k, v, lens, return_partials=True)
    torch.cuda.synchronize()
    mean_v = v.float().mean(dim=1).repeat_interleave(h // kv, dim=1)  # (B, H, dh)
    tol = _tol(dtype)
    for r in (0, 2):
        np.testing.assert_allclose(o[r].float().cpu().numpy(), mean_v[r].cpu().numpy(), rtol=tol, atol=tol)
        assert bool((m_k[r] == -1e30).all()) and bool((l_k[r] == s).all())
    np.testing.assert_allclose(
        o.float().cpu().numpy(), da_ops.decode_attention_plain(q, k, v, lens).float().cpu().numpy(),
        rtol=tol, atol=tol,
    )


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("g", [1, 2, 8, 16])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 272])
def test_flash_decode_split_edges(cuda_device, s, g, dh, dtype):
    """Cache lengths and row lengths on either side of the 64-position
    splits, the empty row (mean V) and a length past S (clamped), in the
    normalised and the partials form."""
    kv = 2
    lens = [0, 1, 63, 64, 65, s, s + 7]
    rng = np.random.default_rng(s * 131 + g * 7 + dh)
    q, k, v, _ = _decode_case(rng, cuda_device, len(lens), s, kv * g, kv, dh, dtype)
    ln = torch.as_tensor(lens, dtype=torch.int32, device=cuda_device)
    o = da_ops.decode_attention(q, k, v, ln)
    o_k, m_k, l_k = da_ops.decode_attention(q, k, v, ln, return_partials=True)
    o_p = da_ops.decode_attention_plain(q, k, v, ln)
    o_q, m_q, l_q = da_ops.decode_attention_plain(q, k, v, ln, return_partials=True)
    torch.cuda.synchronize()
    tol = _tol(dtype)
    np.testing.assert_allclose(o.float().cpu().numpy(), o_p.float().cpu().numpy(), rtol=tol, atol=tol)
    np.testing.assert_allclose(m_k.cpu().numpy(), m_q.cpu().numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(l_k.cpu().numpy(), l_q.cpu().numpy(), rtol=2e-5, atol=0)
    np.testing.assert_allclose((o_k / l_k).cpu().numpy(), (o_q / l_q).cpu().numpy(), rtol=2e-5, atol=2e-5)
    assert bool((m_k[0] == -1e30).all()) and bool((l_k[0] == s).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_shard_partials_and_unaligned_view(cuda_device, dtype):
    """Partials of 4 sequence shards (views into the cache, read in place),
    combined, equal the monolithic partials, with an empty row (mean V)
    and a shard with no live position; a cache view at an unaligned
    pointer is copied first and gives the contiguous answer bitwise."""
    b, s, h, kv, dh, shards = 8, 272, 16, 8, 128, 4
    rng = np.random.default_rng(12)
    q, k, v, _ = _decode_case(rng, cuda_device, b, s, h, kv, dh, dtype)
    lens = torch.as_tensor([272, 17, 0, 64, 250, 131, 99, 1], dtype=torch.int32, device=cuda_device)
    step = s // shards
    parts = [
        da_ops.decode_attention(q, k[:, i * step : (i + 1) * step], v[:, i * step : (i + 1) * step],
                                torch.clamp(lens - i * step, 0, step), return_partials=True)
        for i in range(shards)
    ]
    o_m, m_m, l_m = da_ops.decode_attention(q, k, v, lens, return_partials=True)
    combined = da_ops.combine_partials(*zip(*parts))
    full = da_ops.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    np.testing.assert_allclose(combined.cpu().numpy(), (o_m / l_m).cpu().numpy(), rtol=2e-5, atol=2e-5)
    mean_v = v[2].float().mean(dim=0).repeat_interleave(h // kv, dim=0)  # (H, dh)
    tol = _tol(dtype)
    np.testing.assert_allclose(full[2].float().cpu().numpy(), mean_v.cpu().numpy(), rtol=tol, atol=tol)
    np.testing.assert_allclose(combined.reshape(b, h, dh)[2].cpu().numpy(), mean_v.cpu().numpy(), rtol=2e-5, atol=2e-5)
    # two elements past an aligned pointer: 4 bytes in bf16, 8 in f32
    wide = torch.as_tensor(rng.standard_normal((b, s, kv, dh + 8)), dtype=dtype, device=cuda_device)
    k_odd = wide[..., 2 : 2 + dh]
    assert not _build.aligned16(k_odd)
    for form in (False, True):
        got = da_ops.decode_attention(q, k_odd, v, lens, return_partials=form)
        want = da_ops.decode_attention(q, k_odd.contiguous(), v, lens, return_partials=form)
        torch.cuda.synchronize()
        for x, y in zip(*((got, want) if form else ((got,), (want,)))):
            assert torch.equal(x, y)


def _mixed_edges_case(rng, device, g, dh, bs, w=70, kv=2):
    """Rows around the 64-row and 64-key tiles of the bf16 kernel, tables
    whose entries past each row's keys point at the trash block."""
    desc = np.array([
        (0, 0, 64 // g, 64 // g),          # a cold prefill filling one 64-row tile
        (1, 0, 64 // g + 1, 64 // g + 1),  # one lane more: a second tile with G live rows
        (2, 63, 1, 64),                    # decode at the last key of the first key tile
        (3, 64, 1, 65),                    # decode at the first key of the second
        (4, 100, 29, 129),                 # a continuation over key tiles 1-2, one key past 128
        (5, 0, 0, 0),                      # an empty row
        (6, 10, 0, 50),                    # no live lane, a cache behind it
        (7, 30, w, 30 + w),                # every lane live
    ], np.int32)
    r, n_t = len(desc), -(-160 // bs)
    n_pool = r * n_t + 1
    tables = rng.permutation(n_pool - 1)[: r * n_t].reshape(r, n_t)
    for i, (_, _, _, kl) in enumerate(desc):
        tables[i, -(-kl // bs):] = n_pool - 1
    q, kp, vp = (torch.as_tensor(rng.standard_normal(sh), dtype=torch.bfloat16, device=device)
                 for sh in ((r, w, kv * g, dh), (n_pool, bs, kv, dh), (n_pool, bs, kv, dh)))
    return (q, kp, vp, torch.as_tensor(tables, dtype=torch.int32, device=device),
            torch.as_tensor(desc, device=device))


@pytest.mark.parametrize("bs", [4, 16, 32])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("g", [1, 2])
def test_mixed_prefill_bf16_tile_edges(cuda_device, g, dh, bs):
    """The tensor-core kernel at lane and key counts on either side of its
    64-row and 64-key tiles, an all-dead tile and an empty row, 64 / bs
    pool blocks a key tile: against the plain version, dead lanes exactly 0."""
    args = _mixed_edges_case(np.random.default_rng(g * 100 + dh + bs), cuda_device, g, dh, bs)
    o = cp_ops.mixed_prefill_attention(*args)
    o_p = cp_ops.mixed_prefill_attention_plain(*args)
    torch.cuda.synchronize()
    np.testing.assert_allclose(o.float().cpu().numpy(), o_p.float().cpu().numpy(), rtol=2e-2, atol=2e-2)
    dead = torch.arange(o.shape[1], device=cuda_device)[None, :] >= args[4][:, 2:3]
    assert bool((o[dead] == 0).all())


def test_mixed_prefill_bf16_nan_never_reaches_the_output(cuda_device):
    """NaN in the trash block, in the unwritten tail of a row's last block
    and in dead lanes' q changes no bit of the output at the path shape,
    and dead lanes stay exactly 0."""
    r, w, h, kv, dh, bs, n_t = 8, 256, 16, 8, 128, 32, 9
    rng = np.random.default_rng(21)
    desc_h = [(0, 0, 180, 180), (1, 100, 76, 176)] + [(i, 120 + 25 * i, 1, 121 + 25 * i) for i in range(2, 7)] + [(7, 0, 0, 0)]
    n_pool = r * n_t + 1
    tables = rng.permutation(n_pool - 1)[: r * n_t].reshape(r, n_t)
    for i, (_, _, _, kl) in enumerate(desc_h):
        tables[i, -(-kl // bs):] = n_pool - 1
    q, kp, vp = (torch.as_tensor(rng.standard_normal(sh), dtype=torch.bfloat16, device=cuda_device)
                 for sh in ((r, w, h, dh), (n_pool, bs, kv, dh), (n_pool, bs, kv, dh)))
    tables = torch.as_tensor(tables, dtype=torch.int32, device=cuda_device)
    desc = torch.as_tensor(desc_h, dtype=torch.int32, device=cuda_device)
    base = cp_ops.mixed_prefill_attention(q, kp, vp, tables, desc)
    dead = torch.arange(w, device=cuda_device)[None, :] >= desc[:, 2:3]
    q2, kp2, vp2 = q.clone(), kp.clone(), vp.clone()
    q2[dead] = float("nan")
    for t in (kp2, vp2):
        t[n_pool - 1] = float("nan")  # the trash block
        t[tables[0, 5].long(), 180 - 5 * bs:] = float("nan")  # past row 0's kv_len 180
        t[tables[1, 5].long(), 176 - 5 * bs:] = float("nan")  # past row 1's kv_len 176
    poisoned = cp_ops.mixed_prefill_attention(q2, kp2, vp2, tables, desc)
    torch.cuda.synchronize()
    assert torch.equal(poisoned, base)
    assert bool((base[dead] == 0).all())
    np.testing.assert_allclose(
        base.float().cpu().numpy(), cp_ops.mixed_prefill_attention_plain(q, kp, vp, tables, desc).float().cpu().numpy(),
        rtol=2e-2, atol=2e-2,
    )


# ---------------- SSD chunk ----------------
def _ssd_case(rng, device, b, l, h, hd, ds, dtype, expand=False):
    x = torch.as_tensor(rng.standard_normal((b, l, h, hd)), dtype=dtype, device=device)
    gh = 1 if expand else h
    bb = torch.as_tensor(rng.standard_normal((b, l, gh, ds)), dtype=dtype, device=device)
    cc = torch.as_tensor(rng.standard_normal((b, l, gh, ds)), dtype=dtype, device=device)
    if expand:
        bb, cc = bb.expand(b, l, h, ds), cc.expand(b, l, h, ds)
    dt = torch.nn.functional.softplus(torch.as_tensor(rng.standard_normal((b, l, h)), dtype=torch.float32, device=device))
    a = -torch.exp(torch.as_tensor(rng.standard_normal(h), dtype=torch.float32, device=device))
    return x, bb, cc, dt, a


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ds", [16, 128])
@pytest.mark.parametrize("l,hd", [(16, 64), (64, 64), (256, 64), (100, 16)])
def test_ssd_chunk_matches_plain(cuda_device, l, hd, ds, dtype):
    args = _ssd_case(np.random.default_rng(l * ds + hd), cuda_device, 2, l, 4, hd, ds, dtype)
    outs = ss_ops.ssd_chunk(*args)
    plain = ss_ops.ssd_chunk_plain(*args)
    torch.cuda.synchronize()
    for got, want, shape in zip(outs, plain, [(2, l, 4, hd), (2, 4, hd, ds), (2, 4)]):
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=1e-4)


def test_ssd_chunk_reads_expanded_group_views(cuda_device):
    """One group shared by every head, handed over as a head-stride-0
    view, gives the materialised answer bitwise; x and dt sliced out of a
    longer sequence are read in place."""
    x, bb, cc, dt, a = _ssd_case(np.random.default_rng(3), cuda_device, 2, 300, 8, 64, 128, torch.bfloat16, expand=True)
    assert bb.stride(2) == 0
    xs, bs_, cs, dts = x[:, 22:278], bb[:, 22:278], cc[:, 22:278], dt[:, 22:278]
    got = ss_ops.ssd_chunk(xs, bs_, cs, dts, a)
    want = ss_ops.ssd_chunk(*(t.contiguous() for t in (xs, bs_, cs, dts)), a)
    plain = ss_ops.ssd_chunk_plain(xs, bs_, cs, dts, a)
    torch.cuda.synchronize()
    for g, w, p in zip(got, want, plain):
        assert torch.equal(g, w)
        np.testing.assert_allclose(g.cpu().numpy(), p.cpu().numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l", [1, 100, 300])
def test_ssd_chunk_one_group_over_heads_equals_materialised(cuda_device, l, dtype):
    """One group expanded over 8 heads (C.B^T computed once for all of
    them) against its materialised copy (once per head): the same bits."""
    x, bb, cc, dt, a = _ssd_case(np.random.default_rng(l), cuda_device, 2, l, 8, 64, 128, dtype, expand=True)
    got = ss_ops.ssd_chunk(x, bb, cc, dt, a)
    want = ss_ops.ssd_chunk(x, bb.contiguous(), cc.contiguous(), dt, a)
    plain = ss_ops.ssd_chunk_plain(x, bb, cc, dt, a)
    torch.cuda.synchronize()
    for g, w, p in zip(got, want, plain):
        assert torch.equal(g, w)
        np.testing.assert_allclose(g.cpu().numpy(), p.cpu().numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l", [1, 100, 256])
def test_ssd_chunk_groups_repeated_per_head(cuda_device, l, dtype):
    """jamba's mixer: 8 groups of B and C at state 16, each repeated over
    the 8 heads that read it (``repeat_interleave``, so head stride != 0
    and the kernel takes one group per head), hd 64: against the plain
    version, and against the same rows handed over as one group expanded
    over the heads where all 8 groups are equal."""
    rng = np.random.default_rng(l + 17)
    b, h, hd, ds, g = 2, 64, 64, 16, 8
    x, _, _, dt, a = _ssd_case(rng, cuda_device, b, l, h, hd, ds, dtype)
    bg = torch.as_tensor(rng.standard_normal((b, l, g, ds)), dtype=dtype, device=cuda_device)
    cg = torch.as_tensor(rng.standard_normal((b, l, g, ds)), dtype=dtype, device=cuda_device)
    bh, ch = bg.repeat_interleave(h // g, dim=2), cg.repeat_interleave(h // g, dim=2)
    assert ss_ops._scores_scratch(bh, ch, b, l, h)[0] == h
    outs = ss_ops.ssd_chunk(x, bh, ch, dt, a)
    plain = ss_ops.ssd_chunk_plain(x, bh, ch, dt, a)
    torch.cuda.synchronize()
    for got, want in zip(outs, plain):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=1e-4)
    one, per_head = bg[:, :, :1].expand(b, l, h, ds), bg[:, :, :1].repeat_interleave(h, dim=2)
    c_one, c_per_head = cg[:, :, :1].expand(b, l, h, ds), cg[:, :, :1].repeat_interleave(h, dim=2)
    for p, q in zip(ss_ops.ssd_chunk(x, one, c_one, dt, a), ss_ops.ssd_chunk(x, per_head, c_per_head, dt, a)):
        assert torch.equal(p, q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_unaligned_rows_equal_aligned(cuda_device, dtype):
    """x and B whose rows are not 16-byte aligned (copied by the wrapper
    before the kernel's 16-byte copies read them), B also as one group
    expanded over the heads, give bitwise the outputs of their aligned
    copies."""
    x, bb, cc, dt, a = _ssd_case(np.random.default_rng(5), cuda_device, 2, 100, 4, 64, 128, dtype)
    xu, bu = _shifted(x), _shifted(bb)
    assert xu.data_ptr() % 16 and bu.data_ptr() % 16
    got = ss_ops.ssd_chunk(xu, bu, cc, dt, a)
    want = ss_ops.ssd_chunk(x, bb, cc, dt, a)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    x, bb, cc, dt, a = _ssd_case(np.random.default_rng(6), cuda_device, 2, 100, 4, 64, 128, dtype, expand=True)
    bu = _shifted(bb[:, :, :1]).expand(bb.shape)
    assert bu.data_ptr() % 16 and bu.stride(2) == 0
    got = ss_ops.ssd_chunk(x, bu, cc, dt, a)
    want = ss_ops.ssd_chunk(x, bb, cc, dt, a)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---------------- the prefix cache on the card ----------------
_WARM_LEN = (200, 231, 257, 287, 192, 150, 95, 288)  # prompt lengths; 192 and 288 end on a block


def _warm_admission_case(device, dtype, bs=32, n_t=9, h=16, kv=8, dh=128, w=256):
    """Rows 0-3 and 4-7 each share one cached chain: a row's table points
    its first L // bs entries at the chain (less the boundary block, copied
    privately, where L ends on a block) and prefills only its suffix."""
    r = len(_WARM_LEN)
    n_pool = r * n_t + 1
    chain = (list(range(n_t)), list(range(n_t, 2 * n_t)))
    tables = np.full((r, n_t), n_pool - 1, np.int32)
    desc, nxt = [], 2 * n_t
    for i, ln in enumerate(_WARM_LEN):
        cow = ln % bs == 0
        own = chain[i // 4][: ln // bs - cow]
        for c in range(-(-ln // bs)):
            if c < len(own):
                tables[i, c] = own[c]
            else:
                tables[i, c], nxt = nxt, nxt + 1
        q0 = ln - 1 if cow else ln // bs * bs
        desc.append((i, q0, ln - q0, ln))
    g = torch.Generator(device="cpu").manual_seed(17)
    q = torch.randn(r, w, h, dh, generator=g).to(dtype).to(device)
    kp, vp = (torch.randn(n_pool, bs, kv, dh, generator=g).to(dtype).to(device) for _ in range(2))
    return q, kp, vp, torch.as_tensor(tables, device=device), torch.as_tensor(desc, dtype=torch.int32, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mixed_prefill_warm_admission_matches_plain(cuda_device, dtype):
    q, kp, vp, tables, desc = _warm_admission_case(cuda_device, dtype)
    o = cp_ops.mixed_prefill_attention(q, kp, vp, tables, desc)
    o_p = cp_ops.mixed_prefill_attention_plain(q, kp, vp, tables, desc)
    torch.cuda.synchronize()
    tol = _tol(dtype)
    np.testing.assert_allclose(o.float().cpu().numpy(), o_p.float().cpu().numpy(), rtol=tol, atol=tol)
    dead = torch.arange(q.shape[1], device=cuda_device)[None, :] >= desc[:, 2:3]
    assert bool((o[dead] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mixed_prefill_warm_lanes_equal_cold_lanes(cuda_device, dtype):
    """A warm row's suffix lanes give bitwise what the same positions give
    in the cold row that prefills the whole prompt from 0 over the same
    pool: a lane's result depends on its position, not on its lane or the
    lanes beside it (the trailing key tiles its tile walks are fully
    masked for it and leave its softmax unchanged)."""
    q, kp, vp, tables, desc = _warm_admission_case(cuda_device, dtype)
    warm = cp_ops.mixed_prefill_attention(q, kp, vp, tables, desc)
    # cold: row i prefills [0, L) in lanes 0..L-1 (L reaches 288, past the
    # warm step's 256 lanes): the warm row's lane j is position q0 + j
    qc = torch.zeros((q.shape[0], 320, *q.shape[2:]), dtype=q.dtype, device=q.device)
    desc_c = desc.clone()
    for i, (_, q0, ql, ln) in enumerate(desc.tolist()):
        qc[i, q0 : q0 + ql] = q[i, :ql]
        desc_c[i, 1], desc_c[i, 2] = 0, ln
    cold = cp_ops.mixed_prefill_attention(qc, kp, vp, tables, desc_c)
    torch.cuda.synchronize()
    for i, (_, q0, ql, _) in enumerate(desc.tolist()):
        assert torch.equal(warm[i, :ql], cold[i, q0 : q0 + ql]), f"row {i}"


def _small_engine(device, dtype="float32", **kw):
    """Smoke-width qwen3-0.6b (weights drawn from seed 0) on
    ``device``, activations and pool in ``dtype``."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import lm as LM
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import ServeConfig, ServeEngine

    cfg = smoke_config(get_config("qwen3-0.6b")).with_overrides(dtype=dtype, vocab_size=8192)
    params = init_params(LM.param_specs(cfg), torch.Generator(device=device).manual_seed(0), device=device)
    return ServeEngine(cfg, params, ServeConfig(**kw), device=device)


def test_bf16_block_demoted_and_readmitted_bitwise(cuda_device):
    """A bf16 pool block leaves the card for the host tier and comes back
    bit for bit, in bf16; the readmitted chain decodes the cold tokens."""
    kw = dict(max_batch=1, max_prompt_len=8, max_new_tokens=4, sched_chunk=2, paged=True, prefix_cache=True,
              block_size=4, n_pool_blocks=3, spill_bytes=4 << 20)
    eng = _small_engine(cuda_device, "bfloat16", **kw)
    fetched, uploaded = [], []
    real_fetch, real_upload = eng._fetch_block, eng._upload_block

    def fetch(b):
        before = [leaf[:, b].clone() for leaf in eng._pool_leaves()]
        payload, nbytes = real_fetch(b)
        fetched.append((before, [p.clone() for p in payload]))
        return payload, nbytes

    def upload(payload, b):
        real_upload(payload, b)
        uploaded.append(([p.clone() for p in payload], [leaf[:, b].clone() for leaf in eng._pool_leaves()]))

    eng._fetch_block, eng._upload_block = fetch, upload
    rng = np.random.default_rng(9)
    a, b = (rng.integers(8, 8192, size=8).astype(np.int32) for _ in range(2))
    cold = eng.serve_prompts([a], max_new_tokens=4)[0]
    eng.serve_prompts([b], max_new_tokens=4)
    warm = eng.serve_prompts([a], max_new_tokens=4)[0]
    assert eng._index.n_demotions >= 1 and eng._index.n_readmits >= 1 and uploaded
    assert np.array_equal(cold, warm)
    for before, payload in fetched:
        assert all(p.dtype == torch.bfloat16 and p.device.type == "cpu" for p in payload)
        assert all(torch.equal(x.cpu(), p) for x, p in zip(before, payload))
    for payload, after in uploaded:
        assert all(torch.equal(p, x.cpu()) for p, x in zip(payload, after))
        assert any(all(torch.equal(p, q) for p, q in zip(payload, d)) for _, d in fetched)


@pytest.mark.parametrize("block_size", [4, 16])
def test_prefix_cache_warm_equals_cold_tokens(cuda_device, block_size):
    """On the card at smoke width: a shared/COW workload with the prefix
    cache gives the tokens of the engine without it, and serving it again
    on the warm engine gives them once more."""
    rng = np.random.default_rng(42)
    pre = rng.integers(8, 8192, size=16).astype(np.int32)
    prompts = [np.concatenate([pre, rng.integers(8, 8192, size=n).astype(np.int32)]) for n in (1, 3)]
    prompts += [pre.copy(), rng.integers(8, 8192, size=9).astype(np.int32), pre.copy()]
    budgets = [5, 1, 4, 5, 2]
    kw = dict(max_batch=2, max_prompt_len=20, max_new_tokens=5, sched_chunk=2, paged=True, block_size=block_size)
    cold = _small_engine(cuda_device, **kw).serve_prompts(prompts, budgets)
    eng = _small_engine(cuda_device, prefix_cache=True, **kw)
    for _ in range(2):
        got = eng.serve_prompts(prompts, budgets)
        for w, g in zip(cold, got):
            assert np.array_equal(w, g)
    assert eng.prefix_hits >= len(prompts) + 2


# --------------------------------------------------------------------- #
# one query head per KV head (qwen2-moe-a2.7b: H = KV = 16, dh = 128),
# speculative verify rows, and the MoE layer
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernels_at_one_head_per_kv_head(cuda_device, dtype):
    """The four attention kernels at qwen2-moe's heads (G = 1, dh = 128)
    and the path's batch, block size and lengths, against their plain
    versions: mixed prefill's tile of 64 flattened (lane, group) rows then
    holds 64 lanes of one head, the decode kernels' blocks one head."""
    rng = np.random.default_rng(61)
    tol = _tol(dtype)

    def close(a, b):
        np.testing.assert_allclose(a.float().cpu().numpy(), b.float().cpu().numpy(), rtol=tol, atol=tol)

    args = _mixed_case(rng, 8, 256, 16, 16, 128, 32, 9, dtype, cuda_device)
    o = cp_ops.mixed_prefill_attention(*args)
    close(o, cp_ops.mixed_prefill_attention_plain(*args))
    assert bool((o[torch.arange(256, device=cuda_device)[None, :] >= args[4][:, 2:3]] == 0).all())
    q, kp, vp, tables = args[0][:, 0], args[1], args[2], args[3]
    lens = torch.as_tensor(rng.integers(1, 9 * 32 + 1, size=8), dtype=torch.int32, device=cuda_device)
    close(da_ops.paged_decode_attention(q, kp, vp, tables, lens), da_ops.paged_decode_attention_plain(q, kp, vp, tables, lens))
    g = torch.Generator(device="cpu").manual_seed(62)
    qf, kf, vf = (torch.randn(8, 256, 16, 128, generator=g).to(dtype).to(cuda_device) for _ in range(3))
    close(fa_ops.flash_attention(qf, kf, vf, causal=True), fa_ops.flash_attention_plain(qf, kf, vf, causal=True))
    kc, vc = (torch.randn(8, 272, 16, 128, generator=g).to(dtype).to(cuda_device) for _ in range(2))
    lc = torch.as_tensor([272, 17, 200, 64, 250, 131, 99, 1], dtype=torch.int32, device=cuda_device)
    close(da_ops.decode_attention(q, kc, vc, lc), da_ops.decode_attention_plain(q, kc, vc, lc))
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kv", [(16, 8), (16, 16)], ids=["G2", "G1"])
def test_verify_lanes_equal_single_lane_rows(cuda_device, h, kv, dtype):
    """A verify row (q_len = k + 1 lanes from the committed position)
    gives each lane bitwise what a q_len = 1 row at that position gives
    over the same pool: the lane's trailing, fully masked key tiles leave
    its m, l and output exactly as they were."""
    bs, n_t, dh, k1 = 32, 9, 128, 4
    rng = np.random.default_rng(h + kv)
    r = 8
    n_pool = r * n_t + 1
    g = torch.Generator(device="cpu").manual_seed(63)
    kp, vp = (torch.randn(n_pool, bs, kv, dh, generator=g).to(dtype).to(cuda_device) for _ in range(2))
    tables = torch.as_tensor(rng.permutation(n_pool - 1)[: r * n_t].reshape(r, n_t), dtype=torch.int32,
                             device=cuda_device)
    q0 = [0, 27, 28, 31, 62, 63, 100, 283]  # windows that end on, before and past a block or a 64-key tile
    q = torch.randn(r, 256, h, dh, generator=g).to(dtype).to(cuda_device)
    desc = torch.as_tensor([(i, s, k1, s + k1) for i, s in enumerate(q0)], dtype=torch.int32, device=cuda_device)
    ver = cp_ops.mixed_prefill_attention(q, kp, vp, tables, desc)
    for j in range(k1):
        qj = torch.zeros_like(q)
        qj[:, 0] = q[:, j]
        dj = torch.as_tensor([(i, s + j, 1, s + j + 1) for i, s in enumerate(q0)], dtype=torch.int32,
                             device=cuda_device)
        one = cp_ops.mixed_prefill_attention(qj, kp, vp, tables, dj)
        torch.cuda.synchronize()
        assert torch.equal(ver[:, j], one[:, 0]), f"lane {j}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_apply_matches_dense_oracle_on_the_card(cuda_device, dtype):
    """The routed experts on the card (expert loop, deterministic combine)
    against ``moe_reference``'s dense products, with every pair kept."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import moe as MOE
    from repro_torch.models.params import init_params

    cfg = ModelConfig(name="t", family="moe", d_model=256, n_experts=12, moe_top_k=4, moe_d_ff=192, d_ff=192,
                      capacity_slack=1.5, dtype="float32")
    p = init_params(MOE.moe_specs(cfg), torch.Generator(device=cuda_device).manual_seed(0), device=cuda_device)
    x = torch.randn(4, 64, 256, generator=torch.Generator(device=cuda_device).manual_seed(1), device=cuda_device)
    x = x.to(dtype)
    out, aux = MOE.moe_apply(cfg, p, x)
    ref, aux_r = MOE.moe_reference(cfg, p, x)
    torch.cuda.synchronize()
    tol = _tol(dtype)
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(), rtol=tol, atol=tol)
    assert float(aux) == float(aux_r)
    again, _ = MOE.moe_apply(cfg, p, x)
    assert torch.equal(out, again), "the combine is deterministic"


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_spec_decode_equals_plain_tokens(cuda_device, prefix_cache):
    """Smoke width, f32, on the card: speculation gives plain decode's
    tokens, with and without the prefix cache."""
    rng = np.random.default_rng(42)
    pre = rng.integers(8, 8192, size=16).astype(np.int32)
    prompts = [np.concatenate([pre, rng.integers(8, 8192, size=n).astype(np.int32)]) for n in (1, 3)]
    prompts += [pre.copy(), rng.integers(8, 8192, size=9).astype(np.int32), pre.copy()]
    budgets = [5, 1, 4, 5, 2]
    kw = dict(max_batch=2, max_prompt_len=20, max_new_tokens=5, sched_chunk=2, paged=True, block_size=8,
              token_budget=7)
    plain = _small_engine(cuda_device, **kw).serve_prompts(prompts, budgets)
    eng = _small_engine(cuda_device, draft_k=3, prefix_cache=prefix_cache, **kw)
    got = eng.serve_prompts(prompts, budgets)
    for w, g in zip(plain, got):
        assert np.array_equal(w, g)
    assert eng.spec_rounds > 0 and eng.spec_tokens_accepted > 0 and eng.decode_dispatches == 0


# ------------------------------------------------------------------ #
# training: gradients through the kernels, head_dim 80, the raise
# ------------------------------------------------------------------ #


def _grads_through(fn, ins, up):
    """Gradients of sum(out * up) + sum(out^2) / 2: the second term makes
    them depend on the forward's output, so the kernel's forward error
    reaches them."""
    leaves = [t.detach().requires_grad_(True) for t in ins]
    out = fn(*leaves)
    outs = out if isinstance(out, tuple) else (out,)
    ups = up if isinstance(up, tuple) else (up,)
    loss = sum((o.float() * u).sum() + 0.5 * (o.float() ** 2).sum() for o, u in zip(outs, ups))
    return out, torch.autograd.grad(loss, leaves)


def _close(a, b, tol):
    """max |a - b| within tol of max(1, max |b|)."""
    err = float((a.float() - b.float()).abs().max())
    assert err <= tol * max(1.0, float(b.float().abs().max())), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh", [64, 80, 128])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 100])
def test_flash_attention_gradient_matches_plain_autograd(cuda_device, s, g, dh, causal, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(s * 7 + dh)
    kv = 4
    q, k, v = (torch.randn(2, s, n, dh, generator=gen, device=cuda_device).to(dtype) for n in (kv * g, kv, kv))
    up = torch.randn(2, s, kv * g, dh, generator=gen, device=cuda_device)
    before = fa_ops.launches
    out, got = _grads_through(lambda a, b, c: fa_ops.flash_attention(a, b, c, causal=causal), (q, k, v), up)
    assert fa_ops.launches == before + 1 and out.grad_fn is not None
    out_p, want = _grads_through(lambda a, b, c: fa_ops.flash_attention_plain(a, b, c, causal=causal), (q, k, v), up)
    torch.cuda.synchronize()
    _close(out, out_p, _tol(dtype))
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        _close(a, b, _tol(dtype))


def test_flash_attention_gradient_through_strided_views(cuda_device):
    """q, k, v as views into one fused projection (heads interleaved):
    the kernel reads them in place, and the gradient lands in the fused
    tensor's layout."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    for dtype in (torch.float32, torch.bfloat16):
        fused = torch.randn(2, 70, 3, 8, 80, generator=gen, device=cuda_device).to(dtype).requires_grad_(True)
        up = torch.randn(2, 70, 8, 80, generator=gen, device=cuda_device)
        grads = []
        for fn in (fa_ops.flash_attention, fa_ops.flash_attention_plain):
            out = fn(fused[:, :, 0], fused[:, :, 1], fused[:, :, 2], causal=True)
            (gf,) = torch.autograd.grad((out.float() * up).sum() + 0.5 * (out.float() ** 2).sum(), (fused,))
            grads.append(gf)
        torch.cuda.synchronize()
        _close(grads[0], grads[1], _tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kv", [(16, 16), (16, 8)])
def test_flash_attention_head_dim_80_matches_plain(cuda_device, h, kv, causal, dtype):
    """HuBERT's head_dim, padded to 128 by the wrapper and scaled by
    1/sqrt(80), at its path shape (B=4, S=256) and a ragged one."""
    gen = torch.Generator(device=cuda_device).manual_seed(h + kv)
    for b, s in ((4, 256), (3, 77)):
        q = torch.randn(b, s, h, 80, generator=gen, device=cuda_device).to(dtype)
        k = torch.randn(b, s, kv, 80, generator=gen, device=cuda_device).to(dtype)
        v = torch.randn(b, s, kv, 80, generator=gen, device=cuda_device).to(dtype)
        o = fa_ops.flash_attention(q, k, v, causal=causal)
        o_p = fa_ops.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert o.shape == (b, s, h, 80) and o.dtype == dtype
        tol = _tol(dtype)
        np.testing.assert_allclose(o.float().cpu().numpy(), o_p.float().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l", [64, 100, 256])
def test_ssd_chunk_gradient_matches_plain_autograd(cuda_device, l, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(l)
    b, h, hd, ds = 2, 8, 64, 128
    x = torch.nn.functional.silu(torch.randn(b, l, h, hd, generator=gen, device=cuda_device)).to(dtype)
    bg = torch.nn.functional.silu(torch.randn(b, l, 1, ds, generator=gen, device=cuda_device)).to(dtype)
    cg = torch.nn.functional.silu(torch.randn(b, l, 1, ds, generator=gen, device=cuda_device)).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(b, l, h, generator=gen, device=cuda_device))
    a = -torch.exp(0.5 * torch.randn(h, generator=gen, device=cuda_device))
    ups = tuple(torch.randn(*shape, generator=gen, device=cuda_device)
                for shape in ((b, l, h, hd), (b, h, hd, ds), (b, h)))

    def run(fn):
        return lambda x_, b_, c_, dt_, a_: fn(x_, b_.expand(b, l, h, ds), c_.expand(b, l, h, ds), dt_, a_)

    before = ss_ops.launches
    outs, got = _grads_through(run(ss_ops.ssd_chunk), (x, bg, cg, dt, a), ups)
    assert ss_ops.launches == before + 1 and all(o.grad_fn is not None for o in outs)
    outs_p, want = _grads_through(run(ss_ops.ssd_chunk_plain), (x, bg, cg, dt, a), ups)
    torch.cuda.synchronize()
    for o, p in zip(outs, outs_p):
        _close(o, p, 1e-4)
    for t, a_, w in zip((x, bg, cg, dt, a), got, want):
        assert a_.shape == t.shape and a_.dtype == t.dtype
        _close(a_, w, 1e-4 if dtype == torch.float32 else 2e-2)


def test_serving_kernels_raise_on_inputs_that_require_grad(cuda_device):
    dev = cuda_device
    q = torch.randn(2, 4, 64, device=dev, requires_grad=True)
    kc = torch.randn(2, 8, 2, 64, device=dev)
    lengths = torch.tensor([3, 8], dtype=torch.int32, device=dev)
    pool = torch.randn(5, 4, 2, 64, device=dev)
    tables = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32, device=dev)
    desc = torch.tensor([[0, 0, 3, 3], [1, 0, 2, 2]], dtype=torch.int32, device=dev)
    calls = [
        lambda: da_ops.decode_attention(q, kc, kc, lengths),
        lambda: da_ops.paged_decode_attention(q, pool, pool, tables, lengths),
        lambda: cp_ops.mixed_prefill_attention(torch.randn(2, 3, 4, 64, device=dev, requires_grad=True), pool, pool,
                                               tables, desc),
        lambda: rt_ops.retrieval_topk(torch.randn(3, 64, device=dev, requires_grad=True),
                                      torch.randn(20, 64, device=dev), 4),
    ]
    counts = (da_ops.flash_decode_launches, da_ops.launches, cp_ops.launches, rt_ops.launches)
    for call in calls:
        with pytest.raises(RuntimeError, match="no backward"):
            call()
    assert (da_ops.flash_decode_launches, da_ops.launches, cp_ops.launches, rt_ops.launches) == counts
    with torch.no_grad():
        assert da_ops.decode_attention(q, kc, kc, lengths).shape == (2, 4, 64)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-1.3b", "pixtral-12b"])
def test_every_leaf_gets_the_cpu_gradient_on_the_card(cuda_device, arch):
    """Smoke width, f32: the card's gradients (kernels forward, plain
    recompute backward, remat on) equal the CPU run's to 1e-4 of each
    leaf's largest entry, and none is missing or zero."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import lm as LM
    from repro_torch.models.params import init_params, leaves, map_tree
    from repro_torch.runtime.steps import value_and_grad

    cfg = smoke_config(get_config(arch)).with_overrides(dtype="float32", remat="block", vocab_size=512)
    p_cpu = init_params(LM.param_specs(cfg), torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(1)
    tok = rng.integers(0, 512, size=(2, 64)).astype(np.int32)
    batch = {"tokens": tok, "targets": tok}
    if cfg.frontend == "patches":
        batch["patch_embeds"] = rng.normal(size=(2, cfg.n_patches, cfg.d_model)).astype(np.float32)
    grads = {}
    for dev in ("cpu", cuda_device):
        p = p_cpu if dev == "cpu" else map_tree(lambda t: t.to(dev), p_cpu)
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        _, _, grads[str(dev)] = value_and_grad(lambda pp: LM.loss_fn(cfg, pp, b), p)
    torch.cuda.synchronize()
    want = dict(leaves(grads["cpu"]))
    for path, g in leaves(grads["cuda"]):
        g = g.cpu()
        assert bool(torch.isfinite(g).all()) and bool((g != 0).any()), path
        assert float((g - want[path]).abs().max()) <= 1e-4 * float(want[path].abs().max()), path


# --------------------------------------------------------------------- #
# sharded serving: the partials forms, the combine, the sharded engine
# --------------------------------------------------------------------- #


def _sharded_case(rng, device, dtype, g, dh, n_shards=4, b=8, w=70, kv=2, bs=16, n_t=6):
    """A global pool of ``n_shards * n_local`` blocks plus the global trash,
    row-affine tables (row r's blocks all on shard r % n_shards, entries
    past its keys at the trash), and rows of every kind: cold and warm
    prefills, decode rows, a dead row, one past a 64-key tile."""
    n_local = (b // n_shards + 1) * n_t
    n_pool = n_shards * n_local
    trash = n_pool
    cap = n_t * bs
    desc = [(0, 0, w, w), (1, 40, 30, 70), (2, 63, 1, 64), (3, 0, 0, 0), (4, cap - 1, 1, cap),
            (5, cap - w, w, cap), (6, 10, 5, 15), (7, 80, 1, 81)]
    tables = np.full((b, n_t), trash, np.int32)
    nxt = [0] * n_shards
    for r, (_, q0, ql, kl) in enumerate(desc):
        s = r % n_shards
        for e in range(-(-max(kl, 1) // bs)):
            tables[r, e] = s * n_local + nxt[s]
            nxt[s] += 1
    q = torch.as_tensor(rng.standard_normal((b, w, kv * g, dh)), dtype=torch.float32).to(dtype).to(device)
    kp = torch.as_tensor(rng.standard_normal((n_pool + 1, bs, kv, dh)), dtype=torch.float32).to(dtype).to(device)
    vp = torch.as_tensor(rng.standard_normal((n_pool + 1, bs, kv, dh)), dtype=torch.float32).to(dtype).to(device)
    return (q, kp, vp, torch.as_tensor(tables, device=device), torch.as_tensor(desc, dtype=torch.int32, device=device),
            n_local)


def _partials_close(got, want, tol):
    o_k, m_k, l_k = (t.cpu() for t in got)
    o_p, m_p, l_p = (t.cpu() for t in want)
    np.testing.assert_allclose(m_k.numpy(), m_p.numpy(), rtol=tol, atol=tol)
    np.testing.assert_allclose(l_k.numpy(), l_p.numpy(), rtol=tol, atol=0)
    ok = l_p[..., 0] > 0
    np.testing.assert_allclose((o_k / l_k)[ok].numpy(), (o_p / l_p)[ok].numpy(), rtol=tol, atol=tol)
    assert bool((o_k[~ok] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("g", [1, 2])
def test_mixed_prefill_partials_match_plain(cuda_device, g, dh, dtype):
    """The partials kernel against its plain version: no mask, a random
    block-level mask, and each shard's row-affine mask; rows that see no
    key give exactly o = 0, l = 0, m = -1e30 (never -inf or -1e30 ln 2)."""
    q, kp, vp, tables, desc, n_local = _sharded_case(np.random.default_rng(g * dh), cuda_device, dtype, g, dh)
    rng = np.random.default_rng(3)
    masks = [None, torch.as_tensor(rng.random(tuple(tables.shape)) < 0.5, device=cuda_device)]
    masks += [(tables // n_local) == s for s in range(4)]
    for owned in masks:
        got = cp_ops.mixed_prefill_partials(q, kp, vp, tables, desc, owned=owned)
        want = cp_ops.mixed_prefill_partials_plain(q, kp, vp, tables, desc, owned=owned)
        torch.cuda.synchronize()
        assert all(t.dtype == torch.float32 and t.shape == u.shape for t, u in zip(got, want))
        _partials_close(got, want, _tol(dtype))
        o, m, l = got
        empty = (want[2] == 0)[..., 0]
        assert bool((m[empty] == -1e30).all()) and bool((l[empty] == 0).all()) and bool((o[empty] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("g", [1, 2])
def test_mixed_prefill_packed_partials_match_plain_and_padded(cuda_device, g, dh, dtype):
    """The packed partials ((N, KV, G, dh), (N, KV, G, 1) twice) against
    their plain version under each mask, and bitwise the padded partials
    at every live lane."""
    q, kp, vp, tables, desc, n_local = _sharded_case(np.random.default_rng(g * dh + 1), cuda_device, dtype, g, dh)
    qp, d5, rows, lanes = pack_rows(q, desc)
    rng = np.random.default_rng(4)
    masks = [None, torch.as_tensor(rng.random(tuple(tables.shape)) < 0.5, device=cuda_device)]
    masks += [(tables // n_local) == s for s in range(4)]
    at = (torch.as_tensor(rows), slice(None), slice(None), torch.as_tensor(lanes))
    for owned in masks:
        got = cp_ops.mixed_prefill_partials(qp, kp, vp, tables, d5, owned=owned)
        want = cp_ops.mixed_prefill_partials_plain(qp, kp, vp, tables, d5, owned=owned)
        pad = cp_ops.mixed_prefill_partials(q, kp, vp, tables, desc, owned=owned)
        torch.cuda.synchronize()
        assert all(t.dtype == torch.float32 and t.shape == u.shape for t, u in zip(got, want))
        _partials_close(got, want, _tol(dtype))
        assert all(torch.equal(t, u[at]) for t, u in zip(got, pad))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mixed_prefill_partials_no_owned_entry_is_exact_zero(cuda_device, dtype):
    """A shard that owns none of the rows' blocks (their entries pointing at
    its trash, poisoned with NaN and 1e4): every lane gives exact zeros
    and m = -1e30, so the combine never meets -inf - -inf."""
    q, kp, vp, tables, desc, n_local = _sharded_case(np.random.default_rng(9), cuda_device, dtype, 2, 128)
    kp[-1], vp[-1] = float("nan"), 1e4
    loc = torch.full_like(tables, kp.shape[0] - 1)
    o, m, l = cp_ops.mixed_prefill_partials(q, kp, vp, loc, desc, owned=torch.zeros_like(tables, dtype=torch.bool))
    torch.cuda.synchronize()
    assert bool((o == 0).all()) and bool((l == 0).all()) and bool((m == -1e30).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("g", [1, 2])
def test_mixed_prefill_partials_4_shard_combine_equals_1_shard_bitwise(cuda_device, g, dh, dtype):
    """Each shard's own pool (its blocks and a trash block, poisoned), its
    local table and ``owned`` mask: the 4 shards' partials combined equal
    the 1-shard partials combined, bit for bit."""
    from repro_torch.serving.dist_decode import combine_partials

    q, kp, vp, tables, desc, n_local = _sharded_case(np.random.default_rng(g + dh), cuda_device, dtype, g, dh)
    one = combine_partials(*[[t] for t in cp_ops.mixed_prefill_partials(
        q, kp, vp, tables, desc, owned=(tables // (4 * n_local)) == 0)])
    none = combine_partials(*[[t] for t in cp_ops.mixed_prefill_partials(q, kp, vp, tables, desc)])
    parts = []
    for s in range(4):
        kl, vl = kp[s * n_local : (s + 1) * n_local + 1].clone(), vp[s * n_local : (s + 1) * n_local + 1].clone()
        kl[-1], vl[-1] = 1e4, float("nan")  # the shard's trash
        owned = (tables // n_local) == s
        loc = torch.where(owned, tables % n_local, n_local)
        parts.append(cp_ops.mixed_prefill_partials(q, kl, vl, loc, desc, owned=owned))
    four = combine_partials(*map(list, zip(*parts)))
    torch.cuda.synchronize()
    assert torch.equal(four, one) and torch.equal(none, one)
    assert bool(torch.isfinite(four).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_empty_zero_partials(cuda_device, dtype):
    """``empty_zero``: a row of length 0 gives o = 0, l = 0, m = -1e30
    exactly (and 0 normalised); every other row is bitwise the mean rule's."""
    b, s, h, kv, dh = 4, 130, 8, 4, 128
    q, k, v, _ = _decode_case(np.random.default_rng(21), cuda_device, b, s, h, kv, dh, dtype)
    lens = torch.as_tensor([0, 9, 130, 0], dtype=torch.int32, device=cuda_device)
    o_z, m_z, l_z = da_ops.decode_attention(q, k, v, lens, return_partials=True, empty_zero=True)
    o_m, m_m, l_m = da_ops.decode_attention(q, k, v, lens, return_partials=True)
    out = da_ops.decode_attention(q, k, v, lens, empty_zero=True)
    plain = da_ops.decode_attention_plain(q, k, v, lens, return_partials=True, empty_zero=True)
    torch.cuda.synchronize()
    for r in (0, 3):
        assert bool((o_z[r] == 0).all()) and bool((l_z[r] == 0).all()) and bool((m_z[r] == -1e30).all())
        assert bool((out[r] == 0).all())
    for r in (1, 2):
        assert torch.equal(o_z[r], o_m[r]) and torch.equal(m_z[r], m_m[r]) and torch.equal(l_z[r], l_m[r])
    _partials_close((o_z, m_z, l_z), plain, _tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_dist_decode_on_one_card_matches_flash_decode(cuda_device, n_shards, dtype):
    """``dist_decode_attention`` over shards all on one card equals
    flash-decode on the whole cache (f32 tolerance on the f32 combine),
    a row of length 0 giving 0."""
    from repro_torch.runtime.compat import make_mesh
    from repro_torch.serving.dist_decode import dist_decode_attention

    b, s, h, kv, dh = 8, 272, 16, 8, 128
    q, k, v, _ = _decode_case(np.random.default_rng(4), cuda_device, b, s, h, kv, dh, dtype)
    lens = torch.as_tensor([272, 17, 0, 64, 250, 131, 99, 1], dtype=torch.int32, device=cuda_device)
    n0 = da_ops.flash_decode_launches
    got = dist_decode_attention(q, k, v, lens, make_mesh(["cuda:0"] * n_shards))
    want = da_ops.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert da_ops.flash_decode_launches - n0 == n_shards + 1
    live = lens > 0
    tol = _tol(dtype)
    np.testing.assert_allclose(got[live].float().cpu().numpy(), want[live].float().cpu().numpy(), rtol=tol, atol=tol)
    assert bool((got[~live] == 0).all())


def test_federated_topk_on_one_card_matches_the_whole_corpus_bitwise(cuda_device):
    """4 providers on one card: the merged scores are bitwise the
    whole-corpus kernel's (each score the same in-order chain), the ids
    equal; a dead provider's ids never appear."""
    from repro_torch.core.retrieval import federated_topk
    from repro_torch.runtime.compat import make_mesh

    g = torch.Generator(device="cpu").manual_seed(8)
    q = torch.nn.functional.normalize(torch.randn(16, 256, generator=g), dim=1).to(cuda_device)
    c = torch.nn.functional.normalize(torch.randn(4 * 2048, 256, generator=g), dim=1).to(cuda_device)
    mesh = make_mesh(["cuda:0"] * 4)
    n0 = rt_ops.launches
    s, i, p = federated_topk(q, c, m_local=8, n_global=8, mesh=mesh)
    s_w, i_w = rt_ops.retrieval_topk(q, c, 8)
    torch.cuda.synchronize()
    assert rt_ops.launches - n0 == 5
    assert torch.equal(s, s_w) and torch.equal(i, i_w) and torch.equal(p, i // 2048)
    alive = torch.tensor([True, False, True, True])
    _, _, p_d = federated_topk(q, c, m_local=8, n_global=8, mesh=mesh, alive=alive)
    assert not bool((p_d == 1).any())


def test_sharded_serving_smoke_width_matches_cpu(cuda_device):
    """Smoke width, f32: shards=4 and 2 on one card give shards=1's tokens
    bit for bit and the CPU run's, through the partials kernel (one launch
    per shard per layer and step)."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import lm as LM
    from repro_torch.models.params import init_params, map_tree
    from repro_torch.runtime.compat import make_mesh
    from repro_torch.serving.engine import ServeConfig, ServeEngine

    cfg = smoke_config(get_config("qwen3-0.6b")).with_overrides(dtype="float32")
    p_cpu = init_params(LM.param_specs(cfg), torch.Generator().manual_seed(0), device="cpu")
    p_gpu = map_tree(lambda t: t.to(cuda_device), p_cpu)
    rng = np.random.default_rng(42)
    prompts = [rng.integers(8, cfg.vocab_size, size=n).astype(np.int32) for n in (9, 11, 6, 3, 11, 7)]
    kw = dict(max_batch=2, max_prompt_len=11, max_new_tokens=5, sched_chunk=2, paged=True, n_pool_blocks=16,
              block_size=4)
    outs, launches = {}, {}
    for dev, p, shards in (("cpu", p_cpu, 1), ("cuda", p_gpu, 1), ("cuda", p_gpu, 2), ("cuda", p_gpu, 4)):
        mesh = make_mesh([f"{dev}:0" if dev == "cuda" else dev] * shards)
        eng = ServeEngine(cfg, p, ServeConfig(shards=shards, **kw), device=dev, mesh=mesh)
        n0 = cp_ops.launches
        outs[dev, shards] = eng.serve_prompts(prompts, max_new_tokens=[5, 1, 4, 5, 2, 5])
        launches[dev, shards] = (cp_ops.launches - n0, (eng.mixed_dispatches, eng.decode_dispatches))
    want = outs["cpu", 1]
    for key, got in outs.items():
        assert all(np.array_equal(a, b) for a, b in zip(want, got)), key
    assert launches["cuda", 1][0] > 0 and launches["cpu", 1][0] == 0
    for shards in (2, 4):  # the same steps, one launch per shard per layer
        assert launches["cuda", shards] == (shards * launches["cuda", 1][0], launches["cuda", 1][1])


# --------------------------------------------------------------------- #
# multi-device training on one card: data-parallel and expert-parallel
# steps over meshes of cuda:0, the kernels at the per-shard batches
# --------------------------------------------------------------------- #


def _dp_grads(cfg, device, shape, batch, params, grad_pspecs=None):
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.models.params import map_tree
    from repro_torch.runtime.compat import make_mesh
    from repro_torch.runtime.sharding import make_policy
    from repro_torch.runtime.steps import data_parallel_grads

    mesh = make_mesh([device] * (shape[0] * shape[1]), ("data", "model"), shape=shape)
    pol = make_policy(mesh, global_batch=batch["tokens"].shape[0])
    placed = shard_batch(batch, mesh, pol.spec("act_batch", shape=batch["tokens"].shape[:1]))
    return data_parallel_grads(cfg, pol, map_tree(lambda t: t.to(device), params), placed, grad_pspecs)


@pytest.mark.parametrize("arch,shape,impl", [("qwen3-0.6b", (2, 1), "psum"), ("qwen3-0.6b", (4, 1), "psum"),
                                             ("mamba2-1.3b", (2, 1), "psum"), ("qwen2-moe-a2.7b", (2, 4), "psum"),
                                             ("qwen2-moe-a2.7b", (2, 4), "a2a")])
def test_dp_and_ep_steps_on_one_card_match_the_cpu_run(cuda_device, arch, shape, impl):
    """Smoke width, f32: the data-parallel (and, for qwen2-moe, expert-
    parallel) gradients over a mesh of cuda:0 equal the same step over a
    mesh of cpu (loss 1e-5 relative, each leaf 1e-4 of its largest entry,
    the card-gradient rule above), through the kernels; the
    reduce-scatter form is bitwise the all-reduce form on the card."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import lm as LM
    from repro_torch.models.params import init_params, leaves, make_pspecs

    cfg = smoke_config(get_config(arch)).with_overrides(dtype="float32", remat="block", vocab_size=512,
                                                        moe_impl=impl)
    params = init_params(LM.param_specs(cfg), torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(2)
    tok = rng.integers(0, 512, size=(8, 64)).astype(np.int32)
    tgt = tok.copy()
    tgt[0, 3:] = -1
    tgt[5, ::2] = -1
    batch = {"tokens": tok, "targets": tgt}
    kernel = ss_ops if cfg.family == "ssm" else fa_ops
    loss_c, _, g_c = _dp_grads(cfg, "cpu", shape, batch, params)
    n0 = kernel.launches
    loss_g, _, g_g = _dp_grads(cfg, "cuda:0", shape, batch, params)
    torch.cuda.synchronize()
    assert kernel.launches - n0 >= 2 * shape[0] * cfg.n_layers  # forward + remat recompute per data shard
    assert float(loss_g) == pytest.approx(float(loss_c), rel=1e-5)
    want = dict(leaves(g_c))
    for path, g in leaves(g_g):
        g = g.cpu()
        assert bool(torch.isfinite(g).all()) and bool((g != 0).any()), path
        assert float((g - want[path]).abs().max()) <= 1e-4 * float(want[path].abs().max()), path
    pspecs = make_pspecs(LM.param_specs(cfg), {"embed": "data", "expert_in": "data"}, {"data": shape[0]})
    _, _, g_rs = _dp_grads(cfg, "cuda:0", shape, batch, params, grad_pspecs=pspecs)
    for (path, a), (_, b) in zip(leaves(g_g), leaves(g_rs)):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("impl", ["psum", "a2a"])
def test_ep_forms_on_one_card_ignore_poisoned_memory(cuda_device, impl):
    """The EP forms' pad-bucket rows and empty slots are zeros even where
    the caching allocator hands back memory that held NaN; the card's
    output equals the CPU's (f32, 1e-5) and, at slack 8, the dense oracle."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import moe as MOE
    from repro_torch.models.params import init_params, map_tree
    from repro_torch.runtime.compat import make_mesh
    from repro_torch.runtime.sharding import ShardingPolicy, base_rules

    outs = {}
    for slack in (8.0, 0.25):
        cfg = ModelConfig(name="t", family="moe", d_model=256, n_experts=12, moe_top_k=4, moe_d_ff=192, d_ff=192,
                          capacity_slack=slack, moe_impl=impl, dtype="float32")
        p = init_params(MOE.moe_specs(cfg, tp_hint=4), torch.Generator().manual_seed(0), device="cpu")
        x = torch.randn(8, 64, 256, generator=torch.Generator().manual_seed(1))
        for dev in ("cpu", "cuda:0"):
            pol = ShardingPolicy(rules=base_rules(False),
                                 mesh=make_mesh([dev] * 8, ("data", "model"), shape=(2, 4)))
            if dev != "cpu":
                junk = torch.full((1 << 24,), float("nan"), device=dev)
                del junk
            outs[slack, dev] = MOE.moe_apply(cfg, map_tree(lambda t: t.to(dev), p), x.to(dev), pol=pol)
        torch.cuda.synchronize()
        got, want = outs[slack, "cuda:0"][0].cpu(), outs[slack, "cpu"][0]
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
        if slack == 8.0:
            dense, _ = MOE.moe_reference(cfg, p, x)
            np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("b,h,kv", [(4, 16, 8), (2, 16, 8), (4, 16, 16)])
def test_flash_attention_at_the_per_shard_batches(cuda_device, b, h, kv):
    """qwen3-0.6b's train shape split over 2 and 4 data shards (B = 4, 2;
    16 / 8 heads of 128, S = 256, causal) and qwen2-moe's (16 / 16 heads),
    bf16: output and gradients against the plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(b * h + kv)
    q, k, v = (torch.randn(b, 256, n, 128, generator=gen, device=cuda_device).to(torch.bfloat16) for n in (h, kv, kv))
    up = torch.randn(b, 256, h, 128, generator=gen, device=cuda_device)
    out, got = _grads_through(lambda a, c, d: fa_ops.flash_attention(a, c, d, causal=True), (q, k, v), up)
    out_p, want = _grads_through(lambda a, c, d: fa_ops.flash_attention_plain(a, c, d, causal=True), (q, k, v), up)
    torch.cuda.synchronize()
    _close(out, out_p, 2e-2)
    for a, w in zip(got, want):
        _close(a, w, 2e-2)


def test_ssd_chunk_at_the_per_shard_batch(cuda_device):
    """mamba2-1.3b's train chunk for one of 2 data shards (B = 4, L = 256,
    64 heads of 64, state 128, one group), bf16: outputs and gradients
    against the plain version at the SSD tolerances above."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    b, l, h, hd, ds = 4, 256, 64, 64, 128
    x = torch.nn.functional.silu(torch.randn(b, l, h, hd, generator=gen, device=cuda_device)).to(torch.bfloat16)
    bg = torch.nn.functional.silu(torch.randn(b, l, 1, ds, generator=gen, device=cuda_device)).to(torch.bfloat16)
    cg = torch.nn.functional.silu(torch.randn(b, l, 1, ds, generator=gen, device=cuda_device)).to(torch.bfloat16)
    dt = torch.nn.functional.softplus(torch.randn(b, l, h, generator=gen, device=cuda_device))
    a = -torch.exp(0.5 * torch.randn(h, generator=gen, device=cuda_device))
    ups = tuple(torch.randn(*shape, generator=gen, device=cuda_device)
                for shape in ((b, l, h, hd), (b, h, hd, ds), (b, h)))

    def run(fn):
        return lambda x_, b_, c_, dt_, a_: fn(x_, b_.expand(b, l, h, ds), c_.expand(b, l, h, ds), dt_, a_)

    outs, got = _grads_through(run(ss_ops.ssd_chunk), (x, bg, cg, dt, a), ups)
    outs_p, want = _grads_through(run(ss_ops.ssd_chunk_plain), (x, bg, cg, dt, a), ups)
    torch.cuda.synchronize()
    for o, p in zip(outs, outs_p):
        _close(o, p, 1e-4)
    for a_, w in zip(got, want):
        _close(a_, w, 2e-2)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-1.3b"])
def test_meta_count_equals_the_cards(cuda_device, arch):
    """The dry run's count of a smoke-width train step on ``meta`` equals
    the same step's on the card: FLOPs, bytes, conversions, collectives and
    kernel calls exactly; the kernels launched on the card only."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as D
    from repro_torch.runtime.sharding import make_policy

    cfg = smoke_config(get_config(arch)).with_overrides(vocab_size=512)
    shape = ShapeConfig("t", 64, 4, "train")
    name = {"qwen3-0.6b": "flash_attention", "mamba2-1.3b": "ssd_chunk"}[arch]
    counter = (fa_ops, "launches") if name == "flash_attention" else (ss_ops, "launches")
    before = getattr(*counter)
    meta, _ = D._run_cell(cfg, shape, make_policy(None), "adamw")
    assert getattr(*counter) == before
    card, _ = D._run_cell(cfg, shape, make_policy(None), "adamw", device="cuda",
                          generator=torch.Generator(device=cuda_device).manual_seed(0))
    torch.cuda.synchronize()
    assert getattr(*counter) > before
    for k in ("flops", "bytes", "convert_bytes", "dus_bytes", "collectives", "kernels"):
        assert getattr(meta, k) == getattr(card, k), k


# ---------------- the sliding window (Mellum2-12B-A2.5B's layers) ----------------


def _window_pool(rng, b, n_t, kv, dh, bs, dtype, device):
    n_pool = b * n_t + 1
    kp, vp = (torch.as_tensor(rng.standard_normal((n_pool, bs, kv, dh)), dtype=torch.float32).to(dtype).to(device)
              for _ in range(2))
    tables = torch.as_tensor(rng.permutation(n_pool - 1)[: b * n_t].reshape(b, n_t), dtype=torch.int32,
                             device=device)
    return kp, vp, tables


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [1, 37, 64, 100, 1024])
@pytest.mark.parametrize("h,kv,dh,bs", [(8, 4, 32, 16), (32, 4, 128, 32)], ids=["G2", "G8-dh128"])
def test_windowed_mixed_prefill_matches_plain(cuda_device, h, kv, dh, bs, window, dtype):
    """A fill's later chunks (900-1,299 and 1,000-1,063: the window's edge
    inside them at 1,024), its first chunk, one-lane rows at the window's
    length and around a 64-key tile, packed; against the plain version,
    bitwise the padded form's lanes, and a window past every row bitwise
    the window-0 kernel."""
    rng = np.random.default_rng(window + h)
    rows4 = [(0, 900, 400, 1300), (1, 0, 300, 300), (2, 1000, 64, 1064), (3, window - 1, 1, window),
             (4, window, 1, window + 1), (5, 1300, 1, 1301), (6, 63, 2, 65)]
    kp, vp, tables = _window_pool(rng, len(rows4), -(-1400 // bs), kv, dh, bs, dtype, cuda_device)
    w = max(d[2] for d in rows4)
    q = torch.as_tensor(rng.standard_normal((len(rows4), w, h, dh)), dtype=torch.float32).to(dtype).to(cuda_device)
    desc = torch.as_tensor(rows4, dtype=torch.int32, device=cuda_device)
    qp, d5, rows, lanes = pack_rows(q, desc)
    o = cp_ops.mixed_prefill_attention(qp, kp, vp, tables, d5, window=window)
    o_p = cp_ops.mixed_prefill_attention_plain(qp, kp, vp, tables, d5, window)
    pad = cp_ops.mixed_prefill_attention(q, kp, vp, tables, desc, window=window)
    wide = cp_ops.mixed_prefill_attention(qp, kp, vp, tables, d5, window=10**6)
    full = cp_ops.mixed_prefill_attention(qp, kp, vp, tables, d5)
    torch.cuda.synchronize()
    tol = _tol(dtype)
    np.testing.assert_allclose(o.float().cpu().numpy(), o_p.float().cpu().numpy(), rtol=tol, atol=tol)
    assert torch.equal(o, pad[torch.as_tensor(rows), torch.as_tensor(lanes)])
    assert torch.equal(wide, full)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [1, 63, 64, 65, 1024])
@pytest.mark.parametrize("h,kv,dh,bs", [(8, 4, 32, 16), (32, 4, 128, 32)], ids=["G2", "G8-dh128"])
def test_windowed_paged_decode_matches_plain(cuda_device, h, kv, dh, bs, window, dtype):
    """Rows from 1 position to 2,240, around the window's length and the
    64-position splits; against the plain version, and a window past every
    row bitwise the window-0 kernel."""
    rng = np.random.default_rng(window * h)
    lens_h = [1, 63, 64, 65, 127, window, window + 1, window + 63, 2048, 2240]
    kp, vp, tables = _window_pool(rng, len(lens_h), 2240 // bs, kv, dh, bs, dtype, cuda_device)
    q = torch.as_tensor(rng.standard_normal((len(lens_h), h, dh)), dtype=torch.float32).to(dtype).to(cuda_device)
    lens = torch.as_tensor(lens_h, dtype=torch.int32, device=cuda_device)
    o = da_ops.paged_decode_attention(q, kp, vp, tables, lens, window=window)
    o_p = da_ops.paged_decode_attention_plain(q, kp, vp, tables, lens, window)
    wide = da_ops.paged_decode_attention(q, kp, vp, tables, lens, window=10**6)
    full = da_ops.paged_decode_attention(q, kp, vp, tables, lens)
    torch.cuda.synchronize()
    tol = _tol(dtype)
    np.testing.assert_allclose(o.float().cpu().numpy(), o_p.float().cpu().numpy(), rtol=tol, atol=tol)
    assert torch.equal(wide, full)
