"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips when no CUDA device is present (decided
inside the ``cuda_device`` fixture, never at import).  On a machine with
the card and without JAX run them with

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: f32 2e-5 (the kernel sums in another order than the plain
version's batched products), bf16 2e-2, top-k ids exact on inputs with
exact integer-valued scores.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.chunked_prefill import ops as cp_ops  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.retrieval_topk import ops as rt_ops  # noqa: E402

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
