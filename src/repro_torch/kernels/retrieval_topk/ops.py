"""Top-k maximum-inner-product retrieval: the provider's scoring op.

``retrieval_topk`` launches the hand-written kernel
(``kernels/csrc/retrieval_topk.cu``) for CUDA tensors, runs
``retrieval_topk_plain`` for CPU tensors and returns empty outputs for
``meta`` tensors; anything else raises.  ``cost`` is one call's FLOPs
and bytes, which a cost counter records (``_build.counted``).
``launches`` counts the calls that reach the card, one each (two kernel
launches: the partial lists over splits of the corpus, then their merge).

Serving only: an input that requires grad under grad mode raises, since
the kernel has no backward and would cut the autograd graph silently.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0

_SPLIT_ROWS = 256  # corpus rows a split is a multiple of (a multiple of every tile)


def retrieval_topk_plain(queries: torch.Tensor, corpus: torch.Tensor, k: int):
    """Scores ``Q·Cᵀ`` in f32, then a stable descending sort: ties go to
    the smaller corpus index, as in ``lax.top_k``."""
    scores = queries.float() @ corpus.float().T
    s, i = torch.sort(scores, dim=1, descending=True, stable=True)
    return s[:, :k].contiguous(), i[:, :k].to(torch.int32).contiguous()


def _split_plan(n: int, q_blocks: int, n_sm: int) -> tuple[int, int]:
    """(splits, rows_per_split): about four blocks per SM in all, each
    split a multiple of 256 rows (of every tile); the splits cover rows 0 .. n-1
    once, and only the last may be short."""
    target = max(1, (4 * n_sm) // q_blocks)
    rows = -(-n // target)
    rows = -(-rows // _SPLIT_ROWS) * _SPLIT_ROWS
    return -(-n // rows), rows


def _plan(nq: int, n: int, device) -> tuple[int, int]:
    """(splits, rows_per_split) of the partial kernel for ``nq`` queries
    (blocks of 8 queries for a few, else 32) over ``n`` rows on ``device``."""
    q_blocks = -(-nq // (8 if nq <= 8 else 32))
    return _split_plan(n, q_blocks, torch.cuda.get_device_properties(device).multi_processor_count)


def _rows16(t: torch.Tensor, d_pad: int) -> torch.Tensor:
    """``t`` (rows, D) with its rows 16-byte aligned, as the kernel's
    16-byte copies read them: in place where they are, else a copy padded
    with zero columns to ``d_pad``."""
    if t.shape[1] == d_pad and t.data_ptr() % 16 == 0:
        return t
    out = t.new_zeros((t.shape[0], d_pad))
    out[:, : t.shape[1]] = t
    return out


def cost(queries: torch.Tensor, corpus: torch.Tensor, k: int):
    """(FLOPs by dtype, bytes) of one call: the queries and the corpus read
    once, k scores and ids per query written once; Q.C^T."""
    (nq, d), n, es = queries.shape, corpus.shape[0], queries.element_size()
    return _build.flops((2 * nq * n * d, queries.dtype)), nq * d * es + n * d * es + nq * k * 8


def retrieval_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int):
    """queries (Q, D), corpus (N, D) -> (scores (Q, k) f32, idx (Q, k) i32),
    sorted by score descending, ties to the smaller index."""
    _build.refuse_grad("retrieval_topk", queries, corpus)
    return _build.counted("retrieval_topk", lambda: cost(queries, corpus, k), lambda: _run(queries, corpus, k))


def _run(queries: torch.Tensor, corpus: torch.Tensor, k: int):
    if queries.device.type == "cpu" and corpus.device.type == "cpu":
        return retrieval_topk_plain(queries, corpus, k)
    if queries.device.type == "meta" and corpus.device.type == "meta":
        nq = queries.shape[0]
        return (torch.empty((nq, k), dtype=torch.float32, device=queries.device),
                torch.empty((nq, k), dtype=torch.int32, device=queries.device))
    if queries.device.type != "cuda" or corpus.device != queries.device:
        raise ValueError(f"retrieval_topk: tensors on {queries.device} / {corpus.device}")
    if queries.dim() != 2 or corpus.dim() != 2 or queries.shape[1] != corpus.shape[1]:
        raise ValueError(f"retrieval_topk: shapes {tuple(queries.shape)} x {tuple(corpus.shape)}")
    if queries.dtype != corpus.dtype or queries.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"retrieval_topk: dtypes {queries.dtype} / {corpus.dtype}")
    nq, d = queries.shape
    n = corpus.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"retrieval_topk: k={k} must lie in [1, N={n}]")
    # D padded to a multiple of 16 bytes: each zero column adds fmaf(0, 0, s) = s
    # to a score's chain, as the kernel's zero-filled slice tail already does
    vec = 16 // queries.element_size()
    d_pad = -(-d // vec) * vec
    queries, corpus = (_rows16(t.contiguous(), d_pad) for t in (queries, corpus))
    out_s = torch.empty((nq, k), dtype=torch.float32, device=queries.device)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=queries.device)
    if nq == 0:
        return out_s, out_i
    splits, rows = _plan(nq, n, queries.device)
    part_s = torch.empty((nq, splits, k), dtype=torch.float32, device=queries.device)
    part_i = torch.empty((nq, splits, k), dtype=torch.int32, device=queries.device)
    lib = _build.load("retrieval_topk")
    err = lib.retrieval_topk_launch(
        queries.data_ptr(), corpus.data_ptr(), part_s.data_ptr(), part_i.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(), nq, n, d_pad, k, splits, rows,
        int(queries.dtype == torch.bfloat16),
        ctypes.c_void_p(torch.cuda.current_stream(queries.device).cuda_stream),
    )
    _build.check(err, "retrieval_topk")
    global launches
    launches += 1
    return out_s, out_i
