"""Top-k maximum-inner-product retrieval: the provider's scoring op.

``retrieval_topk`` launches the hand-written kernel
(``kernels/csrc/retrieval_topk.cu``) for CUDA tensors and runs
``retrieval_topk_plain`` for CPU tensors; anything else raises.
``launches`` counts kernel launches (one per call that reaches the card).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0

_SPLIT_ROWS = 256  # corpus rows per chunk of the partial kernel
_MAX_K = 32


def retrieval_topk_plain(queries: torch.Tensor, corpus: torch.Tensor, k: int):
    """Scores ``Q·Cᵀ`` in f32, then a stable descending sort: ties go to
    the smaller corpus index, as in ``lax.top_k``."""
    scores = queries.float() @ corpus.float().T
    s, i = torch.sort(scores, dim=1, descending=True, stable=True)
    return s[:, :k].contiguous(), i[:, :k].to(torch.int32).contiguous()


def _split_plan(n: int, q_blocks: int, n_sm: int) -> tuple[int, int]:
    """(splits, rows_per_split): about four blocks per SM in all, each
    split a multiple of the 256-row chunk."""
    target = max(1, (4 * n_sm) // q_blocks)
    rows = -(-n // target)
    rows = -(-rows // _SPLIT_ROWS) * _SPLIT_ROWS
    return -(-n // rows), rows


def retrieval_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int):
    """queries (Q, D), corpus (N, D) -> (scores (Q, k) f32, idx (Q, k) i32),
    sorted by score descending, ties to the smaller index."""
    if queries.device.type == "cpu" and corpus.device.type == "cpu":
        return retrieval_topk_plain(queries, corpus, k)
    if queries.device.type != "cuda" or corpus.device != queries.device:
        raise ValueError(f"retrieval_topk: tensors on {queries.device} / {corpus.device}")
    if queries.dim() != 2 or corpus.dim() != 2 or queries.shape[1] != corpus.shape[1]:
        raise ValueError(f"retrieval_topk: shapes {tuple(queries.shape)} x {tuple(corpus.shape)}")
    if queries.dtype != corpus.dtype or queries.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"retrieval_topk: dtypes {queries.dtype} / {corpus.dtype}")
    nq, d = queries.shape
    n = corpus.shape[0]
    if d % 4 or d > 1024:
        raise ValueError(f"retrieval_topk: D={d} must be a multiple of 4 and at most 1024")
    if not 1 <= k <= min(_MAX_K, n):
        raise ValueError(f"retrieval_topk: k={k} must lie in [1, min({_MAX_K}, N={n})]")
    queries, corpus = queries.contiguous(), corpus.contiguous()
    out_s = torch.empty((nq, k), dtype=torch.float32, device=queries.device)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=queries.device)
    if nq == 0:
        return out_s, out_i
    q_blocks = -(-nq // (8 if nq <= 8 else 32))
    n_sm = torch.cuda.get_device_properties(queries.device).multi_processor_count
    splits, rows = _split_plan(n, q_blocks, n_sm)
    part_s = torch.empty((nq, splits, k), dtype=torch.float32, device=queries.device)
    part_i = torch.empty((nq, splits, k), dtype=torch.int32, device=queries.device)
    lib = _build.load("retrieval_topk")
    err = lib.retrieval_topk_launch(
        queries.data_ptr(), corpus.data_ptr(), part_s.data_ptr(), part_i.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(), nq, n, d, k, splits, rows,
        int(queries.dtype == torch.bfloat16),
        ctypes.c_void_p(torch.cuda.current_stream(queries.device).cuda_stream),
    )
    _build.check(err, "retrieval_topk")
    global launches
    launches += 1
    return out_s, out_i
