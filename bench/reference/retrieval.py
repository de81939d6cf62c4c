"""Maximum inner-product retrieval, plainly: ``q @ c.T``, then the top m."""
from __future__ import annotations

import torch


def scores(q: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """(B, D) queries against (N, D) chunks -> (B, N) inner products in f32."""
    return q.float() @ corpus.float().T


def topk(q: torch.Tensor, corpus: torch.Tensor, m: int):
    """The m best chunks of each query: (scores (B, m), indices (B, m))."""
    return torch.topk(scores(q, corpus), m, dim=-1)
