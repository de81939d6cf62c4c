"""bge-reranker-style cross encoder: the paper's aggregation model F_aggr.

Takes a (query, chunk) token pair packed into one sequence and outputs a
relevance score; the orchestrator scores all k_n x m candidates pairwise
and keeps the global top-n (paper §2.3.2).  The layer stack is
bidirectional, so its attention runs through ``kernels/flash_attention``;
as in the reference, attention does not mask PAD keys.  ``rank_loss``
trains it (listwise softmax over each query's candidates).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.tokenizer import EOS, PAD, SEP
from repro_torch.models import layers as L
from repro_torch.models.lm import _stack_specs, encoder_stack
from repro_torch.models.params import ParamSpec
from repro_torch.runtime import trace


def param_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    block = {
        "mixer_norm": ParamSpec((d,), ("norm",), "ones"),
        "attn": L.attn_specs(cfg),
        "ffn_norm": ParamSpec((d,), ("norm",), "ones"),
        "mlp": L.mlp_specs(cfg),
    }
    return {
        "embed": L.embed_specs(cfg),
        "type_embed": ParamSpec((2, d), (None, "embed"), "normal"),
        "blocks": _stack_specs(block, cfg.n_layers),
        "final_norm": ParamSpec((d,), ("norm",), "ones"),
        "score": {"w": ParamSpec((d, 1), ("embed", None), "fan_in", fan_in_dims=(0,))},
    }


def score_pairs(cfg: ModelConfig, params, tokens, type_ids):
    """tokens: (B, S) packed [query ; chunk]; type_ids: (B, S) 0 = query,
    1 = chunk.  Returns f32 relevance scores (B,)."""
    h = L.embed_apply(cfg, params["embed"], tokens)
    h = h + params["type_embed"].to(h.dtype)[type_ids.long()]
    h = encoder_stack(cfg, params, h)
    cls = h[:, 0, :].float()  # first-token pooling
    return (cls @ params["score"]["w"].float())[:, 0]


def _pack_pairs(q_tokens: np.ndarray, cand: np.ndarray, max_len: int):
    q = [int(t) for t in q_tokens if t != PAD and t != EOS]
    toks = np.full((len(cand), max_len), PAD, np.int32)
    types = np.zeros((len(cand), max_len), np.int32)
    for i, row in enumerate(cand):
        d = [int(t) for t in row if t != PAD]
        ids = (q + [SEP] + d + [EOS])[:max_len]
        toks[i, : len(ids)] = ids
        types[i, min(len(q) + 1, max_len) : len(ids)] = 1
    return toks, types


def make_reranker(cfg: ModelConfig, params, *, max_len: int = 64):
    """Adapt the cross encoder to the orchestrator's reranker contract:

      (query_tokens (S,), cand_tokens (C, S)) -> (C,) scores, or the
      batched form (queries (B, S), cands (B, C, S)) -> (B, C)

    The batched form flattens all B*C (query, chunk) pairs into ONE
    ``score_pairs`` call (``supports_batch``, used by
    ``aggregate_batch``).  Scoring runs where ``params`` live."""
    device = params["embed"]["tok"].device

    def score(toks: np.ndarray, types: np.ndarray) -> np.ndarray:
        out = score_pairs(cfg, params, torch.as_tensor(toks, device=device), torch.as_tensor(types, device=device))
        return trace.to_host(out, "rerank.scores").numpy().astype(np.float32)

    def rerank(query_tokens: np.ndarray, cand_tokens: np.ndarray) -> np.ndarray:
        cand = np.asarray(cand_tokens)
        if cand.ndim == 3:  # (B, C, S) batch -> one flattened forward pass
            b, c, _ = cand.shape
            packed = [_pack_pairs(q, cv, max_len) for q, cv in zip(np.asarray(query_tokens), cand)]
            toks = np.concatenate([t for t, _ in packed], 0)
            types = np.concatenate([ty for _, ty in packed], 0)
            return score(toks, types).reshape(b, c)
        return score(*_pack_pairs(np.asarray(query_tokens), cand, max_len))

    rerank.supports_batch = True
    return rerank


def rank_loss(cfg: ModelConfig, params, batch):
    """Listwise softmax ranking loss: one positive among each query's
    ``n_cand`` candidates.  batch: ``tokens`` and ``type_ids`` (B, n_cand,
    S), ``label`` (B,) the positive's index.  Returns ``(loss, {"loss",
    "acc"})``."""
    b, n, s = batch["tokens"].shape
    scores = score_pairs(cfg, params, batch["tokens"].reshape(b * n, s),
                         batch["type_ids"].reshape(b * n, s)).reshape(b, n)
    logp = torch.log_softmax(scores, dim=-1)
    label = batch["label"].long()
    loss = -logp.gather(1, label[:, None]).mean()
    acc = (scores.argmax(-1) == label).float().mean()
    return loss, {"loss": loss, "acc": acc}
