"""Contriever-style dual encoder: the paper's embedding model F_emb.

Token encoder + mean pooling over the non-PAD tokens, L2-normalised.
Shared weights for the query and document towers.  The layer stack is
bidirectional (``attn_apply(..., causal=False)``), so its attention runs
through ``kernels/flash_attention``.  As in the reference, attention
itself does not mask PAD keys; only the pooling does.  ``info_nce_loss``
trains it (the paper's §2.2 federated training of F_emb).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.lm import _stack_specs, encoder_stack
from repro_torch.models.params import ParamSpec


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
        "blocks": _stack_specs(block, cfg.n_layers),
        "final_norm": ParamSpec((d,), ("norm",), "ones"),
    }


def encode(cfg: ModelConfig, params, tokens, pad_id: int = 0):
    """tokens: (B, S) -> L2-normalised f32 embeddings (B, d)."""
    h = encoder_stack(cfg, params, L.embed_apply(cfg, params["embed"], tokens))
    msk = (tokens != pad_id).float()[..., None]
    pooled = (h.float() * msk).sum(1) / torch.clamp(msk.sum(1), min=1.0)
    return pooled / torch.clamp(torch.linalg.vector_norm(pooled, dim=-1, keepdim=True), min=1e-9)


def info_nce_loss(cfg: ModelConfig, params, batch, temperature: float = 0.05):
    """InfoNCE with in-batch negatives.  batch: ``query_tokens`` (B, S) and
    ``doc_tokens`` (B, S), row i's document the positive of row i's query.
    Returns ``(loss, {"loss", "acc"})``."""
    q = encode(cfg, params, batch["query_tokens"])
    d = encode(cfg, params, batch["doc_tokens"])
    sim = (q @ d.T) / temperature  # (B, B)
    labels = torch.arange(q.shape[0], device=q.device)
    logp = torch.log_softmax(sim, dim=-1)
    loss = -logp[labels, labels].mean()
    acc = (sim.argmax(-1) == labels).float().mean()
    return loss, {"loss": loss, "acc": acc}
