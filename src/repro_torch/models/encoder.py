"""Encoder-only backbone (HuBERT-xlarge) and its masked-prediction loss.

The frontend is a stub, as in the reference: callers hand over frame
embeddings (B, S, d_model); the CNN feature extractor is out of scope.
The layer stack is bidirectional (``lm.encoder_stack``: its attention
runs through ``kernels/flash_attention``, HuBERT's head_dim 80 padded to
128 there) with no cache and no decode step.  Masked positions take the
learned ``mask_embed``; ``loss_fn`` is cross-entropy over the codebook
(``vocab_size``) at the masked positions.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.lm import _stack_specs, encoder_stack, sharded_ce
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
        "mask_embed": ParamSpec((d,), ("norm",), "normal"),
        "blocks": _stack_specs(block, cfg.n_layers),
        "final_norm": ParamSpec((d,), ("norm",), "ones"),
        "head": {"w": ParamSpec((d, cfg.vocab_size), ("embed", "vocab"), "fan_in", fan_in_dims=(0,))},
    }


def encode(cfg: ModelConfig, params, frames, mask=None):
    """frames (B, S, d) -> final-normed hidden states (B, S, d) in
    ``cfg.dtype``; ``mask`` (B, S) bool replaces those positions by the
    learned mask embedding."""
    h = frames.to(L.torch_dtype(cfg.dtype))
    if mask is not None:
        h = torch.where(mask[..., None], params["mask_embed"].to(h.dtype), h)
    return encoder_stack(cfg, params, h)


def loss_fn(cfg: ModelConfig, params, batch):
    """Masked-prediction CE over the codebook.  batch: ``frames`` (B, S, d),
    ``mask`` (B, S) bool, ``targets`` (B, S).  Returns ``(ce, {"ce",
    "tokens"})``."""
    h = encode(cfg, params, batch["frames"], batch["mask"])
    logits = (h @ params["head"]["w"].to(h.dtype)).float()
    m = batch["mask"].float()
    ce = sharded_ce(logits, batch["targets"], m)
    return ce, {"ce": ce, "tokens": m.sum()}


def embed_corpus(cfg: ModelConfig, params, frames):
    """Mean-pooled utterance embeddings (B, d) (provider-side audio
    retrieval)."""
    return encode(cfg, params, frames).mean(dim=1)
