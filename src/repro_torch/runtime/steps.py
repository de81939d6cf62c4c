"""Step builders: the train, prefill and decode callables per family.

``make_train_step`` differentiates the family's loss with autograd (the
reference's ``jax.value_and_grad``) and applies the optimizer under
``torch.no_grad``; the parameter tree it is given is not modified, a new
one is returned, as in the reference.  With ``cfg.bf16_grads`` the loss
is differentiated at a bf16 copy of the parameters (bf16 gradients, f32
master update).  A leaf the loss does not reach raises: ``jax.grad``
would give it zeros, but here a missing gradient is how a kernel that
cuts the autograd graph shows, so it is never filled in silently.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encoder as ENC
from repro_torch.models import lm as LM
from repro_torch.models.params import cast_tree, leaves, map_tree
from repro_torch.optim.optimizers import Optimizer


def model_loss_fn(cfg: ModelConfig):
    if cfg.family == "encoder":
        return ENC.loss_fn
    return LM.loss_fn


def value_and_grad(loss_fn, params, *args):
    """``(loss, aux, grads)`` of ``loss_fn(params, *args) -> (loss, aux)``:
    the gradient tree mirrors ``params``.  Raises ``RuntimeError`` naming
    the leaves the loss does not reach."""
    with torch.enable_grad():
        live = map_tree(lambda p: p.detach().requires_grad_(True), params)
        loss, aux = loss_fn(live, *args)
        named = leaves(live)
        got = torch.autograd.grad(loss, [t for _, t in named], allow_unused=True)
    missing = [path for (path, _), g in zip(named, got) if g is None]
    if missing:
        raise RuntimeError(f"the loss does not reach the leaves {missing}: no gradient (a cut autograd graph?)")
    by_id = {id(t): g for (_, t), g in zip(named, got)}
    return loss.detach(), map_tree(lambda t: t.detach(), aux), map_tree(lambda t: by_id[id(t)], live)


def make_train_step(cfg: ModelConfig, opt: Optimizer, lr_fn=None):
    """``train_step(params, opt_state, batch, step) -> (new_params,
    new_state, metrics)``; metrics: the loss function's own, ``loss``,
    ``grad_norm`` and ``lr``, as tensors or floats (not synchronised)."""
    loss_fn = model_loss_fn(cfg)
    lr_fn = lr_fn or (lambda step: 3e-4)
    bf16_grads = getattr(cfg, "bf16_grads", False)

    def train_step(params, opt_state, batch, step):
        shadow = cast_tree(params, torch.bfloat16) if bf16_grads else params
        loss, metrics, grads = value_and_grad(lambda p: loss_fn(cfg, p, batch), shadow)
        lr = lr_fn(step)
        with torch.no_grad():
            new_params, new_state, gnorm = opt.update(grads, opt_state, params, lr)
        return new_params, new_state, dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)

    return train_step


def make_prefill_step(cfg: ModelConfig):
    if cfg.family == "encoder":
        def encode_step(params, batch):
            return ENC.encode(cfg, params, batch["frames"])

        return encode_step

    def prefill_step(params, batch):
        logits, cache = LM.prefill(cfg, params, batch)
        return logits[:, -1:, :], cache

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, cache, tokens, pos):
        """One token per row; the cache is updated in place and returned."""
        return LM.decode_step(cfg, params, cache, tokens, pos), cache

    return decode_step
