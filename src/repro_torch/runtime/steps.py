"""Step builders: the train, prefill and decode callables per family.

``make_train_step`` differentiates the family's loss with autograd (the
reference's ``jax.value_and_grad``) and applies the optimizer under
``torch.no_grad``; the parameter tree it is given is not modified, a new
one is returned, as in the reference.  With ``cfg.bf16_grads`` the loss
is differentiated at a bf16 copy of the parameters (bf16 gradients, f32
master update).  A leaf the loss does not reach raises: ``jax.grad``
would give it zeros, but here a missing gradient is how a kernel that
cuts the autograd graph shows, so it is never filled in silently.

With a policy over a mesh (``pol=``) the step is data-parallel
(``data_parallel_grads``): each data shard differentiates its share of
the one global loss on its own rows, on its own first device, and the
gradients are gathered onto the lead and summed in shard order as each
shard finishes.  A shard's share is its masked CE sum over the global
count of masked tokens, plus ``router_aux_weight`` times its MoE loss
over the number of shards: the shares add up to the reference's loss
over the whole batch (a mean of the shards' own losses would weigh a
shard's tokens by how many its rows happen to mask).  With
``grad_pspecs`` (the parameters' partition specs), each data shard sums
only its own slice of each leaf sharded over the data axes, the
reduce-scatter form, and the slices are put back together for the
update; each element is summed in the same order, so it is bitwise the
all-reduce form.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encoder as ENC
from repro_torch.models import lm as LM
from repro_torch.models.params import cast_tree, leaves, map_tree
from repro_torch.optim.optimizers import Optimizer
from repro_torch.runtime.sharding import ShardedTensor, data_shards, entry_axes


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


def _shard_rows(batch, mesh, shards):
    """Each data shard's rows of ``batch``: a placed leaf's block at the
    shard's coordinate, or a tensor's equal slice of rows on its device."""
    out = [{} for _ in shards]
    for k, v in batch.items():
        for i, (coord, _) in enumerate(shards):
            if isinstance(v, ShardedTensor):
                out[i][k] = v.block(coord)
            else:
                out[i][k] = torch.chunk(v, len(shards))[i].to(mesh.device(coord))
    return out


def _batch_rows(batch) -> int:
    v = batch["tokens"]
    return v.shape[0] if isinstance(v, ShardedTensor) else int(v.shape[0])


def _slicing(spec, batch_axes, mesh, coords):
    """Where a gradient leaf of partition spec ``spec`` is reduce-scattered:
    ``(dim, n_slices, the data shard index that sums each slice)``, or None
    when no dimension is sharded over the data axes."""
    for d, e in enumerate(spec):
        axes = [a for a in entry_axes(e) if a in batch_axes]
        if not axes:
            continue
        owner = {}
        for i, coord in enumerate(coords):
            pos = dict(zip(mesh.axis_names, coord))
            r = 0
            for a in axes:
                r = r * mesh.shape[a] + pos[a]
            owner.setdefault(r, i)
        return d, len(owner), [owner[r] for r in range(len(owner))]
    return None


def data_parallel_grads(cfg: ModelConfig, pol, params, batch, grad_pspecs=None):
    """``(loss, metrics, grads)`` of the global loss of ``batch`` over
    ``pol``'s data shards (see the module docstring); ``batch`` holds
    tensors or ``shard_batch`` placements.  The gradients come back on the
    mesh's lead device."""
    if cfg.family == "encoder":
        raise NotImplementedError("data-parallel steps take the LM families; the encoder trains on one device")
    mesh = pol.mesh
    lead = mesh.lead
    n_rows = _batch_rows(batch)
    shards = data_shards(pol, n_rows)
    dp = len(shards)
    rows = _shard_rows(batch, mesh, shards)
    n_tok = torch.clamp(sum(r["targets"].ge(0).sum().to(lead) for r in rows).float(), min=1.0)
    bf16_grads = getattr(cfg, "bf16_grads", False)
    batch_axes = entry_axes(pol.spec("act_batch", shape=(n_rows,))[0])
    coords = [c for c, _ in shards]
    slicing = {} if grad_pspecs is None else {
        path: _slicing(spec, batch_axes, mesh, coords) for path, spec in leaves(grad_pspecs)}
    acc: dict = {}
    loss = ce = aux = None
    for i, ((coord, sub_pol), sub) in enumerate(zip(shards, rows)):
        dev = mesh.device(coord)
        local = map_tree(lambda t: t.to(dev), params)
        shadow = cast_tree(local, torch.bfloat16) if bf16_grads else local
        n_i = n_tok.to(dev)

        def share(p):
            logits, aux_i = LM.forward(cfg, p, sub, pol=sub_pol)
            ce_i = LM.masked_ce_sum(logits, sub["targets"], sub["targets"].ge(0).float()) / n_i
            return ce_i + cfg.router_aux_weight * aux_i / dp, {"ce": ce_i, "aux": aux_i}

        loss_i, m_i, g_i = value_and_grad(share, shadow)
        loss = loss_i.to(lead) if loss is None else loss + loss_i.to(lead)
        ce = m_i["ce"].to(lead) if ce is None else ce + m_i["ce"].to(lead)
        aux = m_i["aux"].to(lead) if aux is None else aux + m_i["aux"].to(lead)
        for path, g in leaves(g_i):  # the reduction, in shard order, as each shard finishes
            cut = slicing.get(path)
            if cut is None:
                acc[path] = g.to(lead) if i == 0 else acc[path] + g.to(lead)
                continue
            d, n, owners = cut
            parts = torch.chunk(g, n, dim=d)
            dst = [mesh.device(coords[o]) for o in owners]
            acc[path] = ([p.to(t) for p, t in zip(parts, dst)] if i == 0
                         else [a + p.to(t) for a, p, t in zip(acc[path], parts, dst)])
        del g_i
    grads = map_tree(lambda _: None, params)
    for path, a in acc.items():  # the reduce-scattered slices put back together
        node = grads
        *parents, last = path.split("/")
        for key in parents:
            node = node[key]
        d = slicing[path][0] if slicing.get(path) else None
        node[last] = a if d is None else torch.cat([x.to(lead) for x in a], dim=d)
    return loss, {"ce": ce, "aux": aux / dp, "tokens": n_tok}, grads


def make_train_step(cfg: ModelConfig, opt: Optimizer, lr_fn=None, grad_pspecs=None, *, pol=None):
    """``train_step(params, opt_state, batch, step) -> (new_params,
    new_state, metrics)``; metrics: the loss function's own, ``loss``,
    ``grad_norm`` and ``lr``, as tensors or floats (not synchronised).
    With ``pol`` over a mesh, the data-parallel step (``grad_pspecs``: the
    reduce-scatter form); without, the one-device step."""
    loss_fn = model_loss_fn(cfg)
    lr_fn = lr_fn or (lambda step: 3e-4)
    bf16_grads = getattr(cfg, "bf16_grads", False)
    sharded = pol is not None and pol.mesh is not None

    def train_step(params, opt_state, batch, step):
        if sharded:
            loss, metrics, grads = data_parallel_grads(cfg, pol, params, batch, grad_pspecs)
        else:
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
