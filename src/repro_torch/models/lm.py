"""Causal LM: full forward, prefill and the serving steps, for the dense,
``moe`` (all-attention, MoE FFNs), ``ssm`` (all-Mamba2) and ``hybrid``
(jamba: attention every ``attn_every``-th layer, Mamba2 elsewhere, MoE
every ``moe_every``-th) families.

``forward`` is the whole-sequence pass; ``prefill`` runs it over a prompt
batch and fills the contiguous cache ``init_cache`` builds, and
``decode_step`` without block tables then decodes from those per-row
stripes (the contiguous engine and the lock-step baseline).
``mixed_step`` is the paged unified engine step (any mix of prompt
chunks and decode rows, one pass over the layer stack), and
``decode_step`` with block tables decodes one token per row through the
pool that ``init_paged_cache`` builds; ``paged_copy_block`` copies one
pool block, the copy-on-write half of the engine's prefix cache;
``verify_step`` is ``mixed_step`` over speculative verify rows (all three
paged steps take a sharded pool, ``init_paged_cache(n_shards=, mesh=)``,
and carry its mesh); ``generate``
decodes greedily (or samples) from a prompt batch.  Whole-sequence attention runs
through ``kernels/flash_attention``, contiguous decode attention through
``kernels/decode_attention``, and the Mamba2 mixer (``models/mamba2``)
through ``kernels/ssd_scan``.  A layer whose ``ffn_kind`` is ``moe`` runs
``models/moe.moe_apply`` in place of the dense MLP; ``forward`` returns the
mean of those layers' load-balance losses.

Parameters keep the JAX package's tree: ``blocks`` holds one scan
period's ``pos{j}`` subtrees stacked on a leading ``n_blocks`` axis, so
``params.from_reference`` maps the reference's tree one to one.  The
layer loop is a Python loop over that axis; the cache keeps the same
stacked layout and each layer updates its slice in place.  Each period
position ``pos{j}`` runs the mixer ``cfg.mixer_kind(j)`` names: an
attention layer caches ``{"k", "v"}``; a Mamba2 layer caches ``{"conv":
(x, B, C) conv histories, "ssm": state}``, which has no sequence axis to
page, so the paged steps (``mixed_step``, ``init_paged_cache``, paged
``decode_step``) take all-attention models only, as the reference's
unified path does.

The ``vlm`` family is a dense backbone whose batch may carry
``patch_embeds`` (B, n_patches, d): precomputed patch embeddings that
replace the first positions' token embeddings in ``forward`` and
``prefill`` (and so in ``generate``), as in the reference.  ``loss_fn`` is
next-token cross-entropy (``sharded_ce``) plus the weighted MoE loss.
With ``cfg.remat == "block"`` and grad mode on, ``forward`` runs each
scan block under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint``): its activations are recomputed in the backward,
through the same kernels.  The encoders (``dual_encoder``,
``cross_encoder``, ``encoder``) declare their own trees with
``_stack_specs`` and run their layers through ``encoder_stack``.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as MOE
from repro_torch.models.params import ParamSpec, map_tree


def attention_only(cfg: ModelConfig) -> bool:
    """Whether every layer's mixer is attention: what the paged steps take."""
    return all(cfg.mixer_kind(i) == "attn" for i in range(cfg.n_layers))


def _check_attention(cfg: ModelConfig, what: str) -> None:
    if not attention_only(cfg):
        raise NotImplementedError(
            f"{cfg.name}: {what} needs every mixer to be attention: SSM/conv state "
            "folds the whole sequence and cannot restart mid-prompt"
        )


def _position_specs(cfg: ModelConfig, j: int) -> dict:
    d = cfg.d_model
    s: dict[str, Any] = {"mixer_norm": ParamSpec((d,), ("norm",), "ones")}
    if cfg.mixer_kind(j) == "attn":
        s["attn"] = L.attn_specs(cfg)
    else:
        s["mamba"] = M.mamba_specs(cfg)
    if cfg.ffn_kind(j) == "moe":
        s["ffn_norm"] = ParamSpec((d,), ("norm",), "ones")
        s["moe"] = MOE.moe_specs(cfg)
    elif cfg.d_ff > 0:
        s["ffn_norm"] = ParamSpec((d,), ("norm",), "ones")
        s["mlp"] = L.mlp_specs(cfg)
    return s


def _stack_specs(tree, n: int):
    """Every ParamSpec of ``tree`` stacked on a leading ``n``-long "layers" axis."""
    return map_tree(
        lambda p: ParamSpec(
            (n,) + p.shape, ("layers",) + p.axes, p.init, p.scale, tuple(d + 1 for d in p.fan_in_dims),
        ),
        tree,
    )


def param_specs(cfg: ModelConfig) -> dict:
    block = {f"pos{j}": _position_specs(cfg, j) for j in range(cfg.scan_period)}
    specs = {
        "embed": L.embed_specs(cfg),
        "blocks": _stack_specs(block, cfg.n_blocks),
        "final_norm": ParamSpec((cfg.d_model,), ("norm",), "ones"),
    }
    if head := L.head_specs(cfg):
        specs["head"] = head
    return specs


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype=torch.bfloat16, device="cuda") -> dict:
    """Contiguous decode cache per period position, by its mixer.
    Attention: ``{"k", "v"}`` leaves of shape ``(n_blocks, batch,
    cache_len, kv, hd)``, one stripe per row.  Mamba2: ``{"conv": three
    (n_blocks, batch, W - 1, C) leaves in ``dtype`` (C = d_inner, G * ds,
    G * ds), "ssm": (n_blocks, batch, H, hd, ds) f32}``; ``cache_len`` does
    not apply."""
    n, w, gds = cfg.n_blocks, cfg.conv_width, cfg.ssm_groups * cfg.ssm_state
    kv_shape = (n, batch, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim)

    def position(j: int) -> dict:
        if cfg.mixer_kind(j) == "attn":
            return {
                "k": torch.zeros(kv_shape, dtype=dtype, device=device),
                "v": torch.zeros(kv_shape, dtype=dtype, device=device),
            }
        return {
            "conv": tuple(
                torch.zeros((n, batch, w - 1, c), dtype=dtype, device=device) for c in (cfg.d_inner, gds, gds)
            ),
            "ssm": torch.zeros(
                (n, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state), dtype=torch.float32, device=device
            ),
        }

    return {f"pos{j}": position(j) for j in range(cfg.scan_period)}


def init_paged_cache(cfg: ModelConfig, n_pool_blocks: int, block_size: int,
                     dtype=torch.bfloat16, device="cuda", n_shards: int | None = None,
                     mesh=None) -> dict:
    """Paged K/V: per period position ``{"k", "v"}`` leaves of shape
    ``(n_blocks, n_pool_blocks, block_size, kv, hd)``.  The caller keeps
    one pool index (the last) as the trash block that unallocated table
    entries and dead lanes point at.  Attention models only.

    Sharded (``n_shards``, or a ``runtime.compat.Mesh`` whose size it is):
    each leaf is the list of the shards' pools, shard ``s``'s of the shape
    above on ``mesh.devices[s]`` (all on ``device`` without a mesh), with
    ``n_pool_blocks`` the PER-SHARD count including its own trash block at
    local index ``n_pool_blocks - 1``."""
    _check_attention(cfg, "the paged KV cache")
    shape = (cfg.n_blocks, n_pool_blocks, block_size, cfg.n_kv_heads, cfg.resolved_head_dim)
    if mesh is not None and n_shards not in (None, mesh.size):
        raise ValueError(f"init_paged_cache: n_shards={n_shards} on a mesh of {mesh.size}")
    if mesh is None and n_shards is None:
        def leaf():
            return torch.zeros(shape, dtype=dtype, device=device)
    else:
        devices = mesh.devices if mesh is not None else [device] * n_shards

        def leaf():
            return [torch.zeros(shape, dtype=dtype, device=d) for d in devices]
    return {f"pos{j}": {"k": leaf(), "v": leaf()} for j in range(cfg.scan_period)}


def paged_copy_block(cfg: ModelConfig, cache, src: int, dst: int):
    """Copy pool block ``src``'s K/V into block ``dst`` across every
    attention layer, in place: the copy-on-write half of prefix sharing.
    ``src`` holds a cached chunk that a new request's last prompt token
    would overwrite (a full-prefix hit ending on a block boundary); the
    engine copies it into the request's private ``dst`` before the row's
    first mixed-step write.  On a sharded pool the GLOBAL ids resolve to
    (shard ``b // n_local``, local ``b % n_local``); prefix chains are
    row-affine, so both lie on one shard, but any pair is copied right.
    Leaves without a block axis (none in this port's paged cache, which
    takes attention models only) pass through untouched.  Returns
    ``cache``."""
    for sub in cache.values():
        if "k" in sub:
            for leaf in (sub["k"], sub["v"]):
                if isinstance(leaf, list):
                    n_local = leaf[0].shape[1] - 1
                    leaf[dst // n_local][:, dst % n_local].copy_(leaf[src // n_local][:, src % n_local])
                else:
                    leaf[:, dst].copy_(leaf[:, src])
    return cache


def _layer_pool(leaf, i: int):
    """Layer ``i``'s pool of a paged leaf: a tensor, or the list of its
    shards' pools."""
    return [t[i] for t in leaf] if isinstance(leaf, list) else leaf[i]


def _layer_params(params, i: int, j: int):
    return map_tree(lambda t: t[i], params["blocks"][f"pos{j}"])


def _ffn(cfg, pp, h, pol=None):
    """h + the layer's FFN (dense MLP or MoE; none for a Mamba2 block) ->
    (h, the MoE load-balance loss or None).  ``pol`` reaches the MoE layer
    (its expert-parallel forms)."""
    if "ffn_norm" not in pp:
        return h, None
    x = L.rmsnorm(h, pp["ffn_norm"], cfg.norm_eps)
    if "moe" in pp:
        o, aux = MOE.moe_apply(cfg, pp["moe"], x, pol=pol)
        return h + o, aux
    return h + L.mlp_apply(cfg, pp["mlp"], x), None


def _embed_inputs(cfg: ModelConfig, params, batch):
    """Token embeddings of ``batch["tokens"]``; with the patch frontend and
    ``batch["patch_embeds"]`` (B, P, d), those P rows replace the first P
    positions."""
    h = L.embed_apply(cfg, params["embed"], batch["tokens"])
    if cfg.frontend == "patches" and "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(h.dtype)
        h = torch.cat([pe, h[:, pe.shape[1]:, :]], dim=1)
    return h


def _positions(shape, device):
    """(B, S) absolute positions 0..S-1 of a whole-sequence pass."""
    return torch.arange(shape[1], device=device)[None, :].expand(shape[0], shape[1])


def _block(cfg: ModelConfig, params, i: int, h, positions, aux, pol=None):
    """Scan block ``i`` (its ``scan_period`` layers) of the whole-sequence
    pass -> (h, aux plus the block's MoE load-balance losses)."""
    for j in range(cfg.scan_period):
        pp = _layer_params(params, i, j)
        x = L.rmsnorm(h, pp["mixer_norm"], cfg.norm_eps)
        if cfg.mixer_kind(j) == "mamba":
            o, _ = M.mamba_apply(cfg, pp["mamba"], x)
        else:
            o = L.attn_apply(cfg, pp["attn"], x, positions)
        h, a = _ffn(cfg, pp, h + o, pol)
        if a is not None:
            aux = aux + a
    return h, aux


def _remat(cfg: ModelConfig) -> bool:
    """Whether blocks run under activation checkpointing: ``remat="block"``
    and a graph being recorded."""
    return cfg.remat == "block" and torch.is_grad_enabled()


def forward(cfg: ModelConfig, params, batch, pol=None):
    """Full causal forward.  ``batch["tokens"]`` (B, S), optionally
    ``batch["patch_embeds"]`` -> ``(logits (B, S, V), aux)``; ``aux`` is the
    MoE load-balance loss summed over the MoE layers in f32 and divided by
    their count, 0 without experts.  With ``pol`` (a
    ``runtime.sharding.ShardingPolicy``) the MoE layers run expert-parallel
    over its mesh; nothing else changes."""
    tokens = batch["tokens"]
    h = _embed_inputs(cfg, params, batch)
    positions = _positions(tokens.shape, tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    remat = _remat(cfg)
    for i in range(cfg.n_blocks):
        if remat:
            h, aux = checkpoint(_block, cfg, params, i, h, positions, aux, pol, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            h, aux = _block(cfg, params, i, h, positions, aux, pol)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    n_moe = sum(cfg.ffn_kind(i) == "moe" for i in range(cfg.n_layers))
    return L.head_apply(cfg, params, h), aux / max(n_moe, 1)


def masked_ce_sum(logits, targets, mask):
    """Next-token cross-entropy in f32 summed over the positions where
    ``mask`` is set; a target below 0 (masked) reads class 0.  The
    reference's one-hot contraction picks the label logit exactly, as the
    gather here does."""
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    label = torch.gather(lg, -1, torch.clamp(targets, min=0).long()[..., None])[..., 0]
    return -((label - lse) * mask).sum()


def sharded_ce(logits, targets, mask):
    """Mean next-token cross-entropy in f32 over the positions where
    ``mask`` is set."""
    return masked_ce_sum(logits, targets, mask) / torch.clamp(mask.sum(), min=1.0)


def loss_fn(cfg: ModelConfig, params, batch, pol=None):
    """Next-token CE plus ``router_aux_weight`` times the MoE loss.  batch:
    ``tokens`` (B, S), ``targets`` (B, S) with -1 masked.  Returns ``(loss,
    {"ce", "aux", "tokens"})``; ``pol`` as in ``forward``."""
    logits, aux = forward(cfg, params, batch, pol)
    targets = batch["targets"]
    mask = (targets >= 0).float()
    ce = sharded_ce(logits, targets, mask)
    loss = ce + cfg.router_aux_weight * aux
    return loss, {"ce": ce, "aux": aux, "tokens": mask.sum()}


def cache_pspecs(cfg: ModelConfig, pol):
    """PartitionSpec tree matching ``init_cache``'s structure (the
    reference's, tuple for tuple)."""
    blk = {}
    for j in range(cfg.scan_period):
        if cfg.mixer_kind(j) == "attn":
            kv_spec = pol.spec(None, "cache_batch", "cache_seq", "cache_kv", None)
            blk[f"pos{j}"] = {"k": kv_spec, "v": kv_spec}
        else:
            blk[f"pos{j}"] = {
                "conv": tuple(pol.spec(None, "cache_batch", None, "act_ff" if i == 0 else None) for i in range(3)),
                "ssm": pol.spec(None, "cache_batch", "act_heads", None, None),
            }
    return blk


def prefill(cfg: ModelConfig, params, batch, cache_len: int | None = None):
    """Process a prompt batch and build its contiguous decode cache
    (``cache_len`` positions per row, default the prompt length; the
    prompt's K/V fill ``[0, S)``).  Returns ``(logits (B, S, V), cache)``."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    h = _embed_inputs(cfg, params, batch)
    positions = _positions(tokens.shape, tokens.device)
    cache = init_cache(cfg, b, cache_len or s, dtype=L.torch_dtype(cfg.dtype), device=tokens.device)
    for i in range(cfg.n_blocks):
        for j in range(cfg.scan_period):
            pp = _layer_params(params, i, j)
            c = cache[f"pos{j}"]
            x = L.rmsnorm(h, pp["mixer_norm"], cfg.norm_eps)
            if cfg.mixer_kind(j) == "mamba":
                o, (conv, ssm) = M.mamba_apply(cfg, pp["mamba"], x)
                for leaf, new in zip(c["conv"], conv):
                    leaf[i] = new
                c["ssm"][i] = ssm
            else:
                q, k, v = L.attn_qkv(cfg, pp["attn"], x, positions)
                c["k"][i, :, :s] = k.to(c["k"].dtype)
                c["v"][i, :, :s] = v.to(c["v"].dtype)
                o = L._out_proj(L.attention_core(cfg, q, k, v, causal=cfg.causal), pp["attn"]["wo"])
            h, _ = _ffn(cfg, pp, h + o)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return L.head_apply(cfg, params, h), cache


def _encoder_layer(cfg: ModelConfig, params, i: int, h, positions):
    bp = map_tree(lambda t: t[i], params["blocks"])
    x = L.rmsnorm(h, bp["mixer_norm"], cfg.norm_eps)
    h = h + L.attn_apply(cfg, bp["attn"], x, positions, causal=False)
    return _ffn(cfg, bp, h)[0]


def encoder_stack(cfg: ModelConfig, params, h):
    """The encoders' bidirectional layer stack: ``params["blocks"]`` holds
    one layer's tree stacked over ``n_layers``.  h (B, S, d) -> final-normed
    (B, S, d).  Each layer runs under activation checkpointing when
    ``remat="block"`` and grad mode is on."""
    positions = _positions(h.shape, h.device)
    remat = _remat(cfg)
    for i in range(cfg.n_layers):
        if remat:
            h = checkpoint(_encoder_layer, cfg, params, i, h, positions, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            h = _encoder_layer(cfg, params, i, h, positions)
    return L.rmsnorm(h, params["final_norm"], cfg.norm_eps)


def mixed_step(cfg: ModelConfig, params, tokens, cache, block_tables, q_start, q_len,
               block_size: int, mesh=None):
    """Unified engine step.  ``tokens`` (B, W): row ``b`` carries
    ``q_len[b]`` live tokens from absolute position ``q_start[b]`` (a
    decode row has ``q_len == 1``, an idle slot ``q_len == 0``).  Earlier
    positions must already be in the pool blocks of ``block_tables``.  On
    a sharded cache (over ``mesh``) each attention layer is the
    distributed dispatch and everything else runs once, on the tokens'
    device.  Returns logits (B, W, V); ``cache`` is updated in place.
    Attention models only."""
    _check_attention(cfg, "the unified mixed step")
    b, w = tokens.shape
    h = L.embed_apply(cfg, params["embed"], tokens)
    q_start = q_start.to(torch.int32)
    q_len = q_len.to(torch.int32)
    positions = q_start[:, None] + torch.arange(w, dtype=torch.int32, device=tokens.device)[None, :]
    for i in range(cfg.n_blocks):
        for j in range(cfg.scan_period):
            pp = _layer_params(params, i, j)
            c = cache[f"pos{j}"]
            x = L.rmsnorm(h, pp["mixer_norm"], cfg.norm_eps)
            h = h + L.attn_mixed_paged(
                cfg, pp["attn"], x, _layer_pool(c["k"], i), _layer_pool(c["v"], i), positions, block_tables,
                block_size, q_len, mesh,
            )
            h, _ = _ffn(cfg, pp, h)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return L.head_apply(cfg, params, h)


def verify_step(cfg: ModelConfig, params, tokens, cache, block_tables, q_start, q_len,
                block_size: int, mesh=None):
    """The speculative target pass: ``mixed_step`` over verify rows.  A
    speculating row ``b`` carries ``q_len[b] <= k + 1`` lanes from its last
    committed position ``q_start[b]``: lane 0 its last committed token,
    lanes 1.. the drafter's proposals.  Each layer writes the lanes' K/V
    into the pool before attending, so lane ``j``'s logits are what a
    1-token decode would give after emitting lanes ``< j``; the engine's
    greedy accept-prefix then keeps the output equal to plain decode.
    Rejected lanes need no rollback: the next round's window starts at the
    new committed position and rewrites every stale position before any
    lane reads it.  Returns logits (B, W, V)."""
    return mixed_step(cfg, params, tokens, cache, block_tables, q_start, q_len, block_size, mesh)


def decode_step(cfg: ModelConfig, params, cache, tokens, pos, block_tables=None,
                block_size: int = 0, mesh=None):
    """One decode token per row.  ``tokens`` (B, 1); ``pos`` a scalar write
    position or (B,) per-row positions (row ``b`` attends ``[0, pos[b]]``).
    Without ``block_tables`` the cache is ``init_cache``'s contiguous
    stripes; with them (per-row ``pos``) it is ``init_paged_cache``'s pool,
    sharded or not (over ``mesh``).
    A Mamba2 layer takes its recurrent step from its ``conv`` / ``ssm``
    leaves (``pos`` does not apply; paged Mamba2 decode raises).
    Returns logits (B, 1, V); ``cache`` is updated in place."""
    if block_tables is not None:
        _check_attention(cfg, "paged decode")
    h = L.embed_apply(cfg, params["embed"], tokens)
    pos = torch.as_tensor(pos, device=tokens.device).to(torch.int32)
    for i in range(cfg.n_blocks):
        for j in range(cfg.scan_period):
            pp = _layer_params(params, i, j)
            c = cache[f"pos{j}"]
            x = L.rmsnorm(h, pp["mixer_norm"], cfg.norm_eps)
            if cfg.mixer_kind(j) == "mamba":
                o, conv, ssm = M.mamba_decode(cfg, pp["mamba"], x, tuple(t[i] for t in c["conv"]), c["ssm"][i])
                for leaf, new in zip(c["conv"], conv):
                    leaf[i] = new
                c["ssm"][i] = ssm
            elif block_tables is None:
                o = L.attn_decode(cfg, pp["attn"], x, c["k"][i], c["v"][i], pos)
            else:
                o = L.attn_decode_paged(cfg, pp["attn"], x, _layer_pool(c["k"], i), _layer_pool(c["v"], i), pos,
                                        block_tables, block_size, mesh)
            h, _ = _ffn(cfg, pp, h + o)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return L.head_apply(cfg, params, h)


def generate(cfg: ModelConfig, params, batch, n_tokens: int, temperature: float = 0.0,
             generator: torch.Generator | None = None):
    """Autoregressive generation of ``n_tokens`` per row from the prompt
    batch ``batch["tokens"]`` (B, S): a prefill into a contiguous cache of
    S + n_tokens positions, then one ``decode_step`` per token.  Greedy
    (argmax) at ``temperature <= 0``; otherwise each token is drawn from
    softmax(logits / temperature) with ``generator`` (on the tokens'
    device, required: the draws are its own, not JAX's).  Returns (B,
    n_tokens) int32."""
    if temperature > 0.0 and generator is None:
        raise ValueError("generate: sampling (temperature > 0) needs an explicit torch.Generator")
    tokens = batch["tokens"]
    prompt_len = tokens.shape[1]
    logits, cache = prefill(cfg, params, batch, cache_len=prompt_len + n_tokens)

    def pick(lg):
        if temperature <= 0.0:
            return torch.argmax(lg, -1).to(torch.int32)
        # Gumbel-max: argmax(logits / T + Gumbel noise) is a draw from the softmax
        u = torch.rand(lg.shape, generator=generator, device=lg.device, dtype=torch.float32)
        return torch.argmax(lg.float() / temperature - torch.log(-torch.log(u.clamp_min(1e-20))), -1).to(torch.int32)

    tok = pick(logits[:, -1, :])
    out = [tok]
    for t in range(1, n_tokens):
        logits = decode_step(cfg, params, cache, tok[:, None], prompt_len + t - 1)
        tok = pick(logits[:, -1, :])
        out.append(tok)
    return torch.stack(out, dim=1)
