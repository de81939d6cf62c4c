"""Mixture-of-Experts FFN with top-k routing: the single-device (tp = 1)
path and the reference's two expert-parallel forms.

``moe_specs`` declares the JAX package's tree: a router ``(d, E_pad)``
and stacked expert weights ``wg``/``wu`` ``(E_pad, d, f)``, ``wd``
``(E_pad, f, d)``, the expert count padded to a multiple of ``tp_hint``
(16 by default, so qwen2-moe's 60 experts are allocated as 64) so that
``params.from_reference`` maps the tree one to one; padded experts are
never routed.  With ``n_shared_experts`` a dense SwiGLU of
``n_shared_experts * f`` hidden units runs beside the routed experts,
scaled by a sigmoid gate.

``_local_moe`` is one model shard's body (the whole layer at tp = 1): it
routes its tokens in f32 (softmax over the real experts, top-k, gates
renormalised), puts the (token, expert) pairs whose expert lies in its
slice first and the others in a pad bucket after them (a stable sort, so
a token's pairs keep its order), keeps the first ``cap``, runs each local
expert's SwiGLU over its contiguous group of rows, and adds each token's
gated contributions into a zero tensor of the activations' dtype.  The
JAX package's grouped product is XLA's ``ragged_dot``, not a Pallas
kernel, so here it stays on stock matmuls: a loop over the experts whose
group is not empty, their sizes read on the host (one device sync per
call, counted under the recorder's ``moe.group_sizes``
(``runtime/trace.py``); on ``meta`` tensors, which hold no
routing, a stated stand-in: the buffer's rows split evenly over the
experts).  Rows in no group (the pad bucket, the
empty all-to-all slots) are zeros, as ``ragged_dot`` gives them.  Each
expert's weights are cast to the activation dtype one expert at a time,
never the whole stacked leaf.  The combine is deterministic: each token's
kept contributions are gathered into a ``(T, k, d)`` buffer in expert
order and summed in that order (``index_add_`` on the card would sum in
an order that changes from run to run).

``moe_apply(..., pol=)`` with a mesh that has a ``model`` axis of more
than one device takes the reference's ``shard_map`` forms as loops over
the mesh (``runtime/compat.py``), the experts placed over ``model``
(``_moe_param_specs``):

* ``psum`` (masked-local EP): tokens split over the policy's
  ``act_batch`` axes and replicated over ``model``; each model shard runs
  ``_local_moe`` on its slice of experts at the capacity of its tokens
  over tp, and the shards' outputs are summed in shard order;
* ``a2a``: tokens split over the batch axes and ``model``; each shard
  buckets its pairs by destination shard, ``cap`` a destination, the
  overflow dropped, hands block ``[j, j']`` of its send buffers to shard
  ``j'`` (the all-to-all), runs its experts over what it received, and
  the results come back the same way to be combined.

Both give the mean of the shards' local load-balance losses (the
reference's ``pmean``), not the loss over all tokens.

``moe_reference`` is the dense oracle: every expert over every token,
weighted by the token's gate for it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import mlp_apply, mlp_specs
from repro_torch.models.params import ParamSpec, map_tree
from repro_torch.runtime import trace
from repro_torch.runtime.compat import gather
from repro_torch.runtime.sharding import NamedSharding, PartitionSpec, assemble, device_put, entry_axes


def padded_experts(cfg: ModelConfig, tp: int) -> int:
    return int(math.ceil(cfg.n_experts / tp) * tp)


def moe_specs(cfg: ModelConfig, tp_hint: int = 16) -> dict:
    d, f = cfg.d_model, cfg.resolved_moe_d_ff
    e_pad = padded_experts(cfg, tp_hint)
    s = {
        "router": ParamSpec((d, e_pad), ("embed", "experts"), "fan_in", fan_in_dims=(0,)),
        "wg": ParamSpec((e_pad, d, f), ("experts", "expert_in", "expert_mlp"), "fan_in", fan_in_dims=(1,)),
        "wu": ParamSpec((e_pad, d, f), ("experts", "expert_in", "expert_mlp"), "fan_in", fan_in_dims=(1,)),
        "wd": ParamSpec((e_pad, f, d), ("experts", "expert_mlp", "expert_in"), "fan_in", fan_in_dims=(1,)),
    }
    if cfg.n_shared_experts:
        s["shared"] = mlp_specs(cfg, d_ff=cfg.n_shared_experts * f)
        s["shared_gate"] = ParamSpec((d, 1), ("embed", None), "fan_in", fan_in_dims=(0,))
    return s


def _route(cfg: ModelConfig, router_w, x2d):
    """Top-k routing in f32.  x2d (T, d) -> gates (T, k), ids (T, k),
    probs (T, E_pad); padded experts get probability 0."""
    logits = x2d.float() @ router_w.float()
    e_pad = logits.shape[-1]
    valid = torch.arange(e_pad, device=x2d.device) < cfg.n_experts
    logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.topk(probs, cfg.moe_top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)  # renormalise
    return gates, ids, probs


def _counts(v, n: int):
    """How often each of 0 .. n - 1 occurs in ``v``, whose values all lie
    there.  A meta tensor has no values (and ``bincount``, whose length
    depends on them, no meta kernel): zeros of the counts' shape."""
    if v.device.type == "meta":
        return torch.zeros(n, dtype=torch.int64, device=v.device)
    return torch.bincount(v, minlength=n)


def _aux_loss(cfg: ModelConfig, probs, ids):
    """Switch-style load-balance loss over the tokens given."""
    e = probs.shape[-1]
    me = probs.mean(dim=0)
    ce = _counts(ids.reshape(-1), e).float()
    ce = ce / torch.clamp(ce.sum(), min=1.0)
    return e * torch.sum(me * ce)


def _capacity(cfg: ModelConfig, t_loc: int, tp: int) -> int:
    cap = int(math.ceil(t_loc * cfg.moe_top_k / tp * cfg.capacity_slack))
    cap = max(cap, cfg.moe_top_k)
    return int(math.ceil(cap / 8) * 8)


def _expert_compute(wg, wu, wd, xbuf, group_sizes):
    """SwiGLU of each expert over its contiguous group of ``xbuf`` rows
    (``group_sizes`` per expert, from the first row), in ``xbuf``'s dtype;
    the rows past the groups are zeros."""
    dt = xbuf.dtype
    y = torch.zeros((xbuf.shape[0], wd.shape[-1]), dtype=dt, device=xbuf.device)
    start = 0
    if xbuf.device.type == "meta":  # no routing to read: the rows split evenly over the experts
        n, n_e = xbuf.shape[0], group_sizes.shape[0]
        sizes = [n // n_e + (e < n % n_e) for e in range(n_e)]
    else:
        sizes = trace.to_host(group_sizes, "moe.group_sizes").tolist()  # the one host sync of the call
    for e, g in enumerate(sizes):
        if g == 0:
            continue
        xe = xbuf[start : start + g]
        h = F.silu(xe @ wg[e].to(dt)) * (xe @ wu[e].to(dt))
        y[start : start + g] = h @ wd[e].to(dt)
        start += g
    return y


def _combine(contrib, pairs, ids, dtype):
    """Each token's contributions summed in expert order, left to right
    from the first: ``contrib[i]`` belongs to pair ``pairs[i]`` (token
    ``pairs[i] // k``); a pair not listed adds nothing."""
    t, k = ids.shape
    d = contrib.shape[-1]
    slots = torch.zeros((t * k, d), dtype=dtype, device=contrib.device)
    slots[pairs] = contrib.to(dtype)
    by_expert = torch.argsort(ids, dim=1)
    slots = torch.gather(slots.view(t, k, d), 1, by_expert[:, :, None].expand(t, k, d))
    out = slots[:, 0]
    for j in range(1, k):
        out = out + slots[:, j]
    return out


def _local_moe(cfg: ModelConfig, cap: int, p, x2d, my: int = 0):
    """Model shard ``my``'s routed experts over x2d (T, d) at capacity
    ``cap``: ``p["wg"/"wu"/"wd"]`` hold its ``e_loc`` experts (global ids
    ``my * e_loc`` on), ``p["router"]`` all of them.  Returns (its part of
    the output (T, d) in x2d's dtype, its aux loss)."""
    k = cfg.moe_top_k
    e_loc = p["wg"].shape[0]
    gates, ids, probs = _route(cfg, p["router"], x2d)
    flat_ids = ids.reshape(-1)
    mine = torch.div(flat_ids, e_loc, rounding_mode="floor") == my
    eloc = torch.where(mine, flat_ids - my * e_loc, torch.full_like(flat_ids, e_loc))  # e_loc: the pad bucket
    order = torch.argsort(eloc, stable=True)[:cap]
    sel_e = eloc[order]
    sel_t = torch.div(order, k, rounding_mode="floor")  # the pair's token
    sel_g = torch.where(sel_e < e_loc, gates.reshape(-1)[order], torch.zeros((), device=x2d.device))
    with record_function("moe_expert_loop"):  # the profiler's name for the loop's device time
        y = _expert_compute(p["wg"], p["wu"], p["wd"], x2d[sel_t], _counts(sel_e, e_loc + 1)[:e_loc])
    out = _combine(y * sel_g[:, None].to(y.dtype), order, ids, x2d.dtype)
    return out, _aux_loss(cfg, probs, ids)


def _moe_param_specs(p):
    """The placement of the MoE leaves on the mesh: experts over ``model``,
    everything else replicated."""
    specs = {}
    for k, v in p.items():
        if k in ("wg", "wu", "wd"):
            specs[k] = PartitionSpec("model", *([None] * (v.ndim - 1)))
        elif k == "shared":
            specs[k] = map_tree(lambda _: PartitionSpec(), v)
        else:
            specs[k] = PartitionSpec(*([None] * v.ndim))
    return specs


def _placed_experts(mesh, p):
    """The router and expert leaves placed per ``_moe_param_specs``."""
    specs = _moe_param_specs(p)
    return {k: device_put(p[k], NamedSharding(mesh, specs[k])) for k in ("router", "wg", "wu", "wd")}


def _groups(mesh, tok_axes: tuple):
    """The token groups of a shard map whose tokens go over ``tok_axes``:
    per group, its coordinates along ``model`` in shard order.  Replicas
    over the axes that are neither ``model`` nor token axes are left out
    (they would compute the same)."""
    mi = mesh.axis_names.index("model")
    out = []
    for coord in mesh.coords():
        if coord[mi] == 0 and not any(c for a, c in zip(mesh.axis_names, coord) if a != "model" and a not in tok_axes):
            out.append([coord[:mi] + (j,) + coord[mi + 1:] for j in range(mesh.dims[mi])])
    return out


def _mean_aux(auxes, device):
    auxes = gather(auxes, device, "all-reduce")  # the pmean
    total = auxes[0]
    for a in auxes[1:]:
        total = total + a
    return total / len(auxes)


def _moe_psum(cfg: ModelConfig, pol, p, x2d):
    """Masked-local EP (the reference's ``_local_moe`` under ``shard_map``)."""
    mesh = pol.mesh
    t_all = x2d.shape[0]
    tp = mesh.shape["model"]
    dp = mesh.size // tp
    batch_rule = pol.rules.get("act_batch")
    cap = _capacity(cfg, max(t_all // dp, 1) if batch_rule else t_all, tp)
    tok = NamedSharding(mesh, PartitionSpec(batch_rule or None, None))
    xs, ws = device_put(x2d, tok), _placed_experts(mesh, p)
    mi = mesh.axis_names.index("model")
    outs, auxes = [], []
    for group in _groups(mesh, entry_axes(batch_rule)):
        parts = []
        for coord in group:
            o, a = _local_moe(cfg, cap, {k: w.block(coord) for k, w in ws.items()}, xs.block(coord), my=coord[mi])
            parts.append(o)
            auxes.append(a)
        parts = gather(parts, parts[0].device, "all-reduce")  # the psum over model, in shard order
        total = parts[0]
        for o in parts[1:]:
            total = total + o
        outs.append((group[0], total))
    return assemble(tok, outs, x2d.device), _mean_aux(auxes, x2d.device)


def _moe_a2a(cfg: ModelConfig, pol, p, x2d):
    """All-to-all EP (the reference's ``_local_moe_a2a`` under ``shard_map``)."""
    mesh = pol.mesh
    t_all, d = x2d.shape
    k = cfg.moe_top_k
    tp = mesh.shape["model"]
    dp = mesh.size // tp
    cap = _capacity(cfg, t_all // (dp * tp), tp)
    tok_axes = entry_axes(pol.rules.get("act_batch"))
    tok = NamedSharding(mesh, PartitionSpec(tok_axes + ("model",) if "model" not in tok_axes else tok_axes, None))
    xs, ws = device_put(x2d, tok), _placed_experts(mesh, p)
    outs, auxes = [], []
    for group in _groups(mesh, tok_axes + ("model",)):
        sends = []
        for coord in group:  # route and bucket each shard's pairs by destination shard
            x_loc = xs.block(coord)
            e_loc = ws["wg"].block(coord).shape[0]
            gates, ids, probs = _route(cfg, ws["router"].block(coord), x_loc)
            auxes.append(_aux_loss(cfg, probs, ids))
            flat_ids = ids.reshape(-1)
            dest = torch.div(flat_ids, e_loc, rounding_mode="floor")
            order = torch.argsort(dest, stable=True)
            d_sorted = dest[order]
            pos_in_dest = torch.arange(d_sorted.numel(), device=x_loc.device) - torch.searchsorted(
                d_sorted, d_sorted, side="left")
            keep = pos_in_dest < cap
            slot = torch.where(keep, d_sorted * cap + pos_in_dest, torch.full_like(d_sorted, tp * cap))  # overflow
            tok_sorted = torch.div(order, k, rounding_mode="floor")
            send_x = torch.zeros((tp * cap + 1, d), dtype=x_loc.dtype, device=x_loc.device).index_put(
                (slot,), x_loc[tok_sorted])[:-1]
            send_e = torch.full((tp * cap + 1,), e_loc, dtype=flat_ids.dtype, device=x_loc.device).index_put(
                (slot,), torch.where(keep, flat_ids[order] - d_sorted * e_loc, torch.full_like(slot, e_loc)))[:-1]
            g_sorted = torch.where(keep, gates.reshape(-1)[order], torch.zeros((), device=x_loc.device))
            sends.append(dict(x=send_x.view(tp, cap, d), e=send_e.view(tp, cap), order=order, slot=slot,
                              g=g_sorted, ids=ids, e_loc=e_loc))
        ys = []
        for jp, coord in enumerate(group):  # the all-to-all there: shard jp takes block [j, jp] of every j
            dev = mesh.device(coord)
            recv_x = torch.cat(gather([s["x"][jp] for s in sends], dev, "all-to-all"))
            recv_e = torch.cat(gather([s["e"][jp] for s in sends], dev, "all-to-all"))
            e_loc = sends[jp]["e_loc"]
            eorder = torch.argsort(recv_e, stable=True)
            w = {n: ws[n].block(coord) for n in ("wg", "wu", "wd")}
            with record_function("moe_expert_loop"):
                y = _expert_compute(w["wg"], w["wu"], w["wd"], recv_x[eorder], _counts(recv_e, e_loc + 1)[:e_loc])
            ys.append(torch.zeros_like(y).index_copy(0, eorder, y).view(tp, cap, d))  # un-sorted
        for j, (coord, s) in enumerate(zip(group, sends)):  # and back: shard j takes block [jp, j] of every jp
            dev = mesh.device(coord)
            back = torch.cat(gather([y[j] for y in ys], dev, "all-to-all")
                             + [torch.zeros((1, d), dtype=ys[0].dtype, device=dev)])
            contrib = back[s["slot"]] * s["g"][:, None].to(back.dtype)  # a dropped pair reads the zero row
            outs.append((coord, _combine(contrib, s["order"], s["ids"], x2d.dtype)))
    return assemble(tok, outs, x2d.device), _mean_aux(auxes, x2d.device)


def moe_apply(cfg: ModelConfig, p, x, pol=None):
    """x (..., d), T tokens (B, S, d for a batch, N, d for a packed
    serving step) -> (out of x's shape, aux loss): the routed experts plus
    the gated shared experts.  Without a policy whose mesh has a ``model``
    axis over more than one device, the tp = 1 path at the capacity of T
    tokens; with one, the expert-parallel form ``cfg.moe_impl`` names
    (``a2a`` only where T divides over the mesh, else ``psum``), x being
    the whole batch over ``pol.mesh``."""
    x2d = x.reshape(-1, x.shape[-1])
    t = x2d.shape[0]
    mesh = pol.mesh if pol is not None else None
    if mesh is None or "model" not in mesh.shape or mesh.size == 1:
        out, aux = _local_moe(cfg, _capacity(cfg, t, 1), p, x2d)
    elif cfg.moe_impl == "a2a" and t % mesh.size == 0:
        out, aux = _moe_a2a(cfg, pol, p, x2d)
    else:
        out, aux = _moe_psum(cfg, pol, p, x2d)
    out = out.reshape(x.shape)
    if cfg.n_shared_experts:
        shared = mlp_apply(cfg, p["shared"], x)
        gate = torch.sigmoid((x @ p["shared_gate"].to(x.dtype)).float())
        out = out + shared * gate.to(x.dtype)
    return out, aux


def moe_reference(cfg: ModelConfig, p, x):
    """Dense oracle of the routed experts: every real expert over every
    token, weighted by the token's gate for it (0 where not routed)."""
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    gates, ids, probs = _route(cfg, p["router"], x2d)
    dt = x2d.dtype
    out = torch.zeros_like(x2d)
    for e in range(cfg.n_experts):
        w = torch.where(ids == e, gates, torch.zeros_like(gates)).sum(-1)
        h = F.silu(x2d @ p["wg"][e].to(dt)) * (x2d @ p["wu"][e].to(dt))
        out = out + (h @ p["wd"][e].to(dt)) * w[:, None].to(dt)
    return out.reshape(b, s, d), _aux_loss(cfg, probs, ids)
