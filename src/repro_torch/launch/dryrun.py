"""Multi-pod dry run: run every (arch x shape x mesh) cell's own step on
``meta`` tensors under a ``CostCounter`` and price it on the H100 model
of ``launch/roofline.py``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun.json

The reference lowered and compiled each cell for a fake 512-device TPU
mesh and read XLA's cost analysis.  Here the production mesh is a
``runtime.compat`` mesh of ``meta`` devices ((16, 16) over ("data",
"model"), or (2, 16, 16) with "pod"), and the step is the port's own:
``runtime/steps.make_train_step(..., pol=)`` (the data-parallel loop,
each data shard's forward and backward, the reduction and the update;
the encoder family has no data-parallel step in the port, so its cell
runs one data shard's rows through the one-device step),
``make_prefill_step`` and ``make_decode_step`` on one coordinate's rows
of the batch and cache.  Parameters and optimizer state are whole on
every coordinate: the port replicates the dense layers over ``model``
(only the MoE experts go over it), and the table shows that redundancy
rather than model a tensor parallelism the port does not run.  Nothing is
computed and nothing is allocated; the hand-written kernels return empty
outputs and count their cost hooks.

One coordinate's figures (the reference's per-device module) are the
counts over the data shards the step ran (``runtime.sharding.
data_shards``): exact for the shards' forward and backward, which are
alike; the reduction and the update, which run once on the lead, and the
experts of every ``model`` coordinate of a shard, are folded in.  The
global figures are one coordinate's times the mesh size, as in the
reference.  ``collective_detail`` is one coordinate's bytes by kind and
its count of collective calls.

As in the reference, the cost comes from short steps extrapolated to
full depth (``count_cell``: 1, 2 and 3 scan periods, where the reference
took 1 and 2, because the port's backward has a term in depth squared),
which is exact for the port's homogeneous scan blocks (a test holds it to
the full-depth count) and keeps the ``--all`` sweep fast.  The high-water
mark of live bytes is a max over the step's phases, not a polynomial in
depth: it is estimated on the line through the 2- and 3-period runs.
``measure=False`` counts the full-depth step once instead.  The port
calls ``ssd_chunk`` once per chunk, so the counter sees every chunk and
``ssd_correction`` (the chunks the reference's rolled scan hid) is not
added.  ``decode_donate`` is accepted and changes nothing: the port's
decode step writes the cache in place (``runtime/steps.py``), so
``dus_bytes`` reads 0 either way.  ``memory_analysis``:
``argument_bytes`` is what the step's arguments hold on one coordinate's
device (the parameters and optimizer state whole, the batch as placed,
or the coordinate's rows of it, its cache); ``temp_bytes`` the high-water
mark less them; ``output_bytes`` the step's new outputs (the cache it
updates in place is an argument); ``peak_bytes_per_device`` the
high-water mark.  ``compile_s`` is the seconds the meta runs took.
"""
from __future__ import annotations

import argparse
import json
import math
import multiprocessing
import time
import traceback
from concurrent.futures import ProcessPoolExecutor

import torch

from repro_torch.configs import SHAPES, applicable, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import shard_batch
from repro_torch.launch.inputs import input_specs
from repro_torch.launch.roofline import CostCounter, Roofline, model_flops_for, tensor_bytes, tensors
from repro_torch.models import encoder as ENC
from repro_torch.models import lm as LM
from repro_torch.models.params import ParamSpec, abstract_params, init_params, make_pspecs, map_tree, spec_to_pspec
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.runtime.compat import Mesh, make_mesh
from repro_torch.runtime.sharding import PartitionSpec, data_shards, entry_axes, make_policy
from repro_torch.runtime.steps import make_decode_step, make_prefill_step, make_train_step

_KEYS = ("flops", "bytes", "convert_bytes", "dus_bytes", "coll", "peak")


def production_mesh(multi_pod: bool = False) -> Mesh:
    """The reference's production mesh over ``meta`` devices."""
    if multi_pod:
        return make_mesh(["meta"] * 512, ("pod", "data", "model"), shape=(2, 16, 16))
    return make_mesh(["meta"] * 256, ("data", "model"), shape=(16, 16))


def _opt_pspecs(opt_name: str, specs, rules, axis_sizes):
    """Optimizer-state PartitionSpecs derived from the param logical axes."""

    def p_spec(s):
        return spec_to_pspec(s, rules, axis_sizes)

    def drop_last(s):
        return spec_to_pspec(ParamSpec(s.shape[:-1], s.axes[:-1], s.init), rules, axis_sizes)

    def drop_2nd_last(s):
        return spec_to_pspec(
            ParamSpec(s.shape[:-2] + s.shape[-1:], s.axes[:-2] + s.axes[-1:], s.init),
            rules,
            axis_sizes,
        )

    if opt_name == "adamw":
        return {
            "mu": map_tree(p_spec, specs),
            "nu": map_tree(p_spec, specs),
            "count": PartitionSpec(),
        }
    if opt_name == "adafactor":
        def fac(s):
            if len(s.shape) >= 2 and s.shape[-1] >= 128 and s.shape[-2] >= 128:
                return {"vr": drop_last(s), "vc": drop_2nd_last(s)}
            return {"v": p_spec(s)}

        return {"v": map_tree(fac, specs), "count": PartitionSpec()}
    raise ValueError(opt_name)


def _rows(pspec, mesh: Mesh | None) -> int:
    """How many blocks a batch dimension of partition spec ``pspec`` is cut into."""
    if mesh is None or pspec is None or not len(pspec):
        return 1
    return math.prod(mesh.shape[a] for a in entry_axes(pspec[0]))


def _real(t: torch.Tensor, cfg, device, generator) -> torch.Tensor:
    """A tensor of ``t``'s shape and dtype on ``device``, drawn from
    ``generator``: token ids in the vocabulary, a 30% mask, normal floats."""
    if t.dtype == torch.bool:
        return torch.rand(t.shape, generator=generator, device=device) < 0.3
    if not t.is_floating_point():
        return torch.randint(0, cfg.vocab_size, t.shape, generator=generator, device=device, dtype=t.dtype)
    return torch.randn(t.shape, generator=generator, device=device).to(t.dtype)


def cell_args(cfg, shape: ShapeConfig, pol, opt_name: str | None, device="meta", generator=None,
              grad_rs: bool = False):
    """One cell's step and what it is called with, on ``device`` (``meta``:
    the ``abstract_params`` tree, the ``input_specs`` stand-ins and an
    ``lm.init_cache`` cache; another device: weights, state and inputs
    drawn from ``generator``, a zero cache): a data-parallel train step
    gets the batch placed on the mesh (``shard_batch``), the other steps
    one coordinate's rows of it.  Returns ``(step, args, info)``; ``info``:
    the ``cache`` (or None) and ``shards``, the data shards the step runs."""
    specs = (ENC.param_specs if cfg.family == "encoder" else LM.param_specs)(cfg)
    if device == "meta":
        params = abstract_params(specs)
    else:
        params = init_params(specs, generator, device=device)
    placed = input_specs(cfg, shape, pol)
    batch = {k: t if device == "meta" else _real(t, cfg, device, generator) for k, (t, _) in placed.items()}
    local_b = shape.global_batch // _rows(next(iter(placed.values())).pspec, pol.mesh)
    if shape.kind == "train":
        opt = get_optimizer(opt_name)
        state = opt.init(params)
        if pol.mesh is not None and cfg.family != "encoder":
            batch = shard_batch(batch, pol.mesh, pol.spec("act_batch", shape=(shape.global_batch,)))
            grad_pspecs = make_pspecs(specs, pol.rules, dict(pol.mesh.shape)) if grad_rs else None
            return (make_train_step(cfg, opt, grad_pspecs=grad_pspecs, pol=pol), (params, state, batch, 0),
                    dict(cache=None, shards=len(data_shards(pol, shape.global_batch))))
        batch = {k: v[:local_b].clone() for k, v in batch.items()}  # one coordinate's rows, one device's step
        return make_train_step(cfg, opt), (params, state, batch, 0), dict(cache=None, shards=1)
    batch = {k: v[:local_b].clone() for k, v in batch.items()}
    if shape.kind == "prefill":
        return make_prefill_step(cfg), (params, batch), dict(cache=None, shards=1)
    cache = LM.init_cache(cfg, local_b, shape.seq_len, dtype=torch.bfloat16, device=device)
    # per-row write positions, as the contiguous engine passes them (a
    # scalar position is read on the host, which a meta tensor cannot be):
    # every row writes the cache's last position and attends all of it
    pos = torch.full((local_b,), shape.seq_len - 1, dtype=torch.int32, device=device)
    return make_decode_step(cfg), (params, cache, batch["tokens"], pos), dict(cache=cache, shards=1)


def count_step(step, args, cache=None):
    """``step(*args)`` once under a fresh ``CostCounter``, the arguments held
    as live and the ``cache`` leaves marked.  Returns ``(counter, argument
    bytes, output bytes)``: the bytes of the storages the arguments hold
    (a placement's one copy per device, as ``device_put`` keeps it), and
    of the results that are not arguments (a cache updated in place is
    one)."""
    with CostCounter() as cc:
        arguments = cc.track(tensors(args))
        if cache is not None:
            cc.mark_cache(cache)
        out = step(*args)
    held = {t.untyped_storage()._cdata for t in tensors(args)}
    return cc, arguments, sum(tensor_bytes(t) for t in tensors(out) if t.untyped_storage()._cdata not in held)


def _run_cell(cfg, shape: ShapeConfig, pol, opt_name: str | None, device="meta", generator=None,
              grad_rs: bool = False):
    """Run one cell's step once under a fresh ``CostCounter``; returns
    ``(counter, info)`` (``info`` as ``cell_args``, with the ``arguments``
    and ``outputs`` bytes of ``count_step``)."""
    step, args, info = cell_args(cfg, shape, pol, opt_name, device, generator, grad_rs)
    cc, info["arguments"], info["outputs"] = count_step(step, args, info["cache"])
    return cc, info


def _measure(cc: CostCounter, shards: int) -> dict:
    """One coordinate's counts: the step's over its data shards."""
    detail = {k: v / shards for k, v in cc.collectives.items()}
    return {
        "flops": cc.flops / shards,
        "bytes": cc.bytes / shards,
        "convert_bytes": cc.convert_bytes / shards,
        "dus_bytes": cc.dus_bytes / shards,
        "coll": sum(v for k, v in detail.items() if k != "collective_count"),
        "peak": float(cc.peak_bytes),
        "detail": detail,
    }


def _depth_run(cfg, shape: ShapeConfig, pol, opt_name: str | None, grad_rs: bool):
    """One coordinate's counts of the step at ``cfg``'s depth, and its
    argument, output and shard figures (what a worker process hands back)."""
    cc, info = _run_cell(cfg, shape, pol, opt_name, grad_rs=grad_rs)
    return _measure(cc, info["shards"]), {k: info[k] for k in ("arguments", "outputs")}


def count_cell(cfg, shape: ShapeConfig, pol, opt_name: str | None, measure: bool = True, grad_rs: bool = False,
               workers: int = 1):
    """One coordinate's counts of a cell's step on ``meta``: ``(totals,
    collective detail, argument bytes, output bytes)``; ``totals`` holds
    flops, bytes, convert_bytes, dus_bytes, coll and peak.  With
    ``measure``, from the steps of 1, 2 and 3 scan periods, extrapolated to
    ``n_blocks`` by their differences (f(N) = m1 + (N - 1) d1 + (N - 1)(N -
    2) / 2 d2): exact for the port's homogeneous blocks, whose backward
    through the stacked leaves also writes a whole stacked leaf per block,
    a term in depth squared that two depths cannot pin down (the reference
    also raised the flash chunk and unrolled its scans for XLA: overrides
    kept here, which change nothing in the port); the high-water mark of
    live bytes is estimated on the line through the 2- and 3-period
    runs.  ``workers`` > 1 runs the
    three depths in that many spawned processes.  Without ``measure``, or
    with at most 3 blocks, the full-depth step is counted once."""
    if not measure or cfg.n_blocks <= 3:
        m, info = _depth_run(cfg, shape, pol, opt_name, grad_rs)
        return {k: m[k] for k in _KEYS}, m["detail"], info["arguments"], info["outputs"]
    meas_chunk = max(cfg.attn_chunk, shape.seq_len // 8)
    jobs = [(cfg.with_overrides(n_layers=n * cfg.scan_period, scan_unroll=True, attn_chunk=meas_chunk),
             shape, pol, opt_name, grad_rs) for n in (1, 2, 3)]
    if workers > 1:
        with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as ex:
            runs = list(ex.map(_depth_run, *zip(*jobs)))
    else:
        runs = [_depth_run(*job) for job in jobs]
    n = cfg.n_blocks

    def extrapolate(f1, f2, f3):
        return f1 + (n - 1) * (f2 - f1) + (n - 1) * (n - 2) / 2 * (f3 - 2 * f2 + f1)

    (m1, i1), (m2, i2), (m3, i3) = runs
    totals = {k: extrapolate(m1[k], m2[k], m3[k]) for k in _KEYS if k != "peak"}
    # the high-water mark is a max over the step's phases, not a polynomial
    # in depth: the line through the two deeper runs estimates it
    totals["peak"] = m3["peak"] + (n - 3) * (m3["peak"] - m2["peak"])
    detail = {k: extrapolate(m1["detail"][k], m2["detail"][k], m3["detail"][k]) for k in m1["detail"]}
    arguments, outputs = (int(extrapolate(i1[k], i2[k], i3[k])) for k in ("arguments", "outputs"))
    return totals, detail, arguments, outputs


def dryrun_cell(
    arch: str,
    shape_name: str,
    mesh_kind: str,
    opt_name: str | None = None,
    verbose: bool = True,
    measure: bool = True,
    cfg_overrides: dict | None = None,
    rules_patch: dict | None = None,
    decode_donate: bool = False,
    grad_rs: bool = False,
):
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = cfg.with_overrides(**cfg_overrides)
    shape = SHAPES[shape_name]
    ok, why = applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "status": "skip", "reason": why}

    mesh = production_mesh(multi_pod=(mesh_kind == "multi"))
    n_chips = mesh.size
    pol = make_policy(
        mesh,
        multi_pod=(mesh_kind == "multi"),
        shape_kind=shape.kind,
        global_batch=shape.global_batch,
        seq_len=shape.seq_len,
        long_context=shape.name == "long_500k",
    )
    if rules_patch:
        pol.rules.update(rules_patch)
    # big models need the factored optimizer to fit (DESIGN.md §4)
    if opt_name is None:
        big = cfg.param_count(False) + cfg.embedding_params() > 20e9
        opt_name = "adafactor" if big else "adamw"

    t0 = time.monotonic()
    # a train cell's three depths, the slow ones, run side by side
    workers = 3 if shape.kind == "train" else 1
    totals, coll_detail, arguments, outputs = count_cell(cfg, shape, pol, opt_name, measure, grad_rs, workers)
    compile_s = time.monotonic() - t0
    peak = int(totals["peak"])

    rl = Roofline(
        arch=arch,
        shape=shape_name,
        mesh=mesh_kind,
        n_chips=n_chips,
        hlo_flops=totals["flops"] * n_chips,
        hlo_bytes=totals["bytes"] * n_chips,
        collective_bytes=totals["coll"] * n_chips,
        collective_detail=coll_detail,
        model_flops=model_flops_for(cfg, shape),
        memory_per_device=peak,
    )
    out = {
        "status": "ok",
        "compile_s": compile_s,
        "bytes_raw": totals["bytes"] * n_chips,
        "convert_bytes": totals["convert_bytes"] * n_chips,
        "dus_bytes": totals["dus_bytes"] * n_chips,
        "opt": opt_name if shape.kind == "train" else None,
        "memory_analysis": {
            "temp_bytes": max(peak - int(arguments), 0),
            "argument_bytes": int(arguments),
            "output_bytes": int(outputs),
            "peak_bytes_per_device": peak,
        },
        **rl.to_dict(),
    }
    if verbose:
        print(
            f"[{arch} x {shape_name} x {mesh_kind}] run={compile_s:.1f}s "
            f"flops={out['hlo_flops']:.3e} bytes={out['hlo_bytes']:.3e} "
            f"coll={out['collective_bytes']:.3e} dominant={out['dominant']} "
            f"bound={out['step_bound_s']*1e3:.2f}ms mfu_bound={out['mfu_bound']:.3f} "
            f"useful={out['useful_flops_frac']:.2f} "
            f"mem/dev={out['memory_analysis']['peak_bytes_per_device']/2**30:.2f}GiB",
            flush=True,
        )
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true", help="all assigned (arch x shape) cells")
    ap.add_argument("--opt", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        from repro_torch.configs import ASSIGNED_ARCHS

        cells = [(a, s) for a in ASSIGNED_ARCHS for s in SHAPES]
    elif not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    else:
        cells = [(args.arch, args.shape)]

    results = []
    for arch, shape in cells:
        for mk in meshes:
            try:
                # the 1- and 2-period runs are the cheap ones on meta, so
                # every cell is measured, multi-pod too
                results.append(dryrun_cell(arch, shape, mk, args.opt))
            except Exception as e:  # a failing cell is a bug: record it loudly
                traceback.print_exc()
                results.append(
                    {"arch": arch, "shape": shape, "mesh": mk, "status": "FAIL", "error": str(e)[:500]}
                )
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1, default=str)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skip" for r in results)
    n_fail = sum(r["status"] == "FAIL" for r in results)
    print(f"\ndone: {n_ok} ok, {n_skip} documented skips, {n_fail} FAILURES")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
