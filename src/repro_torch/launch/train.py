"""Training launcher.

    python -m repro_torch.launch.train --arch qwen3-0.6b --reduced --steps 200 \
        --batch 8 --seq 256 --ckpt-dir DIR --resume auto [--device cpu]

``--reduced`` swaps in the smoke-scale config of the same family, for the
CPU.  Runs on the CUDA card unless ``--device cpu``.  As in the reference,
more than one visible card gives a ``("data", "model")`` mesh of
``(n_cards, 1)`` and ``make_policy(global_batch=, seq_len=)``: the step is
data-parallel.  ``--shards N`` asks for a ``(N, 1)`` mesh and ``--mesh
DxM`` for a ``(D, M)`` one (the MoE experts over ``M``); where fewer cards
are visible (or with ``--device cpu``) one device stands in for all of
them, repeated at every coordinate.  ``--fail-at N`` raises
``SimulatedFailure`` at step N (after the last checkpoint before it); a
second launch with ``--resume auto`` goes on from that checkpoint, onto
whatever mesh it is given.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.data.pipeline import LMBatchStream
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import lm as LM
from repro_torch.models.params import make_shardings
from repro_torch.optim.optimizers import cosine_schedule, get_optimizer
from repro_torch.runtime.sharding import make_policy
from repro_torch.runtime.train_loop import Trainer, TrainerConfig


def train_mesh(shape, device: str):
    """A ``("data", "model")`` mesh of ``shape``: the first cards, or one
    device repeated where fewer are visible (always on the CPU)."""
    if device != "cpu" and torch.cuda.is_available() and torch.cuda.device_count() >= shape[0] * shape[1]:
        return make_smoke_mesh(shape)
    return make_smoke_mesh(shape, device="cpu" if device == "cpu" else "cuda:0")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--opt", default="adamw")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default="auto")
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, default=None, help="data shards: a (N, 1) mesh")
    ap.add_argument("--mesh", default=None, help="DxM: a (D, M) mesh, the experts over M")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = smoke_config(cfg)
    if args.mesh:
        shape = tuple(int(n) for n in args.mesh.lower().split("x"))
    elif args.shards:
        shape = (args.shards, 1)
    else:
        n_dev = torch.cuda.device_count() if args.device != "cpu" and torch.cuda.is_available() else 1
        shape = (n_dev, 1)
    mesh = train_mesh(shape, args.device) if shape[0] * shape[1] > 1 else None
    pol = make_policy(mesh, shape_kind="train", global_batch=args.batch, seq_len=args.seq)
    if mesh is not None:
        print(f"mesh {mesh.shape} on {[str(d) for d in mesh.devices]}", flush=True)
    stream = LMBatchStream(args.batch, args.seq, cfg.vocab_size)
    tcfg = TrainerConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir, fail_at_step=args.fail_at,
    )
    trainer = Trainer(cfg, get_optimizer(args.opt), stream, tcfg, lr_fn=cosine_schedule(args.lr, 20, args.steps),
                      device=args.device, pol=pol if mesh is not None else None,
                      shardings=make_shardings(LM.param_specs(cfg), mesh, pol.rules) if mesh is not None else None)
    params, _ = trainer.run(resume=args.resume)
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(trainer.metrics_log, f, indent=1)
    last = trainer.metrics_log[-1] if trainer.metrics_log else {}
    print(f"final: {last}")
    return params, trainer


if __name__ == "__main__":
    main()
