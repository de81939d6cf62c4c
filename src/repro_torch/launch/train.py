"""Training launcher.

    python -m repro_torch.launch.train --arch qwen3-0.6b --reduced --steps 200 \
        --batch 8 --seq 256 --ckpt-dir DIR --resume auto [--device cpu]

``--reduced`` swaps in the smoke-scale config of the same family, for the
CPU.  Runs on the CUDA card unless ``--device cpu``; one device, no mesh.
``--fail-at N`` raises ``SimulatedFailure`` at step N (after the last
checkpoint before it); a second launch with ``--resume auto`` goes on from
that checkpoint.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

from repro_torch.configs import get_config, smoke_config
from repro_torch.data.pipeline import LMBatchStream
from repro_torch.optim.optimizers import cosine_schedule, get_optimizer
from repro_torch.runtime.train_loop import Trainer, TrainerConfig


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
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = smoke_config(cfg)
    stream = LMBatchStream(args.batch, args.seq, cfg.vocab_size)
    tcfg = TrainerConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir, fail_at_step=args.fail_at,
    )
    trainer = Trainer(cfg, get_optimizer(args.opt), stream, tcfg, lr_fn=cosine_schedule(args.lr, 20, args.steps),
                      device=args.device)
    params, _ = trainer.run(resume=args.resume)
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(trainer.metrics_log, f, indent=1)
    last = trainer.metrics_log[-1] if trainer.metrics_log else {}
    print(f"final: {last}")
    return params, trainer


if __name__ == "__main__":
    main()
