"""Fault-tolerant training loop: checkpoint/restart, straggler accounting,
simulated-failure injection for the restart tests.

Every state that matters (parameters, optimizer state, the data stream's
position, the step) round-trips through ``CheckpointManager``, so ``run``
can be killed at any step and relaunched with ``resume="auto"`` to go on
from the last checkpoint with the same losses as an uninterrupted run.
Parameters are drawn on ``device`` from a ``torch.Generator`` seeded with
``seed``, so a resumed run rebuilds the same tree before restoring it.

With a policy over a mesh (``pol``) the loop trains data-parallel: each
batch is placed on the mesh by ``shard_batch`` and the step is
``make_train_step(..., pol=pol)``; parameters and optimizer state live on
the mesh's lead device.  Given ``shardings`` (the parameters'
``NamedSharding`` tree, ``params.make_shardings``) a resume restores
through ``CheckpointManager.restore(shardings=)``, the optimizer state's
moments placed as the parameters they mirror and everything else
replicated, and gathers the placed leaves onto the lead: a run saved on
one mesh goes on on another.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import shard_batch
from repro_torch.models.params import init_params, leaves, map_tree
from repro_torch.optim.optimizers import Optimizer
from repro_torch.runtime.sharding import ShardedTensor, ShardingPolicy, replicated
from repro_torch.runtime.steps import make_train_step


class SimulatedFailure(Exception):
    """Injected node failure (tests / chaos drills)."""


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    log_every: int = 10
    straggler_warn_factor: float = 2.0  # a step taking 2x the median is a straggler
    fail_at_step: int | None = None  # raise SimulatedFailure there (tests)


class Trainer:
    def __init__(
        self,
        cfg: ModelConfig,
        opt: Optimizer,
        data_stream,
        tcfg: TrainerConfig,
        lr_fn: Callable | None = None,
        param_specs_fn=None,
        device="cuda",
        pol: ShardingPolicy | None = None,
        shardings=None,
    ):
        from repro_torch.models import encoder as ENC
        from repro_torch.models import lm as LM

        self.cfg, self.opt, self.tcfg = cfg, opt, tcfg
        self.mesh = pol.mesh if pol is not None else None
        self.pol, self.shardings = pol, shardings
        self.device = self.mesh.lead if self.mesh is not None else torch.device(device)
        self.stream = data_stream
        specs_fn = param_specs_fn or (ENC.param_specs if cfg.family == "encoder" else LM.param_specs)
        self.specs = specs_fn(cfg)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir)
        self.train_step = make_train_step(cfg, opt, lr_fn, pol=pol)
        self.step_times: list[float] = []
        self.metrics_log: list[dict] = []

    def init_state(self, seed: int = 0):
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = init_params(self.specs, gen, device=self.device)
        return params, self.opt.init(params)

    def state_shardings(self, state):
        """The optimizer state's placements: a leaf at ``<key>/<param path>``
        of that parameter's shape as the parameter, any other replicated."""
        by_path = dict(leaves(self.shardings))
        shapes = {path: tuple(s.shape) for path, s in leaves(self.specs)}
        rep = replicated(next(iter(by_path.values())).mesh)

        def walk(node, path):
            if isinstance(node, dict):
                return {k: walk(v, path + (k,)) for k, v in node.items()}
            sub = "/".join(path[1:])
            return by_path[sub] if shapes.get(sub) == tuple(node.shape) else rep

        return walk(state, ())

    def run(self, resume: str = "auto", seed: int = 0):
        start_step = 0
        params, opt_state = self.init_state(seed)
        if resume == "auto" and self.ckpt.latest_step() is not None:
            if self.shardings is None:
                (params, opt_state), extra, start_step = self.ckpt.restore((params, opt_state))
            else:
                placed, extra, start_step = self.ckpt.restore(
                    (params, opt_state), shardings=(self.shardings, self.state_shardings(opt_state)))
                params, opt_state = (map_tree(lambda t: t.full(self.device) if isinstance(t, ShardedTensor) else t, x)
                                     for x in placed)
            self.stream.load_state_dict(extra["stream"])
            start_step += 1

        for step in range(start_step, self.tcfg.total_steps):
            if self.tcfg.fail_at_step is not None and step == self.tcfg.fail_at_step:
                # persist nothing beyond the last checkpoint: a real node loss
                self.ckpt.wait()
                raise SimulatedFailure(f"node lost at step {step}")
            t0 = time.monotonic()
            raw = self.stream.next()
            spec = self.pol.spec("act_batch", shape=raw["tokens"].shape[:1]) if self.mesh is not None else None
            batch = shard_batch(raw, self.mesh, spec, device=self.device)
            params, opt_state, metrics = self.train_step(params, opt_state, batch, step)
            metrics = {k: float(v) for k, v in metrics.items()}  # synchronises the step
            dt = time.monotonic() - t0
            self.step_times.append(dt)
            med = float(np.median(self.step_times[-20:]))
            if dt > self.tcfg.straggler_warn_factor * med and len(self.step_times) > 5:
                metrics["straggler"] = dt / med  # logged; a scheduler's hook point
            metrics["step"] = step
            self.metrics_log.append(metrics)
            if (step + 1) % self.tcfg.ckpt_every == 0 or step + 1 == self.tcfg.total_steps:
                self.ckpt.save(step, (params, opt_state), extra={"stream": self.stream.state_dict()})
        self.ckpt.wait()
        return params, opt_state
