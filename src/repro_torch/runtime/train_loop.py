"""Fault-tolerant training loop: checkpoint/restart, straggler accounting,
simulated-failure injection for the restart tests.

Every state that matters (parameters, optimizer state, the data stream's
position, the step) round-trips through ``CheckpointManager``, so ``run``
can be killed at any step and relaunched with ``resume="auto"`` to go on
from the last checkpoint with the same losses as an uninterrupted run.
Parameters are drawn on ``device`` from a ``torch.Generator`` seeded with
``seed``, so a resumed run rebuilds the same tree before restoring it.
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
from repro_torch.models.params import init_params
from repro_torch.optim.optimizers import Optimizer
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
    ):
        from repro_torch.models import encoder as ENC
        from repro_torch.models import lm as LM

        self.cfg, self.opt, self.tcfg, self.device = cfg, opt, tcfg, torch.device(device)
        self.stream = data_stream
        specs_fn = param_specs_fn or (ENC.param_specs if cfg.family == "encoder" else LM.param_specs)
        self.specs = specs_fn(cfg)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir)
        self.train_step = make_train_step(cfg, opt, lr_fn)
        self.step_times: list[float] = []
        self.metrics_log: list[dict] = []

    def init_state(self, seed: int = 0):
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = init_params(self.specs, gen, device=self.device)
        return params, self.opt.init(params)

    def run(self, resume: str = "auto", seed: int = 0):
        start_step = 0
        params, opt_state = self.init_state(seed)
        if resume == "auto" and self.ckpt.latest_step() is not None:
            (params, opt_state), extra, start_step = self.ckpt.restore((params, opt_state))
            self.stream.load_state_dict(extra["stream"])
            start_step += 1

        for step in range(start_step, self.tcfg.total_steps):
            if self.tcfg.fail_at_step is not None and step == self.tcfg.fail_at_step:
                # persist nothing beyond the last checkpoint: a real node loss
                self.ckpt.wait()
                raise SimulatedFailure(f"node lost at step {step}")
            t0 = time.monotonic()
            batch = {k: torch.as_tensor(v, device=self.device) for k, v in self.stream.next().items()}
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
