"""Training loop on one device: straggler monitoring, multi-step fusion,
gradient accumulation, logging.

The reference's loop begins with restore-or-init and checkpoints every
``ckpt_every`` steps; the checkpoint module is not ported yet (ROADMAP
Queue A 10), so a ``ckpt_dir`` raises here and the loop always begins from
a fresh init. A mesh raises too (Queue A 13). ``fuse_steps`` = k runs k
steps behind one call (core/stripmine.fuse_steps).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.stripmine import fuse_steps as _fuse
from repro_torch.data.pipeline import DataConfig, make_source, to_device
from repro_torch.device import resolve_device
from repro_torch.ft.elastic import StragglerMonitor
from repro_torch.models import transformer as tf
from repro_torch.models.layers import init_params
from repro_torch.optim import adamw
from repro_torch.train import step as step_lib


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    fuse_steps: int = 1
    grad_accum: int = 1
    seed: int = 0


class Trainer:
    def __init__(self, cfg: ArchConfig, opt_cfg: adamw.OptConfig,
                 data_cfg: DataConfig, tcfg: TrainerConfig, mesh=None,
                 device=None):
        if mesh is not None:
            raise NotImplementedError(
                "Trainer runs on one device; a mesh waits for the "
                "multi-device machinery (ROADMAP Queue A 13)")
        if tcfg.ckpt_dir:
            raise NotImplementedError(
                "checkpointing (checkpoint/ckpt.py) is not ported yet: "
                "ROADMAP Queue A 10")
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.bundle = step_lib.make_train_step(cfg, opt_cfg,
                                               grad_accum=tcfg.grad_accum)
        self.step_fn = self.bundle.step_fn
        self.source = make_source(data_cfg)
        self.monitor = StragglerMonitor()
        self.metrics_log: list[dict] = []

    # -- state ------------------------------------------------------------

    def init_state(self):
        """Parameters from the port's ``init_params`` with a
        ``torch.Generator`` seeded from ``tcfg.seed``, zero moments."""
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        params = init_params(tf.model_template(self.cfg), gen,
                             dtype=self.cfg.param_dtype, device=self.device)
        return {"params": params, "opt": adamw.init(self.opt_cfg, params)}

    def restore_or_init(self):
        return 0, self.init_state()

    # -- loop ---------------------------------------------------------------

    def run(self, on_step: Optional[Callable] = None):
        start, state = self.restore_or_init()
        t = self.tcfg
        fused = _fuse(self.step_fn, t.fuse_steps) if t.fuse_steps > 1 else None
        step = start
        while step < t.steps:
            self.monitor.start_step()
            if fused is not None:
                k = min(t.fuse_steps, t.steps - step)
                batches = [self.source.batch(step + i) for i in range(k)]
                stacked = {key: np.stack([b[key] for b in batches])
                           for key in batches[0]}
                state, metrics = fused(state, to_device(stacked, self.device))
                metrics = {key: v[-1] for key, v in metrics.items()}
                step += k
            else:
                batch = to_device(self.source.batch(step), self.device)
                state, metrics = self.step_fn(state, batch)
                step += 1
            # float() waits for the step's device work
            m = {key: float(v) for key, v in metrics.items()}
            straggler = self.monitor.end_step()
            if step % t.log_every == 0 or step >= t.steps:
                m["step"] = step
                m["straggler"] = straggler
                self.metrics_log.append(m)
                if on_step:
                    on_step(m)
        return step, state
