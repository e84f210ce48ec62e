"""Training loop: checkpoint/restart, straggler monitoring, multi-step
fusion, gradient accumulation, logging.

Restart contract (the reference's): the loop always begins with
restore-or-init; a SIGKILL at any point loses at most ``ckpt_every`` steps
(checkpoints are atomic), and a restart resumes exactly — the state, the
step and hence the batch and the learning rate are those of the run that
was cut. The state is restored onto the trainer's device. ``fuse_steps`` =
k runs k steps behind one call (core/stripmine.fuse_steps).

With ``mesh=`` (``launch.mesh.make_mesh``) the step is the reference's
sharded step (``train.step.make_train_step`` with a ``MeshCtx``), the mesh
held as tensor dimensions on the one device; ``state_sharding`` is the
reference's sanitized spec tree (each leaf's shard shape), which the
restore checks. With a mesh of processes (``launch.mesh.
make_process_mesh``; the rank's device is the mesh's) the step is
data-parallel: each rank takes its block of every global batch from the
same source (the rows of its coordinate along the batch axes), only rank
0 writes checkpoints, with a barrier before the next step, and every rank
restores. With a ``model`` axis above 1 it is tensor-parallel too, and
with ``cfg.fsdp`` FSDP over the batch axes: the state is the rank's
blocks of the global one (``models.sharding.shard_params`` of the same
seeded init, so each block is bit-equal to the one-device init's), the
checkpoint is the global state gathered to rank 0 (the one-device
trainer's files), and a restore keeps each rank's block of it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ArchConfig
from repro_torch.core import compat
from repro_torch.core.stripmine import fuse_steps as _fuse
from repro_torch.data.pipeline import DataConfig, make_source, to_device
from repro_torch.device import resolve_device
from repro_torch.ft.elastic import StragglerMonitor
from repro_torch.models import transformer as tf
from repro_torch.models.layers import init_params
from repro_torch.models.sharding import (MeshCtx, fsdp_split,
                                         gather_params, sanitize_specs,
                                         shard_params, tensor_parallel)
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
                 batch_axes=("data",), device=None):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.process = compat.is_process_mesh(mesh)
        if self.process:
            if device is not None and \
                    torch.device(device).type != mesh.device.type:
                raise ValueError(f"Trainer: device {device!r} on a process "
                                 f"mesh of {mesh.device}")
            self.device = mesh.device
            n = math.prod(mesh.shape[a] for a in batch_axes)
            if data_cfg.global_batch % n:
                raise ValueError(f"Trainer: a global batch of "
                                 f"{data_cfg.global_batch} does not split "
                                 f"over {n} ranks")
            rows, block = data_cfg.global_batch // n, mesh.block(batch_axes)
            self.rows = slice(block * rows, (block + 1) * rows)
        else:
            self.device = resolve_device(device)
            self.rows = slice(None)
        self.mesh = mesh
        self.ctx = MeshCtx(mesh=mesh, batch_axes=batch_axes)
        # the rank holds blocks of the state: tensor-parallel or FSDP
        self.split = tensor_parallel(cfg, self.ctx) is not None \
            or fsdp_split(cfg, self.ctx) is not None
        self.bundle = step_lib.make_train_step(cfg, opt_cfg, self.ctx,
                                               grad_accum=tcfg.grad_accum)
        # by the global shapes (the bundle's are a rank's blocks')
        whole = step_lib.make_train_state_abstract(cfg, opt_cfg)
        self.state_specs = None if mesh is None else sanitize_specs(
            self.bundle.state_specs, whole, mesh)
        self.state_sharding = None if mesh is None else step_lib.named_for(
            self.bundle.state_specs, whole, mesh)
        self.step_fn = self.bundle.step_fn
        self.source = make_source(data_cfg)
        self.monitor = StragglerMonitor()
        self.metrics_log: list[dict] = []

    # -- state ------------------------------------------------------------

    def init_state(self):
        """Parameters from the port's ``init_params`` with a
        ``torch.Generator`` seeded from ``tcfg.seed``, zero moments; on a
        tensor-parallel or FSDP rank its blocks of those parameters (the
        global ones freed before the moments are made)."""
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        params = init_params(tf.model_template(self.cfg), gen,
                             dtype=self.cfg.param_dtype, device=self.device)
        if self.split:
            params = shard_params(params, self.state_specs["params"],
                                  self.mesh)
        return {"params": params, "opt": adamw.init(self.opt_cfg, params)}

    def restore_or_init(self):
        if self.tcfg.ckpt_dir:
            step, state = ckpt.restore(self.tcfg.ckpt_dir, device=self.device,
                                       shardings=self.state_sharding)
            if state is not None:
                return step, state
        return 0, self.init_state()

    def batch(self, step: int) -> dict:
        """The global batch of ``step``, or on a process mesh the rank's
        block of it (numpy)."""
        return {k: v[self.rows] for k, v in self.source.batch(step).items()}

    # -- loop ---------------------------------------------------------------

    def run(self, on_step: Optional[Callable] = None):
        start, state = self.restore_or_init()
        t = self.tcfg
        fused = _fuse(self.step_fn, t.fuse_steps) if t.fuse_steps > 1 else None
        step = start
        pending_save = None
        while step < t.steps:
            self.monitor.start_step()
            if fused is not None:
                k = min(t.fuse_steps, t.steps - step)
                batches = [self.batch(step + i) for i in range(k)]
                stacked = {key: np.stack([b[key] for b in batches])
                           for key in batches[0]}
                state, metrics = fused(state, to_device(stacked, self.device))
                metrics = {key: v[-1] for key, v in metrics.items()}
                step += k
            else:
                batch = to_device(self.batch(step), self.device)
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
            if t.ckpt_dir and (step % t.ckpt_every == 0 or step >= t.steps):
                if pending_save is not None:
                    pending_save.join()
                # the state is on the host when save returns: the next
                # step's in-place update cannot reach the checkpoint
                whole = gather_params(state, self.state_specs, self.mesh) \
                    if self.split else state
                if not self.process or self.mesh.rank == 0:
                    pending_save = ckpt.save(t.ckpt_dir, step, whole,
                                             blocking=False)
                del whole
                if self.process:
                    self.mesh.barrier()
        if pending_save is not None:
            pending_save.join()
        if self.process and t.ckpt_dir:
            self.mesh.barrier()     # the last checkpoint is whole
        return step, state
