"""AdamW with warmup+cosine schedule, global-norm clipping, and
precision-configurable moments (bf16 moments for the 671B config).

Functional API over dict-of-tensors trees, as the reference's: the
optimizer state mirrors the parameter tree. Same fp32 math, the same
``p.ndim >= 2`` weight-decay rule and ``moment_dtype``. One difference of
form: :func:`update` writes the new parameters and moments **in place**
(under ``torch.no_grad()``) and returns the same tensors — at full width a
second copy of parameters and moments would cost several GB.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.precision import torch_dtype
from repro_torch.models.layers import tree_leaves, tree_map, widen


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"


def schedule(cfg: OptConfig, step):
    """Learning rate at ``step`` (an int or an integer tensor), as a
    float32 tensor: linear warmup, then cosine decay to
    ``min_lr_ratio * peak_lr``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 \
        * (1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def init(cfg: OptConfig, params) -> dict:
    """Zero moments of ``moment_dtype`` beside each parameter, on its
    device, and an int32 step counter."""
    dt = torch_dtype(cfg.moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    dev = next(tree_leaves(params)).device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in fp32 (float64 for a
    float64 tree)."""
    return torch.sqrt(sum(torch.sum(torch.square(widen(x)))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def update(cfg: OptConfig, grads, opt_state, params):
    """Returns (new_params, new_opt_state, metrics). The parameter and
    moment tensors are updated in place and are the ones returned; the
    step counter is a new tensor."""
    step = opt_state["step"] + 1
    lr = schedule(cfg, step).to(step.device)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step_f = step.to(torch.float32)
    bc1 = 1 - cfg.b1 ** step_f
    bc2 = 1 - cfg.b2 ** step_f

    def upd(p, g, m, v):
        g = widen(g) * scale
        m32 = cfg.b1 * widen(m) + (1 - cfg.b1) * g
        v32 = cfg.b2 * widen(v) + (1 - cfg.b2) * torch.square(g)
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if p.dim() >= 2:  # no weight decay on norms/biases/scalars
            delta = delta + cfg.weight_decay * widen(p)
        p.copy_(widen(p) - lr * delta)
        m.copy_(m32)
        v.copy_(v32)
        return p

    new_params = tree_map(upd, params, grads, opt_state["m"],
                          opt_state["v"])
    new_state = {"m": opt_state["m"], "v": opt_state["v"], "step": step}
    return new_params, new_state, {"lr": lr, "grad_norm": gnorm}
