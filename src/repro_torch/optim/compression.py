"""int8 error-feedback gradient compression for the DP all-reduce.

The reference's two-phase compressed all-reduce, all int8 on the wire:

  1. shared scale  s  = pmax(|g + residual|) / 127
  2. quantize      q  = round((g + residual)/s) : int8 ; residual update
  3. reduce-scatter: all_to_all the int8 shards, accumulate int32 locally
  4. re-quantize the local partial sum (per-device scale s2)
  5. all-gather    int8 chunks + f32 scales; dequantize, divide by n

Wire bytes = 2x int8 passes ~= g.nbytes/2 vs 2x f32 for a ring all-reduce:
``core.compat.BYTES`` counts both kinds of traffic. Error feedback carries
the step-2 quantization residual into the next step. ``torch.round`` rounds
half to even, as ``jnp.round`` does, so ``q`` is the reference's bit for
bit.

Call ``compressed_psum`` inside ``core.compat.shard_map``'s body, with
grads sharded on ``axis``: its tensors are the mesh's stacks (every device
at once, the mesh axes leading).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import compat
from repro_torch.models.layers import tree_map


def _quantize(x, s):
    """round(x / s) clipped to [-127, 127], as int8."""
    return torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)


def _compressed_allreduce_mean(g, axis: str, n: int):
    """g: the stacks of each device's fp32 tensor (same local shape on
    every device). Returns (mean over the axis, residual), computed via an
    int8 all_to_all and an int8 all_gather."""
    lead = compat.stack_shape()
    nl = len(lead)
    flat = g.reshape(lead + (-1,))
    pad = (-flat.shape[-1]) % n
    if pad:
        flat = F.pad(flat, (0, pad))
    k = flat.shape[-1] // n

    # phase 1: shared scale, int8 quantize
    s = compat.pmax(flat.abs().amax(dim=-1), axis) / 127.0
    s = s.clamp_min(1e-12)[..., None]
    q = _quantize(flat, s)
    residual = flat - q.to(torch.float32) * s

    # phase 2: reduce-scatter via int8 all_to_all, int32 local accumulation
    shards = q.reshape(lead + (n, k))
    recv = compat.all_to_all(shards, axis, 0, 0, tiled=False)  # (n, k) int8
    partial = recv.to(torch.int32).sum(dim=nl, dtype=torch.int32)  # (k,)
    partial_f = partial.to(torch.float32) * s

    # phase 3: re-quantize the partial sum, all-gather int8 + scales
    s2 = (partial_f.abs().amax(dim=-1) / 127.0).clamp_min(1e-12)
    q2 = _quantize(partial_f, s2[..., None])
    gq = compat.all_gather(q2, axis)                            # (n, k) int8
    gs = compat.all_gather(s2, axis)                            # (n,) f32
    full = (gq.to(torch.float32) * gs[..., None]).reshape(lead + (-1,))
    orig = flat.shape[-1] - pad
    return ((full[..., :orig] / n).reshape(g.shape),
            residual[..., :orig].reshape(g.shape))


def compressed_psum(grads, residuals, mesh, axes):
    """grads/residuals: trees (dicts, tuples or lists) of the stacks of
    each device's fp32 grads (replicated layout over ``axes``). Returns
    (mean_grads, new_residuals) of the same structure. Use inside
    shard_map."""
    axis = axes[0] if len(axes) == 1 else axes
    if isinstance(axis, (tuple, list)):
        raise NotImplementedError("compress over one axis; fold axes first")
    n = mesh.shape[axis]

    def one(g, r):
        return _compressed_allreduce_mean(g + r, axis, n)

    if isinstance(grads, (tuple, list)):
        outs = [one(g, r) for g, r in zip(grads, residuals)]
        return (type(grads)(o[0] for o in outs),
                type(grads)(o[1] for o in outs))
    pairs = tree_map(one, grads, residuals)
    return (tree_map(lambda o: o[0], pairs), tree_map(lambda o: o[1], pairs))


def init_residuals(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
