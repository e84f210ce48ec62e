"""Pipeline parallelism over a mesh axis (GPipe schedule, shard_map).

Cross-pod staging: the ``pod`` axis carries only stage-boundary
activations (one ppermute per tick) instead of per-layer gradient traffic.

Mechanics, as in the reference: stage s of S holds a contiguous slice of
layers (stage-stacked params sharded on the axis). Microbatches m=0..M-1
enter stage 0 on ticks t=m; stage s computes microbatch t-s on tick t;
outputs leave stage S-1 on ticks t>=S-1; M+S-1 ticks with one ring
ppermute each, then one psum of the last stage's outputs. Autograd through
it gives the mirrored backward schedule.

The mesh is held as tensor dimensions on one device (``core/compat.py``).
A stage function may launch kernels (the attention kernels are called
through ``ctypes``), so the body loops over the devices on each tick and
stacks their outputs; the ring is a ``torch.roll`` of that stack. One
difference of schedule, which changes no output and no gradient: the
reference computes every stage on every tick and masks the inactive ones'
outputs to zeros; here an inactive stage is skipped and yields the zeros
directly. ``stage_fn`` therefore runs M·S times a call (not (M+S-1)·S), and
a stage of L attention layers launches the forward attention kernel M·L
times a call per stage (and each backward kernel as often under autograd).

Bubble fraction = (S-1)/(M+S-1), the classic GPipe overhead; reported by
``bubble_fraction``.
"""
from __future__ import annotations

import itertools
from typing import Callable

import torch

from repro_torch.core import compat
from repro_torch.core.compat import PartitionSpec as PS
from repro_torch.models.layers import tree_map


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def pipeline_apply(stage_fn: Callable, stage_params, x_micro, mesh,
                   axis: str):
    """Run microbatches through a stage pipeline.

    stage_fn(params_one_stage, x) -> y     (same shape as x)
    stage_params: tree, every leaf with leading dim == n_stages
                  (sharded over ``axis``)
    x_micro: (M, mb, ...) microbatched inputs (replicated over ``axis``)
    Returns (M, mb, ...) outputs of the last stage (replicated).
    """
    n_stages = mesh.shape[axis]
    m_micro = x_micro.shape[0]
    n_ticks = m_micro + n_stages - 1
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]

    def device_fn(params_local, x_all):
        lead = compat.stack_shape()
        stage_st = compat.axis_index(axis)
        stage = stage_st.expand(lead).reshape(-1).tolist()
        devs = list(itertools.product(*map(range, lead)))  # row-major
        # each device's stage slice: its leaves' local dim 0 has size 1
        params_me = [tree_map(lambda a, dv=dv: a[dv][0], params_local)
                     for dv in devs]
        mb_shape = x_all.shape[len(lead) + 1:]
        zeros = x_all.new_zeros(mb_shape)

        recv, outs = None, []
        for t in range(n_ticks):
            ys = []
            for i, dv in enumerate(devs):
                s = stage[i]
                if not (s <= t < s + m_micro):    # inactive: zeros
                    ys.append(zeros)
                    continue
                # stage 0 injects microbatch t; the others take the ring's
                x_in = x_all[dv][t] if s == 0 else recv[dv]
                ys.append(stage_fn(params_me[i], x_in))
            y = torch.stack(ys).reshape(lead + mb_shape)
            # collect finished microbatch t-(S-1) (kept from the last
            # stage below)
            if t >= n_stages - 1:
                outs.append(y)
            recv = compat.ppermute(y, axis, perm)
        outs = torch.stack(outs, dim=len(lead))
        # only the last stage holds real outputs; broadcast via psum
        last = (stage_st == n_stages - 1).reshape(
            stage_st.shape + (1,) * (outs.dim() - len(lead)))
        outs = torch.where(last, outs, torch.zeros_like(outs))
        return compat.psum(outs, axis)

    in_specs = (tree_map(lambda _: PS(axis), stage_params), PS())
    return compat.shard_map(device_fn, mesh=mesh, in_specs=in_specs,
                            out_specs=PS())(
        stage_params, x_micro)


def pipeline_loss(stage_fn, loss_fn, stage_params, x_micro, y_micro, mesh,
                  axis: str):
    """Mean loss over microbatches through the pipeline (differentiable:
    autograd produces the mirrored backward schedule)."""
    outs = pipeline_apply(stage_fn, stage_params, x_micro, mesh, axis)
    return loss_fn(outs, y_micro)
