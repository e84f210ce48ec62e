"""Compute/communication overlap (vector chaining at mesh scale).

Ara's chaining overlaps a consumer FU with a producer at element
granularity (§III-E3). At mesh scale the analogue is overlapping collective
steps with partial compute: ring variants of all-gather/reduce-scatter
matmuls built from shard_map + ppermute, so each hop would hide behind one
shard's matmul.

The mesh is held as tensor dimensions on one device (``core/compat.py``):
the same ring order and the same schedule as the reference, each hop a
counted ``ppermute`` (a ``torch.roll`` of the stacks), the per-shard
products one batched ``torch.matmul`` over every device, with a float32
accumulator (narrow operands are widened first; float64 stays float64;
TF32 is off, PyTorch's default). One device runs the hops one after the
other: what this shows is the math and the counts, not an overlap.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import compat
from repro_torch.core.compat import PartitionSpec as PS


def _check_divisible(fn: str, what: str, dim: int, by: int, why: str):
    """Ring collectives move fixed-size shards: a ragged dimension would
    either crash deep inside the loop or silently drop the remainder rows
    (a floor-divided slice). Fail up front with the shapes in the message
    instead."""
    if by < 1 or dim % by:
        raise ValueError(
            f"{fn}: {what}={dim} is not divisible by {why}={by}; "
            f"ring steps move fixed-size shards, so ragged shapes "
            f"cannot be scattered exactly — pad {what} to a multiple "
            f"of {by}")


def _dot(a, b):
    """Each device's ``a @ b`` over the stacks, accumulated in fp32 (the
    reference's ``preferred_element_type=float32``). A ``b`` replicated
    over the mesh (a stride-0 stack) enters as its one copy, so the
    devices' products are one matmul."""
    lead = len(compat.stack_shape())
    if all(st == 0 for st, n in zip(b.stride()[:lead], b.shape[:lead])
           if n > 1):
        b = b[(0,) * lead]
    wide = torch.promote_types(a.dtype, torch.float32)
    return torch.matmul(a.to(wide), b.to(wide))


def _flat(x, lead):
    """The stacks with their mesh dimensions flattened into one."""
    return x.reshape((math.prod(lead),) + x.shape[len(lead):])


def all_gather_matmul(x, w, mesh, axis: str, group: int = 1):
    """y = all_gather(x, axis) @ w, overlapped.

    x: (m, k) sharded on ``axis`` along m; w: (k, n) replicated. Each step
    multiplies the shard(s) a device holds while ppermuting the next in.
    Returns (m, n). Requires ``m % n_dev == 0``.

    ``group`` is the ring's LMUL analogue (register grouping, §IV): the
    steady-state loop moves a ``group``-shard buffer per ppermute and runs
    one (group*m_local, k) matmul per hop — n_dev/group ppermutes instead
    of n_dev. A fill phase of ``group - 1`` single-shard hops plays the
    operand-queue warm-up: ``(group - 1) + n_dev/group`` ppermutes in all.
    Requires ``n_dev % group == 0``.
    """
    n_dev = mesh.shape[axis]
    _check_divisible("all_gather_matmul", "m", x.shape[0], n_dev,
                     f"mesh axis '{axis}' size")
    _check_divisible("all_gather_matmul", "n_dev", n_dev, group, "group")
    if x.shape[1] != w.shape[0]:
        raise ValueError(
            f"all_gather_matmul: contraction mismatch x{tuple(x.shape)} "
            f"@ w{tuple(w.shape)}")

    def device_fn(x_loc, w_loc):
        lead = compat.stack_shape()
        idx = compat.axis_index(axis).expand(lead).reshape(-1)
        rows = torch.arange(idx.numel(), device=idx.device)
        m_loc = x_loc.shape[-2]
        n_out = w_loc.shape[-1]
        out = x_loc.new_zeros((idx.numel(), n_dev, m_loc, n_out))
        perm1 = [(i, (i + 1) % n_dev) for i in range(n_dev)]

        # fill: assemble the group buffer [idx, idx-1, ..., idx-group+1]
        parts, cur = [x_loc], x_loc
        for _ in range(group - 1):
            cur = compat.ppermute(cur, axis, perm1)
            parts.append(cur)
        big = torch.cat(parts, dim=-2)

        perm_g = [(i, (i + group) % n_dev) for i in range(n_dev)]
        for s in range(n_dev // group):
            # one long chain per hop: (group*m_loc, k) @ (k, n)
            part = _flat(_dot(big, w_loc), lead)
            for j in range(group):
                src = (idx - s * group - j) % n_dev      # shard owner
                out[rows, src] = part[:, j * m_loc:(j + 1) * m_loc] \
                    .to(out.dtype)
            big = compat.ppermute(big, axis, perm_g)
        return out.reshape(lead + (n_dev * m_loc, n_out))

    return compat.shard_map(device_fn, mesh=mesh,
                            in_specs=(PS(axis, None), PS(None, None)),
                            out_specs=PS(None, None))(x, w)


def matmul_reduce_scatter(x, w, mesh, axis: str):
    """y = reduce_scatter(x @ w_sharded, axis), overlapped.

    x: (m, k) sharded on k; w: (k, n) sharded on k. The full (m, n)
    partial product never materializes per device: accumulate ring-style
    (``n_dev`` ppermutes), each device ends with its (m/n_dev, n) slice of
    the sum. Requires ``k % n_dev == 0`` (the shard split) and
    ``m % n_dev == 0`` (the scatter slices), both validated up front.
    """
    n_dev = mesh.shape[axis]
    _check_divisible("matmul_reduce_scatter", "k", x.shape[1], n_dev,
                     f"mesh axis '{axis}' size")
    _check_divisible("matmul_reduce_scatter", "m", x.shape[0], n_dev,
                     f"mesh axis '{axis}' size")
    if x.shape[1] != w.shape[0]:
        raise ValueError(
            f"matmul_reduce_scatter: contraction mismatch "
            f"x{tuple(x.shape)} @ w{tuple(w.shape)}")

    def device_fn(x_loc, w_loc):
        lead = compat.stack_shape()
        idx = compat.axis_index(axis).expand(lead).reshape(-1)
        rows = torch.arange(idx.numel(), device=idx.device)
        m = x_loc.shape[-2]
        m_loc = m // n_dev
        xs = _flat(x_loc, lead).reshape(idx.numel(), n_dev, m_loc, -1)
        perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
        wide = torch.promote_types(x_loc.dtype, torch.float32)
        acc = torch.zeros(lead + (m_loc, w_loc.shape[-1]), dtype=wide,
                          device=x_loc.device)
        for i in range(n_dev):
            # contribute the chunk that reaches its owner after the
            # remaining n-1-i hops: owner = idx + (n-1-i)
            chunk = (idx + n_dev - 1 - i) % n_dev
            part = _dot(xs[rows, chunk].reshape(lead + (m_loc, -1)), w_loc)
            acc = compat.ppermute(acc, axis, perm) + part
        return acc.to(x_loc.dtype)

    return compat.shard_map(device_fn, mesh=mesh,
                            in_specs=(PS(None, axis), PS(axis, None)),
                            out_specs=PS(axis, None))(x, w)
