"""The reference's ``shard_map``, on one device as tensor dimensions or on
one process a device.

The reference's file is a JAX version shim around ``jax.shard_map``. Here
the same call takes one of two routes, chosen by the mesh it is given:

**The stacked route** (a ``core.staging.Mesh``: named axes and sizes, no
devices). One device holds the whole mesh as leading dimensions of every
tensor the body sees, in the mesh's axis order: for a mesh ``("data",
"model")`` of sizes (2, 4), device ``(d, m)``'s shard of ``x`` is
``stack[d, m]``.

- :func:`shard_map` splits each input by its :class:`PartitionSpec` into
  those dimensions, as views (a dimension sharded over an axis is reshaped
  so that shard ``i`` is the ``i``-th contiguous block, the first axis of a
  tuple entry the major one, as in the reference; an axis that the spec
  does not name is a stride-0 ``expand``, so a replicated input is held
  once). It calls the body **once** on the stacks and reassembles the
  outputs by ``out_specs``; an output replicated over an axis is read from
  that axis's device 0.
- Inside the body, the collectives below act on the stacks:
  :func:`ppermute` over a ring is ``torch.roll`` along the axis's
  dimension, :func:`psum` / :func:`pmean` / :func:`pmax` a
  reduction over it broadcast back, :func:`all_to_all` swaps the axis's
  dimension with the split dimension, :func:`all_gather` is a view, and
  :func:`axis_index` an ``arange`` over the dimension. Outside a
  ``shard_map`` they raise.

**The process route** (a :class:`ProcessMesh`, built by
``launch.mesh.make_process_mesh``: one process a device, on
``torch.distributed``, gloo on the CPU and NCCL on the card). Every stack
keeps its contract with each mesh axis at local extent 1
(:func:`stack_shape` is ``(1,) * len(axes)``), so a body written on the
stacks runs unchanged; an axis's size is ``mesh.shape[axis]``. The
collectives are the process group's: ``all_reduce`` over the axes' group
(SUM, then divided by n for :func:`pmean`; MAX), ``all_to_all_single``,
``all_gather`` into a new local dimension of size n, and
``batch_isend_irecv`` around the ring. :func:`shard_map` keeps the
reference's contract, global tensors in and out: it takes the rank's
block of each input and all-gathers the output blocks over the axes that
``out_specs`` names (an axis it does not name keeps the rank's own
value). Through autograd, a global input's gradient is assembled the
same way (the blocks' gradients all-gathered over the axes its spec
names, summed over those it replicates) and a global output's cotangent
is sliced to the rank's block, kept on the axes' device 0 where the spec
replicates it, as the stacked route's read from device 0 does. These
gathers of the global tensors are not counted: the stacked route holds
those tensors whole. **Local axes.** A mesh may declare axes local
(``ProcessMesh.with_local``; the trainer declares its batch axes): outside
a body a tensor on a rank is already its own block along them, so
:func:`shard_map` neither cuts nor gathers along them, forward or
backward. **Held inputs.** An in_spec of the class :class:`Held` says
the same for one input along the axes it names: on a process mesh the
rank passes its own block along them (a tensor-parallel rank's block of
an expert table), which is neither cut nor gathered there, and whose
gradient is the block's own (not summed over those axes, as a replicated
input's would be); on the stacked route the caller passes the whole
tensor and the spec cuts it as a :class:`PartitionSpec` would, so both
routes compute the same thing. Outside a body, :func:`pmean_in_place`
averages tensors over
axes in place (the data-parallel step's gradient mean), and Megatron's
two operators split a product over the ``model`` axis (the
tensor-parallel step): :func:`copy_to` (identity forward, the cotangent
all-reduced backward) at the input of a product split by columns,
:func:`reduce_from` (all-reduce forward, identity backward) after one
split by rows; :func:`reduce_over` and :func:`gather_over` all-reduce and
all-gather a tensor outside autograd (the vocab-parallel cross-entropy's
terms, the serve steps' logits), :func:`gather_from` is FSDP's
gather of a parameter's blocks (an all-gather forward, a reduce-scatter
of the cotangent backward), :func:`gather_blocks` gathers each
rank's rows of a small tensor (the MoE dispatch's per-expert counts),
:func:`all_to_all_over` re-lays a tensor's blocks from one dimension to
another (an expert table's FFN block as its block of experts), and
:func:`scatter_over` reduce-scatters the ranks' partial sums by blocks
(an mLSTM block's q, k and v by heads; an all-gather backward).
On the stacked route, whose one device holds what every rank holds,
:func:`copy_to`, :func:`reduce_from`, :func:`gather_from` (one axis),
:func:`scatter_over` and :func:`gather_blocks` move nothing and count
what the ranks would move; under a count of the step
(``core.step_analysis``), an input that a body's in_spec splits over
``model`` along another dimension than the parameter's own spec splits
it is re-laid by a counted all-to-all, forward and backward, as a
partitioner reshards it (``step_analysis.relaid_bytes``).

**Counts.** Each collective adds one to ``CALLS[kind]`` and, to
``BYTES[kind]``, the bytes that a real mesh moves over its links for that
call: on the stacked route summed over the devices, on a process the
rank's own share by the same formula (a ring all-reduce for the three
reductions: each device sends ``2 (n-1)/n`` of its buffer; an all-to-all
``(n-1)/n``; an all-gather ``n-1`` buffers; a ring permutation one
buffer). ``read_counts(reduce=True)`` sums the processes' bytes, which
then equal the stacked route's for the same body, kind by kind.
``CALLS["shard_map"]`` counts the bodies run.

Each collective is a ``torch.autograd.Function`` whose backward is the
collective that a real mesh runs for it, counted under the forward's kind
in ``CALLS_BWD`` / ``BYTES_BWD``: ``all_gather``'s is a reduce-scatter (as
many bytes), ``all_to_all``'s the inverse ``all_to_all`` and
``ppermute``'s the inverse permutation (as many bytes each); the three
reductions' is an all-reduce of the cotangent (as many bytes; ``pmax``
twice as many: it all-reduces the tie mask beside the cotangent to split
it among ties). On the stacked route the backward's arithmetic is the one
autograd took through the stacked operations before, bit for bit.

A count of the step (``core.step_analysis.analyze``) receives each
collective, forward and backward, from :func:`_count` and the backward
(``step_analysis.collective``). A collective's own operations on the
stacks run under ``step_analysis.uncounted``, so it is taken as a
collective, not as memory traffic, and a body runs under
``step_analysis.explicit``: its collectives are explicit, and the count
derives none of its own there.

A body written per device cannot be ``torch.func.vmap``-ed: the attention
kernels are called through ``ctypes``. So a body that launches a kernel
loops over the device dimensions (``train/pipeline.py``), and one that does
not is written on the stacks (``core/chaining.py``, ``optim/compression.py``,
``models/moe.py``'s expert-parallel route, MLA's lane-local route).
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core import step_analysis
from repro_torch.core.partition import PartitionSpec, entry_axes

CALLS: collections.Counter = collections.Counter()
BYTES: collections.Counter = collections.Counter()
CALLS_BWD: collections.Counter = collections.Counter()
BYTES_BWD: collections.Counter = collections.Counter()


def reset_counts():
    for counter in (CALLS, BYTES, CALLS_BWD, BYTES_BWD):
        counter.clear()


def read_counts(reduce: bool = False, backward: bool = False) -> dict:
    """``{kind: {"calls": n, "bytes": b}}`` of the collectives so far (their
    backward's with ``backward``). With ``reduce``, on processes: the calls
    every rank made (the same on each; a rank that differs raises) and the
    bytes summed over the ranks."""
    calls, nbytes = (CALLS_BWD, BYTES_BWD) if backward else (CALLS, BYTES)
    mine = {k: {"calls": calls[k], "bytes": nbytes[k]} for k in sorted(calls)}
    if not reduce:
        return mine
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    calls_of = [{k: v["calls"] for k, v in c.items()} for c in every]
    if any(c != calls_of[0] for c in calls_of):
        raise RuntimeError(f"the ranks ran different collectives: {calls_of}")
    return {k: {"calls": v["calls"],
                "bytes": sum(c[k]["bytes"] for c in every)}
            for k, v in mine.items()}


# ---------------------------------------------------------------------------
# the process mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """A mesh of processes, one device each (``launch.mesh.
    make_process_mesh`` builds it): the axes and sizes that
    ``core.staging.Mesh`` answers, the rank's global rank and device, the
    rank's process group over each non-empty set of axes, and the axes
    declared local (see the module's docstring). Ranks are laid out
    row-major over the axes, as the reference's ``make_mesh`` lays out
    devices."""
    axis_names: tuple
    sizes: tuple
    rank: int
    device: torch.device
    # frozenset of axes -> (the group over them holding this rank, or None
    # for a group of one; the group's global ranks in their axes' row-major
    # order, which is the group's own rank order)
    groups: dict = dataclasses.field(repr=False, compare=False)
    local: tuple = ()

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    def coords_of(self, rank: int) -> tuple:
        """A global rank's coordinates, row-major over the axes."""
        out = []
        for n in reversed(self.sizes):
            rank, c = divmod(rank, n)
            out.append(c)
        return tuple(reversed(out))

    def coord(self, axis: str) -> int:
        return self.coords_of(self.rank)[self.axis_names.index(axis)]

    def block(self, axes, rank: Optional[int] = None) -> int:
        """Which block a rank (this one by default) holds of a dimension
        cut over ``axes``, the first axis the major one."""
        coords = self.coords_of(self.rank if rank is None else rank)
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + coords[self.axis_names.index(a)]
        return idx

    def group(self, axes) -> tuple:
        """(group, ranks) over ``axes`` (a name or a tuple of names)."""
        return self.groups[frozenset(entry_axes(axes))]

    def barrier(self):
        """Wait for every rank (on NCCL, the rank's own card)."""
        if self.device.type == "cuda" and dist.get_backend() == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def with_local(self, axes) -> "ProcessMesh":
        """The same mesh with ``axes`` declared local."""
        axes = tuple(entry_axes(tuple(axes)))
        unknown = [a for a in axes if a not in self.axis_names]
        if unknown:
            raise ValueError(f"local axes {unknown} are not in the mesh's "
                             f"{self.axis_names}")
        return dataclasses.replace(self, local=axes)


def is_process_mesh(mesh) -> bool:
    return isinstance(mesh, ProcessMesh)


# ---------------------------------------------------------------------------
# the axis context of a running body
# ---------------------------------------------------------------------------


class _Axes:
    def __init__(self, mesh, device):
        self.names = tuple(mesh.axis_names)
        self.sizes = tuple(int(n) for n in mesh.sizes)
        self.device = device
        self.proc = mesh if is_process_mesh(mesh) else None
        # the stacks' leading dimensions, and the devices a count covers
        self.stack = (1,) * len(self.names) if self.proc else self.sizes
        self.counted = 1 if self.proc else self.n_dev
        self.chain = None

    @property
    def n_dev(self) -> int:
        return math.prod(self.sizes)

    def dims(self, axes) -> tuple:
        axes = entry_axes(axes)
        missing = [a for a in axes if a not in self.names]
        if missing:
            raise ValueError(f"axes {missing} are not in the mesh's "
                             f"{self.names}")
        return tuple(self.names.index(a) for a in axes)

    def local_bytes(self, x) -> int:
        return x[(0,) * len(self.names)].numel() * x.element_size()


_ACTIVE: list = []


def _axes() -> _Axes:
    if not _ACTIVE:
        raise RuntimeError("a collective runs only inside shard_map's body")
    return _ACTIVE[-1]


def stack_shape() -> tuple:
    """The leading dimensions of every stack in the running body: the mesh
    axes' sizes, in mesh order (each 1 on a process)."""
    return _axes().stack


def stack_devices() -> list:
    """The row-major indices over the mesh's axes of the devices whose
    stacks the running body holds: every device on the stacked route (in
    the order of the stacks' leading dimensions, flattened), the rank's
    own on a process."""
    ax = _axes()
    if ax.proc:
        return [ax.proc.block(ax.names)]
    return list(range(ax.n_dev))


def _count(kind: str, nbytes: float):
    CALLS[kind] += 1
    BYTES[kind] += int(round(nbytes))
    step_analysis.collective(kind, nbytes)


class _Collective(torch.autograd.Function):
    """One collective on the stacks: ``fwd(x)`` forward, ``bwd(g)``
    backward (``bwd(g, x, y)`` with ``save``: the input and the output),
    each counted, the backward under the forward's kind."""

    @staticmethod
    def forward(ctx, x, kind, nbytes, nbytes_bwd, fwd, bwd, save):
        _count(kind, nbytes)
        ctx.kind, ctx.nbytes_bwd, ctx.bwd = kind, nbytes_bwd, bwd
        with step_analysis.uncounted():
            y = fwd(x)
        if save:
            ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        _count_backward(ctx.kind, ctx.nbytes_bwd)
        with step_analysis.uncounted():
            dx = ctx.bwd(g, *ctx.saved_tensors)
        return dx, None, None, None, None, None, None


def _count_backward(kind, nbytes):
    CALLS_BWD[kind] += 1
    BYTES_BWD[kind] += int(round(nbytes))
    step_analysis.collective(kind, nbytes, backward=True)


def _token_like(token):
    return None if token is None else torch.zeros((), device=token.device)


class _ProcCollective(torch.autograd.Function):
    """One collective on a process, as :class:`_Collective`, threaded on the
    body's chain (see :class:`_Chain`): ``(x, token) -> (y, token')``. The
    backward runs on every rank, after the collectives that came later;
    it first asks the mesh's ranks whether any holds a cotangent for its
    output (a one-element all-reduce): if none does, as where the stacked
    route's output was never read, it moves and counts nothing."""

    @staticmethod
    def forward(ctx, x, token, kind, nbytes, nbytes_bwd, fwd, bwd, save,
                mesh):
        ctx.set_materialize_grads(False)
        _count(kind, nbytes)
        y = fwd(x)
        ctx.kind, ctx.nbytes_bwd, ctx.bwd, ctx.mesh = kind, nbytes_bwd, bwd, \
            mesh
        ctx.y = (y.shape, y.dtype, y.device)
        if save:
            ctx.save_for_backward(x, y)
        return y, _token_like(token)

    @staticmethod
    def backward(ctx, g, _):
        shape, dtype, device = ctx.y
        dx = None
        if dtype.is_floating_point and _any_rank(ctx.mesh, g is not None,
                                                 device):
            _count_backward(ctx.kind, ctx.nbytes_bwd)
            if g is None:
                g = torch.zeros(shape, dtype=dtype, device=device)
            dx = ctx.bwd(g, *ctx.saved_tensors)
        tok = torch.zeros((), device=device) \
            if ctx.needs_input_grad[1] else None
        return dx, tok, None, None, None, None, None, None, None


def _any_rank(mesh, flag: bool, device) -> bool:
    """Whether ``flag`` holds on any rank of the mesh."""
    t = torch.tensor([float(flag)], device=device)
    return bool(_all_reduce(t, mesh.group(mesh.axis_names)[0], "MAX")[0])


def _apply(ax, x, kind, nbytes, nbytes_bwd, fwd, bwd, save=False):
    """The collective on the stacks or, threaded on the body's chain, on a
    process."""
    if ax.proc is None:
        return _Collective.apply(x, kind, nbytes, nbytes_bwd, fwd, bwd, save)
    y, ax.chain.token = _ProcCollective.apply(
        x, ax.chain.token, kind, nbytes, nbytes_bwd, fwd, bwd, save, ax.proc)
    return y


# -- the process group's operations -----------------------------------------


def _all_reduce(x, group, op: str):
    """A new tensor: ``x`` all-reduced over ``group`` (None: one rank)."""
    y = x.contiguous().clone()
    if group is not None:
        dist.all_reduce(y, op=getattr(dist.ReduceOp, op), group=group)
    return y


def _all_to_all(x, group, n: int):
    """Chunk ``j`` of ``x``'s dimension 0 to the group's rank ``j``, where
    it lands as chunk ``i`` of the sender ``i``."""
    if group is None:
        return x.clone()
    src = x.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out


def _all_gather(x, group, n: int):
    """The group's buffers stacked along a new dimension 0."""
    if group is None:
        return x.unsqueeze(0).clone()
    return torch.stack(_gather_parts(x, group, n))


def _gather_parts(x, group, n: int) -> list:
    """The group's buffers, in its rank order."""
    src = x.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return parts


def _reduce_scatter(g, group, n: int):
    """Chunk ``j`` of ``g``'s dimension 0 (of size ``n``) to the group's
    rank ``j``, the chunks received summed in rank order: a reduce-scatter
    by the all-to-all."""
    return _all_to_all(g, group, n).sum(dim=0)


def _exchange(x, to: int, frm: int, group):
    """Send ``x`` to global rank ``to`` and receive a buffer like it from
    ``frm``."""
    if group is None or to == dist.get_rank():
        return x.clone()
    send = x.contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, to, group),
           dist.P2POp(dist.irecv, recv, frm, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


# -- the collectives ----------------------------------------------------------


def axis_index(axis: str) -> torch.Tensor:
    """Each device's index along ``axis``: an int64 ``arange`` shaped to
    broadcast against the stacks' leading dimensions (on a process, the
    rank's coordinate, shaped ``(1,) * len(axes)``)."""
    ax = _axes()
    (d,) = ax.dims(axis)
    if ax.proc:
        return torch.full(ax.stack, ax.proc.coord(axis), dtype=torch.int64,
                          device=ax.device)
    shape = [1] * len(ax.sizes)
    shape[d] = ax.sizes[d]
    return torch.arange(ax.sizes[d], device=ax.device).reshape(shape)


def ppermute(x, axis: str, perm):
    """Device ``dst`` receives ``src``'s buffer for each ``(src, dst)`` in
    ``perm``, which must be a ring: every device sends to the one ``k``
    places on (the only form the reference's callers use), a
    ``torch.roll`` along the axis's dimension (on processes, a send to the
    rank ``k`` places on and a receive from the one ``k`` places back)."""
    ax = _axes()
    (d,) = ax.dims(axis)
    n = ax.sizes[d]
    shifts = {(int(t) - int(s)) % n for s, t in perm}
    if sorted(int(s) % n for s, _ in perm) != list(range(n)) \
            or len(shifts) != 1:
        raise ValueError(f"ppermute over '{axis}': {perm} is not a ring "
                         f"of its {n} devices")
    shift = shifts.pop()
    nbytes = ax.local_bytes(x) * ax.counted * (shift != 0)
    if ax.proc:
        group, ranks = ax.proc.group(axis)
        me = ax.proc.coord(axis)
        on, back = ranks[(me + shift) % n], ranks[(me - shift) % n]
        fwd = lambda x: _exchange(x, on, back, group)
        bwd = lambda g: _exchange(g, back, on, group)
    else:
        fwd = lambda x: torch.roll(x, shifts=shift, dims=d)
        bwd = lambda g: torch.roll(g, shifts=-shift, dims=d)
    return _apply(ax, x, "ppermute", nbytes, nbytes, fwd, bwd)


def _reduce(kind: str, x, axes, op, grad, op_proc, grad_proc):
    ax = _axes()
    dims = ax.dims(axes)
    n = math.prod(ax.sizes[d] for d in dims)
    nbytes = 2 * (n - 1) / n * ax.local_bytes(x) * ax.counted
    # the backward all-reduces the cotangent (pmax's with its tie mask)
    nbytes_bwd = nbytes * (2 if kind == "pmax" else 1)
    shape = x.shape
    if ax.proc:
        group = ax.proc.group(axes)[0]
        return _apply(ax, x, kind, nbytes, nbytes_bwd,
                      lambda x: op_proc(x, group, n),
                      lambda g, *xy: grad_proc(g, group, n, *xy),
                      kind == "pmax")
    return _apply(ax, x, kind, nbytes, nbytes_bwd,
                  lambda x: op(x, dims).expand(shape),
                  lambda g, *xy: grad(g, dims, n, shape, *xy),
                  kind == "pmax")


def _sum_back(g, dims):
    # the backward of ``.expand`` that autograd takes: a sum over the
    # expanded dimensions
    return g.sum(dim=dims, keepdim=True)


def psum(x, axes):
    """The sum over ``axes`` (a name or a tuple), on every device."""
    return _reduce("psum", x, axes,
                   # in x's dtype, as the reference's (torch widens integers)
                   lambda x, dims: x.sum(dim=dims, keepdim=True,
                                         dtype=x.dtype),
                   lambda g, dims, n, shape: _sum_back(g, dims).expand(shape),
                   lambda x, group, n: _all_reduce(x, group, "SUM"),
                   lambda g, group, n: _all_reduce(g, group, "SUM"))


def pmean(x, axes):
    return _reduce("pmean", x, axes,
                   lambda x, dims: x.mean(dim=dims, keepdim=True),
                   lambda g, dims, n, shape:
                   _sum_back(g, dims).expand(shape) / n,
                   lambda x, group, n: _all_reduce(x, group, "SUM").div_(n),
                   lambda g, group, n: _all_reduce(g, group, "SUM").div_(n))


def pmax(x, axes):
    return _reduce("pmax", x, axes,
                   lambda x, dims: x.amax(dim=dims, keepdim=True),
                   lambda g, dims, n, shape, x, y: _max_back(g, dims, x, y),
                   lambda x, group, n: _all_reduce(x, group, "MAX"),
                   lambda g, group, n, x, y: _max_back_proc(g, group, x, y))


def pmean_in_place(tensors, mesh: ProcessMesh, axes):
    """Outside a body, on a process mesh: each tensor replaced in place by
    its mean over ``axes``, one all-reduce (SUM, then divided by n, as
    :func:`pmean`) a tensor, counted as :func:`pmean` counts a call on a
    process; a group of one moves and divides nothing. Not
    differentiable: the data-parallel step's gradient mean."""
    group, ranks = mesh.group(axes)
    n = len(ranks)
    for t in tensors:
        _count("pmean", 2 * (n - 1) / n * t.numel() * t.element_size())
        if group is not None:
            buf = t if t.is_contiguous() else t.contiguous()
            dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
            buf.div_(n)
            if buf is not t:
                t.copy_(buf)


# -- Megatron's operators and the reductions around them, outside a body ----


def _ring(mesh, axes):
    """(group, size) of the rank's group over ``axes``."""
    group, ranks = mesh.group(axes)
    return group, len(ranks)


class _CopyTo(torch.autograd.Function):
    """Identity forward; the cotangent all-reduced (SUM) backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.ring = _ring(mesh, axis)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        group, n = ctx.ring
        _count_backward("psum", 2 * (n - 1) / n * g.numel()
                        * g.element_size())
        return _all_reduce(g, group, "SUM"), None, None


class _ReduceFrom(torch.autograd.Function):
    """All-reduce (SUM) forward; the cotangent as it is backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return reduce_over(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Counted(torch.autograd.Function):
    """The stacked route's Megatron operators and the re-lays of a block
    split over ``model`` (:func:`copy_to`, :func:`reduce_from`,
    :func:`gather_from`, :func:`scatter_over`): the identity both ways
    (one device holds the whole tensor that the ranks hold blocks or
    partial sums of), the collective of ``kind`` counted with ``nbytes``
    in the forward and ``nbytes_bwd`` in the backward (0: none there), as
    a process mesh's ranks run it."""

    @staticmethod
    def forward(ctx, x, kind, nbytes, nbytes_bwd):
        if nbytes:
            _count(kind, nbytes)
        ctx.kind, ctx.nbytes = kind, nbytes_bwd
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.nbytes:
            _count_backward(ctx.kind, ctx.nbytes)
        return g, None, None, None


def _counted(x, mesh, axis, kind, per_rank, fwd=True, bwd=True):
    """:class:`_Counted` on a stacked mesh: every device moves
    ``per_rank(n)`` bytes over ``axis`` of size n (summed over the
    devices), in the forward and (or) the backward; nothing for an axis of
    one."""
    n = mesh.shape[axis]
    if n == 1:
        return x
    nbytes = math.prod(mesh.sizes) * per_rank(n)
    return _Counted.apply(x, kind, nbytes if fwd else 0,
                          nbytes if bwd else 0)


def _ring_share(x, share):
    """A ring all-reduce's bytes a rank, of ``share`` of ``x``."""
    return lambda n: 2 * (n - 1) / n * share * x.numel() * x.element_size()


def copy_to(x, mesh, axis: str = "model", share: float = 1.0):
    """Outside a body, on a process mesh: Megatron's ``f`` at the input of
    a product split by columns over ``axis``. The identity forward; its
    backward all-reduces the cotangent (each rank's holds the part of its
    own columns), counted as :func:`psum`'s backward counts. A group of one
    is the identity both ways and counts nothing. On a stacked mesh (a
    step whose count, ``core.step_analysis``, stands for the ranks'): the
    identity both ways, the backward's all-reduce counted as the ranks run
    it, each rank holding ``share`` of ``x``."""
    if not is_process_mesh(mesh):
        return _counted(x, mesh, axis, "psum", _ring_share(x, share),
                        fwd=False)
    if _ring(mesh, axis)[1] == 1:
        return x
    return _CopyTo.apply(x, mesh, axis)


def reduce_from(x, mesh, axis: str = "model", share: float = 1.0):
    """Outside a body, on a process mesh: Megatron's ``g`` after a product
    split by rows over ``axis`` (each rank holds a partial sum). The
    all-reduce forward, counted as :func:`psum` counts a call on a process;
    the identity backward (the cotangent is replicated). A group of one is
    the identity both ways and counts nothing. On a stacked mesh: the
    identity both ways, the forward's all-reduce counted as the ranks run
    it, each rank holding ``share`` of ``x``."""
    if not is_process_mesh(mesh):
        return _counted(x, mesh, axis, "psum", _ring_share(x, share),
                        bwd=False)
    if _ring(mesh, axis)[1] == 1:
        return x
    return _ReduceFrom.apply(x, mesh, axis)


def reduce_over(x, mesh: ProcessMesh, axes, op: str = "SUM"):
    """Outside a body, on a process mesh: a new tensor, ``x`` all-reduced
    over ``axes`` (``op`` SUM or MAX), counted as :func:`psum` or
    :func:`pmax` counts a call on a process. Not differentiable. A group
    of one returns ``x`` and counts nothing."""
    group, n = _ring(mesh, axes)
    if n == 1:
        return x
    _count("psum" if op == "SUM" else "pmax",
           2 * (n - 1) / n * x.numel() * x.element_size())
    return _all_reduce(x, group, op)


def gather_over(x, mesh: ProcessMesh, axis: str, dim: int = -1):
    """Outside a body, on a process mesh: the group's blocks of ``x``
    concatenated along ``dim`` in their coordinate order along ``axis``,
    counted as :func:`all_gather` counts a call on a process. Not
    differentiable. A group of one returns ``x`` and counts nothing."""
    group, n = _ring(mesh, axis)
    if n == 1:
        return x
    _count("all_gather", (n - 1) * x.numel() * x.element_size())
    return torch.cat(_gather_parts(x, group, n), dim=dim)


def gather_blocks(x, mesh, axes):
    """Outside a body: every block's rows of ``x`` over ``axes`` (a tuple
    of the mesh's axes, the first the major one), concatenated along
    dimension 0 in block order, on every rank; not differentiable. On a
    process mesh ``x`` holds the rank's own rows (:func:`gather_over`: one
    counted all-gather; a group of one moves and counts nothing). On a
    stacked mesh the caller holds every block, so ``x`` already holds
    every block's rows: it is returned as it is, and the all-gather that
    the ranks of a process mesh run for it is counted, summed over the
    devices (each device moves ``n - 1`` of the blocks)."""
    if is_process_mesh(mesh):
        return gather_over(x, mesh, axes, dim=0)
    n = math.prod(mesh.shape[a] for a in axes)
    if n > 1:
        _count("all_gather", math.prod(mesh.sizes) * (n - 1) * x.numel()
               // n * x.element_size())
    return x


class _GatherFrom(torch.autograd.Function):
    """:func:`gather_over` forward; the cotangent reduce-scattered back to
    the rank's block backward, counted as :func:`all_gather`'s backward
    counts on a process."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.ring, ctx.dim = _ring(mesh, axes), dim
        return gather_over(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        (group, n), dim = ctx.ring, ctx.dim
        blocks = g.movedim(dim, 0)
        blocks = blocks.reshape((n, blocks.shape[0] // n) + blocks.shape[1:])
        _count_backward("all_gather", (n - 1) * blocks[0].numel()
                        * blocks.element_size())
        return _reduce_scatter(blocks, group, n).movedim(
            0, dim).contiguous(), None, None, None


def gather_from(x, mesh, axes, dim: int, share: float = 1.0):
    """Outside a body, on a process mesh: FSDP's gather of a parameter (and
    the gather of a block's activation split over ``model``). Forward, the
    group's blocks of ``x`` over ``axes`` (a name or a tuple, the first the
    major one) concatenated along ``dim`` in their coordinate order
    (:func:`gather_over`: one counted all-gather); backward, the
    cotangent's block of each rank summed over the group and left on that
    rank (a reduce-scatter: the all-to-all and sum of :func:`all_gather`'s
    backward, counted as that backward counts). A group of one is the
    identity both ways and counts nothing. On a stacked mesh (one axis):
    ``x`` is already the gathered tensor, the identity both ways, the
    ranks' all-gather and reduce-scatter counted, each rank holding
    ``share`` of ``x``'s rows (its block of ``1 / n`` of them along
    ``dim``)."""
    if not is_process_mesh(mesh):
        blk = share * x.numel() * x.element_size()
        return _counted(x, mesh, axes, "all_gather",
                        lambda n: (n - 1) * blk / n)
    if _ring(mesh, axes)[1] == 1:
        return x
    return _GatherFrom.apply(x, mesh, axes, dim)


class _ScatterOver(torch.autograd.Function):
    """The reduce-scatter of :func:`scatter_over` forward; the cotangent's
    blocks all-gathered backward, counted under ``psum_scatter``."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        group, n = _ring(mesh, axis)
        ctx.ring, ctx.dim = (group, n), dim
        blocks = x.movedim(dim, 0)
        blocks = blocks.reshape((n, blocks.shape[0] // n) + blocks.shape[1:])
        _count("psum_scatter", (n - 1) * blocks[0].numel()
               * blocks.element_size())
        return _reduce_scatter(blocks, group, n).movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        (group, n), dim = ctx.ring, ctx.dim
        _count_backward("psum_scatter", (n - 1) * g.numel() * g.element_size())
        return torch.cat(_gather_parts(g, group, n), dim=dim), None, None, \
            None


def scatter_over(x, mesh, axis: str = "model", dim: int = -1,
                 share: float = 1.0):
    """Outside a body: ``x`` (each rank's partial sum) summed over ``axis``
    and cut into the group's blocks along ``dim``, the rank keeping its
    own (a reduce-scatter, counted as ``psum_scatter``: each rank sends
    ``(n-1)/n`` of ``x``); backward, the cotangent's blocks all-gathered
    (as many bytes). A group of one is the identity both ways and counts
    nothing. On a stacked mesh: the identity both ways (``x`` is the sum,
    every block of it), the two counted as the ranks run them, each rank
    holding ``share`` of ``x``'s rows."""
    if not is_process_mesh(mesh):
        blk = share * x.numel() * x.element_size()
        return _counted(x, mesh, axis, "psum_scatter",
                        lambda n: (n - 1) * blk / n)
    if _ring(mesh, axis)[1] == 1:
        return x
    return _ScatterOver.apply(x, mesh, axis, dim % x.dim())


def _blocks_over(x, n: int, split_dim: int, concat_dim: int, group):
    """``x`` cut into ``n`` blocks along ``split_dim``, block ``j`` sent
    to the group's rank ``j``, the blocks received concatenated along
    ``concat_dim`` in the group's rank order."""
    parts = torch.stack(x.chunk(n, dim=split_dim))
    return torch.cat(_all_to_all(parts, group, n).unbind(0), dim=concat_dim)


class _AllToAllOver(torch.autograd.Function):
    """:func:`all_to_all_over` forward; the inverse re-lay of the cotangent
    backward, counted as :func:`all_to_all`'s backward counts."""

    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        group, n = _ring(mesh, axis)
        ctx.plan = group, n, split_dim, concat_dim
        nbytes = (n - 1) / n * x.numel() * x.element_size()
        ctx.nbytes = nbytes
        _count("all_to_all", nbytes)
        return _blocks_over(x, n, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        group, n, split_dim, concat_dim = ctx.plan
        _count_backward("all_to_all", ctx.nbytes)
        return _blocks_over(g, n, concat_dim, split_dim, group), None, \
            None, None, None


def all_to_all_over(x, mesh: ProcessMesh, axis: str, split_dim: int,
                    concat_dim: int):
    """Outside a body, on a process mesh: the group over ``axis`` re-lays
    ``x`` (each rank's block of a tensor cut along ``concat_dim``) as each
    rank's block of the same tensor cut along ``split_dim``: ``x`` cut into
    n blocks along ``split_dim``, block ``j`` to the group's rank ``j``,
    the blocks received concatenated along ``concat_dim`` in rank order
    (one ``all_to_all_single``). Its backward re-lays the cotangent back.
    Counted as :func:`all_to_all` counts a call on a process, forward and
    backward (each rank sends ``(n-1)/n`` of its block). A group of one
    is the identity both ways and counts nothing."""
    if _ring(mesh, axis)[1] == 1:
        return x
    return _AllToAllOver.apply(x, mesh, axis, split_dim, concat_dim)


class _Relaid(torch.autograd.Function):
    """The stacked route's re-lay of a body's input under a count: the
    identity both ways, an all-to-all counted forward and backward."""

    @staticmethod
    def forward(ctx, x, nbytes):
        _count("all_to_all", nbytes)
        ctx.nbytes = nbytes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        _count_backward("all_to_all", ctx.nbytes)
        return g, None


def _max_back(g, dims, x, y):
    # autograd's backward of ``.expand`` after ``amax``: the cotangent
    # summed over the expanded dimensions, split evenly among the ties
    mask = x == y
    return _sum_back(g, dims) / mask.sum(dim=dims, keepdim=True) * mask


def _max_back_proc(g, group, x, y):
    mask = x == y
    tot = _all_reduce(torch.stack([g, mask.to(g.dtype)]), group, "SUM")
    return tot[0] / tot[1] * mask


def all_to_all(x, axis: str, split_axis: int, concat_axis: int,
               tiled: bool = False):
    """``tiled=False`` with ``split_axis = concat_axis = 0`` (the only form
    the reference calls): chunk ``j`` of device ``i``'s local dimension 0
    goes to device ``j``, where it lands as chunk ``i`` — the axis's
    dimension swapped with the local dimension 0, whose size must be the
    axis's."""
    if tiled or split_axis != 0 or concat_axis != 0:
        raise NotImplementedError(
            "all_to_all: only split_axis = concat_axis = 0, tiled=False")
    ax = _axes()
    (d,) = ax.dims(axis)
    n, lead = ax.sizes[d], len(ax.sizes)
    if x.shape[lead] != n:
        raise ValueError(f"all_to_all over '{axis}' (size {n}) splits a "
                         f"local dimension of {x.shape[lead]}")
    nbytes = ax.local_bytes(x) * (n - 1) / n * ax.counted
    if ax.proc:
        group = ax.proc.group(axis)[0]
        swap = lambda x: _all_to_all(x.reshape(x.shape[lead:]), group,
                                     n).reshape(x.shape)
        return _apply(ax, x, "all_to_all", nbytes, nbytes, swap, swap)
    return _apply(ax, x, "all_to_all", nbytes, nbytes,
                  lambda x: x.transpose(d, lead),
                  lambda g: g.transpose(d, lead))


def all_gather(x, axis: str):
    """Every device's buffer stacked along a new local dimension 0, on every
    device along ``axis``: a view (on processes, the group's
    ``all_gather``)."""
    ax = _axes()
    (d,) = ax.dims(axis)
    n, lead = ax.sizes[d], len(ax.sizes)
    nbytes = ax.local_bytes(x) * (n - 1) * ax.counted
    if ax.proc:
        group = ax.proc.group(axis)[0]
        stack = x.shape[:lead]

        def gather(x):
            return _all_gather(x.reshape(x.shape[lead:]), group, n).reshape(
                stack + (n,) + x.shape[lead:])

        def scatter(g):
            return _reduce_scatter(g.reshape(g.shape[lead:]), group,
                                   n).reshape(stack + g.shape[lead + 1:])
        return _apply(ax, x, "all_gather", nbytes, nbytes, gather, scatter)
    return _apply(
        ax, x, "all_gather", nbytes, nbytes,
        lambda x: x.movedim(d, lead - 1).unsqueeze(d).expand(
            x.shape[:lead] + (n,) + x.shape[lead:]),
        lambda g: _sum_back(g, (d,)).squeeze(d).movedim(lead - 1, d))


# ---------------------------------------------------------------------------
# splitting and reassembling by spec
# ---------------------------------------------------------------------------


class Held(PartitionSpec):
    """An in_spec of :func:`shard_map` whose input a process mesh's rank
    holds already as its block along the axes the spec names (see the
    module's docstring): there the input is taken as it is along them,
    and its gradient is the block's own; on the stacked route it is a
    :class:`PartitionSpec`, cutting the whole tensor the caller passes."""

    def __repr__(self):
        return f"Held{tuple.__repr__(self)}"


def _spec_of(spec, ndim: int, what: str) -> tuple:
    spec = tuple(spec) if spec is not None else ()
    if len(spec) > ndim:
        raise ValueError(f"{what}: spec {PartitionSpec(*spec)} has more "
                         f"entries than the array's {ndim} dimensions")
    return spec + (None,) * (ndim - len(spec))


def _divides(fname, i, x, spec, dim, axis_names, sizes):
    n = math.prod(sizes)
    if n and x.shape[dim] % n == 0:
        return
    names = axis_names[0] if len(axis_names) == 1 else axis_names
    raise ValueError(
        f"shard_map applied to the function '{fname}' was given argument "
        f"arrays with axis sizes that are not evenly divisible by the "
        f"corresponding mesh axis sizes: args[{i}] of shape "
        f"{tuple(x.shape)} corresponds to in_specs[{i}] of value {spec}, "
        f"which maps array axis {dim} (of size {x.shape[dim]}) to mesh "
        f"axis {names!r} (of size {n}), but {n} does not evenly divide "
        f"{x.shape[dim]}")


def _check_axes(entries, names, what):
    used = []
    for entry in entries:
        for a in entry_axes(entry):
            if a not in names or a in used:
                raise ValueError(f"{what} {PartitionSpec(*entries)}: "
                                 f"axis {a!r} is unknown or used twice")
            used.append(a)


def split(x, spec, mesh, fname: str = "f", i: int = 0):
    """The stacks ``(*mesh.sizes, *local shape)`` of a global tensor laid
    out by ``spec``: views where the tensor's layout allows."""
    names, sizes = tuple(mesh.axis_names), tuple(int(n) for n in mesh.sizes)
    entries = _spec_of(spec, x.dim(), f"in_specs[{i}]")
    _check_axes(entries, names, f"in_specs[{i}]")
    shape, at, local = [], {}, []
    for dim, (n, entry) in enumerate(zip(x.shape, entries)):
        axes = entry_axes(entry)
        axis_sizes = [sizes[names.index(a)] for a in axes]
        _divides(fname, i, x, PartitionSpec(*entries), dim, axes,
                 axis_sizes)
        for a, k in zip(axes, axis_sizes):
            at[a] = len(shape)
            shape.append(k)
        local.append(len(shape))
        shape.append(n // math.prod(axis_sizes))
    missing = [a for a in names if a not in at]
    v = x.reshape([1] * len(missing) + shape)
    off = len(missing)
    perm = [missing.index(a) if a in missing else at[a] + off for a in names]
    v = v.permute(perm + [p + off for p in local])
    return v.expand(sizes + tuple(v.shape[len(names):]))


def _split_stacked(x, spec, mesh, fname, i):
    """:func:`split` of a body's input on the stacked route; under a count
    of the step, re-laid by a counted all-to-all where the spec splits it
    over ``model`` along another dimension than its parameter's spec
    (``step_analysis.relaid_bytes``)."""
    v = split(x, spec, mesh, fname, i)
    nbytes = step_analysis.relaid_bytes(
        x, _spec_of(spec, x.dim(), f"in_specs[{i}]"))
    return _Relaid.apply(v, nbytes) if nbytes else v


def merge(v, spec, mesh):
    """The global tensor of output stacks laid out by ``spec``; an axis that
    ``spec`` does not name is read from its device 0."""
    names, sizes = tuple(mesh.axis_names), tuple(int(n) for n in mesh.sizes)
    lead = len(names)
    entries = _spec_of(spec, v.dim() - lead, "out_specs")
    named = [a for e in entries for a in entry_axes(e)]
    v = v[tuple(slice(None) if a in named else 0 for a in names)]
    kept = [a for a in names if a in named]
    perm, shape = [], []
    for dim, entry in enumerate(entries):
        axes = entry_axes(entry)
        perm += [kept.index(a) for a in axes]
        perm.append(len(kept) + dim)
        shape.append(math.prod(sizes[names.index(a)] for a in axes)
                     * v.shape[len(kept) + dim])
    return v.permute(perm).reshape(shape)


# -- on processes ------------------------------------------------------------


def _layout(entries, mesh, what):
    """Per dimension the axes its blocks are cut over (the local ones
    left out: a tensor holds its own block along those), the axes named
    that way, and those that replicate the tensor (neither named nor
    local, of size > 1)."""
    _check_axes(entries, tuple(mesh.axis_names), what)
    cut = []
    for entry in entries:
        axes = entry_axes(entry)
        loc = [j for j, a in enumerate(axes) if a in mesh.local]
        if loc and loc != list(range(len(loc))):
            raise NotImplementedError(
                f"{what} {PartitionSpec(*entries)}: a local axis must be "
                f"the major one of its entry")
        cut.append(tuple(a for a in axes if a not in mesh.local))
    named = {a for e in entries for a in entry_axes(e)}
    cut_axes = tuple(a for a in mesh.axis_names if any(a in c for c in cut))
    repl = tuple(a for a in mesh.axis_names if a not in named
                 and a not in mesh.local and mesh.shape[a] > 1)
    return cut, cut_axes, repl


def _slices(mesh, rank, cut, block_shape):
    """Where rank ``rank``'s block lies in the global tensor."""
    return tuple(slice(mesh.block(axes, rank) * n,
                       (mesh.block(axes, rank) + 1) * n)
                 for axes, n in zip(cut, block_shape))


def _assemble(block, mesh, cut, cut_axes):
    """The global tensor of every rank's ``block`` over ``cut_axes`` (the
    block itself where there are none)."""
    if not cut_axes:
        return block
    group, ranks = mesh.group(cut_axes)
    parts = _all_gather(block, group, len(ranks))
    shape = [n * math.prod(mesh.shape[a] for a in axes)
             for n, axes in zip(block.shape, cut)]
    out = block.new_empty(shape)
    for r, part in zip(ranks, parts):
        out[_slices(mesh, r, cut, block.shape)] = part
    return out


class _Chain:
    """The order of a body's backward on processes. Autograd runs a node
    when its own outputs' gradients are in, so on each rank it would run
    the collectives' backward in an order, and for a set, of that rank's
    own data flow: a pipeline stage that never reads a tick's ``recv``
    never runs that ``ppermute``'s backward, which its ring neighbours
    wait in. So each split, each collective and each merge of a body takes
    a token (a zero scalar) and gives the next one, and every output of the
    body depends on the last: the backward then reaches every collective
    on every rank, the later ones first, and the splits' after them, in
    one order on all ranks. A chain starts where autograd records and an
    argument of the call requires a gradient (a body's differentiable
    tensors are its arguments: one it closes over is not ordered). One
    chain a ``shard_map`` call; two calls whose outputs never meet are not
    ordered against each other."""

    def __init__(self, device, differentiable: bool):
        self.token = torch.zeros((), device=device, requires_grad=True) \
            if differentiable else None


class _Split(torch.autograd.Function):
    """The rank's block of a global tensor; backward, the global gradient:
    the blocks' gradients all-gathered over the cut axes and summed over
    the replicating ones."""

    @staticmethod
    def forward(ctx, x, token, mesh, cut, cut_axes, repl, block_shape):
        ctx.set_materialize_grads(False)
        ctx.plan = mesh, cut, cut_axes, repl, tuple(block_shape)
        ctx.dtype, ctx.device = x.dtype, x.device
        block = x[_slices(mesh, mesh.rank, cut, block_shape)].reshape(
            (1,) * len(mesh.axis_names) + tuple(block_shape))
        return block, _token_like(token)

    @staticmethod
    def backward(ctx, g, _):
        mesh, cut, cut_axes, repl, block_shape = ctx.plan
        full = None
        if ctx.needs_input_grad[0]:
            if g is None:
                g = torch.zeros((1,) * len(mesh.axis_names) + block_shape,
                                dtype=ctx.dtype, device=ctx.device)
            lead = len(mesh.axis_names)
            full = _assemble(g.reshape(g.shape[lead:]), mesh, cut, cut_axes)
            if repl:
                full = _all_reduce(full, mesh.group(repl)[0], "SUM")
        tok = torch.zeros((), device=mesh.device) \
            if ctx.needs_input_grad[1] else None
        return full, tok, None, None, None, None, None


class _Merge(torch.autograd.Function):
    """The global tensor of the ranks' blocks; backward, the rank's block of
    the cotangent, kept on the replicating axes' device 0 (the stacked
    route reads a replicated output from there)."""

    @staticmethod
    def forward(ctx, v, token, mesh, cut, cut_axes, repl):
        lead = len(mesh.axis_names)
        ctx.plan = mesh, cut, tuple(v.shape)
        ctx.keep = all(mesh.coord(a) == 0 for a in repl)
        return _assemble(v.reshape(v.shape[lead:]), mesh, cut, cut_axes)

    @staticmethod
    def backward(ctx, g):
        mesh, cut, shape = ctx.plan
        lead = len(mesh.axis_names)
        block = g[_slices(mesh, mesh.rank, cut, shape[lead:])].reshape(shape)
        tok = torch.zeros((), device=g.device) \
            if ctx.needs_input_grad[1] else None
        return (block if ctx.keep else torch.zeros_like(block)), tok, None, \
            None, None, None


def _split_process(x, spec, mesh, fname, i, chain):
    """The rank's block of a global tensor, shaped ``(1,) * len(axes) +
    local shape``, threaded on ``chain``."""
    entries = _spec_of(spec, x.dim(), f"in_specs[{i}]")
    if isinstance(spec, Held):
        mesh = mesh.with_local(tuple(dict.fromkeys(
            mesh.local + tuple(a for e in entries for a in entry_axes(e)))))
    cut, cut_axes, repl = _layout(entries, mesh, f"in_specs[{i}]")
    block_shape = []
    for dim, axes in enumerate(cut):
        sizes = [mesh.shape[a] for a in axes]
        _divides(fname, i, x, PartitionSpec(*entries), dim, axes, sizes)
        block_shape.append(x.shape[dim] // math.prod(sizes))
    block, chain.token = _Split.apply(x, chain.token, mesh, cut, cut_axes,
                                      repl, tuple(block_shape))
    return block


def _merge_process(v, spec, mesh, chain):
    """The rank's output blocks all-gathered over the axes ``spec`` names
    (the local ones excepted), dependent on ``chain``'s last token."""
    entries = _spec_of(spec, v.dim() - len(mesh.axis_names), "out_specs")
    cut, cut_axes, repl = _layout(entries, mesh, "out_specs")
    return _Merge.apply(v, chain.token, mesh, cut, cut_axes, repl)


# ---------------------------------------------------------------------------
# shard_map
# ---------------------------------------------------------------------------


def _map(fn, spec, tree):
    """``fn(spec, leaf)`` over a tree of tensors (nested dicts, tuples and
    lists) whose spec tree is a prefix of it: a spec at a node applies to
    every leaf below."""
    if spec is None or isinstance(spec, PartitionSpec):
        if isinstance(tree, dict):
            return {k: _map(fn, spec, v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(_map(fn, spec, v) for v in tree)
        return fn(spec, tree)
    if isinstance(spec, dict):
        return {k: _map(fn, spec[k], tree[k]) for k in tree}
    if len(spec) != len(tree):
        raise ValueError(f"{len(spec)} specs for {len(tree)} values")
    return type(tree)(_map(fn, s, t) for s, t in zip(spec, tree))


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (dict, tuple, list)):
        for v in tree.values() if isinstance(tree, dict) else tree:
            yield from _tensors(v)


def _first_device(tree) -> Optional[torch.device]:
    return next((t.device for t in _tensors(tree)), None)


def shard_map(f, *, mesh, in_specs, out_specs):
    """The reference's ``shard_map(f, mesh=, in_specs=, out_specs=)``: the
    returned function splits its arguments into stacks by ``in_specs``,
    runs ``f`` once on them with the collectives above bound to ``mesh``
    (the stacks of every device on a ``core.staging.Mesh``, the rank's own
    on a :class:`ProcessMesh`), and reassembles ``f``'s outputs by
    ``out_specs``. As the reference's calls (``check_vma=False``), it does
    not check that an output is replicated where its spec says so: on the
    stacked route such an output is read from its axes' device 0, on
    processes each rank keeps its own."""
    fname = getattr(f, "__name__", type(f).__name__)

    def run(*args):
        if len(in_specs) != len(args):
            raise ValueError(f"shard_map of '{fname}': {len(in_specs)} "
                             f"in_specs for {len(args)} arguments")
        ax = _Axes(mesh, _first_device(args))
        if ax.proc:
            ax.chain = _Chain(ax.device, torch.is_grad_enabled() and any(
                t.requires_grad for t in _tensors(args)))
            cut = functools.partial(_split_process, chain=ax.chain)
            glue = functools.partial(_merge_process, chain=ax.chain)
        else:
            cut, glue = _split_stacked, merge
        stacks = tuple(
            _map(lambda s, x, i=i: cut(x, s, mesh, fname, i), spec, a)
            for i, (spec, a) in enumerate(zip(in_specs, args)))
        CALLS["shard_map"] += 1
        _ACTIVE.append(ax)
        try:
            with step_analysis.explicit():
                out = f(*stacks)
        finally:
            _ACTIVE.pop()
        return _map(lambda s, v: glue(v, s, mesh), out_specs, out)
    return run
