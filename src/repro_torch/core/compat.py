"""The reference's ``shard_map`` on one device: a mesh held as tensor
dimensions.

The reference's file is a JAX version shim around ``jax.shard_map``. Here
the same call runs on one device. A mesh (``core.staging.Mesh``: named axes
and sizes, no devices) becomes leading dimensions of every tensor the body
sees, in the mesh's axis order: for a mesh ``("data", "model")`` of sizes
(2, 4), device ``(d, m)``'s shard of ``x`` is ``stack[d, m]``.

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
- Each collective adds one to ``CALLS[kind]`` and, to ``BYTES[kind]``, the
  bytes that a real mesh would move over its links for that call, summed
  over the devices (a ring all-reduce for the three reductions: each device
  sends ``2 (n-1)/n`` of its buffer; an all-to-all ``(n-1)/n``; an
  all-gather ``n-1`` buffers; a ring permutation one buffer).
  ``CALLS["shard_map"]`` counts the bodies run.
- Each collective is a ``torch.autograd.Function`` whose backward is the
  collective that a real mesh runs for it, counted under the forward's
  kind in ``CALLS_BWD`` / ``BYTES_BWD``: ``all_gather``'s is a
  reduce-scatter (as many bytes), ``all_to_all``'s the inverse
  ``all_to_all`` and ``ppermute``'s the inverse permutation (as many
  bytes each); the three reductions' is a broadcast of a cotangent that
  every device of the axis holds (a call, no bytes; ``pmax``'s keeps its
  input and output to split the cotangent among ties). The backward's
  arithmetic is the one autograd took through the stacked operations
  before, bit for bit.
- A count of the step (``core.step_analysis.analyze``) receives each
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
import math
from typing import Optional

import torch

from repro_torch.core import step_analysis
from repro_torch.core.partition import PartitionSpec, entry_axes

CALLS: collections.Counter = collections.Counter()
BYTES: collections.Counter = collections.Counter()
CALLS_BWD: collections.Counter = collections.Counter()
BYTES_BWD: collections.Counter = collections.Counter()


def reset_counts():
    for counter in (CALLS, BYTES, CALLS_BWD, BYTES_BWD):
        counter.clear()


def read_counts() -> dict:
    """``{kind: {"calls": n, "bytes": b}}`` of the collectives so far."""
    return {k: {"calls": CALLS[k], "bytes": BYTES[k]} for k in sorted(CALLS)}


# ---------------------------------------------------------------------------
# the axis context of a running body
# ---------------------------------------------------------------------------


class _Axes:
    def __init__(self, mesh, device):
        self.names = tuple(mesh.axis_names)
        self.sizes = tuple(int(n) for n in mesh.sizes)
        self.device = device

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
    axes' sizes, in mesh order."""
    return _axes().sizes


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
        CALLS_BWD[ctx.kind] += 1
        BYTES_BWD[ctx.kind] += int(round(ctx.nbytes_bwd))
        step_analysis.collective(ctx.kind, ctx.nbytes_bwd, backward=True)
        with step_analysis.uncounted():
            dx = ctx.bwd(g, *ctx.saved_tensors)
        return dx, None, None, None, None, None, None


def axis_index(axis: str) -> torch.Tensor:
    """Each device's index along ``axis``: an int64 ``arange`` shaped to
    broadcast against the stacks' leading dimensions."""
    ax = _axes()
    (d,) = ax.dims(axis)
    shape = [1] * len(ax.sizes)
    shape[d] = ax.sizes[d]
    return torch.arange(ax.sizes[d], device=ax.device).reshape(shape)


def ppermute(x, axis: str, perm):
    """Device ``dst`` receives ``src``'s buffer for each ``(src, dst)`` in
    ``perm``, which must be a ring: every device sends to the one ``k``
    places on (the only form the reference's callers use), a
    ``torch.roll`` along the axis's dimension."""
    ax = _axes()
    (d,) = ax.dims(axis)
    n = ax.sizes[d]
    shifts = {(int(t) - int(s)) % n for s, t in perm}
    if sorted(int(s) % n for s, _ in perm) != list(range(n)) \
            or len(shifts) != 1:
        raise ValueError(f"ppermute over '{axis}': {perm} is not a ring "
                         f"of its {n} devices")
    shift = shifts.pop()
    nbytes = ax.local_bytes(x) * ax.n_dev * (shift != 0)
    return _Collective.apply(x, "ppermute", nbytes, nbytes,
                             lambda x: torch.roll(x, shifts=shift, dims=d),
                             lambda g: torch.roll(g, shifts=-shift, dims=d),
                             False)


def _reduce(kind: str, x, axes, op, grad):
    ax = _axes()
    dims = ax.dims(axes)
    n = math.prod(ax.sizes[d] for d in dims)
    nbytes = 2 * (n - 1) / n * ax.local_bytes(x) * ax.n_dev
    shape = x.shape
    return _Collective.apply(x, kind, nbytes, 0,
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
                   lambda x, dims: x.sum(dim=dims, keepdim=True),
                   lambda g, dims, n, shape: _sum_back(g, dims).expand(shape))


def pmean(x, axes):
    return _reduce("pmean", x, axes,
                   lambda x, dims: x.mean(dim=dims, keepdim=True),
                   lambda g, dims, n, shape:
                   _sum_back(g, dims).expand(shape) / n)


def pmax(x, axes):
    return _reduce("pmax", x, axes,
                   lambda x, dims: x.amax(dim=dims, keepdim=True),
                   lambda g, dims, n, shape, x, y: _max_back(g, dims, x, y))


def _max_back(g, dims, x, y):
    # autograd's backward of ``.expand`` after ``amax``: the cotangent
    # summed over the expanded dimensions, split evenly among the ties
    mask = x == y
    return _sum_back(g, dims) / mask.sum(dim=dims, keepdim=True) * mask


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
    nbytes = ax.local_bytes(x) * (n - 1) / n * ax.n_dev
    return _Collective.apply(x, "all_to_all", nbytes, nbytes,
                             lambda x: x.transpose(d, lead),
                             lambda g: g.transpose(d, lead), False)


def all_gather(x, axis: str):
    """Every device's buffer stacked along a new local dimension 0, on every
    device along ``axis``: a view."""
    ax = _axes()
    (d,) = ax.dims(axis)
    n, lead = ax.sizes[d], len(ax.sizes)
    nbytes = ax.local_bytes(x) * (n - 1) * ax.n_dev
    return _Collective.apply(
        x, "all_gather", nbytes, nbytes,
        lambda x: x.movedim(d, lead - 1).unsqueeze(d).expand(
            x.shape[:lead] + (n,) + x.shape[lead:]),
        lambda g: _sum_back(g, (d,)).squeeze(d).movedim(lead - 1, d), False)


# ---------------------------------------------------------------------------
# splitting and reassembling by spec
# ---------------------------------------------------------------------------


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


def split(x, spec, mesh, fname: str = "f", i: int = 0):
    """The stacks ``(*mesh.sizes, *local shape)`` of a global tensor laid
    out by ``spec``: views where the tensor's layout allows."""
    names, sizes = tuple(mesh.axis_names), tuple(int(n) for n in mesh.sizes)
    entries = _spec_of(spec, x.dim(), f"in_specs[{i}]")
    shape, at, local, used = [], {}, [], []
    for dim, (n, entry) in enumerate(zip(x.shape, entries)):
        axes = entry_axes(entry)
        for a in axes:
            if a not in names or a in used:
                raise ValueError(f"in_specs[{i}] {PartitionSpec(*entries)}: "
                                 f"axis {a!r} is unknown or used twice")
            used.append(a)
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


def _first_device(tree) -> Optional[torch.device]:
    if isinstance(tree, torch.Tensor):
        return tree.device
    items = tree.values() if isinstance(tree, dict) else \
        tree if isinstance(tree, (tuple, list)) else ()
    for v in items:
        dev = _first_device(v)
        if dev is not None:
            return dev
    return None


def shard_map(f, *, mesh, in_specs, out_specs):
    """The reference's ``shard_map(f, mesh=, in_specs=, out_specs=)``, with
    the mesh held as tensor dimensions: the returned function splits its
    arguments into stacks by ``in_specs``, runs ``f`` once on them with the
    collectives above bound to ``mesh``, and reassembles ``f``'s outputs by
    ``out_specs``. As the reference's calls (``check_vma=False``), it does
    not check that an output is replicated where its spec says so: such an
    output is read from its axes' device 0."""
    fname = getattr(f, "__name__", type(f).__name__)

    def run(*args):
        if len(in_specs) != len(args):
            raise ValueError(f"shard_map of '{fname}': {len(in_specs)} "
                             f"in_specs for {len(args)} arguments")
        stacks = tuple(
            _map(lambda s, x, i=i: split(x, s, mesh, fname, i), spec, a)
            for i, (spec, a) in enumerate(zip(in_specs, args)))
        CALLS["shard_map"] += 1
        _ACTIVE.append(_Axes(mesh, _first_device(args)))
        try:
            with step_analysis.explicit():
                out = f(*stacks)
        finally:
            _ACTIVE.pop()
        return _map(lambda s, v: merge(v, s, mesh), out_specs, out)
    return run
