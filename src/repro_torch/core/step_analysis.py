"""FLOP, byte and collective count of a torch step: the twin of the
reference's ``core/hlo_analysis.py`` (the dry-run profiler).

The reference parses the HLO that XLA compiled for a mesh and counts it.
The port has no HLO. :func:`analyze` runs the step itself, usually on
``meta`` tensors (shapes and dtypes, no memory, no card), under one
``TorchDispatchMode`` that sees every aten operation of the forward, the
backward and the optimizer, and counts:

- **FLOPs**: the matrix-product family (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``) by ``torch.utils.flop_counter``'s formulas, 2 per
  multiply-add, the reference's dot count; ``convolution`` as the
  reference counts it, 2 * prod(result). Elementwise FLOPs are not
  counted, as in the reference. A hand-written kernel adds its own count
  (each wrapper's ``work``, recorded by :func:`kernel`); the aten
  operations inside a wrapper (its plain version on the CPU, its output
  allocations everywhere) are not counted, so a kernel counts once on
  every device.
- **Bytes**: operands plus results of each aten operation, except views
  and the reference's ``_BOOKKEEPING`` / ``_FUSABLE_MOVEMENT`` classes
  mapped to aten names (:data:`NOT_COUNTED`). This is an eager count: XLA
  fuses elementwise chains, so the reference reads fewer bytes.
- **Collectives** per device, with the reference's ring formulas
  (:func:`ring_bytes`), from three sources:

  1. the explicit ``shard_map`` collectives of ``core/compat.py``, forward
     and backward, each reported as it runs (:func:`collective`);
  2. the parameters' own, from each leaf's spec: under FSDP (a leaf
     sharded over a batch axis) an all-gather over those axes in the
     forward that reads it and one more in the backward that reads it,
     or reads its cast to the compute dtype (the gradient products, and
     the recompute under remat, share it), and a reduce-scatter of its
     gradient (neither a view nor the optimizer reads a leaf: one that
     nothing else reads moves nothing); a gradient all-reduce over the
     batch axes that replicate the leaf, and over ``model`` too where it
     replicates a leaf that the forward applies to an activation split
     over ``model`` (a per-head bias: each device holds a partial or
     sliced gradient), not where the leaf meets replicated activations
     only (a norm's weight: every device computes its gradient whole).
     Each covers the extent of the leaf that the forward and backward
     read (the hull of their views of it): the one-hot MoE dispatch reads
     the live experts of a padded table, and the gradients of the other
     slots are identically zero;
  3. tensor parallelism's activation all-reduces: a product whose
     contracting dimension is sharded over the ``model`` axis
     (:data:`MODEL_AXIS`) ends in an all-reduce of its result, forward and
     backward; a lookup (``index``, ``embedding``, ``index_select``) whose
     indexed dimension is sharded over it ends in one all-reduce of its
     result in the forward (its cotangent is replicated and its scatter
     lands in the local shard). Which dimensions are sharded is carried
     from each parameter's spec through the views and copies made of it,
     down to the sub-dimension of a merged one, so that a batch or token
     dimension never carries ``model``. The port has no partitioner, so
     this stands in for the collectives that the reference's GSPMD
     inserts; inside a ``shard_map`` body the collectives are explicit and
     nothing is derived, and so inside an :func:`explicit` scope (the
     one-hot MoE dispatch's expert products, whose ``model`` all-reduces
     of a buffer that each data rank holds whole ``core/compat.py``'s
     ``copy_to`` / ``reduce_from`` count on the stacked route).

Where a partitioner reshards what the port cannot derive, the count is
known short, and where it splits products unevenly, the port's FLOPs a
device are a perfect-division bound. :func:`short` records such a term
from the code that runs (FSDP, the one-hot MoE dispatch on a mesh, MLA
and its absorbed decode and the SSM blocks under ``model``);
``StepStats.count_short`` lists them.

Every count of the global step (FLOPs, bytes, the live bytes) is divided by
``n_devices``; a parameter's or an optimizer state's reads and writes
count as its shard's bytes (its spec), and so do the inputs'
(``argument_bytes``, exact). ``peak_bytes_est`` is an estimate: the
inputs' shard bytes plus the largest bytes the mode saw live at once,
divided by ``n_devices``.

Under ``analyze(target="cuda")`` a ``meta`` tensor takes the routes a CUDA
tensor takes (``models.attention.flash_route_enabled`` reads
:func:`target`), so the count is that of the step the card runs; with
``target="cpu"`` it takes the CPU's, as the reference's dry run on host
devices does.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from collections import defaultdict
from typing import Optional

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.core.partition import PartitionSpec, entry_axes

MODEL_AXIS = "model"          # the tensor-parallel (lane) axis; the others
                              # of a mesh are batch axes (models/sharding.py)

aten = torch.ops.aten
_PRODUCTS = {aten.mm, aten.addmm, aten.bmm, aten.baddbmm}
_CONVOLUTIONS = {aten.convolution, aten._convolution}

# The reference's _BOOKKEEPING (parameter, constant, iota, tuple,
# bitcast, ...) and _FUSABLE_MOVEMENT (copy, convert, transpose, reshape,
# broadcast, slice, reverse, pad) classes by aten name; a view is
# bookkeeping whatever its name (``OpOverload.is_view``).
NOT_COUNTED = frozenset({
    # bookkeeping: allocations, iota, scalars, dtype queries
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "arange", "scalar_tensor", "_local_scalar_dense", "promote_types",
    "result_type",
    # copy, convert, reshape
    "_to_copy", "copy", "copy_", "clone", "_unsafe_view",
    # broadcast (of a constant or an operand)
    "zeros", "ones", "full", "zeros_like", "ones_like", "full_like",
    "new_zeros", "new_ones", "new_full", "fill", "fill_", "zero_", "repeat",
    # slice (the slicing ops' backward pads), reverse, pad
    "slice_backward", "select_backward", "flip", "roll", "constant_pad_nd",
})

# compat's collectives on the real mesh: forward kind -> the reference's
# kind, and what each one's backward is there (a reduction's, an
# all-reduce of the cotangent: the reference's transpose of psum is psum)
_KIND = {"psum": "all-reduce", "pmean": "all-reduce", "pmax": "all-reduce",
         "all_gather": "all-gather", "all_to_all": "all-to-all",
         "ppermute": "collective-permute", "psum_scatter": "reduce-scatter"}
_KIND_BWD = {**_KIND, "all_gather": "reduce-scatter",
             "psum_scatter": "all-gather"}


def ring_bytes(kind: str, result_bytes: float, g: int) -> float:
    """Bytes a device moves for one collective of ``result_bytes`` (its
    result on that device) over a group of ``g`` (the reference's
    ``hlo_analysis`` ring model)."""
    if kind == "all-reduce":
        return 2.0 * result_bytes * (g - 1) / max(g, 1)
    if kind in ("all-gather", "all-to-all"):
        return result_bytes * (g - 1) / max(g, 1)
    if kind == "reduce-scatter":
        return float(result_bytes) * (g - 1)
    if kind == "collective-permute":
        return float(result_bytes)
    raise ValueError(f"unknown collective kind {kind!r}")


# ---------------------------------------------------------------------------
# the analysis context that kernel wrappers, compat and the attention route
# read
# ---------------------------------------------------------------------------


_RUNS: list = []              # the running analyses, innermost last


def target() -> Optional[str]:
    """The device whose routes a ``meta`` tensor takes in the running
    analysis ("cuda" or "cpu"), or None outside :func:`analyze`."""
    return _RUNS[-1].target if _RUNS else None


_NOT_COUNTING = contextlib.nullcontext()


class _Scope:
    """Within it the running analysis counts no aten operation; entering
    it first records ``on_enter`` (a kernel's call and work)."""

    def __init__(self, run, on_enter=None):
        self.run, self.on_enter = run, on_enter

    def __enter__(self):
        if self.on_enter is not None:
            self.run.record_kernel(*self.on_enter)
        self.run.uncounted += 1

    def __exit__(self, *exc):
        self.run.uncounted -= 1


def kernel(name: str, work, *args):
    """Around a kernel wrapper's body: records one call of ``name`` with
    its ``work(*args)`` (FLOPs, bytes) in the running analysis, and stops
    the aten operations inside (the plain version, the output allocations)
    from being counted. Outside :func:`analyze` it is a shared no-op
    context and ``work`` is not called."""
    if not _RUNS:
        return _NOT_COUNTING
    return _Scope(_RUNS[-1], (name, *work(*args)))


def uncounted():
    """The aten operations inside are not counted (a collective's own
    operations on the stacks: they are counted as the collective)."""
    return _Scope(_RUNS[-1]) if _RUNS else _NOT_COUNTING


@contextlib.contextmanager
def explicit():
    """Around a ``shard_map`` body: its collectives are explicit (each
    reaches :func:`collective`), so no tensor-parallel collective is
    derived from the products inside."""
    if not _RUNS:
        yield
        return
    run = _RUNS[-1]
    run.explicit += 1
    try:
        yield
    finally:
        run.explicit -= 1


def collective(name: str, nbytes: float, backward: bool = False):
    """One of ``core/compat.py``'s collectives (``name``: its function)
    moving ``nbytes`` summed over the devices, in the forward or, with
    ``backward``, the collective a real mesh runs for its backward."""
    if _RUNS:
        _RUNS[-1].record_collective(name, nbytes, backward)


def short(term: str, axis: Optional[str] = None):
    """Records ``term`` ("collective: ..." or "flops: ...") as known short
    of, or split more evenly than, a partitioner's count in the running
    analysis, where its mesh has more than one device (on ``axis``, when
    given)."""
    if _RUNS:
        run = _RUNS[-1]
        if (run.sizes.get(axis, 1) if axis else run.n) > 1:
            run.stats.count_short.add(term)


def relaid_bytes(t, entries) -> float:
    """A body's input ``t`` that the stacked route's ``shard_map`` splits by
    ``entries`` (one tuple of axes a dimension): where ``t`` is a
    parameter (a view or a cast of one) whose spec splits it over
    ``model`` along one dimension and ``entries`` along another, the
    bytes, summed over the devices, of the all-to-all by which a
    partitioner re-lays each device's block (an expert table's FFN block
    as its block of experts): 0 where the layouts agree, outside
    :func:`analyze`, and for any other reshard, which is recorded as
    known short (:func:`short`)."""
    if not _RUNS:
        return 0.0
    run = _RUNS[-1]
    k = _key(t)
    tags = run.tags.get(t)
    if tags is None or (k not in run.params and run._cast_of(k) is None):
        return 0.0
    have = [d for d, tag in enumerate(tags) if MODEL_AXIS in _axes(tag)]
    want = [d for d, e in enumerate(entries) if MODEL_AXIS in entry_axes(e)]
    m = run.sizes.get(MODEL_AXIS, 1)
    if have == want or m == 1:
        return 0.0
    if len(have) == len(want) == 1 and tags[have[0]] == {(MODEL_AXIS, 1)} \
            and t.shape[want[0]] % m == 0:
        return run.n * _nbytes(t) / m * (m - 1) / m
    short(f"collective: a body's input resharded from model on dimensions "
          f"{have} to {want}", MODEL_AXIS)
    return 0.0


def untagged(t):
    """``t`` as a view that carries no ``model`` tag in the running
    analysis, so that no product on it derives a collective, forward or
    backward (a block that counts its own, inside :func:`explicit`); ``t``
    outside :func:`analyze`."""
    if not _RUNS:
        return t
    v = t.view_as(t)
    _RUNS[-1].tags.pop(v, None)
    return v


def check_launch(what: str):
    """Called where a CUDA kernel is launched: under :func:`analyze` a
    launch outside :func:`kernel` would go uncounted, so it raises."""
    if _RUNS and not _RUNS[-1].uncounted:
        raise RuntimeError(f"{what}: a kernel launched under step_analysis."
                           f"analyze without a work count (wrap the "
                           f"wrapper's body in step_analysis.kernel)")


# ---------------------------------------------------------------------------
# results
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StepStats:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0
    collective_by_kind: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    collective_count: int = 0
    top_collectives: list = dataclasses.field(default_factory=list)
    dot_flops_by_shape: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    # per kernel: {"calls", "flops", "bytes"} (calls global, the rest per
    # device)
    kernels: dict = dataclasses.field(default_factory=dict)
    # the terms known short of a partitioner's (see :func:`short`)
    count_short: set = dataclasses.field(default_factory=set)
    lookups: int = 0                # lookups that ended in an all-reduce
    argument_bytes: float = 0.0     # the inputs' shard bytes (exact)
    peak_live_bytes: float = 0.0    # largest live bytes seen, per device
    ops: int = 0                    # aten operations dispatched

    @property
    def peak_bytes_est(self) -> float:
        """Per-device peak estimate: the inputs' shard bytes plus the
        largest live bytes (divided by n_devices)."""
        return self.argument_bytes + self.peak_live_bytes

    def add_collective(self, kind: str, result_bytes: float, g: int,
                       label: str, times: int = 1):
        moved = ring_bytes(kind, result_bytes, g) * times
        self.collective_bytes += moved
        self.collective_by_kind[kind] += moved
        self.collective_count += times
        self.top_collectives.append((f"{kind} {label} g={g}", moved))

    def as_dict(self) -> dict:
        tops = defaultdict(float)
        for k, v in self.top_collectives:
            tops[k] += v
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "collective_bytes": self.collective_bytes,
            "collective_by_kind": dict(self.collective_by_kind),
            "collective_count": self.collective_count,
            "top_collectives": sorted(tops.items(), key=lambda t: -t[1])[:12],
            "top_dots": sorted(self.dot_flops_by_shape.items(),
                               key=lambda t: -t[1])[:12],
            "kernels": {k: dict(v) for k, v in sorted(self.kernels.items())},
            "count_short": sorted(self.count_short),
            "lookups": self.lookups,
            "argument_bytes": self.argument_bytes,
            "peak_bytes_est": self.peak_bytes_est,
        }


# ---------------------------------------------------------------------------
# the mode
# ---------------------------------------------------------------------------


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _type(t) -> str:
    return f"{str(t.dtype).replace('torch.', '')}{list(t.shape)}"


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tensors(tree[k])
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def _pairs(spec_tree, tree):
    """(tensor, spec) of every leaf; a spec at a node applies below it."""
    if spec_tree is None or isinstance(spec_tree, PartitionSpec):
        for t in _tensors(tree):
            yield t, spec_tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _pairs(spec_tree.get(k) if isinstance(spec_tree, dict)
                              else spec_tree, tree[k])
    else:
        for s, v in zip(spec_tree, tree):
            yield from _pairs(s, v)


def _key(t) -> int:
    """The identity of ``t``'s storage (shared by its views)."""
    return t.untyped_storage()._cdata


def _flat(args, kwargs=None) -> list:
    """The tensors among an operation's arguments (and in its lists)."""
    out = []
    for a in (args if kwargs is None else (*args, *kwargs.values())):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (tuple, list)):
            out.extend(x for x in a if isinstance(x, torch.Tensor))
    return out


def _reshape_tags(tags, src, dst):
    """Sharded-axis tags of a reshape from ``src`` to ``dst``. A tag is
    ``(axis, outer)``: the dimension, read row-major as ``outer`` blocks
    of what follows, is sharded from the sub-dimension that starts there
    (``outer`` 1: the whole dimension, block-sharded). Dimensions are
    grouped where their products meet; in its group a tag goes to the
    output dimension that holds its sub-dimension's start, so a merge of
    (batch, heads) and its split back keep ``model`` on the heads."""
    out = [frozenset()] * len(dst)
    i = j = 0
    while i < len(src) or j < len(dst):
        gi, gj = [i], [j]
        pi = src[i] if i < len(src) else 1
        pj = dst[j] if j < len(dst) else 1
        i, j = i + 1, j + 1
        while pi != pj:
            if pi < pj and i < len(src):
                pi *= src[i]
                gi.append(i)
                i += 1
            elif j < len(dst):
                pj *= dst[j]
                gj.append(j)
                j += 1
            else:
                break
        above = 1                   # the group's extent above src dim a
        for a in gi:
            if a >= len(src):
                break
            for axis, outer in tags[a]:
                pos, q = above * outer, 1
                for b in gj:
                    if b < len(dst) and pos < q * dst[b]:
                        out[b] = out[b] | {(axis, pos // q)}
                        break
                    q *= dst[b] if b < len(dst) else 1
            above *= src[a]
    return tuple(out)


def _axes(*tags) -> frozenset:
    """The mesh axes among dimension tags."""
    return frozenset(axis for tag in tags for axis, _ in tag)


def _box(t, p):
    """The index box of the leaf ``p`` that ``t``, a view of it, covers:
    one ``(lo, hi)`` per dimension of ``p``. Each dimension of ``t`` steps
    within one of ``p``'s (the one whose extent holds its stride), so
    their steps add up there; a walk past that dimension's end covers it
    and those it crosses whole."""
    shape, strides = p.shape, p.stride()
    order = sorted((d for d in range(p.dim()) if shape[d] > 1),
                   key=lambda d: -strides[d])
    off = t.storage_offset() - p.storage_offset()
    lo = [0] * p.dim()
    for d in order:
        lo[d], off = divmod(off, strides[d])
    span = [0] * p.dim()
    whole = set()
    for n, st in zip(t.shape, t.stride()):
        if n <= 1 or st == 0:
            continue
        for d in order:
            if strides[d] <= st < strides[d] * shape[d]:
                span[d] += st // strides[d] * (n - 1)
            elif st < strides[d] <= st * (n - 1):
                whole.add(d)
    return [(0, shape[d]) if d in whole or lo[d] + span[d] >= shape[d]
            else (lo[d], lo[d] + span[d] + 1) for d in range(p.dim())]


def _hull(a, b):
    return b if a is None else [(min(x0, y0), max(x1, y1))
                                for (x0, x1), (y0, y1) in zip(a, b)]


class _Run(TorchDispatchMode):
    def __init__(self, n_devices, sizes, target, state, params):
        super().__init__()
        self.n = max(int(n_devices), 1)
        self.sizes = sizes          # mesh axis -> size
        self.target = target
        self.stats = StepStats()
        self.uncounted = 0
        self.state = state          # storage key -> bytes divisor
        self.params = params        # storage key -> (tensor, spec)
        self.read_fwd, self.read_bwd = set(), set()
        self.extent = {}            # leaf key -> hull of the boxes read
        self.extent_bwd = {}        # ... of those the backward read
        self.stacked = set()        # leaves walked layer by layer (unbind)
        # the forward's casts of a leaf (their storage key -> (a weak
        # reference to it, the leaf's key)): the backward that reads a
        # cast (the gradient product of a weight used in the compute
        # dtype) reads the leaf
        self.casts = {}
        self.backward_ran = False
        self.explicit = 0           # inside shard_map bodies
        self.tags = WeakIdKeyDictionary()
        # the leaves replicated over MODEL_AXIS; the forward's tensors made
        # from them alone (-> their keys) and its activations split over
        # MODEL_AXIS; the leaves it applies to such activations
        self.repl = {k for k, (_, axes) in params.items()
                     if sizes.get(MODEL_AXIS, 1) > 1
                     and MODEL_AXIS not in (a for e in axes for a in e)}
        self.derived = WeakIdKeyDictionary()
        self.sharded = WeakIdKeyDictionary()
        self.model_partial = set()
        self.live = {}              # storage key -> (weakref, bytes)
        self.live_bytes = 0

    # -- kernels ------------------------------------------------------------

    def record_kernel(self, name, flops, nbytes):
        k = self.stats.kernels.setdefault(
            name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops / self.n
        k["bytes"] += nbytes / self.n
        self.stats.flops += flops / self.n
        self.stats.bytes_accessed += nbytes / self.n

    def record_collective(self, name, nbytes, backward):
        kind = (_KIND_BWD if backward else _KIND)[name]
        moved = nbytes / self.n     # compat's bytes sum over the devices
        st = self.stats
        st.collective_bytes += moved
        st.collective_by_kind[kind] += moved
        st.collective_count += 1
        st.top_collectives.append((f"{kind} compat.{name}", moved))

    # -- dispatch -----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.uncounted:
            return out
        self.stats.ops += 1
        ins = _flat(args, kwargs)
        outs = _flat((out,))
        in_keys = [_key(t) for t in ins]
        in_backward = torch._C._current_autograd_node() is not None
        if in_backward:
            self.backward_ran = True
        reads = self.read_bwd if in_backward else self.read_fwd
        # the step's reads: the optimizer after the backward reads every
        # leaf whole and is not one of them
        step_read = in_backward or not self.backward_ran
        if func.overloadpacket is aten.unbind and in_keys \
                and in_keys[0] in self.params and not (args[1:] or (0,))[0]:
            self.stacked.add(in_keys[0])
        # a view reads nothing, nor does the optimizer (a leaf that only
        # they touch, as the vision model's unread q_norm, moves nothing
        # under FSDP)
        for t, k in zip(ins, in_keys):
            if func.is_view or not step_read:
                break
            if k in self.params:
                reads.add(k)
                box = _box(t, self.params[k][0])
                self.extent[k] = _hull(self.extent.get(k), box)
            elif self._cast_of(k) is not None:
                k, box = self._cast_of(k), self.casts[k][2]
                reads.add(k)
            else:
                continue
            if in_backward:
                self.extent_bwd[k] = _hull(self.extent_bwd.get(k), box)
        packet = func.overloadpacket
        if packet in _PRODUCTS:
            f = flop_registry[packet](*args, **kwargs, out_val=out) / self.n
            self.stats.flops += f
            self.stats.dot_flops_by_shape[_type(out)] += f
        elif packet in _CONVOLUTIONS:
            self.stats.flops += 2.0 * out.numel() / self.n
        name = packet.__name__
        out_keys = [_key(t) for t in outs]
        if name == "_to_copy" and not in_backward and in_keys:
            leaf, box = in_keys[0], None
            if leaf in self.params:
                box = _box(ins[0], self.params[leaf][0])
            elif self._cast_of(leaf) is not None:
                leaf, box = self._cast_of(leaf), self.casts[leaf][2]
            if box is not None:
                for t, k in zip(outs, out_keys):
                    self.casts[k] = (StorageWeakRef(t.untyped_storage()),
                                     leaf, box)
        if not (func.is_view or name in NOT_COUNTED):
            state, n = self.state, self.n
            self.stats.bytes_accessed += sum(
                _nbytes(t) / state.get(k, n)
                for t, k in zip(ins + outs, in_keys + out_keys))
        reduced = False
        if self.tags and not self.explicit:
            reduced = self._propagate(func, name, args, out, ins, outs,
                                      in_backward)
        if self.repl and not (in_backward or self.backward_ran
                              or self.explicit):
            self._mark(ins, in_keys, outs, reduced)
        self._track_live(outs, out_keys)
        return out

    def _cast_of(self, key):
        """The key of the leaf whose live cast has storage ``key``, or
        None (``casts[key][2]``: the box of the leaf that it casts)."""
        got = self.casts.get(key)
        return got[1] if got is not None and not got[0].expired() else None

    def _track_live(self, outs, keys):
        for t, k in zip(outs, keys):
            if k in self.live or k in self.state:
                continue
            s = t.untyped_storage()
            self.live[k] = (StorageWeakRef(s), s.nbytes())
            self.live_bytes += s.nbytes()
        if self.stats.ops % 32 == 0:
            self._prune()

    def _prune(self):
        dead = [k for k, (ref, _) in self.live.items() if ref.expired()]
        for k in dead:
            self.live_bytes -= self.live.pop(k)[1]
        self.stats.peak_live_bytes = max(self.stats.peak_live_bytes,
                                         self.live_bytes / self.n)

    # -- tensor parallelism: which dimensions are sharded over MODEL_AXIS --

    def _all_reduce(self, axes, out):
        """The all-reduce over ``axes`` that ends an operation whose
        result ``out`` is the sum of the devices' partial results."""
        g = math.prod(self.sizes[ax] for ax in axes)
        self.stats.add_collective("all-reduce", _nbytes(out) * g / self.n, g,
                                  _type(out))

    def _mark(self, ins, keys, outs, reduced):
        """Follow the forward's split activations (an operation on one is
        split too, unless its result was all-reduced) and its tensors made
        from replicated leaves alone; a leaf that meets a split activation
        has a gradient that is partial or sliced on each device."""
        leaves, split, other = set(), False, False
        for t, k in zip(ins, keys):
            if k in self.repl:
                leaves.add(k)
            elif t in self.derived:
                leaves |= self.derived[t]
            elif t in self.tags or t in self.sharded:
                split = True
            else:
                other = True
        if split and leaves:
            self.model_partial |= leaves
        if split and not reduced:
            for t in outs:
                self.sharded[t] = True
        elif leaves and not (split or other):
            for t in outs:
                self.derived[t] = frozenset(leaves)

    def _propagate(self, func, name, args, out, ins, outs, in_backward):
        """Carry the ``model`` tags from ``ins`` to ``outs``, deriving the
        all-reduce that ends an operation on sharded operands; True where
        one did (the result is replicated)."""
        tagged = [t for t in ins if t in self.tags]
        if not tagged or not outs:
            return
        x = args[0] if args and isinstance(args[0], torch.Tensor) else None
        xt = self.tags.get(x) if x is not None else None
        new = None
        if name in _PRODUCT_NAMES:
            a, b = (args[1], args[2]) if name in ("addmm", "baddbmm") \
                else (args[0], args[1])
            ta = self.tags.get(a, (frozenset(),) * a.dim())
            tb = self.tags.get(b, (frozenset(),) * b.dim())
            contracted = _axes(ta[-1], tb[-2])
            if contracted:
                self._all_reduce(contracted, out)
                return True
            new = ta[:-1] + (tb[-1],) if a.dim() == 2 else \
                (ta[0] | tb[0], ta[1], tb[2])
        elif name in _VOCAB_REDUCTIONS:
            # the cross-entropy's reductions over a model-sharded dimension
            # (the logits' vocab): each device reduces its shard, and the
            # partial results are all-reduced, in the forward only (the
            # backward of each is elementwise, or a scatter into the local
            # shard)
            if xt is None or in_backward:
                return
            dims = args[1] if name == "logsumexp" else [args[1]]
            reduced = _axes(*(xt[d % x.dim()] for d in dims))
            for _ in range(_VOCAB_REDUCTIONS[name] if reduced else 0):
                self._all_reduce(reduced, out)
            return bool(reduced)
        elif name in _LOOKUP_NAMES:
            # the table is args[0]; the result, the sum of the shards'
            # rows, is replicated
            if xt is None or in_backward:
                return
            dims = [args[1] % x.dim()] if name == "index_select" else \
                [0] if name == "embedding" else \
                [d for d, ix in enumerate(args[1]) if ix is not None]
            looked_up = _axes(*(xt[d] for d in dims))
            if looked_up:
                self._all_reduce(looked_up, out)
                self.stats.lookups += 1
            return bool(looked_up)
        elif xt is None:
            new = None
        elif name in ("detach", "alias", "_to_copy", "clone", "slice",
                      "narrow", "split", "split_with_sizes"):
            new = xt
        elif name in ("view", "_unsafe_view", "_reshape_alias"):
            new = _reshape_tags(xt, tuple(x.shape), tuple(out.shape))
        elif name == "permute":
            new = tuple(xt[d % x.dim()] for d in args[1])
        elif name in ("transpose", "t"):
            d0, d1 = (args[1] % x.dim(), args[2] % x.dim()) \
                if name == "transpose" else (0, x.dim() - 1)
            lst = list(xt)
            lst[d0], lst[d1] = lst[d1], lst[d0]
            new = tuple(lst)
        elif name in ("expand", "repeat"):
            new = (frozenset(),) * (out.dim() - x.dim()) + xt
        elif name == "unsqueeze":
            d = args[1] % out.dim()
            new = xt[:d] + (frozenset(),) + xt[d:]
        elif name in ("select", "unbind"):
            d = (args[1] if len(args) > 1 else 0) % x.dim()
            new = xt[:d] + xt[d + 1:]
        elif name == "squeeze":
            dims = range(x.dim()) if len(args) < 2 else \
                ([args[1]] if isinstance(args[1], int) else args[1])
            drop = {d % x.dim() for d in dims if x.shape[d] == 1}
            new = tuple(t for d, t in enumerate(xt) if d not in drop)
        if new is None or not any(new):
            return
        for t in outs:
            if t.dim() == len(new):
                self.tags[t] = new


_PRODUCT_NAMES = {"mm", "addmm", "bmm", "baddbmm"}
_LOOKUP_NAMES = {"index", "embedding", "index_select"}
# all-reduces of the result: logsumexp's running max and its sum of
# exponentials, gather's (the gold logit) one
_VOCAB_REDUCTIONS = {"logsumexp": 2, "gather": 1}


# ---------------------------------------------------------------------------
# analyze
# ---------------------------------------------------------------------------


def _sanitize(spec, t, sizes):
    """The spec with the axes dropped that do not divide their dimension
    (``train.step.sanitize_specs``' rule), as a tuple of axis tuples."""
    out = []
    for i in range(t.dim()):
        entry = spec[i] if spec is not None and i < len(spec) else None
        axes = tuple(a for a in entry_axes(entry) if a in sizes)
        g = math.prod(sizes[a] for a in axes)
        out.append(axes if g > 0 and t.shape[i] % g == 0 else ())
    return out


def analyze(fn, *args, n_devices: int = 1, mesh=None, specs=None,
            params=None, target: str = "cuda", strips: int = 1) -> StepStats:
    """Run ``fn(*args)`` under the counting mode and return its
    :class:`StepStats`, per device of a mesh of ``n_devices``.

    ``mesh`` (a ``core.staging.Mesh``) names the axes and sizes the
    ``specs`` refer to: ``specs`` is a tuple of spec trees, one per
    argument (``None``: replicated); ``params`` is the tree of parameter
    tensors among the arguments, whose gradient reductions and FSDP
    gathers are derived from their specs (for a train step,
    ``state["params"]``). ``target`` is "cuda" or "cpu": the device whose
    routes ``meta`` tensors take. The arguments are usually ``meta``
    tensors; on real tensors the step runs for real (and updates a train
    state in place), and the count is the same. ``strips``: the
    micro-batches a train step runs its forward and backward in
    (``grad_accum``): FSDP's gathers and reduce-scatters are counted once
    a strip, as the ranks run them, the gradient reductions once a step
    (what ``fn`` runs itself, compat's collectives and the derived
    all-reduces of the products, is counted as it runs)."""
    if target not in ("cuda", "cpu"):
        raise ValueError(f"analyze: target must be 'cuda' or 'cpu', got "
                         f"{target!r}")
    sizes = dict(zip(mesh.axis_names, (int(s) for s in mesh.sizes))) \
        if mesh is not None else {}
    n = max(int(n_devices), 1)
    if sizes and math.prod(sizes.values()) != n:
        raise ValueError(f"analyze: the mesh {sizes} has "
                         f"{math.prod(sizes.values())} devices, not "
                         f"n_devices={n}")
    specs = tuple(specs) if specs is not None else (None,) * len(args)
    if len(specs) != len(args):
        raise ValueError(f"analyze: {len(specs)} spec trees for "
                         f"{len(args)} arguments")
    state, leaves, arg_bytes = {}, {}, 0.0
    for spec_tree, arg in zip(specs, args):
        for t, spec in _pairs(spec_tree, arg):
            axes = _sanitize(spec, t, sizes)
            shards = math.prod(sizes[a] for e in axes for a in e)
            k = _key(t)
            if k not in state:
                arg_bytes += _nbytes(t) / shards
            state[k] = shards
            leaves[k] = (t, axes)
    param_keys = {_key(t) for t in _tensors(params)} if params is not None \
        else set()
    missing = param_keys - set(leaves)
    if missing:
        raise ValueError("analyze: params must be tensors among the "
                         "arguments")
    run = _Run(n, sizes, target, state, {k: leaves[k] for k in param_keys})
    run.stats.argument_bytes = arg_bytes
    for k, (t, axes) in run.params.items():
        # model's sub-dimension starts below the axes before it in its entry
        tp = tuple(frozenset((a, math.prod(sizes[b] for b in e[:e.index(a)]))
                             for a in e if a == MODEL_AXIS) for e in axes)
        if any(tp):
            run.tags[t] = tp
    _RUNS.append(run)
    try:
        with run:
            fn(*args)
    finally:
        _RUNS.pop()
    run._prune()
    st = run.stats
    # 1. compat's explicit collectives were recorded as they ran
    # 2. the parameters' gathers and gradient reductions
    batch_axes = [a for a in sizes if a != MODEL_AXIS]
    def extent(box, t):
        """The share of ``t`` that ``box`` covers (1 without a box)."""
        return math.prod(hi - lo for lo, hi in box) / t.numel() \
            if box is not None and t.numel() else 1.0

    for k, (t, axes) in run.params.items():
        used = [a for e in axes for a in e]
        read = extent(run.extent.get(k), t)
        shard = _nbytes(t) * read / math.prod(sizes[a] for a in used)
        fsdp = [a for a in used if a in batch_axes]
        g_f = math.prod(sizes[a] for a in fsdp)
        label = _type(t) if read == 1.0 else f"{_type(t)} read {read:.4g}"
        if g_f > 1:
            st.count_short.add("collective: fsdp")
            gathers = (k in run.read_fwd) + (k in run.read_bwd)
            # a stacked leaf's layers are gathered one at a time: the
            # backward gathers the layers it reads (the audio encoder's
            # first layer reads no norm weight there: its input is the
            # frontend's)
            back = 1.0
            if k in run.stacked and k in run.extent_bwd:
                (lo, hi), (blo, bhi) = run.extent[k][0], run.extent_bwd[k][0]
                back = (bhi - blo) / (hi - lo)
            if k in run.read_fwd:
                st.add_collective("all-gather", shard * g_f, g_f, label,
                                  times=strips)
            if k in run.read_bwd:
                st.add_collective("all-gather", shard * back * g_f, g_f,
                                  label, times=strips)
            if run.backward_ran and gathers:
                st.add_collective("reduce-scatter", shard, g_f, label,
                                  times=strips)
        # over the batch axes that replicate the leaf, and over model for a
        # leaf replicated there that the forward applied to an activation
        # split over it (its gradient is partial or sliced on each device);
        # one applied to replicated activations alone (a norm's weight)
        # has its gradient whole on every device
        repl = [a for a in batch_axes if a not in used and sizes[a] > 1]
        if k in run.model_partial:
            repl.append(MODEL_AXIS)
        g_r = math.prod(sizes[a] for a in repl)
        if run.backward_ran and g_r > 1:
            st.add_collective("all-reduce", shard, g_r, label)
    return st
