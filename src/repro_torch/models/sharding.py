"""Logical-axis -> mesh-axis policy (the lane-assignment rules).

The ``model`` axis is Ara's lane axis. Rules keep chained ops lane-local
(Megatron column->row pairing), shard experts over lanes when they divide
(expert parallelism), and optionally FSDP-shard the non-lane dim of params
over ``data``. The rules are the reference's; the mesh is the port's
``core.staging.Mesh`` (named axes and sizes, held as tensor dimensions on
one device by ``core/compat.py``) or a mesh of processes
(``core.compat.ProcessMesh``), where each rank holds its block of every
leaf (:func:`shard_params`, :func:`gather_params`) and its forward runs on
those blocks (:class:`TensorParallel` over ``model``, :class:`Fsdp` over
the batch axes).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import compat, step_analysis
from repro_torch.core.compat import PartitionSpec, entry_axes
from repro_torch.models.layers import (Rules, abstract_params, param_specs,
                                       rms_norm, rms_norm_split, tree_map)


@dataclasses.dataclass(frozen=True)
class MeshCtx:
    """Runtime mesh context threaded through forwards (None = single
    device)."""
    mesh: Optional[object]
    batch_axes: tuple = ("data",)
    model_axis: str = "model"

    @property
    def axis_sizes(self) -> dict:
        if self.mesh is None:
            return {}
        return dict(self.mesh.shape)

    @property
    def n_lanes(self) -> int:
        return self.axis_sizes.get(self.model_axis, 1)


def make_rules(cfg: ArchConfig, ctx: MeshCtx) -> Rules:
    model = ctx.model_axis
    # ZeRO-3/FSDP: shard the non-lane param dim over every batch axis
    # (pod included on multi-pod: 671B params cannot pod-replicate)
    fsdp_axis = tuple(a for a in ctx.batch_axes if a in ctx.axis_sizes) \
        if cfg.fsdp else None
    fsdp_axis = fsdp_axis or None
    mapping = (
        ("vocab", model),
        ("heads", model),
        ("kv_heads", model),
        ("head_dim", None),
        ("ffn", model),
        ("embed", fsdp_axis),
        ("embed2", fsdp_axis),      # second d_model dim (e.g. wo out)
        ("q_lora", fsdp_axis),
        ("kv_lora", fsdp_axis),
        ("experts", model if cfg.moe.expert_parallel else None),
        ("experts_ffn", model if not cfg.moe.expert_parallel else None),
        ("d_inner", model),         # ssm inner dim
        ("ssm_state", None),
        ("layers", None),
        ("batch", tuple(ctx.batch_axes)),
        ("seq", None),
        ("kv_seq", None),           # set to model for seq-sharded KV caches
    )
    mesh_shape = tuple(ctx.axis_sizes.items())
    return Rules(mapping=mapping, mesh_shape=mesh_shape)


def kv_cache_rules(cfg: ArchConfig, ctx: MeshCtx) -> Rules:
    """Decode caches: shard KV heads over lanes when they divide, else shard
    the sequence dim (sequence-parallel cache)."""
    model = ctx.model_axis
    lanes = ctx.n_lanes
    heads_shardable = cfg.n_kv_heads % max(lanes, 1) == 0 and not cfg.use_mla
    mapping = (
        ("batch", tuple(ctx.batch_axes)),
        ("kv_heads", model if heads_shardable else None),
        ("kv_seq", None if heads_shardable else model),
        ("head_dim", None),
        ("kv_lora", None),
        ("layers", None),
        ("groups", None),
        ("d_inner", model),
        ("ssm_state", None),
        ("heads", model),
        ("embed", None),
        ("seq", None),
    )
    return Rules(mapping=mapping, mesh_shape=tuple(ctx.axis_sizes.items()))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, as the reference's ``jax.sharding.NamedSharding``.
    One card holds every leaf whole, so it places nothing: it gives the
    shard shape each device of the mesh would hold."""
    mesh: object
    spec: PartitionSpec

    def shard_shape(self, global_shape) -> tuple:
        """Each device's shard of a leaf of ``global_shape``; raises the
        reference's ``ValueError`` where a sharded dimension does not
        divide by its mesh axes."""
        global_shape = tuple(global_shape)
        if len(self.spec) > len(global_shape):
            raise ValueError(f"{self} has more entries than the "
                             f"{len(global_shape)} dimensions of "
                             f"{global_shape}")
        sizes = dict(self.mesh.shape)
        out = list(global_shape)
        for dim, entry in enumerate(self.spec):
            n = math.prod(sizes[a] for a in entry_axes(entry))
            if global_shape[dim] % n:
                raise ValueError(
                    f"One of device_put args was given the sharding of "
                    f"{self}, which implies that the global size of its "
                    f"dimension {dim} should be divisible by {n}, but it is "
                    f"equal to {global_shape[dim]} (full shape: "
                    f"{global_shape})")
            out[dim] = global_shape[dim] // n
        return tuple(out)

    def block_index(self, global_shape, rank=None) -> tuple:
        """The slices of a process mesh's rank (its own by default) in a
        leaf of ``global_shape``: the block that rank holds."""
        shape = self.shard_shape(global_shape)
        cut = [entry_axes(e) for e in self.spec] \
            + [()] * (len(shape) - len(self.spec))
        return compat._slices(self.mesh, self.mesh.rank if rank is None
                              else rank, cut, shape)


def named_sharding_tree(spec_tree, mesh):
    return tree_map(lambda s: NamedSharding(mesh, s), spec_tree)


def sanitize_specs(spec_tree, aval_tree, mesh):
    """Drop mesh axes from dims they don't divide (e.g. batch=1 over
    data=16, 24 heads over 16 lanes): the reference's ``jax.jit`` shardings
    need even tiling, and replication is the conservative fallback."""
    sizes = dict(mesh.shape)

    def fix(spec, aval):
        if spec is None or not isinstance(spec, PartitionSpec):
            return spec
        new = []
        for i, entry in enumerate(spec):
            if entry is None or i >= len(aval.shape):
                new.append(None)
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            prod = math.prod(sizes.get(a, 1) for a in axes)
            new.append(entry if prod > 0 and aval.shape[i] % prod == 0
                       else None)
        return PartitionSpec(*new)

    return tree_map(fix, spec_tree, aval_tree)


# ---------------------------------------------------------------------------
# a rank's blocks on a mesh of processes
# ---------------------------------------------------------------------------


def shard_params(tree, specs, mesh):
    """The rank's block of every leaf of ``tree`` (global leaves: numpy
    arrays or tensors) on the process mesh ``mesh``, by ``specs`` after
    :func:`sanitize_specs` against the global shapes; each block a copy
    (a tensor stays on its device), so the global tree can be freed."""
    def block(spec, x):
        b = x[NamedSharding(mesh, spec).block_index(x.shape)]
        return b.clone() if isinstance(x, torch.Tensor) \
            else np.ascontiguousarray(b)
    return tree_map(block, sanitize_specs(specs, tree, mesh), tree)


def gather_params(tree, specs, mesh):
    """The inverse of :func:`shard_params`: every rank's blocks of each
    leaf, all-gathered over the axes that cut it (not counted: the
    checkpoint and the tests read the global tree), on every rank; each
    leaf a new tensor, a replicated one a copy of the rank's own.
    ``specs`` are the sanitized specs of the global tree
    (``sanitize_specs(specs, global tree, mesh)``, which
    :func:`shard_params` cut by)."""
    def whole(spec, x):
        cut = [tuple(entry_axes(e)) for e in spec] \
            + [()] * (x.dim() - len(spec))
        axes = tuple(a for a in mesh.axis_names if any(a in c for c in cut))
        return compat._assemble(x, mesh, cut, axes) if axes else x.clone()
    return tree_map(whole, specs, tree)


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """The ``model`` axis of a process mesh, as a rank's forward sees it:
    the rank holds its block of every leaf that the axis splits (heads,
    kv heads, ffn, the experts or their ffn, vocab), and Megatron's
    operators join the blocks' products (``core.compat.copy_to`` at the
    input of a product split by columns, ``reduce_from`` after one split
    by rows).
    ``vocab``: whether the axis splits the vocab; where it does not divide
    it, the rank holds the table (and the head) whole, as the reference's
    sanitized spec replicates it, and the lookup, the head and the
    cross-entropy are unsplit."""
    mesh: object
    axis: str = "model"
    vocab: bool = True

    @property
    def size(self) -> int:
        return self.mesh.shape[self.axis]

    @property
    def index(self) -> int:
        return self.mesh.coord(self.axis)

    def copy(self, x):
        return compat.copy_to(x, self.mesh, self.axis)

    def reduce(self, x):
        return compat.reduce_from(x, self.mesh, self.axis)

    def all_reduce(self, x, op: str = "SUM"):
        return compat.reduce_over(x, self.mesh, self.axis, op)

    def gather(self, x, dim: int = -1):
        return compat.gather_over(x, self.mesh, self.axis, dim)

    def start(self, local: int) -> int:
        """The global index of the rank's first row of a dimension whose
        block of ``local`` rows it holds."""
        return self.index * local


@dataclasses.dataclass(frozen=True)
class InnerSplit:
    """The model axis over a Mamba2 or mLSTM block (``models.ssm``), whose
    rules put every ``d_inner`` leaf on it. On a tensor-parallel rank
    (``index`` its coordinate) the rank holds each such leaf's contiguous
    block, as the reference's rules lay it, and runs the heads
    :meth:`part` gives; the fused projections' blocks do not line up with
    those heads, so the block re-lays its activations with the collectives
    below. On a stacked mesh whose model axis is above 1 (``index`` None)
    the one device runs every head and the same collectives are counted
    identities, each rank holding ``share`` of a batch tensor's rows, and
    the block runs inside :meth:`scope` (``step_analysis.explicit``), so
    that a count of the step takes what the ranks move. ``mesh`` None:
    one device, or a stacked mesh whose model axis does not divide the
    block's widths; every method is then the identity."""
    mesh: object = None
    axis: str = "model"
    size: int = 1
    index: Optional[int] = None
    share: float = 1.0

    def part(self, n: int) -> slice:
        """The rank's block of ``n`` (heads, or the channels of its heads):
        all of them off a rank."""
        if self.index is None:
            return slice(0, n)
        k = n // self.size
        return slice(self.index * k, (self.index + 1) * k)

    def copy(self, x):
        """Megatron's ``copy_to`` at a column-split product's input."""
        return x if self.mesh is None else compat.copy_to(
            x, self.mesh, self.axis, self.share)

    def reduce(self, x):
        """Megatron's ``reduce_from`` after a row-split product."""
        return x if self.mesh is None else compat.reduce_from(
            x, self.mesh, self.axis, self.share)

    def gather(self, x, weight: bool = False):
        """The ranks' column blocks of ``x`` all-gathered along its last
        dimension (its backward reduce-scatters the cotangent);
        ``weight``: ``x`` is a parameter, which every rank holds whatever
        its rows of the batch."""
        return x if self.mesh is None else compat.gather_from(
            x, self.mesh, self.axis, -1, 1.0 if weight else self.share)

    def psum(self, x):
        """The ranks' partial sums, all-reduced both ways: the sum, of
        which each rank reads its own part (a gate of every head, the
        norm's sum of squares), so the cotangent is all-reduced too."""
        return self.copy(self.reduce(x))

    def scatter(self, x):
        """The ranks' partial sums reduce-scattered by blocks of the last
        dimension (by heads); the backward all-gathers the cotangent."""
        return x if self.mesh is None else compat.scatter_over(
            x, self.mesh, self.axis, -1, self.share)

    def replicated(self, leaf):
        """A leaf that the rules replicate, read in the rank's heads only:
        its gradient all-reduced over the axis (``copy_to``)."""
        return leaf if self.mesh is None else compat.copy_to(
            leaf, self.mesh, self.axis)

    def weight(self, leaf, dtype=None):
        """``leaf`` (cast to ``dtype`` where given); under a count, a view
        that derives no collective of its own (the block counts its own)."""
        leaf = leaf if dtype is None else leaf.to(dtype)
        return leaf if self.mesh is None else step_analysis.untagged(leaf)

    def norm(self, x, gamma, eps: float, width: int):
        """RMSNorm over the whole of a dimension of ``width`` of which ``x``
        holds the rank's block: the float32 sum of squares all-reduced."""
        if self.mesh is None:
            return rms_norm(x, gamma, eps)
        return rms_norm_split(x, gamma, eps, self.psum, width)

    def scope(self):
        return contextlib.nullcontext() if self.index is not None \
            or self.mesh is None else step_analysis.explicit()


def inner_widths(cfg: ArchConfig) -> dict:
    """The widths of a Mamba2 or mLSTM block that the model axis must
    divide for :class:`InnerSplit`: its heads, ``d_inner``, and a Mamba2
    block's fused projection (z | x | B | C | dt) and convolution
    channels (x | B | C)."""
    s = cfg.ssm
    di = s.expansion * cfg.d_model
    if s.kind != "mamba2":
        return {"heads": cfg.n_heads, "d_inner": di}
    nh = di // s.head_dim
    return {"ssm heads": nh, "d_inner": di,
            "in_proj": 2 * di + 2 * s.state_dim + nh,
            "conv channels": di + 2 * s.state_dim}


def inner_split(cfg: ArchConfig, ctx: Optional[MeshCtx],
                tp: Optional[TensorParallel]) -> InnerSplit:
    """The :class:`InnerSplit` of ``cfg``'s mix layers: a tensor-parallel
    rank's (``tp``); on a stacked mesh whose model axis is above 1 and
    divides :func:`inner_widths`, the counted one (each rank holding its
    rows of the batch); else the identity."""
    if tp is not None:
        return InnerSplit(tp.mesh, tp.axis, tp.size, tp.index)
    if ctx is None or ctx.mesh is None or ctx.n_lanes == 1 \
            or compat.is_process_mesh(ctx.mesh) or cfg.family not in (
                "ssm", "hybrid") \
            or any(w % ctx.n_lanes for w in inner_widths(cfg).values()):
        return InnerSplit()
    return InnerSplit(ctx.mesh, ctx.model_axis, ctx.n_lanes, None,
                      ctx.n_lanes / math.prod(ctx.axis_sizes.values()))


def around_split(ctx: Optional[MeshCtx], tp: Optional[TensorParallel],
                 share: float = 1.0) -> tuple:
    """(into, out, scope) around work that the model axis splits by its
    tables' blocks: Megatron's ``copy_to`` / ``reduce_from`` on a
    tensor-parallel rank (``tp``); on a stacked mesh (tensor dimensions on
    one device, ``core.staging.Mesh``) whose model axis is above 1,
    ``core.compat``'s counted identities (each rank holding ``share`` of
    the tensor) inside ``step_analysis.explicit``, so that a count of the
    step takes the ranks' all-reduces in place of the ones it would derive
    from the split tables; identities elsewhere."""
    if tp is not None:
        return tp.copy, tp.reduce, contextlib.nullcontext()
    if ctx is not None and ctx.mesh is not None and ctx.n_lanes > 1 \
            and not compat.is_process_mesh(ctx.mesh):
        mesh, axis = ctx.mesh, ctx.model_axis
        return (lambda t: compat.copy_to(t, mesh, axis, share),
                lambda t: compat.reduce_from(t, mesh, axis, share),
                step_analysis.explicit())
    return (lambda t: t), (lambda t: t), contextlib.nullcontext()


def held_experts(cfg: ArchConfig, tp: Optional[TensorParallel]) -> range:
    """The global indices of the live experts among the rows of a rank's
    expert tables: the first ``n_experts`` of the (padded) tables, or, on
    a rank whose model axis splits the experts (``expert_parallel`` under
    ``tp``), the live ones of its block. The one-hot dispatch reads these
    rows alone; the expert-parallel route reads every row of a rank's
    block of the experts (held, or re-laid by :func:`relay_experts`)."""
    m = cfg.moe
    n_local, start = m.n_experts_padded, 0
    if tp is not None and m.expert_parallel:
        n_local = m.n_experts_padded // tp.size
        start = tp.start(n_local)
    return range(start, max(start, min(start + n_local, m.n_experts)))


# the dimension of each expert table that ``experts_ffn`` names
# (``models.moe.moe_template``)
EXPERT_FFN_DIMS = {"w_gate": 2, "w_up": 2, "w_down": 1}


def relay_experts(p: dict, tp: TensorParallel) -> dict:
    """``p`` (a MoE layer's parameters on a tensor-parallel rank whose
    model axis splits each expert's FFN: ``(E_pad, d, f/m)`` of ``w_gate``
    and ``w_up``, ``(E_pad, f/m, d)`` of ``w_down``) with those tables
    re-laid as the rank's block of the experts, whole: ``(E_pad/m, d,
    f)`` and ``(E_pad/m, f, d)``, the layout the expert-parallel body
    takes (``models.moe.moe_ep_shard_map``), as the reference's
    partitioner reshards them for its in_spec. One all-to-all a table
    over ``model`` (``core.compat.all_to_all_over``), counted; its
    backward re-lays the gradient back to the rank's FFN block."""
    return dict(p, **{k: compat.all_to_all_over(p[k], tp.mesh, tp.axis, 0, d)
                      for k, d in EXPERT_FFN_DIMS.items()})


def vocab_split(tp: Optional[TensorParallel]) -> Optional[TensorParallel]:
    """``tp`` where it splits the vocab, else None (one device, or the
    table whole on every rank)."""
    return tp if tp is not None and tp.vocab else None


def tensor_parallel(cfg: ArchConfig,
                    ctx: Optional[MeshCtx]) -> Optional[TensorParallel]:
    """The rank's :class:`TensorParallel` where ``ctx`` holds a process mesh
    whose model axis is above 1; None otherwise (one device, the stacked
    route, a data-parallel mesh of processes). Every family runs on it: the
    dense family; the MoE family, with GQA or MLA, whether the model axis
    splits its experts' FFN (``expert_parallel=False``: each expert's FFN
    split as the dense FFN) or its experts (``expert_parallel=True``: each
    rank the block of experts the reference's rules give it), on the
    one-hot dispatch or the expert-parallel route (``models.moe.
    moe_block``: there each rank runs its block of the experts, held or
    re-laid by :func:`relay_experts`); the SSM and hybrid families, each
    mix layer on the rank's heads (:class:`InnerSplit`), the hybrid
    family's shared block as a dense block; the vision family's cross
    layers and the encoder-decoder family's encoder and cross-attention on
    the rank's heads and FFN columns, as its self-attention layers."""
    if ctx is None or not compat.is_process_mesh(ctx.mesh) \
            or ctx.n_lanes == 1:
        return None
    return TensorParallel(ctx.mesh, ctx.model_axis,
                          vocab=cfg.vocab_size % ctx.n_lanes == 0)


# which queue item ports the SSM, hybrid, vision and encoder-decoder
# families' FSDP step at model > 1
FSDP_MODEL_QUEUE = "the SSM, hybrid, vision and encoder-decoder families " \
    "under FSDP with model > 1 (ROADMAP Queue A, A13c item 2.6)"


def _split_widths(cfg: ArchConfig) -> dict:
    """The widths of ``cfg``'s leaves that the model axis splits (the kv
    heads and the vocab aside): heads, the dense FFN's columns where the
    model has dense FFNs, the mix layers' (:func:`inner_widths`), the
    experts (``expert_parallel``) or the experts' FFN (else), as the
    reference's rules put them on ``model``, and the shared experts'
    FFN."""
    out = {"heads": cfg.n_heads_padded}
    if cfg.family in ("ssm", "hybrid"):
        out.update(inner_widths(cfg))
    if not cfg.is_moe:
        out["ffn"] = cfg.d_ff
        return out
    m = cfg.moe
    if m.n_dense_layers or cfg.mtp_depth:
        out["ffn"] = m.dense_d_ff or cfg.d_ff
    if m.expert_parallel:
        out["experts"] = m.n_experts_padded
    else:
        out["experts_ffn"] = m.expert_d_ff
    if m.n_shared_experts:
        out["shared ffn"] = m.expert_d_ff * m.n_shared_experts
    return out


def check_tensor_parallel(cfg: ArchConfig, ctx: Optional[MeshCtx],
                          cache: bool = False):
    """Raises ``NotImplementedError``, naming its queue item, for a layout
    that the tensor-parallel route over processes does not take: a leaf
    split over model that the axis does not divide (other than the kv
    heads, which a rank then reads whole, and the vocab, which it then
    holds whole; a mix layer's heads and fused widths among them); with
    ``cache`` a KV cache split over ``kv_seq`` (MLA's latent cache has no
    head axis: every rank holds it whole).
    Nothing off a process mesh with a model axis above 1."""
    if ctx is None or not compat.is_process_mesh(ctx.mesh) \
            or ctx.n_lanes == 1:
        return
    m = ctx.n_lanes
    head = f"{cfg.name} with {ctx.model_axis}={m} on a process mesh"
    odd = [f"{k} {n}" for k, n in _split_widths(cfg).items() if n % m]
    if odd:
        raise NotImplementedError(
            f"{head}: {', '.join(odd)} do not split over {m} ranks; a rank "
            f"holding a leaf that the model axis should split whole "
            f"(ROADMAP Queue A, A13c item 2.6) is not ported")
    if cache and not cfg.use_mla and cfg.n_kv_heads % m:
        raise NotImplementedError(
            f"{head}: {cfg.n_kv_heads} kv heads do not split over {m} "
            f"ranks, so the reference splits the KV cache over kv_seq "
            f"(kv_cache_rules); a sequence-split cache over processes "
            f"(ROADMAP Queue A, A13c item 2.6) is not ported")


# ---------------------------------------------------------------------------
# FSDP over the batch axes of a mesh of processes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Recipe:
    """How to gather a leaf's blocks again: the rank's block (a detached
    view of the parameter), the mesh, the axes and the dimension."""
    block: torch.Tensor
    mesh: object
    axes: tuple
    dim: int

    def gathered(self, dtype):
        return compat.gather_over(self.block, self.mesh, self.axes,
                                  self.dim).to(dtype)

    def key(self, dtype) -> tuple:
        """What two recipes of one block, gathered to ``dtype``, share."""
        b = self.block
        return (b.device, b.untyped_storage().data_ptr(), b.storage_offset(),
                tuple(b.shape), tuple(b.stride()), self.axes, self.dim, dtype)


class _Slot:
    """A leaf gathered again for the backward, shared by every saved
    tensor that views it (:attr:`pending` of them not unpacked yet): the
    first unpack gathers it, the last frees it."""

    __slots__ = ("pending", "tensor", "__weakref__")

    def __init__(self):
        self.pending, self.tensor = 0, None


# the slots of the packed tensors still alive, by their recipe's key
_SLOTS: "weakref.WeakValueDictionary[tuple, _Slot]" = \
    weakref.WeakValueDictionary()


@dataclasses.dataclass(frozen=True)
class _Packed:
    """A saved tensor that views a gathered leaf (or its cast): its recipe,
    where it lies in the gathered tensor, and the slot it shares with the
    other saved views of the same leaf."""
    recipe: _Recipe
    dtype: torch.dtype
    size: tuple
    stride: tuple
    offset: int
    slot: _Slot


_SCOPES: list = []


class _Regather:
    """A block's forward under autograd's saved-tensor hooks: a tensor that
    a product saves for its backward and that views a leaf gathered in the
    block (or the leaf's cast to the compute dtype) is packed as a handle
    to the rank's block, and gathered again when the backward unpacks it;
    the saved views of one leaf share one such gather (one more counted
    all-gather a leaf, however many products read it, in this scope or
    another: the MTP head reads the main head's). Every other saved
    tensor is kept as it is. So the gathered leaf is freed after the
    block's forward, as FSDP frees it, with or without a checkpoint of the
    block."""

    def __init__(self):
        self.held = []          # (weak reference to a gathered tensor, recipe)
        self.hooks = torch.autograd.graph.saved_tensors_hooks(self.pack,
                                                              self.unpack)

    def hold(self, t, recipe):
        self.held.append((weakref.ref(t), recipe))

    def pack(self, t):
        ptr = t.untyped_storage().data_ptr()
        for ref, recipe in self.held:
            g = ref()
            if g is not None and ptr and g.device == t.device \
                    and g.untyped_storage().data_ptr() == ptr:
                key = recipe.key(g.dtype)
                slot = _SLOTS.get(key)
                if slot is None:
                    slot = _SLOTS[key] = _Slot()
                slot.pending += 1
                return _Packed(recipe, g.dtype, tuple(t.size()),
                               tuple(t.stride()), t.storage_offset(), slot)
        return t

    @staticmethod
    def unpack(saved):
        if not isinstance(saved, _Packed):
            return saved
        slot = saved.slot
        full = slot.tensor
        if full is None:
            full = slot.tensor = saved.recipe.gathered(saved.dtype)
        slot.pending -= 1
        if slot.pending <= 0:
            slot.tensor = None
        return full.as_strided(saved.size, saved.stride, saved.offset)

    def __enter__(self):
        _SCOPES.append(self)
        self.hooks.__enter__()
        return self

    def __exit__(self, *exc):
        self.hooks.__exit__(*exc)
        _SCOPES.pop()


def _hold(full, low, recipe):
    """Within a :class:`_Regather` scope, the gathered leaf ``full`` and its
    cast ``low`` are packed as handles to ``recipe`` when a product saves
    them."""
    if _SCOPES:
        _SCOPES[-1].hold(full, recipe)
        _SCOPES[-1].hold(low, recipe)


@dataclasses.dataclass(frozen=True)
class Fsdp:
    """FSDP (ZeRO-3) over the batch axes of a process mesh, as a rank's
    forward sees it: the rank holds its block of every leaf whose
    sanitized spec cuts a dimension over those axes (``embed``,
    ``embed2``, ``q_lora``, ``kv_lora``), and :meth:`gather` all-gathers a
    tree's blocks at their use into the rank's ``model`` block of each
    leaf (``core.compat.gather_from``: its backward reduce-scatters the
    gradient back to the block). Within :meth:`regather`, the gathered
    leaves that the backward reads are gathered again there, not kept.
    ``specs``: the sanitized spec tree of the parameters."""
    mesh: object
    axes: tuple
    specs: dict

    @property
    def size(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.axes)

    def dim(self, spec) -> Optional[int]:
        """The dimension that ``spec`` cuts over the batch axes, or None."""
        return next((i for i, e in enumerate(spec)
                     if any(a in self.axes for a in entry_axes(e))), None)

    def gather_leaf(self, x, spec, dtype=None, lead: int = 0,
                    gathered=None, held=None):
        """The rank's block ``x`` of a leaf of sanitized spec ``spec``
        gathered over the batch axes that cut it (``x`` as it is where
        none does: a leaf FSDP leaves whole keeps its stored dtype), then
        cast to ``dtype`` (None: the stored dtype: the gather moves the
        leaf as it is stored). ``lead``: leading dimensions of the spec
        that ``x`` lacks (1 for a layer of a stacked leaf); ``gathered``:
        ``x`` already gathered (the tied head reads the table that the
        lookup gathered), to cast and hold; ``held``: a list that takes
        ``(gathered, cast, recipe)`` of the leaf (:class:`Reused` holds
        them in each later use's scope)."""
        dim = self.dim(spec)
        if dim is None:
            return x
        axes = tuple(a for a in entry_axes(spec[dim]) if a in self.axes)
        full = gathered if gathered is not None else compat.gather_from(
            x, self.mesh, axes, dim - lead)
        low = full if dtype is None else full.to(dtype)
        recipe = _Recipe(x.detach(), self.mesh, axes, dim - lead)
        if held is not None:
            held.append((full, low, recipe))
        _hold(full, low, recipe)
        return low

    def gather(self, tree, specs, dtype=None, lead: int = 0, held=None):
        """:meth:`gather_leaf` over a tree of blocks and its specs."""
        return tree_map(lambda x, s: self.gather_leaf(x, s, dtype, lead,
                                                      held=held),
                        tree, specs)

    def regather(self):
        """A scope (:class:`_Regather`) for a block's forward whose
        backward reads its gathered leaves."""
        return _Regather()


class Reused:
    """Under FSDP, a block's leaves that ``uses`` blocks of one forward read
    (the hybrid family's shared attention block, after each group of
    ``attn_every`` layers): :meth:`get` gathers them at the first use
    (into the compute dtype ``dtype``) and hands the same gathered copy to
    each later use, which holds it in its own :class:`_Regather` scope,
    and lets it go after the last. So each leaf moves one all-gather in
    the forward however many groups read it. For the backward it is
    gathered once more: a checkpoint's recompute makes the ``uses`` calls
    again (the first gathers, the last lets it go), and without a
    checkpoint the saved views of every use share one gather
    (:class:`_Slot`). Its gradient, summed over the uses, is
    reduce-scattered once."""

    def __init__(self, fs: Fsdp, tree, specs, dtype, uses: int):
        self.fs, self.tree, self.specs, self.dtype = fs, tree, specs, dtype
        self.uses, self.left = max(int(uses), 1), 0
        self.copy, self.held = None, []

    def get(self):
        """The gathered leaves, for one use."""
        if self.left == 0:
            self.held = []
            self.copy = self.fs.gather(self.tree, self.specs, self.dtype,
                                       held=self.held)
            self.left = self.uses
        else:
            for full, low, recipe in self.held:
                _hold(full, low, recipe)
        out = self.copy
        self.left -= 1
        if self.left == 0:
            self.copy, self.held = None, []
        return out


def _fsdp_axes(cfg: ArchConfig, ctx: Optional[MeshCtx]) -> tuple:
    """The batch axes that FSDP splits over on ``ctx``'s mesh of processes
    (those of extent above 1 in all), or () where it does not apply."""
    if ctx is None or not cfg.fsdp or not compat.is_process_mesh(ctx.mesh):
        return ()
    axes = tuple(a for a in ctx.batch_axes if a in ctx.axis_sizes)
    return axes if math.prod(ctx.axis_sizes[a] for a in axes) > 1 else ()


def fsdp_split(cfg: ArchConfig, ctx: Optional[MeshCtx]) -> Optional[Fsdp]:
    """The rank's :class:`Fsdp` where ``ctx`` holds a process mesh whose
    batch axes' extent is above 1 and ``cfg.fsdp`` is set; None otherwise
    (one device, the stacked route, or FSDP off)."""
    axes = _fsdp_axes(cfg, ctx)
    if not axes:
        return None
    from repro_torch.models import transformer as tf
    tmpl = tf.model_template(cfg)
    specs = sanitize_specs(param_specs(tmpl, make_rules(cfg, ctx)),
                           abstract_params(tmpl), ctx.mesh)
    return Fsdp(ctx.mesh, axes, specs)


def serve_ctx(cfg: ArchConfig, ctx: Optional[MeshCtx]):
    """``ctx`` as a serve step over a batch split by rows runs it: under
    FSDP (:func:`fsdp_split`) each rank serves its own rows of the batch,
    so the batch axes are declared local, as the train step declares them
    (a MoE model's dispatch group then spans the ranks' rows, as on one
    device); ``ctx`` as it is elsewhere."""
    if fsdp_split(cfg, ctx) is None:
        return ctx
    return dataclasses.replace(ctx, mesh=ctx.mesh.with_local(ctx.batch_axes))


def check_fsdp(cfg: ArchConfig, ctx: Optional[MeshCtx]):
    """Raises ``NotImplementedError``, naming its queue item, for FSDP over
    processes that the port does not run: the SSM, hybrid, vision and
    encoder-decoder families on a mesh whose model axis is above 1
    (:data:`FSDP_MODEL_QUEUE`: the mix layers gathered by FSDP beside their
    re-lay over ``model``, the cross layers' and the encoder's gathers
    beside their heads' split). Every family's train, prefill and decode
    steps, and the serving engine of every family that serves on one
    device, run FSDP over the batch axes where the model axis is 1, the
    dense and the MoE families' at any model axis. Nothing where FSDP
    does not apply (:func:`fsdp_split`)."""
    axes = _fsdp_axes(cfg, ctx)
    if not axes:
        return
    if cfg.family not in ("dense", "moe") and ctx.n_lanes > 1:
        head = f"{cfg.name} with fsdp=True over {'x'.join(axes)} on a " \
            f"process mesh"
        raise NotImplementedError(
            f"{head} with {ctx.model_axis}={ctx.n_lanes}: the {cfg.family} "
            f"family under FSDP and the model axis; {FSDP_MODEL_QUEUE} are "
            f"not ported")
