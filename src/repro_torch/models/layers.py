"""Param templates + common neural net ops.

A model is described by a *template* tree (nested dicts of ``P`` leaves).
From one template we derive the concrete init (a tree of tensors with the
same keys — the parameter tree every model function takes), shape-only
stand-ins (``meta`` tensors; no memory) and PartitionSpecs (logical axes
-> mesh axes, through :class:`Rules`), as in the reference.

Sharding follows the Ara lane model: the "model" mesh axis is the lane
axis. On one card a spec describes how a mesh of devices would hold a
tensor (``core/compat.py`` holds such a mesh as tensor dimensions).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.core.compat import PartitionSpec
from repro_torch.core.precision import torch_dtype
from repro_torch.device import resolve_device

# ---------------------------------------------------------------------------
# Param template
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class P:
    """One parameter: shape + logical axes (+ init law)."""
    shape: tuple
    axes: tuple                      # logical axis name (or None) per dim
    init: str = "normal"             # normal | zeros | ones | fan_in
    std: float = 0.02

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def _leaves(tree, path=()):
    if isinstance(tree, P):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        raise TypeError(f"bad template node at {path}: {type(tree)}")


def _map_template(tree, fn):
    if isinstance(tree, P):
        return fn(tree)
    return {k: _map_template(v, fn) for k, v in tree.items()}


def init_params(template, generator: torch.Generator,
                dtype=torch.float32, device=None):
    """Concrete init on ``device`` (default: the card; raises without one).

    Same init laws as the reference (``zeros`` / ``ones`` / ``normal`` at
    ``std`` / ``fan_in`` at ``1/sqrt(fan_in)``), drawn in fp32 from
    ``generator`` — which must live on ``device`` — leaf by leaf in sorted
    path order, so one seed gives one tree. The numbers are not the
    reference's: a parity test converts the reference's tree instead
    (:mod:`repro_torch.convert`)."""
    device = resolve_device(device)
    dtype = torch_dtype(dtype)

    def init_one(p: P):
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=dtype, device=device)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=dtype, device=device)
        if p.init == "fan_in":
            fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
            std = 1.0 / math.sqrt(max(fan_in, 1))
        else:
            std = p.std
        x = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                        device=device)
        # scaled in place: a full-width expert table is ~15 GB in fp32
        return x.mul_(std).to(dtype)

    out: dict = {}
    for path, p in _leaves(template):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = init_one(p)
    return out


def abstract_params(template, dtype=torch.float32):
    """Shape-and-dtype stand-ins on the ``meta`` device: no memory is
    allocated (the reference's ``ShapeDtypeStruct`` tree)."""
    dtype = torch_dtype(dtype)
    return _map_template(template, lambda p: torch.empty(p.shape, dtype=dtype,
                                                         device="meta"))


@dataclasses.dataclass(frozen=True)
class Rules:
    """Logical-axis -> mesh-axis mapping (the lane-assignment policy)."""
    mapping: tuple                    # tuple of (logical, mesh_axis_or_tuple)
    mesh_shape: tuple                 # tuple of (mesh_axis, size)

    def mesh_size(self, axis) -> int:
        if isinstance(axis, (tuple, list)):
            return math.prod(self.mesh_size(a) for a in axis)
        return dict(self.mesh_shape).get(axis, 1)

    def spec_for(self, p: P) -> PartitionSpec:
        m = dict(self.mapping)
        used = set()
        out = []
        for dim, ax in zip(p.shape, p.axes):
            mesh_ax = m.get(ax)
            if mesh_ax is None:
                out.append(None)
                continue
            flat = tuple(mesh_ax) if isinstance(mesh_ax, (tuple, list)) \
                else (mesh_ax,)
            if any(a in used for a in flat):
                out.append(None)  # a mesh axis may shard only one dim
                continue
            # shard only when the dim is at least the axis size (the
            # reference accepts the padding an uneven split would need)
            size = self.mesh_size(mesh_ax)
            if dim >= size and size > 1:
                used.update(flat)
                out.append(mesh_ax if not isinstance(mesh_ax, list)
                           else tuple(mesh_ax))
            else:
                out.append(None)
        return PartitionSpec(*out)


def param_specs(template, rules: Rules):
    return _map_template(template, rules.spec_for)


def tree_leaves(tree):
    """The tensors of a nested dict, in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    else:
        yield tree


def tree_map(fn, tree, *rest):
    """``fn`` over every tensor of a nested dict, keys kept; with further
    trees of the same keys, ``fn`` takes one leaf of each."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def value_and_grad(loss_fn):
    """The twin of ``jax.value_and_grad(loss_fn, has_aux=True)`` over a
    dict-of-tensors tree: ``loss_fn(params, batch) -> (loss, metrics)``
    becomes ``(params, batch) -> ((loss, metrics), grads)``, the grads a
    tree of the params' keys. The params are differentiated through
    detached views (no copy); loss and metrics come back detached."""
    def fn(params, batch):
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, metrics = loss_fn(leaves, batch)
        flat = list(tree_leaves(leaves))
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        it = iter(g if g is not None else torch.zeros_like(p)
                  for g, p in zip(grads, flat))
        return ((loss.detach(), tree_map(lambda m: m.detach(), metrics)),
                _fill_like(leaves, it))
    return fn


def _fill_like(tree, it):
    """A tree of ``tree``'s keys whose leaves are taken from ``it`` in the
    order :func:`tree_leaves` walks (sorted keys). A module-level function:
    a recursive closure would form a reference cycle that keeps ``it``, and
    the gradients it holds, alive until the cycle collector runs."""
    if isinstance(tree, dict):
        return {k: _fill_like(tree[k], it) for k in sorted(tree)}
    return next(it)


def tree_size_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


# ---------------------------------------------------------------------------
# Common ops
# ---------------------------------------------------------------------------


def widen(x):
    """``x`` in at least fp32: narrow floats are widened to fp32, float64
    stays as it is (so a float64 run is float64 throughout)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def rms_norm(x, gamma, eps=1e-5):
    """fp32 statistics; cast back to x's dtype *before* the gamma multiply."""
    dt = x.dtype
    x32 = widen(x)
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * gamma.to(dt)


def rms_norm_split(x, gamma, eps, psum, width: int):
    """:func:`rms_norm` over a last dimension of ``width`` split over ranks:
    ``x`` and ``gamma`` hold the rank's block of it, and ``psum`` sums the
    ranks' fp32 sums of squares ``(..., 1)`` (an all-reduce)."""
    dt = x.dtype
    x32 = widen(x)
    var = psum(x32.square().sum(dim=-1, keepdim=True)) / width
    return (x32 * torch.rsqrt(var + eps)).to(dt) * gamma.to(dt)


def activation_fn(name: str):
    """``gelu`` is the tanh approximation, the reference's default."""
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def rotary_embedding(positions, head_dim, theta):
    """positions (...,) int -> cos/sin (..., head_dim/2), fp32."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (..., S, H, D); cos/sin (..., S, D/2) broadcast over heads.
    Half-split layout (first half / second half), not interleaved; the
    rotation runs in fp32 (cos/sin are fp32) and is cast back to x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]  # broadcast over heads axis
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def shard(x, *axes):
    """The reference's ``with_sharding_constraint`` by raw PartitionSpec
    entries: a layout hint to the partitioner. One card holds the whole
    tensor, so it is the identity."""
    del axes
    return x


def repeat_kv(k, n_rep: int):
    """(B,S,Hkv,D) -> (B,S,Hkv*n_rep,D) by head repetition (GQA broadcast)."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d) \
        .reshape(b, s, h * n_rep, d)
