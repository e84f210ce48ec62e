"""Param templates + common neural net ops.

A model is described by a *template* tree (nested dicts of ``P`` leaves).
From one template we derive the concrete init: a tree of tensors with the
same keys — the parameter tree every model function takes. The logical
axis names on ``P`` are kept (they describe the layout and will drive
sharding when the multi-device machinery is ported); nothing here reads
them.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

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
        return (x * std).to(dtype)

    out: dict = {}
    for path, p in _leaves(template):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = init_one(p)
    return out


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
        # tree_leaves walks keys in sorted order: rebuild in that order
        def rebuild(node):
            if isinstance(node, dict):
                return {k: rebuild(node[k]) for k in sorted(node)}
            return next(it)
        return ((loss.detach(), tree_map(lambda m: m.detach(), metrics)),
                rebuild(leaves))
    return fn


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


def repeat_kv(k, n_rep: int):
    """(B,S,Hkv,D) -> (B,S,Hkv*n_rep,D) by head repetition (GQA broadcast)."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d) \
        .reshape(b, s, h * n_rep, d)
