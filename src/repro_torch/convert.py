"""Bring the reference's trees over: nested dicts of numpy arrays in, the
port's trees (nested dicts of tensors, same keys, same stacked-layer
layout) out. The port never sees an array of the reference's framework —
a caller converts its leaves to numpy first."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.precision import torch_dtype
from repro_torch.device import resolve_device


def _leaf(x, device, dtype):
    # torch.tensor copies: the tree never aliases the caller's arrays
    # (cache tensors are written in place)
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":    # numpy's extension type: via float32,
        t = torch.tensor(a.astype(np.float32)).to(torch.bfloat16)  # exact
    else:
        t = torch.tensor(a)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, device=None, dtype=None):
    """Parameter tree from nested dicts of numpy arrays. ``dtype`` (a dtype
    or its name) recasts the floating leaves; ``None`` keeps each leaf's
    own. ``device`` defaults to the card and raises without one."""
    device = resolve_device(device)
    dtype = None if dtype is None else torch_dtype(dtype)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _leaf(node, device, dtype)
    return walk(tree)


def cache_from_numpy(cache, device=None):
    """KV cache ``{"k", "v", "lengths"}`` from numpy arrays; ``lengths``
    becomes int32."""
    device = resolve_device(device)
    out = {k: _leaf(v, device, None) for k, v in cache.items()}
    out["lengths"] = out["lengths"].to(torch.int32)
    return out


def opt_state_from_numpy(opt, device=None):
    """AdamW state ``{"m", "v", "step"}``: the moment trees keep each
    leaf's dtype (bfloat16 moments included), ``step`` becomes an int32
    scalar."""
    device = resolve_device(device)
    return {"m": params_from_numpy(opt["m"], device),
            "v": params_from_numpy(opt["v"], device),
            "step": torch.tensor(int(np.asarray(opt["step"])),
                                 dtype=torch.int32, device=device)}


def train_state_from_numpy(state, device=None, dtype=None):
    """A train state ``{"params", "opt": {"m", "v", "step"}}``, so that both
    packages can step from the same state; ``dtype`` recasts the
    parameters only."""
    device = resolve_device(device)
    return {"params": params_from_numpy(state["params"], device, dtype),
            "opt": opt_state_from_numpy(state["opt"], device)}
