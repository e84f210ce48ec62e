"""Public wrappers for the ported kernels, Policy-routed.

Multi-precision: every wrapper takes ``policy`` (core.precision.Policy) —
inputs are cast to ``policy.compute_dtype`` before the kernel, so bf16/f16
compute with fp32 in-kernel accumulation is one kwarg away. ``policy.lmul``
likewise flows into the block-shape contract (core.stripmine.lmul_tile)
unless the caller passes ``lmul=`` explicitly — register grouping and
element width travel together, as in vsetvl.

Every kernel of the reference has its wrapper here: ``matmul``,
``matmul_int8`` and the logits head over them, ``axpy``, ``conv2d``,
``flash_attention`` and ``ssm_scan``. Each reaches a hand-written CUDA
kernel for CUDA tensors and its plain PyTorch version for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core.precision import Policy, dtype_name, torch_dtype
from repro_torch.kernels.attention import flash_attention as _flash
from repro_torch.kernels.axpy import axpy as _axpy
from repro_torch.kernels.conv import conv2d_direct as _conv
from repro_torch.kernels.matmul import matmul as _matmul
from repro_torch.kernels.matmul import matmul_int8 as _matmul_int8
from repro_torch.kernels.ssm_scan import ssm_scan as _ssm


def _cast(policy, *tensors):
    if policy is None:
        return tensors
    dt = torch_dtype(policy.compute_dtype)
    return tuple(t.to(dt) for t in tensors)


def matmul(a, b, *, policy: Policy | None = None, **kw):
    if policy is not None:
        kw.setdefault("lmul", policy.lmul)
    a, b = _cast(policy, a, b)
    return _matmul(a, b, **kw)


def matmul_int8(a, b, *, policy: Policy | None = None, **kw):
    """SEW=8 route: int8 inputs, int32 accumulation, optional int8
    requantize (``out_dtype=torch.int8, shift=``). No dtype cast here —
    int8 operands are the caller's quantization decision."""
    if policy is not None:
        kw.setdefault("lmul", policy.lmul)
    return _matmul_int8(a, b, **kw)


def axpy(alpha, x, y, *, policy: Policy | None = None, **kw):
    if policy is not None:
        kw.setdefault("lmul", policy.lmul)
    x, y = _cast(policy, x, y)
    return _axpy(alpha, x, y, **kw)


def conv2d(x, w, *, policy: Policy | None = None, **kw):
    x, w = _cast(policy, x, w)
    return _conv(x, w, **kw)


def flash_attention(q, k, v, *, policy: Policy | None = None, **kw):
    """Blockwise flash attention with a training-grade backward (see
    kernels/attention.py). ``policy.attn_bq``/``attn_bk`` pick the block
    shapes; ``kv_valid`` passes through uncast (it is a mask, not data)."""
    if policy is not None:
        kw.setdefault("bq", policy.attn_bq)
        kw.setdefault("bk", policy.attn_bk)
    q, k, v = _cast(policy, q, k, v)
    return _flash(q, k, v, **kw)


def ssm_scan(q, k, v, log_decay, scale, **kw):
    return _ssm(q, k, v, log_decay, scale, **kw)


# ---------------------------------------------------------------------------
# Serving logits head (Policy-routed degrade ladder)
# ---------------------------------------------------------------------------


def _block_tiles(m: int, k: int, n: int, b: int = 128) -> bool:
    """True when (m,k)@(k,n) meets the matmul wrappers' block contract at
    their default blocks."""
    return all(d % min(b, d) == 0 for d in (m, k, n))


def lm_head_route(m: int, k: int, n: int, compute_dtype: str,
                  device=None) -> str:
    """Which path :func:`lm_head` takes for an (m,k)@(k,n) head at a given
    compute dtype — host-side, so the serving engine can log the route.

    ``device`` is where the operands live (default: the CPU's answer, which
    is the reference's). On a CUDA device every narrow head is a ``cuda-*``
    route: the kernels mask their own ragged edges, so a shape that the
    default blocks do not tile still runs through them and nothing there
    gives way to an einsum."""
    if compute_dtype in ("float32", "float64"):
        return "einsum-fp32"
    on_card = device is not None and torch.device(device).type == "cuda"
    if not on_card and not _block_tiles(m, k, n):
        return "einsum-fallback"
    return "cuda-int8" if compute_dtype == "int8" \
        else f"cuda-{dtype_name(compute_dtype)}"


def lm_head(x, w, *, compute_dtype: str = "float32"):
    """Logits head ``x (B,S,D) @ w (D,V) -> (B,S,V) float32``, routed by
    compute dtype — the serving degrade ladder's consumer of the Policy
    kernels, so the quantized datapath actually carries traffic:

    - ``float32``: plain einsum (the exact path).
    - ``bfloat16``/``float16``: the :func:`matmul` kernel at the narrow
      width with fp32 accumulation (§III-E4's 2x rate).
    - ``int8``: dynamic symmetric per-tensor quantization of both
      operands through :func:`matmul_int8` (int32 accumulation, the 8x
      Ara rung), dequantized to fp32 logits. The quantization is plain
      tensor code around the kernel, as in the reference, and quantizes
      the whole of ``w`` on every call.

    Shapes that don't meet the kernels' block contract at the default
    blocks: for CPU tensors they fall back to an einsum at the requested
    width, as in the reference; for CUDA tensors they go through the same
    kernels with whole-dimension blocks (``lm_head_route`` reports which
    path ran).
    """
    b, s, d = x.shape
    d2, v = w.shape
    if d != d2:
        raise ValueError(f"lm_head: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} disagree on the model width")
    m = b * s
    route = lm_head_route(m, d, v, compute_dtype, device=x.device)
    # whole-dimension blocks always meet the block contract
    blocks = {} if _block_tiles(m, d, v) else {"bm": m, "bn": v, "bk": d}
    x2 = x.reshape(m, d)
    if route == "einsum-fp32":
        out = x2.float() @ w.float()
    elif route == "cuda-int8":
        x32, w32 = x2.float(), w.float()
        sx = x32.abs().max() / 127.0 + 1e-8
        sw = w32.abs().max() / 127.0 + 1e-8
        qx = torch.round(x32 / sx).clamp(-127, 127).to(torch.int8)
        qw = torch.round(w32 / sw).clamp(-127, 127).to(torch.int8)
        acc = matmul_int8(qx.contiguous(), qw.contiguous(),
                          **blocks)                      # exact int32
        out = acc.float() * (sx * sw)
    elif route == "einsum-fallback":                     # CPU tensors only
        dt = torch_dtype("bfloat16" if compute_dtype == "int8"
                         else compute_dtype)
        # narrow operands, fp32 accumulation and fp32 result
        out = x2.to(dt).float() @ w.to(dt).float()
    else:
        dt = torch_dtype(compute_dtype)
        out = matmul(x2.to(dt).contiguous(), w.to(dt).contiguous(),
                     out_dtype=torch.float32, **blocks)
    return out.float().reshape(b, s, v)
