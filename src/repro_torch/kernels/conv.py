"""Direct tensor convolution kernel (the paper's DCONV, GoogLeNet layer 1)
for Hopper.

``conv2d_direct`` is the public wrapper of the CUDA kernel in
``csrc/conv.cu``, the counterpart of the reference's ``kernels/conv.py``:
VALID, stride 1, x (C,H,W) pre-padded, w (OC,C,KH,KW) ->
(OC, H-KH+1, W-KW+1). Ara computes one output row per vector register,
accumulating C*KH*KW shifted FMAs (§V-C); the kernel keeps that structure —
a block per (group of output channels, run of output rows), the input rows
it needs and the group's weights staged in shared memory, each thread
sliding a window of input values held in registers over the taps, every
output the sum of its taps in the order c -> kr -> t — and no im2col.
Taps of 7x7 and 3x3 are compile-time constants in the kernel; other shapes,
and those whose channels and weights do not fit that kernel's shared memory,
take a general kernel with runtime tap loops (:func:`kernel_route`).

Accumulation is float32 whatever the input width (bf16/f16 inputs are the
Ara 2x32/4x16 datapath-split path), float64 for float64 operands; the
result is rounded once, to ``out_dtype`` (default: x's dtype).

The wrapper takes the plain version (:func:`conv2d_plain`, the same
shifted-tap sum written as tensor slices — not ``F.conv2d``) **only for CPU
tensors**; for CUDA tensors it launches the kernel on the current stream or
raises. It counts its launches in :data:`LAUNCHES`. On ``meta`` tensors it
returns an output of the right shape and dtype and launches nothing; on
every device it records its launch's :func:`work` in a running
``core.step_analysis.analyze``.
"""
from __future__ import annotations

import torch

from repro_torch.core import step_analysis
from repro_torch.core.precision import torch_dtype
from repro_torch.kernels import build

# launches of the kernel since import (or since reset_launches())
LAUNCHES = {"conv2d_direct": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
                torch.float64: 3}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _acc_dtype(dtype):
    return torch.float64 if dtype == torch.float64 else torch.float32


def work(c: int, h: int, w: int, oc: int, kh: int, kw: int, elt: int,
         out_elt: int):
    """(FLOPs, bytes) of one launch, x (C,H,W) and w (OC,C,KH,KW) of
    ``elt`` bytes, VALID: 2*OC*C*KH*KW*H_out*W_out operations; x and w
    read once, the output (``out_elt``) written once."""
    ho, wo = h - kh + 1, w - kw + 1
    return (2.0 * oc * c * kh * kw * ho * wo,
            (c * h * w + oc * c * kh * kw) * elt + oc * ho * wo * out_elt)


def conv2d_plain(x, w, *, out_dtype=None):
    """Plain PyTorch version of :func:`conv2d_direct`: the shifted-tap sum
    over tensor slices, operands widened to the accumulator type, one
    multiply and one add per tap in the order c -> kr -> t, one rounding
    to ``out_dtype`` at the end."""
    out_dtype = x.dtype if out_dtype is None else torch_dtype(out_dtype)
    acc_t = _acc_dtype(x.dtype)
    c, h, wid = x.shape
    oc, _, kh, kw = w.shape
    h_out, w_out = h - kh + 1, wid - kw + 1
    xa, wa = x.to(acc_t), w.to(acc_t)
    acc = torch.zeros((oc, h_out, w_out), dtype=acc_t, device=x.device)
    for ci in range(c):
        for kr in range(kh):
            for t in range(kw):
                acc = acc + wa[:, ci, kr, t, None, None] \
                    * xa[None, ci, kr:kr + h_out, t:t + w_out]
    return acc.to(out_dtype)


def kernel_route(x, w) -> str:
    """The CUDA kernel ``conv2d_direct(x, w)`` launches, as the source
    decides it from the shapes and x's dtype: ``"taps"`` (taps known at
    compile time: 7x7 and 3x3, where the channels and the group's weights
    fit its shared memory) or ``"general"`` (runtime tap loops). Needs the
    built library."""
    c, h, wid = x.shape
    _, _, kh, kw = w.shape
    return "taps" if build.load("conv").repro_conv2d_route(
        c, h, wid, kh, kw, _DTYPE_CODES[x.dtype]) else "general"


def conv2d_direct(x, w, *, out_dtype=None):
    """x (C, H, W) [pre-padded]; w (OC, C, KH, KW) -> (OC, H_out, W_out).

    x and w share one dtype among float32, bfloat16, float16 (float32
    accumulation; ``out_dtype`` float32, bfloat16 or float16) and float64
    (float64 accumulation and output). A channel count that disagrees
    (the reference's bare ``assert c == c2``) or a kernel larger than the
    image raises ``ValueError``.
    """
    if x.dim() != 3 or w.dim() != 4:
        raise ValueError(f"conv2d_direct: expected x (C,H,W) and w "
                         f"(OC,C,KH,KW), got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    c, h, wid = x.shape
    oc, c2, kh, kw = w.shape
    if c != c2:
        raise ValueError(f"conv2d_direct: x has {c} channels, w expects "
                         f"{c2}")
    if min(c, oc, kh, kw) < 1 or kh > h or kw > wid:
        raise ValueError(f"conv2d_direct: kernel {(kh, kw)} does not fit "
                         f"the image {(h, wid)} (VALID padding)")
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise ValueError(f"conv2d_direct: x and w must share one dtype "
                         f"among float32, bfloat16, float16, float64; got "
                         f"{x.dtype}, {w.dtype}")
    out_dtype = x.dtype if out_dtype is None else torch_dtype(out_dtype)
    allowed = (torch.float64,) if x.dtype == torch.float64 \
        else (torch.float32, torch.bfloat16, torch.float16)
    if out_dtype not in allowed:
        raise ValueError(f"conv2d_direct: out_dtype {out_dtype} with "
                         f"{x.dtype} operands; allowed: {allowed}")
    if x.device != w.device:
        raise ValueError(f"conv2d_direct: operands on different devices "
                         f"({x.device}, {w.device})")
    kind = build.device_kind("conv2d_direct", x)
    with step_analysis.kernel("conv2d_direct", work, c, h, wid, oc, kh, kw,
                              x.element_size(), out_dtype.itemsize):
        if kind == "cpu":
            return conv2d_plain(x, w, out_dtype=out_dtype)
        return _launch(x, w, out_dtype)


def _launch(x, w, out_dtype):
    c, h, wid = x.shape
    oc, _, kh, kw = w.shape
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"conv2d_direct: operands must be contiguous "
                         f"(strides {x.stride()}, {w.stride()})")
    h_out, w_out = h - kh + 1, wid - kw + 1
    if oc > 65535:
        raise ValueError(f"conv2d_direct: {oc} output channels exceed the "
                         f"kernel's grid (65535)")
    if x.device.type == "meta":
        return torch.empty((oc, h_out, w_out), dtype=out_dtype,
                           device=x.device)
    lib = build.load("conv")
    # the source's own rule decides how many rows fit a block
    if lib.repro_conv2d_rows(c, h, wid, kh, kw, _DTYPE_CODES[x.dtype]) < 1:
        raise ValueError(f"conv2d_direct: {c} channels of {kh} rows of "
                         f"width {wid} do not fit the kernel's shared "
                         f"memory ({lib.repro_conv2d_smem_budget()} bytes)")
    out = torch.empty((oc, h_out, w_out), dtype=out_dtype, device=x.device)
    err = build.launch(lib.repro_conv2d, x.device, x.data_ptr(),
                       w.data_ptr(), out.data_ptr(), c, h, wid, oc, kh, kw,
                       _DTYPE_CODES[x.dtype], _DTYPE_CODES[out_dtype])
    build.raise_on_launch_error(err, "conv2d_direct")
    LAUNCHES["conv2d_direct"] += 1
    return out
