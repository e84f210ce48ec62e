"""AXPY streaming kernel (the paper's DAXPY, memory-bound roofline witness)
for Hopper.

``axpy`` is the public wrapper of the CUDA kernel in ``csrc/axpy.cu``, the
counterpart of the reference's ``kernels/axpy.py``. Arithmetic intensity
1/12 in float32 (two loads and one store per multiply-add): firmly left of
the roofline knee at every precision, so the kernel is a 16-byte-vector
stream and its time is the bytes it moves.

The wrapper keeps the reference's signature (``block``, ``lmul``) and its
contract: ``n % min(block, n) == 0`` (a bare ``assert`` there) raises
``ValueError``, then ``block = lmul_tile(n, block, lmul)``. The block is the
contract only; it does not pick the CUDA grid. ``alpha`` is rounded to x's
dtype first, as ``jnp.asarray(alpha, x.dtype)`` does; the product and then
the sum are each rounded to x's dtype. Operands are float32, bfloat16,
float16 or float64 (the paper's DAXPY is double precision); x and y share
their dtype and shape.

The wrapper takes the plain version (:func:`axpy_plain`) **only for CPU
tensors**; for CUDA tensors it launches the kernel on the current stream or
raises. It counts its launches in :data:`LAUNCHES`. On ``meta`` tensors it
returns an output of the right shape and dtype and launches nothing; on
every device it records its launch's :func:`work` in a running
``core.step_analysis.analyze``.
"""
from __future__ import annotations

import torch

from repro_torch.core import step_analysis
from repro_torch.core.stripmine import lmul_tile
from repro_torch.kernels import build

# launches of the kernel since import (or since reset_launches())
LAUNCHES = {"axpy": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
                torch.float64: 3}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _alpha_in(alpha, dtype) -> torch.Tensor:
    """``alpha`` rounded to ``dtype``, as a 0-d CPU tensor."""
    if isinstance(alpha, torch.Tensor):
        return alpha.detach().to("cpu", dtype).reshape(())
    return torch.tensor(alpha, dtype=dtype)


def work(n: int, elt: int):
    """(FLOPs, bytes) of one launch on n elements of ``elt`` bytes: a
    multiply and an add each; x and y read once, the output written once."""
    return 2.0 * n, 3 * n * elt


def axpy_plain(alpha, x, y):
    """Plain PyTorch version of :func:`axpy`: ``alpha`` rounded to x's
    dtype, then ``alpha * x`` and ``+ y``, each rounded to x's dtype."""
    return _alpha_in(alpha, x.dtype).to(x.device) * x + y


def axpy(alpha, x, y, *, block: int = 64 * 1024, lmul=1):
    """alpha scalar (or 0-d tensor); x, y (n,) of one dtype -> alpha*x + y
    in x's dtype.

    ``lmul`` is the register-grouping analogue: the strip each step streams
    grows by LMUL (``lmul_tile``), as Ara2's grouped vectors amortize the
    issue interval; here it is held to the reference's contract and does
    not change the result or the CUDA grid.
    """
    if x.dim() != 1 or y.shape != x.shape:
        raise ValueError(f"axpy: expected x and y of one shape (n,), got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if x.dtype not in _DTYPE_CODES or y.dtype != x.dtype:
        raise ValueError(f"axpy: x and y must share one dtype among "
                         f"float32, bfloat16, float16, float64; got "
                         f"{x.dtype}, {y.dtype}")
    if x.device != y.device:
        raise ValueError(f"axpy: operands on different devices "
                         f"({x.device}, {y.device})")
    n = x.shape[0]
    if n < 1 or block < 1:
        raise ValueError(f"axpy: n={n} and block={block} must be positive")
    # the base block must tile n exactly (loud failure, as before lmul);
    # grouping then only ever widens it to a larger divisor
    if n % min(block, n) != 0:
        raise ValueError(f"axpy: n={n} is not a multiple of its block "
                         f"{block}")
    block = lmul_tile(n, block, lmul)
    kind = build.device_kind("axpy", x)
    with step_analysis.kernel("axpy", work, n, x.element_size()):
        if kind == "cpu":
            return axpy_plain(alpha, x, y)
        if not (x.is_contiguous() and y.is_contiguous()):
            raise ValueError(f"axpy: operands must be contiguous (strides "
                             f"{x.stride()}, {y.stride()})")
        if kind == "meta":
            return torch.empty_like(x)
        a = float(_alpha_in(alpha, x.dtype))       # exact in a double
        lib = build.load("axpy")
        out = torch.empty_like(x)
        err = build.launch(lib.repro_axpy, x.device, a, x.data_ptr(),
                           y.data_ptr(), out.data_ptr(), n,
                           _DTYPE_CODES[x.dtype])
        build.raise_on_launch_error(err, "axpy")
        LAUNCHES["axpy"] += 1
        return out
