"""Matrix-product kernels (the paper's MATMUL) for Hopper.

``matmul`` and ``matmul_int8`` are the public wrappers of the CUDA kernels
in ``csrc/matmul.cu`` — the counterparts of the reference's
``kernels/matmul.py``. Multi-precision (§III-E4): bf16/f16 operands with
fp32 accumulation are Ara's 2x32/4x16 subdivision of the 64-bit datapath;
``matmul_int8`` is the SEW=8 rung: int8 x int8 accumulates exactly in
int32 and optionally requantizes back to int8 with the round-to-nearest-up
rule the ISA's VSMUL uses (add half, arithmetic shift, saturate).

Each wrapper:

- keeps the reference's signature (``bm, bn, bk, out_dtype, lmul`` and
  ``shift``) and its **shape contract**: where the reference asserts, the
  wrapper raises ``ValueError`` naming the shapes, so callers that route
  on "does this shape tile?" route identically. The block arguments are
  validated and otherwise only a hint: the CUDA source picks its own route
  and tile from the operand type and the rows (:func:`kernel_route`:
  tensor cores for bf16/f16 — a swapped skinny product for M <= 16, block
  tiles above; CUDA-core fp32 FMAs for float32; :func:`kernel_route_int8`:
  the int8 tensor cores, ``skinny_imma`` for M <= 16 and ``tiled_imma``
  above), and the kernels mask their own ragged edges;
- takes the plain PyTorch version (``matmul_plain``, ``matmul_int8_plain``)
  **only for CPU tensors**. For CUDA tensors it launches the kernel on the
  current stream, without synchronising, or raises; no library routine
  stands in for it;
- counts its launches in :data:`LAUNCHES` (one per kernel launch, nowhere
  else), so a run can show that its path went through the kernel;
- on ``meta`` tensors returns an output of the right shape and dtype and
  launches nothing; on every device records its launch's :func:`work` in a
  running ``core.step_analysis.analyze``.
"""
from __future__ import annotations

import torch

from repro_torch.core import step_analysis
from repro_torch.core.precision import torch_dtype
from repro_torch.core.stripmine import lmul_tile
from repro_torch.kernels import build

# launches of each kernel since import (or since reset_launches())
LAUNCHES = {"matmul": 0, "matmul_int8": 0}

_FLOAT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_INT8_CODE = 3                  # repro_matmul_max_rows' code for matmul_int8
# the source's route codes (repro_matmul_route, repro_matmul_int8_route)
ROUTES = ("skinny_mma", "tiled_mma", "skinny_fma", "tiled_fma")
ROUTES_INT8 = ("skinny_imma", "tiled_imma")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def work(m: int, k: int, n: int, elt: int, out_elt: int):
    """(FLOPs, bytes) of one (m,k) @ (k,n) launch: 2*m*k*n operations;
    both operands (``elt`` bytes an element) read once and the output
    (``out_elt``) written once."""
    return 2.0 * m * k * n, (m * k + k * n) * elt + m * n * out_elt


def _check_blocks(m: int, k: int, n: int, bm: int, bn: int, bk: int, lmul):
    """The reference's block arithmetic and divisibility contract."""
    if min(bm, bn, bk) < 1:
        raise ValueError(f"block sizes must be positive: {(bm, bn, bk)}")
    if min(m, k, n) < 1:
        raise ValueError(f"empty operand: m={m}, k={k}, n={n}")
    bm, bk = min(bm, m), min(bk, k)
    # the base block must tile N exactly; grouping then only ever widens
    # it to a larger divisor
    if n % min(bn, n) != 0:
        raise ValueError(f"n={n} is not a multiple of its block bn={bn}")
    bn = lmul_tile(n, bn, lmul)
    if m % bm or n % bn or k % bk:
        raise ValueError(
            f"(m,n,k)={(m, n, k)} is not tiled by blocks (bm,bn,bk)="
            f"{(bm, bn, bk)}")


def _check_operands(a, b, what: str):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{what}: expected a (M,K) @ b (K,N), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"{what}: operands on different devices "
                         f"({a.device}, {b.device})")


def _check_launchable(lib, a, b, code: int, what: str):
    """Contiguity, and the rows one launch takes as the source states them
    for the grid that really launches (``repro_matmul_max_rows``)."""
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{what}: operands must be contiguous (strides "
                         f"{a.stride()}, {b.stride()})")
    max_rows = lib.repro_matmul_max_rows(code)
    if a.shape[0] > max_rows:
        raise ValueError(f"{what}: m={a.shape[0]} exceeds the kernel's "
                         f"grid ({max_rows} rows)")


def kernel_route(m: int, k: int, n: int, dtype) -> str:
    """The kernel ``matmul`` launches for an (m,k) @ (k,n) product of
    ``dtype`` operands, as the CUDA source decides it
    (``repro_matmul_route``): ``"skinny_mma"`` (bf16/f16, m <= 16),
    ``"tiled_mma"`` (bf16/f16, m > 16), ``"skinny_fma"`` (float32, m <=
    16) or ``"tiled_fma"`` (float32, m > 16). Needs the built library."""
    dtype = torch_dtype(dtype)
    if dtype not in _FLOAT_CODES:
        raise ValueError(f"matmul: no route for {dtype}")
    code = build.load("matmul").repro_matmul_route(m, k, n,
                                                   _FLOAT_CODES[dtype])
    if code < 0:
        raise ValueError(f"matmul: the source has no route for m={m}, "
                         f"{dtype}")
    return ROUTES[code]


def kernel_route_int8(m: int, k: int, n: int) -> str:
    """The kernel ``matmul_int8`` launches for an (m,k) @ (k,n) product, as
    the CUDA source decides it (``repro_matmul_int8_route``):
    ``"skinny_imma"`` (m <= 16) or ``"tiled_imma"`` (m > 16), both on the
    int8 tensor cores. Needs the built library."""
    code = build.load("matmul").repro_matmul_int8_route(m, k, n)
    if code < 0:
        raise ValueError(f"matmul_int8: the source has no route for m={m}")
    return ROUTES_INT8[code]


# ---------------------------------------------------------------------------
# matmul
# ---------------------------------------------------------------------------


def matmul_plain(a, b, *, out_dtype=None):
    """Plain PyTorch version of :func:`matmul`: operands widened to fp32,
    fp32 product and accumulation, one cast to ``out_dtype`` at the end."""
    out_dtype = a.dtype if out_dtype is None else torch_dtype(out_dtype)
    return (a.float() @ b.float()).to(out_dtype)


def matmul(a, b, *, bm: int = 128, bn: int = 128, bk: int = 128,
           out_dtype=None, lmul=1):
    """a (M,K) @ b (K,N) -> (M,N), fp32 accumulation.

    Operands are float32, bfloat16 or float16 (both the same); products of
    float32 operands are true fp32 (no TF32). The accumulator is fp32
    regardless and ``out_dtype`` (default: a's dtype) picks the final
    narrowing — Ara's VFWMA + VFNCVT pair as one kernel. ``bm, bn, bk`` and
    ``lmul`` (the register-grouping analogue, widening the N block through
    ``lmul_tile``) are held to the reference's divisibility contract and
    raise ``ValueError`` where it would assert; they do not pick the CUDA
    route or tile (:func:`kernel_route`).
    """
    _check_operands(a, b, "matmul")
    if a.dtype not in _FLOAT_CODES or b.dtype != a.dtype:
        raise ValueError(f"matmul: operands must both be float32, bfloat16 "
                         f"or float16, got {a.dtype}, {b.dtype}")
    out_dtype = a.dtype if out_dtype is None else torch_dtype(out_dtype)
    if out_dtype not in _FLOAT_CODES:
        raise ValueError(f"matmul: out_dtype must be float32, bfloat16 or "
                         f"float16, got {out_dtype}")
    m, k = a.shape
    n = b.shape[1]
    _check_blocks(m, k, n, bm, bn, bk, lmul)
    kind = build.device_kind("matmul", a)
    with step_analysis.kernel("matmul", work, m, k, n, a.element_size(),
                              out_dtype.itemsize):
        if kind == "cpu":
            return matmul_plain(a, b, out_dtype=out_dtype)
        if kind == "meta":
            return torch.empty((m, n), dtype=out_dtype, device=a.device)
        lib = build.load("matmul")
        _check_launchable(lib, a, b, _FLOAT_CODES[a.dtype], "matmul")
        out = torch.empty((m, n), dtype=out_dtype, device=a.device)
        err = build.launch(lib.repro_matmul, a.device, a.data_ptr(),
                           b.data_ptr(), out.data_ptr(), m, k, n,
                           _FLOAT_CODES[a.dtype], _FLOAT_CODES[out_dtype])
        build.raise_on_launch_error(err, "matmul")
        LAUNCHES["matmul"] += 1
        return out


# ---------------------------------------------------------------------------
# matmul_int8
# ---------------------------------------------------------------------------


def _requantize(acc64, shift: int, out_dtype):
    """The kernel's epilogue on an int64 tensor holding int32 values: add
    half with int32 wrap-around, arithmetic shift right, saturate only
    when the output is int8."""
    if shift:
        acc64 = acc64 + (1 << (shift - 1))
        acc64 = ((acc64 + 2**31) % 2**32) - 2**31     # wrap as int32 does
        acc64 = acc64 >> shift
    if out_dtype == torch.int8:
        acc64 = acc64.clamp(-128, 127)                # saturate, not wrap
    return acc64.to(out_dtype)


def matmul_int8_plain(a, b, *, out_dtype=torch.int32, shift: int = 0):
    """Plain PyTorch version of :func:`matmul_int8`. The product is taken
    in float64, where sums of int8 products are exact (below 2**53), then
    wrapped to the int32 accumulator's range; the epilogue is integer
    arithmetic in int64."""
    out_dtype = torch_dtype(out_dtype)
    acc = (a.double() @ b.double()).to(torch.int64)
    acc = ((acc + 2**31) % 2**32) - 2**31
    return _requantize(acc, shift, out_dtype)


def matmul_int8(a, b, *, bm: int = 128, bn: int = 128, bk: int = 128,
                out_dtype=torch.int32, shift: int = 0, lmul=1):
    """int8 a (M,K) @ int8 b (K,N), exact int32 accumulation.

    The SEW=8 analogue of the multi-precision path: narrow operands, wide
    accumulator — Ara's VMUL/VADD int8 loop with an int32 C tile.
    ``shift`` requantizes the accumulator (round-to-nearest-up: add half,
    arithmetic shift — identical rounding to the ISA's VSMUL);
    ``out_dtype=int8`` then saturates to [-128, 127], while an int32 output
    is shifted and not clamped. ``out_dtype=int32`` with ``shift=0`` (the
    default) returns the exact products. Block arguments and ``lmul`` as in
    :func:`matmul`.
    """
    _check_operands(a, b, "matmul_int8")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise ValueError(f"matmul_int8: operands must be int8, got "
                         f"{a.dtype}, {b.dtype}")
    out_dtype = torch_dtype(out_dtype)
    if out_dtype not in (torch.int32, torch.int8):
        raise ValueError(f"matmul_int8: out_dtype must be int32 or int8, "
                         f"got {out_dtype}")
    if not 0 <= int(shift) <= 31:
        raise ValueError(f"matmul_int8: shift must be in [0, 31], got "
                         f"{shift}")
    shift = int(shift)
    m, k = a.shape
    n = b.shape[1]
    _check_blocks(m, k, n, bm, bn, bk, lmul)
    kind = build.device_kind("matmul_int8", a)
    with step_analysis.kernel("matmul_int8", work, m, k, n, 1,
                              out_dtype.itemsize):
        if kind == "cpu":
            return matmul_int8_plain(a, b, out_dtype=out_dtype, shift=shift)
        if kind == "meta":
            return torch.empty((m, n), dtype=out_dtype, device=a.device)
        lib = build.load("matmul")
        _check_launchable(lib, a, b, _INT8_CODE, "matmul_int8")
        out = torch.empty((m, n), dtype=out_dtype, device=a.device)
        err = build.launch(lib.repro_matmul_int8, a.device, a.data_ptr(),
                           b.data_ptr(), out.data_ptr(), m, k, n, shift,
                           int(out_dtype == torch.int8))
        build.raise_on_launch_error(err, "matmul_int8")
        LAUNCHES["matmul_int8"] += 1
        return out
