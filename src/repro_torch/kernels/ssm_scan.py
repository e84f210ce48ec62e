"""Chunked linear-attention / SSD scan kernel (Mamba2 & mLSTM hot spot) for
Hopper.

    state_t = exp(dA_t) * state_{t-1} + scale_t * k_t v_t^T ;  y_t = q_t.state_t

``ssm_scan`` is the public wrapper of the CUDA kernel in
``csrc/ssm_scan.cu``, the counterpart of the reference's
``kernels/ssm_scan.py``: the chunkwise-parallel form — quadratic
decay-masked attention inside a chunk, the recurrence across chunks carried
in a float32 state. The reference runs the chunk axis as the innermost,
in-order TPU grid axis with the state in VMEM scratch; the CUDA kernel runs
it as a loop inside a block that holds one ``(bh, p-tile)`` slice of the
state in shared memory (see the source for why the state is split by
columns, and what that costs).

Contract, as the reference's: ``chunk = min(chunk, S)`` and ``S % chunk``
must be 0 (a bare ``assert`` there, ``ValueError`` here); y comes back in
v's dtype; the within-chunk cumsum of ``log_decay`` and all products are
float32 (float64 for float64 operands, the port's convention). q, k and v
share one dtype; ``log_decay`` and ``scale`` are taken in the accumulator
type. Forward only: the reference has no backward for this kernel.

The wrapper takes the plain version (:func:`ssm_scan_plain`, the same
chunked form with the chunks in order) **only for CPU tensors**; for CUDA
tensors it launches the kernel on the current stream or raises. It counts
its launches in :data:`LAUNCHES`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

# launches of the kernel since import (or since reset_launches())
LAUNCHES = {"ssm_scan": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
                torch.float64: 3}
_MAX_BH = 65535                    # the kernel's grid.y


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _acc_dtype(dtype):
    return torch.float64 if dtype == torch.float64 else torch.float32


def _contract(q, k, v, log_decay, scale, chunk):
    if q.dim() != 3 or k.shape != q.shape or v.dim() != 3 \
            or v.shape[:2] != q.shape[:2] \
            or log_decay.shape != q.shape[:2] \
            or scale.shape != q.shape[:2]:
        raise ValueError(
            f"ssm_scan: expected q, k (BH,S,N), v (BH,S,P), log_decay and "
            f"scale (BH,S); got q{tuple(q.shape)} k{tuple(k.shape)} "
            f"v{tuple(v.shape)} log_decay{tuple(log_decay.shape)} "
            f"scale{tuple(scale.shape)}")
    if v.dtype not in _DTYPE_CODES or q.dtype != v.dtype \
            or k.dtype != v.dtype:
        raise ValueError(f"ssm_scan: q, k, v must share one dtype among "
                         f"float32, bfloat16, float16, float64; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    for t in (log_decay, scale):
        if not t.is_floating_point():
            raise ValueError(f"ssm_scan: log_decay and scale must be "
                             f"floating, got {t.dtype}")
    bh, s, n = q.shape
    if min(bh, s, n, v.shape[-1]) < 1 or chunk < 1:
        raise ValueError(f"ssm_scan: empty operand or chunk: q"
                         f"{tuple(q.shape)} v{tuple(v.shape)} chunk={chunk}")
    chunk = min(chunk, s)
    if s % chunk != 0:
        raise ValueError(f"ssm_scan: S={s} is not a multiple of chunk="
                         f"{chunk}")
    return chunk


def ssm_scan_plain(q, k, v, log_decay, scale, *, chunk: int = 128):
    """Plain PyTorch version of :func:`ssm_scan`: the chunked form the
    kernel computes, chunk by chunk in order, every operand widened to the
    accumulator type (float32; float64 stays float64)."""
    chunk = _contract(q, k, v, log_decay, scale, chunk)
    acc_t = _acc_dtype(v.dtype)
    bh, s, n = q.shape
    p_dim = v.shape[-1]
    q, k, vv, ld, sc = (t.to(acc_t) for t in (q, k, v, log_decay, scale))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=q.device))
    state = torch.zeros((bh, n, p_dim), dtype=acc_t, device=q.device)
    ys = []
    for t0 in range(0, s, chunk):
        sl = slice(t0, t0 + chunk)
        qb, kb, vb, scb = q[:, sl], k[:, sl], vv[:, sl], sc[:, sl]
        cd = torch.cumsum(ld[:, sl], dim=-1)                     # (bh, c)
        y_off = torch.exp(cd)[..., None] * (qb @ state)
        scores = qb @ kb.transpose(1, 2)
        ldiff = cd[:, :, None] - cd[:, None, :]
        # select, do not multiply by a 0/1 mask: exp(ldiff) may be inf
        w = torch.where(tri, scores * torch.exp(ldiff),
                        torch.zeros((), dtype=acc_t, device=q.device)) \
            * scb[:, None, :]
        ys.append(y_off + w @ vb)
        cd_last = cd[:, -1:]
        k_dec = kb * (scb * torch.exp(cd_last - cd))[..., None]
        state = state * torch.exp(cd_last)[..., None] \
            + k_dec.transpose(1, 2) @ vb
    return torch.cat(ys, dim=1).to(v.dtype)


def ssm_scan(q, k, v, log_decay, scale, *, chunk: int = 128):
    """q,k (BH, S, N); v (BH, S, P); log_decay, scale (BH, S) ->
    y (BH, S, P) in v's dtype. float32 state; matches
    models/ssm.chunked_linear_attention (with no initial state)."""
    chunk = _contract(q, k, v, log_decay, scale, chunk)
    if q.device.type == "cpu":
        return ssm_scan_plain(q, k, v, log_decay, scale, chunk=chunk)
    if q.device.type != "cuda":
        raise ValueError(f"ssm_scan: unsupported device {q.device}")
    acc_t = _acc_dtype(v.dtype)
    ld = log_decay.to(acc_t).contiguous()
    sc = scale.to(acc_t).contiguous()
    for t in (q, k, v, ld, sc):
        if t.device != q.device:
            raise ValueError(f"ssm_scan: operands on different devices "
                             f"({q.device}, {t.device})")
        if not t.is_contiguous():
            raise ValueError(f"ssm_scan: operands must be contiguous "
                             f"(shape {tuple(t.shape)}, strides "
                             f"{t.stride()})")
    bh, s, n = q.shape
    p_dim = v.shape[-1]
    if bh > _MAX_BH:
        raise ValueError(f"ssm_scan: BH={bh} exceeds the kernel's grid "
                         f"({_MAX_BH})")
    lib = build.load("ssm_scan")
    # the source's own layout decides what fits a block
    need = lib.repro_ssm_scan_smem_bytes(n, chunk, _DTYPE_CODES[v.dtype])
    limit = lib.repro_ssm_scan_smem_limit()
    if need > limit:
        raise ValueError(f"ssm_scan: N={n}, chunk={chunk} need {need} bytes "
                         f"of shared memory per block; the kernel has "
                         f"{limit}")
    y = torch.empty_like(v)
    err = build.launch(lib.repro_ssm_scan, q.device, q.data_ptr(),
                       k.data_ptr(), v.data_ptr(), ld.data_ptr(),
                       sc.data_ptr(), y.data_ptr(), bh, s, n, p_dim, chunk,
                       _DTYPE_CODES[v.dtype])
    build.raise_on_launch_error(err, "ssm_scan")
    LAUNCHES["ssm_scan"] += 1
    return y
