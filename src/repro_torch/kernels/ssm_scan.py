"""Chunked linear-attention / SSD scan kernel (Mamba2 & mLSTM hot spot) for
Hopper.

    state_t = exp(dA_t) * state_{t-1} + scale_t * k_t v_t^T ;  y_t = q_t.state_t

``ssm_scan`` is the public wrapper of the CUDA kernel in
``csrc/ssm_scan.cu``, the counterpart of the reference's
``kernels/ssm_scan.py``: the chunkwise-parallel form — quadratic
decay-masked attention inside a chunk, the recurrence across chunks carried
in a float32 state. The reference runs the chunk axis as the innermost,
in-order TPU grid axis with the state in VMEM scratch; the CUDA source
splits the same arithmetic into SSD's chunk-parallel passes, launched by
one call: every chunk's own state contribution, the states passed from
chunk to chunk (the only pass in order), and each chunk's outputs with
q·kᵀ formed once per tile of rows and keys — the cross-chunk term in a
pass of its own where P spans several column tiles (see the source's
note). :func:`ssm_scan_passes` is a plain mirror of those passes for the
tests; the card never runs it.

Contract, as the reference's: ``chunk = min(chunk, S)`` and ``S % chunk``
must be 0 (a bare ``assert`` there, ``ValueError`` here); y comes back in
v's dtype; the within-chunk cumsum of ``log_decay`` and all products are
float32 (float64 for float64 operands, the port's convention). q, k and v
share one dtype; ``log_decay`` and ``scale`` are taken in the accumulator
type. Forward only: the reference has no backward for this kernel.

The wrapper takes the plain version (:func:`ssm_scan_plain`, the same
chunked form with the chunks in order) **only for CPU tensors**; for CUDA
tensors it launches the kernel on the current stream or raises. It counts
its launches in :data:`LAUNCHES`. On ``meta`` tensors it returns an output
of the right shape and dtype and launches nothing; on every device it
records its launch's :func:`work` in a running
``core.step_analysis.analyze``.
"""
from __future__ import annotations

import torch

from repro_torch.core import step_analysis
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


def work(bh: int, s: int, n: int, p: int, chunk: int, elt: int):
    """(FLOPs, bytes) of one launch: the products the causal chunked form
    needs, per (bh, chunk of c) q.k^T and w.v over the c(c+1)/2 causal
    pairs and q.state and the state update over c x N x P, 2 operations a
    multiply-add; q, k, v and y (``elt`` bytes) and log_decay and scale
    (float32) read or written once."""
    pairs = chunk * (chunk + 1) / 2
    per_chunk = 2 * pairs * (n + p) + 4 * chunk * n * p
    return (bh * (s // chunk) * per_chunk,
            bh * s * (2 * n + 2 * p) * elt + 2 * bh * s * 4)


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


def ssm_scan_passes(q, k, v, log_decay, scale, *, chunk: int = 128):
    """Plain mirror of the CUDA kernel's three passes, a test aid (never
    on a card path): (1) each chunk's state contribution ``dS_c = (k *
    gk)ᵀ·v`` with ``gk = scale * exp(cd_last - cd)``, all chunks at once;
    (2) the states entering each chunk, ``S_in(c+1) = S_in(c) *
    exp(cd_last,c) + dS_c`` from zeros; (3) every chunk's output at once,
    ``exp(cd) * (q·S_in) + (tril(q·kᵀ * exp(cd_i - cd_j)) * scale_j)·v``.
    Accumulates in float32 (float64 for float64 operands)."""
    chunk = _contract(q, k, v, log_decay, scale, chunk)
    acc_t = _acc_dtype(v.dtype)
    bh, s, n = q.shape
    p_dim, nc = v.shape[-1], s // chunk

    def chunks(t):
        return t.to(acc_t).reshape((bh, nc, chunk) + t.shape[2:])
    qc, kc, vc, ldc, scc = map(chunks, (q, k, v, log_decay, scale))
    cd = torch.cumsum(ldc, dim=-1)                           # (bh, nc, c)
    cd_last = cd[..., -1:]
    # pass 1: every chunk's own contribution (the last one is not needed)
    gk = scc * torch.exp(cd_last - cd)
    d_state = (kc * gk[..., None]).transpose(-1, -2) @ vc    # (bh,nc,n,p)
    # pass 2: the state entering each chunk, in order
    s_in = [torch.zeros((bh, n, p_dim), dtype=acc_t, device=q.device)]
    for c in range(nc - 1):
        s_in.append(s_in[-1] * torch.exp(cd_last[:, c])[..., None]
                    + d_state[:, c])
    s_in = torch.stack(s_in, dim=1)
    # pass 3: outputs, q·kᵀ once per chunk; the mask is a select
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=q.device))
    scores = qc @ kc.transpose(-1, -2)
    w = torch.where(tri, scores * torch.exp(cd[..., :, None]
                                            - cd[..., None, :]),
                    torch.zeros((), dtype=acc_t, device=q.device)) \
        * scc[..., None, :]
    y = torch.exp(cd)[..., None] * (qc @ s_in) + w @ vc
    return y.reshape(bh, s, p_dim).to(v.dtype)


def ssm_scan(q, k, v, log_decay, scale, *, chunk: int = 128):
    """q,k (BH, S, N); v (BH, S, P); log_decay, scale (BH, S) ->
    y (BH, S, P) in v's dtype. float32 state; matches
    models/ssm.chunked_linear_attention (with no initial state)."""
    chunk = _contract(q, k, v, log_decay, scale, chunk)
    kind = build.device_kind("ssm_scan", q)
    bh, s, n = q.shape
    with step_analysis.kernel("ssm_scan", work, bh, s, n, v.shape[-1],
                              chunk, v.element_size()):
        if kind == "cpu":
            return ssm_scan_plain(q, k, v, log_decay, scale, chunk=chunk)
        return _launch(q, k, v, log_decay, scale, chunk)


def _launch(q, k, v, log_decay, scale, chunk):
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
    if q.device.type == "meta":
        return torch.empty_like(v)
    lib = build.load("ssm_scan")
    # the source's own layout decides what fits a block (the chunk sets it)
    need = lib.repro_ssm_scan_smem_bytes(n, p_dim, chunk,
                                         _DTYPE_CODES[v.dtype])
    limit = lib.repro_ssm_scan_smem_limit()
    if need > limit:
        raise ValueError(f"ssm_scan: N={n}, P={p_dim}, chunk={chunk} need "
                         f"{need} bytes of shared memory per block; the "
                         f"kernel has {limit}")
    y = torch.empty_like(v)
    # scratch of passes 1-2: each chunk's state, then the state entering
    # the next chunk (in place), and each chunk's total decay; none when
    # the sequence is one chunk. Where P spans several column tiles, the
    # cross-chunk term has a pass of its own and lands in yx.
    nc1 = s // chunk - 1
    states = torch.empty((bh, nc1, n, p_dim), dtype=acc_t, device=q.device)
    dec = torch.empty((bh, nc1), dtype=acc_t, device=q.device)
    cross = nc1 > 0 and lib.repro_ssm_scan_cross_scratch(
        n, p_dim, chunk, _DTYPE_CODES[v.dtype])
    yx = torch.empty((bh, s, p_dim) if cross else (0,), dtype=acc_t,
                     device=q.device)
    err = build.launch(lib.repro_ssm_scan, q.device, q.data_ptr(),
                       k.data_ptr(), v.data_ptr(), ld.data_ptr(),
                       sc.data_ptr(), y.data_ptr(), states.data_ptr(),
                       dec.data_ptr(), yx.data_ptr(), bh, s, n, p_dim,
                       chunk, _DTYPE_CODES[v.dtype])
    build.raise_on_launch_error(err, "ssm_scan")
    LAUNCHES["ssm_scan"] += 1
    return y
