"""Blockwise flash attention for Hopper: fused online-softmax forward AND
backward.

The counterpart of the reference's ``kernels/attention.py``, with the same
names, keywords, ``ValueError`` texts and ``(B,H,S,D)`` layout. The three
Pallas kernels become the CUDA kernels of ``csrc/attention.cu``:

- ``flash_fwd`` (``_fwd_kernel``): online softmax over KV blocks, the causal
  block skip as the KV loop's bound, the trip count per ``(g, q-block)`` as
  the probe; saves only the per-row log-sum-exp;
- ``flash_bwd_dq`` (``_bwd_dq_kernel``) and ``flash_bwd_dkv``
  (``_bwd_dkv_kernel``): recompute each probability block from q, k and the
  saved lse and accumulate dQ, dK, dV in fp32 (float64 for float64
  operands).

Beside each kernel wrapper stands its plain PyTorch version with the same
contract (``flash_fwd_plain``, ``flash_bwd_dq_plain``,
``flash_bwd_dkv_plain``). A wrapper takes the plain version **only for CPU
tensors**; for CUDA tensors it launches the kernel on the current stream or
raises — no library attention stands in for it. Each wrapper counts its
launches in :data:`LAUNCHES`.

``_FlashCore`` (a ``torch.autograd.Function``) takes the place of the
reference's ``jax.custom_vjp``: its forward saves ``(qf, kf, vf, kvm, out,
lse)``, its backward forms ``delta = sum(dO * O)`` in plain torch and calls
the two backward kernels. Padding and the ``(B,H) -> G`` flattening stay
outside it, so autograd slices the padding's gradient away.

Numbers: operands of float32, bfloat16 or float16 accumulate in float32 and
``lse``/``delta`` are float32, as in the reference; float64 operands
accumulate in float64 and ``lse``/``delta`` are float64, so that a float64
run stays float64 throughout (the reference has no float64 path).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

NEG_INF = -1e30
# rows whose running max never left NEG_INF saw no valid key
_DEAD_ROW = NEG_INF * 0.5
# keys per chunk of the forward's online softmax in the CUDA kernel for
# float32/bfloat16/float16 operands; the plain forward walks the same chunks
# so that p is rounded to v's dtype against the same running max
FWD_CHUNK = 64
MAX_HEAD_DIM = 128

# launches of each kernel since import (or since reset_launches())
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
                torch.float64: 3}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _acc_dtype(dtype):
    """float32 for narrow and float32 operands, float64 for float64."""
    return torch.promote_types(dtype, torch.float32)


def _mask(kvm, sq: int, causal: bool):
    """(G, Sq, Sk) bool: kv mask and, if causal, q_pos >= k_pos on raw
    indices."""
    sk = kvm.shape[1]
    mask = (kvm != 0)[:, None, :].expand(kvm.shape[0], sq, sk)
    if causal:
        rows = torch.arange(sq, device=kvm.device)[:, None]
        cols = torch.arange(sk, device=kvm.device)[None, :]
        mask = mask & (rows >= cols)[None]
    return mask


def _probe(g: int, sq: int, sk: int, bq: int, bk: int, causal: bool, device):
    n_q, n_k = sq // bq, sk // bk
    qb = torch.arange(n_q, dtype=torch.int64, device=device)
    trips = torch.clamp((qb * bq + bq - 1) // bk + 1, max=n_k) if causal \
        else torch.full_like(qb, n_k)
    return trips.to(torch.int32)[None, :].expand(g, n_q).contiguous()


# ---------------------------------------------------------------------------
# Plain versions (the arithmetic the kernels repeat)
# ---------------------------------------------------------------------------


def flash_fwd_plain(qf, kf, vf, kvm, *, causal: bool, bq: int, bk: int):
    """Plain version of :func:`flash_fwd`: an online softmax over chunks of
    ``FWD_CHUNK`` keys, in the accumulator type, with p rounded to v's dtype
    before ``P.V``. Returns ``(out (G,Sq,D) q dtype, lse (G,Sq), probe
    (G,n_q) int32)``."""
    g, sq, d = qf.shape
    sk = kf.shape[1]
    acc_t = _acc_dtype(qf.dtype)
    scale = 1.0 / math.sqrt(d)
    q = qf.to(acc_t)
    mask = _mask(kvm, sq, causal)
    m = torch.full((g, sq), NEG_INF, dtype=acc_t, device=qf.device)
    l = torch.zeros((g, sq), dtype=acc_t, device=qf.device)
    acc = torch.zeros((g, sq, d), dtype=acc_t, device=qf.device)
    for c0 in range(0, sk, FWD_CHUNK):
        kc = kf[:, c0:c0 + FWD_CHUNK].to(acc_t)
        vc = vf[:, c0:c0 + FWD_CHUNK]
        s = torch.einsum("gqd,gkd->gqk", q, kc) * scale
        s = torch.where(mask[:, :, c0:c0 + FWD_CHUNK], s,
                        torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # dead rows keep m_new == NEG_INF: exp against 0 underflows their
        # masked scores to 0 instead of exp(0) == 1
        m_safe = torch.where(m_new > _DEAD_ROW, m_new, torch.zeros_like(m_new))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_safe[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "gqk,gkd->gqd", p.to(vf.dtype).to(acc_t), vc.to(acc_t))
        m = m_new
    live = l > 0
    l_safe = torch.where(live, l, torch.ones_like(l))
    out = torch.where(live[..., None], acc / l_safe[..., None],
                      torch.zeros_like(acc)).to(qf.dtype)
    lse = torch.where(live, m + torch.log(l_safe), torch.full_like(m, NEG_INF))
    return out, lse, _probe(g, sq, sk, bq, bk, causal, qf.device)


def _recompute_p(qf, kf, kvm, lse, causal: bool):
    """The probability matrix from q, k and the saved lse, in the
    accumulator type; masked positions and dead rows are exactly 0."""
    acc_t = lse.dtype
    scale = 1.0 / math.sqrt(qf.shape[-1])
    s = torch.einsum("gqd,gkd->gqk", qf.to(acc_t), kf.to(acc_t)) * scale
    s = torch.where(_mask(kvm, qf.shape[1], causal), s,
                    torch.full_like(s, NEG_INF))
    lse_safe = torch.where(lse > _DEAD_ROW, lse, torch.zeros_like(lse))
    return torch.exp(s - lse_safe[..., None]), scale


def _ds(p, vf, dout, delta, scale):
    dp = torch.einsum("gqd,gkd->gqk", dout.to(p.dtype), vf.to(p.dtype))
    return p * (dp - delta[..., None]) * scale


def flash_bwd_dq_plain(qf, kf, vf, kvm, dout, lse, delta, *, causal: bool,
                       bq: int, bk: int):
    """Plain version of :func:`flash_bwd_dq`: ``dQ = (p (dO v^T - delta)
    scale) k`` with ds rounded to k's dtype, accumulated in lse's type."""
    p, scale = _recompute_p(qf, kf, kvm, lse, causal)
    ds = _ds(p, vf, dout, delta, scale)
    dq = torch.einsum("gqk,gkd->gqd", ds.to(kf.dtype).to(p.dtype),
                      kf.to(p.dtype))
    return dq.to(qf.dtype)


def flash_bwd_dkv_plain(qf, kf, vf, kvm, dout, lse, delta, *, causal: bool,
                        bq: int, bk: int):
    """Plain version of :func:`flash_bwd_dkv`: ``dV = p^T dO`` with p rounded
    to dO's dtype, ``dK = ds^T q`` with ds rounded to q's dtype."""
    p, scale = _recompute_p(qf, kf, kvm, lse, causal)
    acc_t = p.dtype
    dv = torch.einsum("gqk,gqd->gkd", p.to(dout.dtype).to(acc_t),
                      dout.to(acc_t))
    ds = _ds(p, vf, dout, delta, scale)
    dk = torch.einsum("gqk,gqd->gkd", ds.to(qf.dtype).to(acc_t),
                      qf.to(acc_t))
    return dk.to(kf.dtype), dv.to(vf.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers (flat, padded operands)
# ---------------------------------------------------------------------------


def _check_launchable(what: str, *tensors):
    dt = tensors[0].dtype
    if dt not in _DTYPE_CODES or any(t.dtype != dt for t in tensors[1:3]):
        raise ValueError(
            f"{what}: the CUDA kernel takes q, k, v of one dtype among "
            f"float32, bfloat16, float16, float64; got "
            f"{[str(t.dtype) for t in tensors[:3]]}")
    if tensors[3].dtype != torch.int32:
        raise ValueError(f"{what}: kvm must be int32, got {tensors[3].dtype}")
    if len(tensors) > 4:                      # dout, lse, delta
        acc_t = _acc_dtype(dt)
        if tensors[4].dtype != dt or tensors[5].dtype != acc_t \
                or tensors[6].dtype != acc_t:
            raise ValueError(
                f"{what}: dout must be {dt} and lse, delta {acc_t}; got "
                f"{[str(t.dtype) for t in tensors[4:]]}")
    d = tensors[0].shape[-1]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{what}: head_dim {d} exceeds the CUDA kernel's "
                         f"{MAX_HEAD_DIM}")
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: operands on different devices "
                             f"({dev}, {t.device})")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous (shape "
                             f"{tuple(t.shape)}, strides {t.stride()})")


def _device_kind(what: str, t) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")
    return t.device.type


def _geometry(qf, kf, bq: int, bk: int):
    g, sq, d = qf.shape
    sk = kf.shape[1]
    return g, sq, sk, d, sq // bq, sk // bk


def flash_fwd(qf, kf, vf, kvm, *, causal: bool, bq: int, bk: int):
    """Forward kernel on flat padded operands: qf (G,Sq,D), kf/vf (G,Sk,D),
    kvm (G,Sk) int32, Sq % bq == Sk % bk == 0. Returns ``(out, lse,
    probe)`` as :func:`flash_fwd_plain` does."""
    if _device_kind("flash_fwd", qf) == "cpu":
        return flash_fwd_plain(qf, kf, vf, kvm, causal=causal, bq=bq, bk=bk)
    _check_launchable("flash_fwd", qf, kf, vf, kvm)
    g, sq, sk, d, n_q, _ = _geometry(qf, kf, bq, bk)
    lib = build.load("attention")
    out = torch.empty_like(qf)
    lse = torch.empty((g, sq), dtype=_acc_dtype(qf.dtype), device=qf.device)
    probe = torch.empty((g, n_q), dtype=torch.int32, device=qf.device)
    err = build.launch(lib.repro_flash_fwd, qf.device, qf.data_ptr(),
                  kf.data_ptr(), vf.data_ptr(), kvm.data_ptr(),
                  out.data_ptr(), lse.data_ptr(), probe.data_ptr(), g, sq, sk,
                  d, bq, bk, int(causal), _DTYPE_CODES[qf.dtype])
    build.raise_on_launch_error(err, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return out, lse, probe


def flash_bwd_dq(qf, kf, vf, kvm, dout, lse, delta, *, causal: bool,
                 bq: int, bk: int):
    """dQ kernel on flat padded operands; ``dout`` in the operands' dtype,
    ``lse`` and ``delta`` (G,Sq) in the accumulator type."""
    if _device_kind("flash_bwd_dq", qf) == "cpu":
        return flash_bwd_dq_plain(qf, kf, vf, kvm, dout, lse, delta,
                                  causal=causal, bq=bq, bk=bk)
    _check_launchable("flash_bwd_dq", qf, kf, vf, kvm, dout, lse, delta)
    g, sq, sk, d, _, _ = _geometry(qf, kf, bq, bk)
    lib = build.load("attention")
    dq = torch.empty_like(qf)
    err = build.launch(lib.repro_flash_bwd_dq, qf.device, qf.data_ptr(),
                  kf.data_ptr(), vf.data_ptr(), kvm.data_ptr(),
                  dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                  dq.data_ptr(), g, sq, sk, d, bq, bk, int(causal),
                  _DTYPE_CODES[qf.dtype])
    build.raise_on_launch_error(err, "flash_bwd_dq")
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv(qf, kf, vf, kvm, dout, lse, delta, *, causal: bool,
                  bq: int, bk: int):
    """dK/dV kernel on flat padded operands; returns ``(dk, dv)``."""
    if _device_kind("flash_bwd_dkv", qf) == "cpu":
        return flash_bwd_dkv_plain(qf, kf, vf, kvm, dout, lse, delta,
                                   causal=causal, bq=bq, bk=bk)
    _check_launchable("flash_bwd_dkv", qf, kf, vf, kvm, dout, lse, delta)
    g, sq, sk, d, _, _ = _geometry(qf, kf, bq, bk)
    lib = build.load("attention")
    dk = torch.empty_like(kf)
    dv = torch.empty_like(vf)
    err = build.launch(lib.repro_flash_bwd_dkv, qf.device, qf.data_ptr(),
                  kf.data_ptr(), vf.data_ptr(), kvm.data_ptr(),
                  dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                  dk.data_ptr(), dv.data_ptr(), g, sq, sk, d, bq, bk,
                  int(causal), _DTYPE_CODES[qf.dtype])
    build.raise_on_launch_error(err, "flash_bwd_dkv")
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


# ---------------------------------------------------------------------------
# autograd core (operates on padded, flattened operands)
# ---------------------------------------------------------------------------


class _FlashCore(torch.autograd.Function):
    """The reference's ``_flash_core`` custom VJP."""

    @staticmethod
    def forward(ctx, qf, kf, vf, kvm, causal, bq, bk):
        out, lse, _ = flash_fwd(qf, kf, vf, kvm, causal=causal, bq=bq, bk=bk)
        ctx.save_for_backward(qf, kf, vf, kvm, out, lse)
        ctx.geom = dict(causal=causal, bq=bq, bk=bk)
        return out

    @staticmethod
    def backward(ctx, dout):
        qf, kf, vf, kvm, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        # D_i = sum_j dO_ij * O_ij, shared by both backward kernels
        delta = (dout.to(lse.dtype) * out.to(lse.dtype)).sum(dim=-1)
        dq = flash_bwd_dq(qf, kf, vf, kvm, dout, lse, delta, **ctx.geom)
        dk, dv = flash_bwd_dkv(qf, kf, vf, kvm, dout, lse, delta, **ctx.geom)
        return dq, dk, dv, None, None, None, None


# ---------------------------------------------------------------------------
# Public entry points (validation, padding, flattening)
# ---------------------------------------------------------------------------


def _validate(q, k, v, kv_valid):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(
            f"flash_attention expects rank-4 (B,H,S,D) operands, got "
            f"q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    if k.shape != v.shape:
        raise ValueError(
            f"flash_attention: k{tuple(k.shape)} and v{tuple(v.shape)} "
            f"must match")
    if q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(
            f"flash_attention: q{tuple(q.shape)} is incompatible with "
            f"k{tuple(k.shape)} (batch/head/head_dim must match)")
    if kv_valid is not None and tuple(kv_valid.shape) != (q.shape[0],
                                                          k.shape[2]):
        raise ValueError(
            f"flash_attention: kv_valid{tuple(kv_valid.shape)} must be "
            f"(B, Sk) = {(q.shape[0], k.shape[2])}")


def _block_geometry(sq: int, sk: int, bq: int, bk: int):
    """Clamp blocks to the (unpadded) lengths, then round lengths UP to
    block multiples — the padded tail is masked, never asserted away."""
    bq = max(1, min(bq, sq))
    bk = max(1, min(bk, sk))
    sq_p = -(-sq // bq) * bq
    sk_p = -(-sk // bk) * bk
    return bq, bk, sq_p, sk_p


def _prepare(q, k, v, kv_valid, bq, bk):
    """Pad to block multiples and flatten (B,H) -> G. Returns the flat,
    contiguous operands plus the blocks needed to undo it."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    bq, bk, sq_p, sk_p = _block_geometry(sq, sk, bq, bk)
    if sq_p != sq:
        q = F.pad(q, (0, 0, 0, sq_p - sq))
    if sk_p != sk:
        k = F.pad(k, (0, 0, 0, sk_p - sk))
        v = F.pad(v, (0, 0, 0, sk_p - sk))
    valid = torch.arange(sk_p, device=q.device) < sk          # (sk_p,)
    if kv_valid is None:
        kvm = valid[None, :].expand(b, sk_p)
    else:
        kvm = F.pad(kv_valid.to(torch.bool), (0, sk_p - sk)) & valid[None, :]
    kvm = kvm[:, None, :].expand(b, h, sk_p).reshape(b * h, sk_p) \
        .to(torch.int32).contiguous()
    qf = q.reshape(b * h, sq_p, d).contiguous()
    kf = k.reshape(b * h, sk_p, d).contiguous()
    vf = v.reshape(b * h, sk_p, d).contiguous()
    return qf, kf, vf, kvm, bq, bk


def _flash_padded(q, k, v, kv_valid, *, causal, bq, bk):
    b, h, sq, d = q.shape
    qf, kf, vf, kvm, bq, bk = _prepare(q, k, v, kv_valid, bq, bk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (qf, kf, vf)):
        out = _FlashCore.apply(qf, kf, vf, kvm, causal, bq, bk)
    else:               # nothing to differentiate: no residuals kept
        out, _, _ = flash_fwd(qf, kf, vf, kvm, causal=causal, bq=bq, bk=bk)
    return out[:, :sq].reshape(b, h, sq, d)


def flash_attention(q, k, v, *, kv_valid=None, causal: bool = True,
                    bq: int = 128, bk: int = 128):
    """Blockwise attention with a training-grade backward.

    q (B,H,Sq,D); k,v (B,H,Sk,D); kv_valid (B,Sk) bool or None ->
    (B,H,Sq,D). Differentiable w.r.t. q, k, v. Ragged Sq/Sk are padded to
    block multiples internally; rows with no valid key return zeros.
    """
    _validate(q, k, v, kv_valid)
    return _flash_padded(q, k, v, kv_valid, causal=causal, bq=bq, bk=bk)


def flash_attention_probe(q, k, v, *, kv_valid=None, causal: bool = True,
                          bq: int = 128, bk: int = 128):
    """Forward pass plus the block-skip witness.

    Returns (out, probe) where probe (B*H, n_q_blocks) int32 counts the KV
    blocks each q row-block's loop walked. The causal guarantee is
    ``probe[g, qb] == min(n_k, qb*bq//bk + 1)`` rather than n_k —
    O(n_k/2) summed over the triangle.
    """
    _validate(q, k, v, kv_valid)
    b, h, sq, d = q.shape
    qf, kf, vf, kvm, bq, bk = _prepare(q, k, v, kv_valid, bq, bk)
    out, _, probe = flash_fwd(qf, kf, vf, kvm, causal=causal, bq=bq, bk=bk)
    return out[:, :sq].reshape(b, h, sq, d), probe
