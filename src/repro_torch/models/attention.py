"""Attention blocks: GQA (+RoPE) with a KV cache.

Long sequences use a chunked online-softmax formulation — blockwise-
parallel attention: the KV axis is walked chunk by chunk with a running
max / denominator, so the score matrix is never materialized past one
chunk. Sequences at or below the threshold take one masked softmax.

The no-cache causal case (training, and the full forward a scorer runs)
routes through the blockwise-attention kernel, ``kernels.ops.
flash_attention`` (CUDA forward and recompute-p backward), when
:func:`flash_route_enabled` says so: by default when the operands lie on a
CUDA device, as the reference takes its kernel on its accelerator. On the
CPU, or with the route off, the same case computes through the quadratic /
per-q-block branches, whose per-q-block ``torch.utils.checkpoint`` policy
(``block_remat``) bounds the residuals a backward pass keeps.

Convention (shared with the reference and its kernel): rows with NO valid
key output zeros.

KV-cache decode supports per-sequence lengths (continuous batching) via a
row-wise indexed write, in place.
"""
from __future__ import annotations

import functools
import math
import os
from typing import Optional

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (P, apply_rope, repeat_kv,
                                       rotary_embedding, widen)

NEG_INF = -1e30
CHUNK_THRESHOLD = 2048  # use chunked attention when kv_len exceeds this
KV_CHUNK = 1024

def flash_route_enabled(mode: str = "auto", device=None) -> bool:
    """Should attention route through the blockwise-attention kernel?

    ``mode`` is the config knob ("auto" | "on" | "off"). The
    ``REPRO_FLASH_ATTENTION`` env var (1/0) overrides. "auto" means kernel
    on the accelerator: True when ``device`` (where the operands lie) is a
    CUDA device, False on the CPU, where the kernel's plain version would
    only repeat the blockwise branches' arithmetic."""
    env = os.environ.get("REPRO_FLASH_ATTENTION", "").strip().lower()
    if env in ("1", "on", "true"):
        return True
    if env in ("0", "off", "false"):
        return False
    if mode == "on":
        return True
    if mode == "off":
        return False
    return device is not None and torch.device(device).type == "cuda"


# the reference's jax.checkpoint policies, by the matrix products whose
# outputs a policy keeps: "dots" keeps every product, batched ones too
# (bmm), "dots_no_batch" only those without batch dimensions (mm)
_SAVED_PRODUCTS = {
    "dots": {torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
             torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default},
    "dots_no_batch": {torch.ops.aten.mm.default,
                      torch.ops.aten.addmm.default},
}
_CKPT_POLICIES = ("everything", "nothing", "dots", "dots_no_batch")


def checkpoint_policy(name: str):
    """The ``torch.utils.checkpoint`` context for a named policy of the
    per-q-block triangular loop (the blockwise-parallel-transformer knob),
    shared with ``transformer._maybe_remat``. "none" -> None (no
    checkpoint); "everything" -> None too, since saving every residual is
    what plain autograd does; "nothing" -> a context that saves no
    residual; "dots" / "dots_no_batch" -> a selective-checkpoint context
    that saves the matrix products' outputs and recomputes the rest. Any
    other name raises ``ValueError``: no policy is mapped to another."""
    if name in (None, "none", ""):
        return None
    if name not in _CKPT_POLICIES:
        raise ValueError(
            f"unknown checkpoint policy {name!r}; pick one of "
            f"{['none', *_CKPT_POLICIES]}")
    if name == "everything":
        return None
    if name == "nothing":
        return _ckpt.noop_context_fn
    saved = _SAVED_PRODUCTS[name]

    def policy(ctx, op, *args, **kwargs):
        return (_ckpt.CheckpointPolicy.MUST_SAVE if op in saved
                else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)
    return functools.partial(_ckpt.create_selective_checkpoint_contexts,
                             policy)


def checkpointed(fn, name: str):
    """``fn`` under the named checkpoint policy (see
    :func:`checkpoint_policy`); ``fn`` itself for "none" and
    "everything"."""
    context_fn = checkpoint_policy(name)
    if context_fn is None:
        return fn

    def wrapped(*args):
        return _ckpt.checkpoint(fn, *args, use_reentrant=False,
                                context_fn=context_fn)
    return wrapped


def _flash_attention(q, k, v, kv_valid, causal: bool):
    """(B,S,H,D)-layout adapter around kernels.ops.flash_attention."""
    from repro_torch.kernels import ops as kops
    out = kops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        kv_valid=kv_valid, causal=causal)
    return out.transpose(1, 2)


# ---------------------------------------------------------------------------
# Templates
# ---------------------------------------------------------------------------


def gqa_template(cfg: ArchConfig) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hp, hkv = cfg.n_heads_padded, cfg.n_kv_heads
    return {
        "wq": P((d, hp, hd), ("embed", "heads", "head_dim"), "fan_in"),
        "wk": P((d, hkv, hd), ("embed", "kv_heads", "head_dim"), "fan_in"),
        "wv": P((d, hkv, hd), ("embed", "kv_heads", "head_dim"), "fan_in"),
        "wo": P((hp, hd, d), ("heads", "head_dim", "embed"), "fan_in"),
    }


# ---------------------------------------------------------------------------
# Core attention math
# ---------------------------------------------------------------------------


def _scores(q, k):
    """q (B,S,H,D) · k (B,T,H,D) -> (B,H,S,T) in fp32 (float64 for float64
    operands). Operands are widened first, so narrow inputs still accumulate
    — and arrive at the mask and the softmax — in fp32, never rounded to
    their own dtype on the way."""
    return torch.einsum("bshd,bthd->bhst", widen(q), widen(k))


def _masked_softmax_attn(q, k, v, mask):
    """Single-block attention. q (B,S,H,D), k/v (B,T,H,D), mask (B,1,S,T).
    Rows with no valid key output zeros (softmax over an all-NEG_INF row
    would otherwise emit uniform garbage)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = _scores(q, k)
    s = torch.where(mask, s * scale, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(dim=-1, keepdim=True), p,
                    torch.zeros_like(p)).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", p, v)


def chunked_attention(q, k, v, q_pos, kv_valid, kv_offset=0, chunk=KV_CHUNK,
                      triangular=False, threshold=None, use_flash="auto",
                      block_remat="none"):
    """Blockwise online-softmax attention over KV chunks.

    q: (B,S,H,D); k,v: (B,T,H,D); q_pos: (B,S) absolute positions;
    kv_valid: (B,T) bool; kv positions are kv_offset + arange(T).
    Causal: kv_pos <= q_pos AND kv_valid.

    ``triangular=True`` (S==T, q_pos==arange, kv_offset==0) splits queries
    into blocks and runs each block only against its causal prefix of KV
    chunks. When the flash route is enabled (``use_flash`` /
    ``REPRO_FLASH_ATTENTION``, see :func:`flash_route_enabled`) that case
    dispatches to the blockwise-attention kernel — same math, fused, with
    its own backward. Otherwise ``block_remat`` names the per-q-block
    checkpoint policy ("none" | "everything" | "nothing" | "dots" |
    "dots_no_batch", see :func:`checkpoint_policy`) bounding the residuals
    a backward pass keeps.

    ``threshold`` caps the materialized quadratic fast path (defaults to
    CHUNK_THRESHOLD); sequences at or below it take one masked softmax.
    """
    b, s_len, h, d = q.shape
    t_len = k.shape[1]
    dev = q.device
    kv_pos = kv_offset + torch.arange(t_len, dtype=torch.int32, device=dev)
    if threshold is None:
        threshold = CHUNK_THRESHOLD

    tri = triangular and s_len == t_len and kv_offset == 0
    if tri and flash_route_enabled(use_flash, device=dev):
        # q_pos is arange(S) by the triangular contract, so the kernel's
        # index-vs-index causal mask is exactly this mask
        return _flash_attention(q, k, v, kv_valid, causal=True)

    if t_len <= max(chunk, threshold):
        mask = (kv_pos[None, None, None, :] <= q_pos[:, None, :, None]) \
            & kv_valid[:, None, None, :]
        return _masked_softmax_attn(q, k, v, mask)

    if tri and s_len % chunk == 0:
        blk = checkpointed(functools.partial(
            chunked_attention, kv_offset=kv_offset, chunk=chunk,
            threshold=threshold), block_remat)
        outs = []
        for i in range(s_len // chunk):
            sl = slice(i * chunk, (i + 1) * chunk)
            t_hi = (i + 1) * chunk
            outs.append(blk(q[:, sl], k[:, :t_hi], v[:, :t_hi],
                            q_pos[:, sl], kv_valid[:, :t_hi]))
        return torch.cat(outs, dim=1)

    # rectangular loop over KV chunks, slicing K/V in place; the ragged
    # last chunk is simply shorter (the reference pads it with invalid
    # keys, which contribute nothing)
    scale = 1.0 / math.sqrt(d)
    wide = torch.promote_types(q.dtype, torch.float32)
    acc = torch.zeros((b, s_len, h, d), dtype=wide, device=dev)
    m_run = torch.full((b, h, s_len), NEG_INF, dtype=wide, device=dev)
    l_run = torch.zeros((b, h, s_len), dtype=wide, device=dev)
    for start in range(0, t_len, chunk):
        kb, vb = k[:, start:start + chunk], v[:, start:start + chunk]
        validb = kv_valid[:, start:start + chunk]
        posb = kv_pos[start:start + chunk]
        sc = _scores(q, kb) * scale
        mask = (posb[None, None, None, :] <= q_pos[:, None, :, None]) \
            & validb[:, None, None, :]
        sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
        m_new = torch.maximum(m_run, sc.amax(dim=-1))
        alpha = torch.exp(m_run - m_new)
        # dead rows (m_new still NEG_INF): exp(sc - m_new) would be
        # exp(0)=1 garbage — rebase those rows at 0 so exp(-1e30) -> 0
        m_safe = torch.where(m_new > NEG_INF * 0.5, m_new,
                             torch.zeros_like(m_new))
        p = torch.exp(sc - m_safe[..., None])
        l_run = l_run * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhst,bthd->bshd", p.to(vb.dtype), vb)
        acc = acc * alpha.transpose(1, 2)[..., None] + widen(pv)
        m_run = m_new
    out = acc / l_run.clamp_min(1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


def update_cache(cache_k, cache_v, k_new, v_new, lengths):
    """Write new KV rows at per-sequence positions, **in place**.

    cache_k/v: (B, Smax, Hkv, D); k/v_new: (B, S_new, Hkv, D); lengths: (B,)
    Row ``b`` is written at ``[start_b, start_b + S_new)``. The start is
    clamped so the slice fits, ``start_b = clip(lengths[b], 0, Smax -
    S_new)``, which is what the reference's dynamic-update-slice does for
    an out-of-range start — so both stacks compute the same thing for every
    input (an unclamped indexed write would be a device-side fault). The
    hardened engine never relies on the clamp: it retires a slot at
    capacity (``I_KV_CAPACITY``). Returns the same two tensors.
    """
    smax, s_new = cache_k.shape[1], k_new.shape[1]
    if s_new > smax:
        raise ValueError(f"update_cache: {s_new} new rows do not fit a cache "
                         f"of {smax}")
    dev = cache_k.device
    start = lengths.to(torch.int64).clamp(0, smax - s_new)
    rows = start[:, None] + torch.arange(s_new, device=dev)[None, :]
    batch = torch.arange(cache_k.shape[0], device=dev)[:, None]
    cache_k[batch, rows] = k_new.to(cache_k.dtype)
    cache_v[batch, rows] = v_new.to(cache_v.dtype)
    return cache_k, cache_v


# ---------------------------------------------------------------------------
# GQA attention (full forward / prefill / decode)
# ---------------------------------------------------------------------------


def gqa_attention(cfg: ArchConfig, p: dict, x, positions, *,
                  cache: Optional[dict] = None, kv_valid=None, causal=True):
    """x (B,S,d); positions (B,S) absolute. cache = {"k","v","lengths"} or None.

    Returns (out (B,S,d), new_cache_entries or None). With a cache, its
    ``k``/``v`` tensors are updated in place and returned.
    """
    h, hkv, hd = cfg.n_heads_padded, cfg.n_kv_heads, cfg.resolved_head_dim
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))

    cos, sin = rotary_embedding(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    new_cache = None
    if cache is not None:
        ck, cv = update_cache(cache["k"], cache["v"], k, v, cache["lengths"])
        new_cache = {"k": ck, "v": cv}
        t_len = ck.shape[1]
        # rows written so far (incl. current step): one validity row per
        # sequence, taken from the LAST query position; causality is then
        # applied per query through mask_pos
        kv_valid = torch.arange(t_len, dtype=torch.int32,
                                device=x.device)[None, :] \
            <= positions[:, -1:]
        k_full, v_full = ck.to(x.dtype), cv.to(x.dtype)
    else:
        k_full, v_full = k, v
        if kv_valid is None:
            kv_valid = torch.ones(k.shape[:2], dtype=torch.bool,
                                  device=x.device)

    k_full = repeat_kv(k_full, h // hkv)
    v_full = repeat_kv(v_full, h // hkv)
    mask_pos = positions if causal else torch.full_like(positions, 2**29)
    # triangular only for the no-cache path, as in the reference
    out = chunked_attention(q, k_full, v_full, mask_pos, kv_valid,
                            triangular=causal and cache is None,
                            chunk=getattr(cfg, "attn_chunk", KV_CHUNK),
                            threshold=getattr(cfg, "attn_threshold", 0)
                            or None,
                            use_flash=getattr(cfg, "attn_flash", "auto"),
                            block_remat=getattr(cfg, "attn_block_remat",
                                                "none"))
    out = _mask_pad_heads(cfg, out)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return out, new_cache


def _mask_pad_heads(cfg: ArchConfig, out):
    """Zero the padded heads' outputs so padding stays model-equivalent.

    GQA grouping: repeat_kv assigns q head h to kv group h // (Hp/hkv), so
    the live heads are the first H/hkv slots of each group — the q<->kv
    pairing of the unpadded model is preserved."""
    hp, h, hkv = cfg.n_heads_padded, cfg.n_heads, cfg.n_kv_heads
    if hp == h:
        return out
    per_group_pad = hp // hkv
    per_group_live = h // hkv
    head_live = (torch.arange(hp, device=out.device) % per_group_pad) \
        < per_group_live
    return out * head_live.to(out.dtype)[None, None, :, None]
