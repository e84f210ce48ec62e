"""Attention blocks: GQA (+RoPE) with a KV cache, cross-attention, and
DeepSeek's Multi-head Latent Attention (MLA).

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

Cross-attention (vision and encoder-decoder models) is pure key-validity
masking, no causal term: with the route enabled it is the kernel's
non-causal mode, with ``memory_valid`` as ``kv_valid``.

MLA keeps a compressed cache (``c_kv`` of the latent width and the rotary
``k_rope``): prefill and the no-cache forward expand K/V chunk by chunk
from it (``_mla_chunked``, an online softmax as above); a one-token decode
takes the absorbed form, scoring and summing in the latent space. Its
products are plain ``torch.einsum`` calls, as the reference's are plain
einsums outside any Pallas kernel. Under a mesh context
(:func:`set_mesh_ctx`) a prefill runs the chunked loop lane-local
(:func:`mla_chunked`); a tensor-parallel rank runs its own heads
(:func:`mla_attention`'s ``tp``).

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
from repro_torch.core import compat, step_analysis
from repro_torch.core.compat import PartitionSpec as PS
from repro_torch.models.layers import (P, apply_rope, repeat_kv, rms_norm,
                                       rotary_embedding, widen)
from repro_torch.models.sharding import around_split

NEG_INF = -1e30
CHUNK_THRESHOLD = 2048  # use chunked attention when kv_len exceeds this
KV_CHUNK = 1024

# Mesh context set by transformer.forward: lets MLA's chunked loop run as
# an explicit lane-local shard_map (see mla_chunked).
_MESH_CTX = None


def set_mesh_ctx(ctx):
    global _MESH_CTX
    _MESH_CTX = ctx


def flash_route_enabled(mode: str = "auto", device=None) -> bool:
    """Should attention route through the blockwise-attention kernel?

    ``mode`` is the config knob ("auto" | "on" | "off"). The
    ``REPRO_FLASH_ATTENTION`` env var (1/0) overrides. "auto" means kernel
    on the accelerator: True when ``device`` (where the operands lie) is a
    CUDA device, False on the CPU, where the kernel's plain version would
    only repeat the blockwise branches' arithmetic. A ``meta`` device takes
    the route of the device that a running ``core.step_analysis.analyze``
    counts for (its ``target``), so a count on ``meta`` is the count of
    that device's step."""
    env = os.environ.get("REPRO_FLASH_ATTENTION", "").strip().lower()
    if env in ("1", "on", "true"):
        return True
    if env in ("0", "off", "false"):
        return False
    if mode == "on":
        return True
    if mode == "off":
        return False
    if device is None:
        return False
    kind = torch.device(device).type
    if kind == "meta":
        kind = step_analysis.target()
    return kind == "cuda"


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


def _lane_local_ok(batch: int, heads: int) -> bool:
    """True when heads divide the lane axis and batch divides the batch
    axes — the MLA chunked loop then runs as an explicit shard_map."""
    ctx = _MESH_CTX
    if ctx is None or ctx.mesh is None:
        return False
    b_div = math.prod(ctx.axis_sizes.get(a, 1) for a in ctx.batch_axes)
    return heads % max(ctx.n_lanes, 1) == 0 and batch % max(b_div, 1) == 0


def gqa_template(cfg: ArchConfig, cross: bool = False) -> dict:
    """``cross`` adds the vision model's ``q_norm`` (kept for a like-for-like
    tree: the reference never reads it) and the tanh ``gate``, initialised
    to zero, so that a cross layer adds nothing at init."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hp, hkv = cfg.n_heads_padded, cfg.n_kv_heads
    t = {
        "wq": P((d, hp, hd), ("embed", "heads", "head_dim"), "fan_in"),
        "wk": P((d, hkv, hd), ("embed", "kv_heads", "head_dim"), "fan_in"),
        "wv": P((d, hkv, hd), ("embed", "kv_heads", "head_dim"), "fan_in"),
        "wo": P((hp, hd, d), ("heads", "head_dim", "embed"), "fan_in"),
    }
    if cross:
        t["q_norm"] = P((d,), ("embed",), "ones")
        t["gate"] = P((), (), "zeros")  # tanh-gated cross-attn (llama3.2-V)
    return t


def mla_template(cfg: ArchConfig) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": P((d, m.q_lora_rank), ("embed", "q_lora"), "fan_in"),
        "q_norm": P((m.q_lora_rank,), ("q_lora",), "ones"),
        "wq_b": P((m.q_lora_rank, h, qk), ("q_lora", "heads", "head_dim"),
                  "fan_in"),
        "wkv_a": P((d, m.kv_lora_rank + m.qk_rope_head_dim),
                   ("embed", "kv_lora"), "fan_in"),
        "kv_norm": P((m.kv_lora_rank,), ("kv_lora",), "ones"),
        "wkv_b": P((m.kv_lora_rank, h, m.qk_nope_head_dim + m.v_head_dim),
                   ("kv_lora", "heads", "head_dim"), "fan_in"),
        "wo": P((h, m.v_head_dim, d), ("heads", "head_dim", "embed"),
                "fan_in"),
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


def write_rows(cache, new, lengths):
    """Write ``new`` (B, S_new, ...) into ``cache`` (B, Smax, ...) at
    per-sequence positions, **in place**, and return ``cache``.

    Row ``b`` is written at ``[start_b, start_b + S_new)``. The start is
    clamped so the slice fits, ``start_b = clip(lengths[b], 0, Smax -
    S_new)``, which is what the reference's dynamic-update-slice does for
    an out-of-range start — so both stacks compute the same thing for every
    input (an unclamped indexed write would be a device-side fault). The
    hardened engine never relies on the clamp: it retires a slot at
    capacity (``I_KV_CAPACITY``).
    """
    smax, s_new = cache.shape[1], new.shape[1]
    if s_new > smax:
        raise ValueError(f"update_cache: {s_new} new rows do not fit a cache "
                         f"of {smax}")
    dev = cache.device
    start = lengths.to(torch.int64).clamp(0, smax - s_new)
    rows = start[:, None] + torch.arange(s_new, device=dev)[None, :]
    batch = torch.arange(cache.shape[0], device=dev)[:, None]
    cache[batch, rows] = new.to(cache.dtype)
    return cache


def update_cache(cache_k, cache_v, k_new, v_new, lengths):
    """Write new KV rows at per-sequence positions, **in place**
    (:func:`write_rows`). cache_k/v: (B, Smax, Hkv, D); k/v_new: (B, S_new,
    Hkv, D); lengths: (B,). Returns the same two tensors."""
    return (write_rows(cache_k, k_new, lengths),
            write_rows(cache_v, v_new, lengths))


# ---------------------------------------------------------------------------
# GQA attention (full forward / prefill / decode)
# ---------------------------------------------------------------------------


def gqa_attention(cfg: ArchConfig, p: dict, x, positions, *,
                  cache: Optional[dict] = None, kv_valid=None, causal=True,
                  tp=None):
    """x (B,S,d); positions (B,S) absolute. cache = {"k","v","lengths"} or None.

    Returns (out (B,S,d), new_cache_entries or None). With a cache, its
    ``k``/``v`` tensors are updated in place and returned.

    ``tp`` (``models.sharding.TensorParallel``): ``p`` holds the rank's
    block of the heads (``wq``, ``wo``) and of the kv heads (``wk``,
    ``wv``, and a cache's ``k``/``v``), or all the kv heads where the
    model axis does not divide them; the rank attends with its own heads
    (each with the kv group it reads in the whole model), Megatron's
    ``copy_to`` at each projection's input (at ``k``'s and ``v``'s output
    where the kv heads are whole) and ``reduce_from`` after ``wo``.
    """
    h, hkv, hd = cfg.n_heads_padded, cfg.n_kv_heads, cfg.resolved_head_dim
    into = (lambda t: t) if tp is None else tp.copy
    q = torch.einsum("bsd,dhk->bshk", into(x), p["wq"].to(x.dtype))
    k, v = _project_kv(p, x, hkv, tp)

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

    heads = _local_heads(q.shape[2], tp)
    k_full, v_full = _kv_for_heads(k_full, v_full, h, hkv, heads)
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
    out = _mask_pad_heads(cfg, out, heads)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return (out if tp is None else tp.reduce(out)), new_cache


def _project_kv(p: dict, src, hkv: int, tp):
    """``src @ wk`` and ``src @ wv`` in ``src``'s dtype. With ``tp`` (a
    tensor-parallel rank): ``copy_to`` at ``src`` where ``wk`` / ``wv`` hold
    the rank's block of the kv heads; where they hold every kv head, ``k``
    and ``v`` are whole and their cotangents partial (the rank's heads'
    groups), so ``copy_to`` goes at their outputs, and ``wk``, ``wv`` and
    ``src`` take whole gradients from them."""
    wk, wv = p["wk"].to(src.dtype), p["wv"].to(src.dtype)
    if tp is not None and p["wk"].shape[1] == hkv:
        return (tp.copy(torch.einsum("bsd,dhk->bshk", src, wk)),
                tp.copy(torch.einsum("bsd,dhk->bshk", src, wv)))
    into = (lambda t: t) if tp is None else tp.copy
    return (torch.einsum("bsd,dhk->bshk", into(src), wk),
            torch.einsum("bsd,dhk->bshk", into(src), wv))


def _kv_for_heads(k, v, h: int, hkv: int, heads: Optional[range]):
    """``k`` and ``v`` (B, T, kv heads, D) repeated to the query heads: to
    ``h`` of them, each group's kv head ``h / hkv`` times; on a
    tensor-parallel rank (``heads``: its query heads' global indices)
    holding every kv head, the group each of its heads reads in the whole
    model."""
    if k.shape[2] == hkv and heads is not None:
        group = torch.arange(heads.start, heads.stop,
                             device=k.device) // (h // hkv)
        return k[:, :, group], v[:, :, group]
    return repeat_kv(k, h // hkv), repeat_kv(v, h // hkv)


def _local_heads(n_local: int, tp) -> Optional[range]:
    """The global indices of a tensor-parallel rank's ``n_local`` heads
    (None without ``tp``)."""
    if tp is None:
        return None
    return range(tp.start(n_local), tp.start(n_local) + n_local)


def _mask_pad_heads(cfg: ArchConfig, out, heads: Optional[range] = None):
    """Zero the padded heads' outputs so padding stays model-equivalent.

    GQA grouping: repeat_kv assigns q head h to kv group h // (Hp/hkv), so
    the live heads are the first H/hkv slots of each group — the q<->kv
    pairing of the unpadded model is preserved. ``heads``: the global
    indices of ``out``'s heads (a tensor-parallel rank's block), all of
    them by default."""
    hp, h, hkv = cfg.n_heads_padded, cfg.n_heads, cfg.n_kv_heads
    if hp == h:
        return out
    per_group_pad = hp // hkv
    per_group_live = h // hkv
    heads = range(hp) if heads is None else heads
    head_live = (torch.arange(heads.start, heads.stop, device=out.device)
                 % per_group_pad) < per_group_live
    return out * head_live.to(out.dtype)[None, None, :, None]


def cross_attention(cfg: ArchConfig, p: dict, x, memory, memory_valid=None,
                    tp=None):
    """Cross-attn to encoder/vision memory (B,T,d). Tanh-gated if gate in p.

    With the flash route enabled (on a CUDA device by default) it runs the
    blockwise-attention kernel in its non-causal mode with ``memory_valid``
    as ``kv_valid``: pure key-validity masking is exactly that mode, and
    rows with no valid key output zeros either way.

    ``tp`` (``models.sharding.TensorParallel``): as :func:`gqa_attention`'s,
    ``p`` holds the rank's block of the heads and of the kv heads (or all
    the kv heads, whose ``k`` and ``v`` then pass ``copy_to`` at their
    outputs), ``copy_to`` at each projection's input (``x`` for ``q``,
    ``memory`` for ``k`` and ``v``: the encoder's output takes its
    cotangent summed over the model axis; the vision frontend's
    embeddings take none) and ``reduce_from`` after ``wo``. The gate,
    whole on every rank, scales the reduced output: its gradient is then
    whole on every rank with no collective of its own."""
    h, hkv = cfg.n_heads_padded, cfg.n_kv_heads
    into = (lambda t: t) if tp is None else tp.copy
    q = torch.einsum("bsd,dhk->bshk", into(x), p["wq"].to(x.dtype))
    heads = _local_heads(q.shape[2], tp)
    k, v = _kv_for_heads(*_project_kv(p, memory, hkv, tp), h,
                         hkv, heads)
    b, t = memory.shape[:2]
    if memory_valid is None:
        memory_valid = torch.ones((b, t), dtype=torch.bool, device=x.device)
    if flash_route_enabled(getattr(cfg, "attn_flash", "auto"),
                           device=x.device):
        out = _flash_attention(q, k, v, memory_valid, causal=False)
    else:
        out = _masked_softmax_attn(q, k, v, memory_valid[:, None, None, :])
    out = _mask_pad_heads(cfg, out, heads)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    if tp is not None:
        out = tp.reduce(out)
    if "gate" in p:
        out = torch.tanh(p["gate"]).to(x.dtype) * out
    return out


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3)
# ---------------------------------------------------------------------------


def _mla_triangular(cfg, q_nope, q_rope, c_kv, k_rope, wkv_b, q_pos,
                    chunk=KV_CHUNK, lane_local=False):
    """Causal-triangle q-block loop around mla_chunked (no-cache forward and
    from-zero prefill: S == T, positions == arange): q block ``i`` runs only
    against the first ``i + 1`` chunks of keys. The loop runs when S is a
    whole number of chunks, more than one; otherwise one mla_chunked call
    walks all keys."""
    s_len = q_nope.shape[1]
    b = c_kv.shape[0]
    if s_len % chunk or s_len <= chunk:
        return mla_chunked(cfg, q_nope, q_rope, c_kv, k_rope, wkv_b, q_pos,
                           torch.ones((b, c_kv.shape[1]), dtype=torch.bool,
                                      device=c_kv.device), chunk,
                           lane_local=lane_local)
    outs = []
    for i in range(s_len // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        t_hi = (i + 1) * chunk
        outs.append(mla_chunked(
            cfg, q_nope[:, sl], q_rope[:, sl], c_kv[:, :t_hi],
            k_rope[:, :t_hi], wkv_b, q_pos[:, sl],
            torch.ones((b, t_hi), dtype=torch.bool, device=c_kv.device),
            chunk, lane_local=lane_local))
    return torch.cat(outs, dim=1)


def mla_chunked(cfg, q_nope, q_rope, c_kv, k_rope, wkv_b, q_pos, kv_valid,
                chunk=KV_CHUNK, lane_local=False):
    """Dispatcher: the lane-local ``shard_map`` when the mesh allows
    (:func:`_lane_local_ok`: heads on the lanes, batch on the batch axes —
    no collective inside the loop; the Ara lane principle applied to
    attention), :func:`_mla_chunked` otherwise. The mesh is held as tensor
    dimensions (``core/compat.py``), so the body is :func:`_mla_chunked`
    run once on the stacks. Inference-only, as in the reference (its
    callers pass ``lane_local=True`` only on the cache path)."""
    ctx = _MESH_CTX
    if not (lane_local and _lane_local_ok(q_nope.shape[0], q_nope.shape[2])):
        return _mla_chunked(cfg, q_nope, q_rope, c_kv, k_rope, wkv_b, q_pos,
                            kv_valid, chunk)
    b_axes = tuple(ctx.batch_axes)
    lanes = ctx.model_axis
    fn = functools.partial(_mla_chunked, cfg, chunk=chunk)
    return compat.shard_map(
        fn, mesh=ctx.mesh,
        in_specs=(PS(b_axes, None, lanes, None),   # q_nope
                  PS(b_axes, None, lanes, None),   # q_rope
                  PS(b_axes, None, None),          # c_kv
                  PS(b_axes, None, None),          # k_rope
                  PS(None, lanes, None),           # wkv_b
                  PS(b_axes, None),                # q_pos
                  PS(b_axes, None)),               # kv_valid
        out_specs=PS(b_axes, None, lanes, None),
    )(q_nope, q_rope, c_kv, k_rope, wkv_b, q_pos, kv_valid)


def _mla_chunked(cfg, q_nope, q_rope, c_kv, k_rope, wkv_b, q_pos, kv_valid,
                 chunk=KV_CHUNK):
    """Chunked MLA attention without materializing the expanded K/V.

    K and V are expanded chunk by chunk from the compressed cache inside an
    online softmax over the chunks, and the rope term stays a separate
    head-free product. q_nope (B,S,H,nope); q_rope (B,S,H,rope); c_kv
    (B,T,kv_lora); k_rope (B,T,rope), already rotary-encoded; every operand
    may carry the same leading dimensions (a mesh's stacks: ``wkv_b``
    (...,kv_lora,H,k), ``q_pos`` (...,B,S), ``kv_valid`` (...,B,T)). Scores
    accumulate in fp32 (float64 for float64 operands). The ragged last
    chunk is simply shorter: the reference pads it with invalid keys,
    which contribute nothing.
    """
    m = cfg.mla
    nope, rope, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    lead = q_nope.shape[:-4]
    b, s_len, h, _ = q_nope.shape[-4:]
    t_len = c_kv.shape[-2]
    dev = q_nope.device
    scale = 1.0 / math.sqrt(nope + rope)
    kv_pos = torch.arange(t_len, dtype=torch.int32, device=dev)
    chunk = min(chunk, t_len)

    wide = torch.promote_types(q_nope.dtype, torch.float32)
    acc = torch.zeros(lead + (b, s_len, h, dv), dtype=wide, device=dev)
    m_run = torch.full(lead + (b, h, s_len), NEG_INF, dtype=wide,
                       device=dev)
    l_run = torch.zeros(lead + (b, h, s_len), dtype=wide, device=dev)
    qn, qr = widen(q_nope), widen(q_rope)
    for start in range(0, t_len, chunk):
        ckv_b = c_kv[..., start:start + chunk, :]
        validb = kv_valid[..., start:start + chunk]
        posb = kv_pos[start:start + chunk]
        kv_b = torch.einsum("...btr,...rhk->...bthk", ckv_b, wkv_b)
        k_nope_b, v_b = kv_b[..., :nope], kv_b[..., nope:]
        sc = torch.einsum("...bshk,...bthk->...bhst", qn, widen(k_nope_b))
        sc = sc + torch.einsum("...bshk,...btk->...bhst", qr,
                               widen(k_rope[..., start:start + chunk, :]))
        sc = sc * scale
        mask = (posb <= q_pos[..., :, None, :, None]) \
            & validb[..., :, None, None, :]
        sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
        m_new = torch.maximum(m_run, sc.amax(dim=-1))
        alpha = torch.exp(m_run - m_new)
        m_safe = torch.where(m_new > NEG_INF * 0.5, m_new,
                             torch.zeros_like(m_new))      # dead rows -> 0
        p = torch.exp(sc - m_safe[..., None])
        l_run = l_run * alpha + p.sum(dim=-1)
        pv = torch.einsum("...bhst,...bthd->...bshd", p.to(v_b.dtype), v_b)
        acc = acc * alpha.transpose(-1, -2)[..., None] + widen(pv)
        m_run = m_new
    out = acc / l_run.clamp_min(1e-30).transpose(-1, -2)[..., None]
    return out.to(q_nope.dtype)


def mla_attention(cfg: ArchConfig, p: dict, x, positions, *,
                  cache: Optional[dict] = None, prefill_from_zero=False,
                  tp=None):
    """Multi-head Latent Attention.

    No cache and prefill: the expanded form. Decode (a cache and one new
    token): the absorbed form — scores and values computed directly in the
    compressed kv_lora space, so the cache is ``c_kv`` (B, Smax, kv_lora)
    and ``k_rope`` (B, Smax, rope) whatever the head count. The cache's two
    tensors are written in place (:func:`write_rows`) and returned.

    ``tp`` (``models.sharding.TensorParallel``): ``p`` holds the rank's
    heads of ``wq_b``, ``wkv_b`` and ``wo`` and the latent projections and
    norms whole (the reference's rules put ``q_lora`` / ``kv_lora`` on the
    FSDP axis, None without FSDP); the rank attends with its heads over
    the whole latent cache, Megatron's ``copy_to`` on the head-split
    work's three inputs (``q_lat``, ``c_kv``, ``k_rope``: their cotangents
    all-reduced, ``q_lora + kv_lora + rope`` values a token) and
    ``reduce_from`` after ``wo``. Its chunked loop is never the lane-local
    ``shard_map``: the rank already holds its heads. On a stacked mesh
    whose model axis splits the heads, the same pair is counted
    (``models.sharding.around_split``), as the ranks run it.
    """
    m = cfg.mla
    nope, rope = m.qk_nope_head_dim, m.qk_rope_head_dim
    # the latent down-projections are replicated over model: a partitioner
    # runs them whole on every device, the dry run divides them evenly
    step_analysis.short("flops: even split of mla's latent projections",
                        step_analysis.MODEL_AXIS)

    q_lat = rms_norm(torch.einsum("bsd,dr->bsr", x, p["wq_a"].to(x.dtype)),
                     p["q_norm"], cfg.norm_eps)
    kv_a = torch.einsum("bsd,dr->bsr", x, p["wkv_a"].to(x.dtype))
    c_kv = rms_norm(kv_a[..., :m.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    k_rope = kv_a[..., m.kv_lora_rank:]
    cos, sin = rotary_embedding(positions, rope, cfg.rope_theta)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]

    ctx, share = _MESH_CTX, 1.0
    if tp is None and ctx is not None and ctx.mesh is not None:
        # each rank of a stacked mesh holds its rows of the batch; where
        # the model axis does not divide the heads, the reference
        # replicates them and nothing is split
        share = ctx.n_lanes / math.prod(ctx.axis_sizes.values())
        ctx = ctx if cfg.n_heads % ctx.n_lanes == 0 else None
    into, out_of, scope = around_split(ctx, tp, share)
    with scope:
        q = torch.einsum("bsr,rhk->bshk", into(q_lat),
                         p["wq_b"].to(x.dtype))
        q_nope, q_rope = q[..., :nope], q[..., nope:]
        q_rope = apply_rope(q_rope, cos, sin)
        c_kv, k_rope = into(c_kv), into(k_rope)
        wkv_b = p["wkv_b"].to(x.dtype)
        out, new_cache = _mla_heads(cfg, q_nope, q_rope, c_kv, k_rope, wkv_b,
                                    positions, cache, prefill_from_zero,
                                    lane_local=tp is None)
        out = out_of(torch.einsum("bshk,hkd->bsd", out,
                                  p["wo"].to(x.dtype)))
    return out, new_cache


def _mla_heads(cfg, q_nope, q_rope, c_kv, k_rope, wkv_b, positions, cache,
               prefill_from_zero, lane_local):
    """MLA's attention over the heads of ``q_nope`` / ``q_rope`` and
    ``wkv_b`` (all of them, or a tensor-parallel rank's): (out (B,S,H,v),
    the cache's two tensors written in place, or None without a cache).
    ``lane_local``: a prefill may take :func:`mla_chunked`'s lane-local
    route."""
    m = cfg.mla
    nope, rope = m.qk_nope_head_dim, m.qk_rope_head_dim
    if cache is None:
        return _mla_triangular(cfg, q_nope, q_rope, c_kv, k_rope, wkv_b,
                               positions), None
    w_uk, w_uv = wkv_b[..., :nope], wkv_b[..., nope:]
    ckv = write_rows(cache["c_kv"], c_kv, cache["lengths"])
    ckr = write_rows(cache["k_rope"], k_rope, cache["lengths"])
    new_cache = {"c_kv": ckv, "k_rope": ckr}
    t_len = ckv.shape[1]
    kv_valid = torch.arange(t_len, dtype=torch.int32,
                            device=q_nope.device)[None, :] \
        <= positions[:, -1:]
    ckv_x, ckr_x = ckv.to(q_nope.dtype), ckr.to(q_nope.dtype)

    if q_nope.shape[1] > 1:
        # prefill: chunked attention over the updated compressed cache; a
        # from-zero prefill that fills the cache walks the triangle
        if prefill_from_zero and q_nope.shape[1] == t_len:
            return _mla_triangular(cfg, q_nope, q_rope, ckv_x, ckr_x, wkv_b,
                                   positions, lane_local=lane_local), \
                new_cache
        return mla_chunked(cfg, q_nope, q_rope, ckv_x, ckr_x, wkv_b,
                           positions, kv_valid,
                           lane_local=lane_local), new_cache
    # absorbed single-token decode: O(kv_lora) per cached token; a
    # partitioner gathers and reduces its scores over model
    step_analysis.short("collective: mla decode gathers",
                        step_analysis.MODEL_AXIS)
    q_c = torch.einsum("bshk,rhk->bshr", q_nope, w_uk)      # absorb W_UK
    s = torch.einsum("bshr,btr->bhst", widen(q_c), widen(ckv_x))
    s = s + torch.einsum("bshk,btk->bhst", widen(q_rope), widen(ckr_x))
    s = s * (1.0 / math.sqrt(nope + rope))
    s = torch.where(kv_valid[:, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    pr = torch.softmax(s, dim=-1).to(q_nope.dtype)
    o_c = torch.einsum("bhst,btr->bshr", pr, ckv_x)
    return torch.einsum("bshr,rhk->bshk", o_c, w_uv), new_cache
