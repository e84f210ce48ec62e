"""State-space / linear-recurrent blocks: Mamba2 (SSD) and mLSTM (xLSTM).

Both reduce to one chunked linear-attention core:
    state_t = exp(log_decay_t) * state_{t-1} + scale_t * k_t v_t^T
    y_t     = q_t . state_t          (+ skip terms)
computed in the standard chunkwise-parallel form: quadratic attention inside
a chunk (with decay mask), a loop over chunks in order carrying the state.
As in the reference, the model runs this plain chunk loop and does not call
the scan kernel (``kernels/ssm_scan.py``), which has no initial state, no
final state and no backward; the kernel is held against
:func:`chunked_linear_attention` instead.

Deviations of the reference, kept: xLSTM's exp input gate + m-stabilizer is
replaced by sigmoid gating with fp32 accumulation + a ones-augmented value
column as normalizer — same state-space form, unconditionally stable in
bf16.

Numbers: states and accumulations are float32 for float32/bfloat16/float16
inputs, as in the reference, and float64 for float64 inputs (the port's
convention; the reference has no float64 path).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import step_analysis
from repro_torch.models.layers import P, widen
from repro_torch.models.sharding import InnerSplit

SSD_CHUNK = 64


# where the model axis does not divide a block's heads and fused widths
# (``models.sharding.inner_widths``: xlstm-1.3b's 4 heads on 16 lanes), a
# partitioner reshards its split projections where the dry run derives
# none; elsewhere the block re-lays them itself (``InnerSplit``), counted
_RESHARDED = "collective: ssm resharding under model"


def _state_dtype(dtype):
    """float32 state for narrow and float32 inputs, float64 for float64."""
    return torch.promote_types(dtype, torch.float32)


# ---------------------------------------------------------------------------
# Chunked linear-attention core
# ---------------------------------------------------------------------------


def chunked_linear_attention(q, k, v, log_decay, scale,
                             initial_state: Optional[torch.Tensor] = None,
                             chunk: int = SSD_CHUNK):
    """q,k (B,S,H,N); v (B,S,H,P); log_decay,scale (B,S,H).

    Returns y (B,S,H,P) in v's dtype and the final state (B,H,N,P),
    float32 (float64 for float64 inputs). A sequence that is not a whole
    number of chunks is zero-padded at the end, as in the reference.
    """
    b, s, h, n = q.shape
    p_dim = v.shape[-1]
    c = min(chunk, s)
    n_chunks = -(-s // c)
    pad = n_chunks * c - s
    if pad:
        def zpad(x):
            return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))
        q, k, v = zpad(q), zpad(k), zpad(v)
        log_decay, scale = zpad(log_decay), zpad(scale)

    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    acc_t = _state_dtype(v.dtype)
    state = initial_state
    if state is None:
        state = torch.zeros((b, h, n, p_dim), dtype=acc_t, device=q.device)

    ys = []
    for i in range(n_chunks):
        sl = slice(i * c, (i + 1) * c)
        qb, kb, vb, db, sb = q[:, sl], k[:, sl], v[:, sl], log_decay[:, sl], \
            scale[:, sl]                                      # (B,c,H,.)
        cd = torch.cumsum(widen(db), dim=1)                   # (B,c,H)
        # cross-chunk: y_off[t] = q_t . (exp(cd_t) * state)
        q_dec = widen(qb) * torch.exp(cd)[..., None]
        y_off = torch.einsum("bqhn,bhnp->bqhp", q_dec, state)
        # within-chunk: L[t,s] = exp(cd_t - cd_s) for s <= t. Above the
        # diagonal cd_t - cd_s >= 0 grows with the chunk's total decay, and
        # exp overflows there once it passes ~88 (fp32); the reference
        # takes exp first and masks after, so its backward multiplies that
        # inf by the mask's zero gradient: NaN. The exponent is masked
        # first here (exp(-inf) = 0): the same forward, and the same
        # gradient wherever the reference's is finite.
        scores = torch.einsum("bqhn,bshn->bqsh", widen(qb), widen(kb))
        ldiff = cd[:, :, None, :] - cd[:, None, :, :]         # (B,q,s,H)
        decay = torch.exp(ldiff.masked_fill(~tri[None, :, :, None],
                                            float("-inf")))
        w = scores * decay * sb[:, None, :, :]
        y_diag = torch.einsum("bqsh,bshp->bqhp", w, widen(vb))
        # state update: decay to end-of-chunk, add chunk contributions
        cd_last = cd[:, -1:, :]                               # (B,1,H)
        k_dec = widen(kb) * (sb * torch.exp(cd_last - cd))[..., None]
        state = state * torch.exp(cd_last[:, 0, :])[:, :, None, None] \
            + torch.einsum("bshn,bshp->bhnp", k_dec, widen(vb))
        ys.append((y_off + y_diag).to(v.dtype))
    y = torch.cat(ys, dim=1)
    return y[:, :s], state


def linear_attention_step(q, k, v, log_decay, scale, state):
    """Single-token recurrence. q,k (B,H,N); v (B,H,P); decay/scale (B,H);
    state (B,H,N,P) fp32. Returns y (B,H,P), new state."""
    state = state * torch.exp(widen(log_decay))[..., None, None] \
        + widen(scale)[..., None, None] \
        * (widen(k)[..., :, None] * widen(v)[..., None, :])
    y = torch.einsum("bhn,bhnp->bhp", widen(q), state)
    return y.to(v.dtype), state


# ---------------------------------------------------------------------------
# Depthwise causal conv (shared)
# ---------------------------------------------------------------------------


def causal_conv1d(x, w, b, conv_state=None):
    """x (B,S,C); w (W,C) depthwise; returns (y, new_state (B,W-1,C))."""
    width = w.shape[0]
    if conv_state is None:
        conv_state = torch.zeros((x.shape[0], width - 1, x.shape[2]),
                                 dtype=x.dtype, device=x.device)
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i].to(x.dtype)
            for i in range(width))
    new_state = xp[:, -(width - 1):, :] if width > 1 else conv_state
    return y + b.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------


def mamba2_template(cfg: ArchConfig) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    di = s.expansion * d
    nh = di // s.head_dim
    n = s.state_dim
    conv_dim = di + 2 * n
    return {
        "in_proj": P((d, 2 * di + 2 * n + nh), ("embed", "d_inner"),
                     "fan_in"),
        "conv_w": P((s.conv_width, conv_dim), (None, "d_inner"), "fan_in"),
        "conv_b": P((conv_dim,), ("d_inner",), "zeros"),
        "a_log": P((nh,), (None,), "zeros"),
        "d_skip": P((nh,), (None,), "ones"),
        "dt_bias": P((nh,), (None,), "zeros"),
        "norm": P((di,), ("d_inner",), "ones"),
        "out_proj": P((di, d), ("d_inner", "embed2"), "fan_in"),
    }


def _mamba2_split(cfg, p, x, split: InnerSplit):
    """(z, xbc, dt_pre, the conv's weight and bias) of the heads the block
    runs (``split.part``): every head on one device or a stacked mesh; on
    a tensor-parallel rank its heads' z, x and dt, beside B and C whole.
    The rank's column block of the fused projection (z | x | B | C | dt) is
    all-gathered (its backward reduce-scatters the cotangent) and sliced,
    and so are the conv's weight and bias (x | B | C) whole."""
    s = cfg.ssm
    di = s.expansion * cfg.d_model
    n = s.state_dim
    nh = di // s.head_dim
    zxbcdt = split.gather(split.copy(x) @ split.weight(p["in_proj"], x.dtype))
    conv_w = split.gather(split.weight(p["conv_w"]), weight=True)
    conv_b = split.gather(split.weight(p["conv_b"]), weight=True)
    z, xbc, dt_pre = zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * n], \
        zxbcdt[..., -nh:]
    if split.index is None:
        return z, xbc, dt_pre, conv_w, conv_b
    chans = split.part(di)

    def mine(t):
        """The rank's x channels, then B and C whole (x | B | C)."""
        return torch.cat([t[..., :di][..., chans], t[..., di:]], dim=-1)
    return z[..., chans], mine(xbc), dt_pre[..., split.part(nh)], \
        mine(conv_w), mine(conv_b)


def mamba2_block(cfg: ArchConfig, p: dict, x, state: Optional[dict] = None,
                 split: Optional[InnerSplit] = None):
    """x (B,S,d). state = {"conv": (B,W-1,conv_dim), "ssm": (B,H,N,P)} or None.
    Returns (y, new_state or None).

    ``split`` (``models.sharding.InnerSplit``, None: one device): on a
    tensor-parallel rank ``p`` holds its contiguous blocks of every
    ``d_inner`` leaf, the rank runs its heads (``_mamba2_split`` re-lays
    the fused projection and the conv onto them; ``a_log``, ``d_skip`` and
    ``dt_bias``, replicated, are sliced to them and their gradients
    all-reduced), its ``y`` block meets its blocks of ``norm`` (the sum of
    squares all-reduced) and of ``out_proj``'s rows (``reduce_from``); the
    state holds its heads (``conv``: their x channels, then B and C)."""
    s = cfg.ssm
    b, seq, _ = x.shape
    split = split or InnerSplit()
    if split.mesh is None:
        step_analysis.short(_RESHARDED, step_analysis.MODEL_AXIS)
    di = s.expansion * cfg.d_model
    n = s.state_dim
    nh_all = di // s.head_dim
    heads = split.part(nh_all)
    nh = heads.stop - heads.start
    hd = s.head_dim
    dl = nh * hd
    z, xbc, dt_pre, conv_w, conv_b = _mamba2_split(cfg, p, x, split)

    conv_state = state["conv"] if state is not None else None
    xbc, new_conv = causal_conv1d(xbc, conv_w, conv_b, conv_state)
    xbc = F.silu(xbc)
    xs = xbc[..., :dl].reshape(b, seq, nh, hd)
    bmat = xbc[..., dl:dl + n]
    cmat = xbc[..., dl + n:]

    def per_head(key):
        return split.replicated(p[key])[heads]
    dt = F.softplus(widen(dt_pre) + widen(per_head("dt_bias")))
    a = -torch.exp(widen(per_head("a_log")))
    log_decay = dt * a                                # (B,S,H)

    kq_shape = (b, seq, nh, n)
    k = bmat[:, :, None, :].expand(kq_shape)
    q = cmat[:, :, None, :].expand(kq_shape)

    if state is None:
        y, _ = chunked_linear_attention(q, k, xs, log_decay, dt,
                                        chunk=s.chunk_size)
        new_state = None
    elif seq == 1:
        yv, new_ssm = linear_attention_step(
            q[:, 0], k[:, 0], xs[:, 0], log_decay[:, 0], dt[:, 0],
            state["ssm"])
        y = yv[:, None]
        new_state = {"conv": new_conv, "ssm": new_ssm}
    else:
        y, new_ssm = chunked_linear_attention(q, k, xs, log_decay, dt,
                                              initial_state=state["ssm"],
                                              chunk=s.chunk_size)
        new_state = {"conv": new_conv, "ssm": new_ssm}

    y = y + xs * per_head("d_skip").to(x.dtype)[None, None, :, None]
    y = y.reshape(b, seq, dl)
    y = split.norm(y * F.silu(z), split.weight(p["norm"]),
                   cfg.norm_eps, di)
    return split.reduce(y @ split.weight(p["out_proj"], x.dtype)), new_state


def mamba2_init_state(cfg: ArchConfig, batch: int, dtype=torch.float32,
                      device=None, ranks: int = 1) -> dict:
    """Zero state of one Mamba2 layer; ``ssm`` is float32 (float64 for a
    float64 ``dtype``). ``ranks``: on a tensor-parallel rank of that many,
    the state of its heads (``conv``: their x channels, then B and C
    whole)."""
    s = cfg.ssm
    di = s.expansion * cfg.d_model
    nh = di // s.head_dim
    return {
        "conv": torch.zeros((batch, s.conv_width - 1,
                             di // ranks + 2 * s.state_dim),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, nh // ranks, s.state_dim, s.head_dim),
                           dtype=_state_dtype(dtype), device=device),
    }


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM)
# ---------------------------------------------------------------------------


def mlstm_template(cfg: ArchConfig) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    di = s.expansion * d
    dqk = int(di * s.qk_dim_factor)
    nh = cfg.n_heads
    return {
        "up_proj": P((d, 2 * di), ("embed", "d_inner"), "fan_in"),
        "conv_w": P((s.conv_width, di), (None, "d_inner"), "fan_in"),
        "conv_b": P((di,), ("d_inner",), "zeros"),
        "wq": P((di, dqk), ("d_inner", None), "fan_in"),
        "wk": P((di, dqk), ("d_inner", None), "fan_in"),
        "wv": P((di, di), ("d_inner", None), "fan_in"),
        "w_igate": P((di, nh), ("d_inner", None), "fan_in"),
        "b_igate": P((nh,), (None,), "zeros"),
        "w_fgate": P((di, nh), ("d_inner", None), "fan_in"),
        "b_fgate": P((nh,), (None,), "ones"),
        "norm": P((di,), ("d_inner",), "ones"),
        "out_proj": P((di, d), ("d_inner", "embed2"), "fan_in"),
    }


def mlstm_block(cfg: ArchConfig, p: dict, x, state: Optional[dict] = None,
                split: Optional[InnerSplit] = None):
    """x (B,S,d). state = {"conv", "ssm" (B,H,Nqk,Pv+1)} or None.

    ``split`` (``models.sharding.InnerSplit``, None: one device): on a
    tensor-parallel rank ``p`` holds its contiguous blocks of every
    ``d_inner`` leaf; the up projection's column block is all-gathered and
    the rank's blocks of ``x_in`` and ``z`` sliced from it (its conv block
    lines up with them); the products with its row blocks of ``wq``,
    ``wk`` and ``wv`` are partial sums, reduce-scattered by heads, those
    with the gates' all-reduced and sliced to its heads (the gates'
    biases, replicated, with their gradients all-reduced); the rank's
    recurrence, norm and ``out_proj`` rows run as Mamba2's; the state
    holds its heads and its ``x_in`` channels."""
    s = cfg.ssm
    b, seq, d = x.shape
    split = split or InnerSplit()
    if split.mesh is None:
        step_analysis.short(_RESHARDED, step_analysis.MODEL_AXIS)
    di = s.expansion * d
    nh_all = cfg.n_heads
    heads, chans = split.part(nh_all), split.part(di)
    nh = heads.stop - heads.start
    dl = chans.stop - chans.start

    def w(key):
        return split.weight(p[key], x.dtype)
    up = split.gather(split.copy(x) @ w("up_proj"))
    x_in, z = up[..., :di][..., chans], up[..., di:][..., chans]

    conv_state = state["conv"] if state is not None else None
    x_c, new_conv = causal_conv1d(
        x_in, split.weight(p["conv_w"]), split.weight(p["conv_b"]),
        conv_state)
    x_c = F.silu(x_c)

    dqk = p["wq"].shape[1]
    hqk, hv = dqk // nh_all, di // nh_all
    q = split.scatter(x_c @ w("wq")).reshape(b, seq, nh, hqk)
    k = split.scatter(x_c @ w("wk")).reshape(b, seq, nh, hqk)
    v = split.scatter(x_in @ w("wv")).reshape(b, seq, nh, hv)
    # sqrt in float32, then cast to x's dtype, as the reference does
    q = q / torch.sqrt(torch.tensor(float(hqk), dtype=torch.float32,
                                    device=x.device)).to(x.dtype)

    def gate(wk, bk):
        return (split.psum(x_in @ w(wk))
                + split.replicated(p[bk]).to(x.dtype))[..., heads]
    ig = gate("w_igate", "b_igate")
    fg = gate("w_fgate", "b_fgate")
    log_f = F.logsigmoid(widen(fg))
    i_gate = torch.sigmoid(widen(ig))

    v_aug = torch.cat([v, torch.ones(v.shape[:-1] + (1,), dtype=v.dtype,
                                     device=v.device)], dim=-1)

    if state is None:
        y_aug, _ = chunked_linear_attention(q, k, v_aug, log_f, i_gate,
                                            chunk=s.chunk_size)
        new_state = None
    elif seq == 1:
        ya, new_ssm = linear_attention_step(
            q[:, 0], k[:, 0], v_aug[:, 0], log_f[:, 0], i_gate[:, 0],
            state["ssm"])
        y_aug = ya[:, None]
        new_state = {"conv": new_conv, "ssm": new_ssm}
    else:
        y_aug, new_ssm = chunked_linear_attention(
            q, k, v_aug, log_f, i_gate, initial_state=state["ssm"],
            chunk=s.chunk_size)
        new_state = {"conv": new_conv, "ssm": new_ssm}

    num = widen(y_aug[..., :hv])
    den = widen(y_aug[..., hv:])
    y = (num / torch.clamp_min(den.abs(), 1e-6)).to(x.dtype)
    y = y.reshape(b, seq, dl)
    y = split.norm(y * F.silu(z), split.weight(p["norm"]),
                   cfg.norm_eps, di)
    return split.reduce(y @ w("out_proj")), new_state


def mlstm_init_state(cfg: ArchConfig, batch: int, dtype=torch.float32,
                     device=None, ranks: int = 1) -> dict:
    """Zero state of one mLSTM layer; ``ssm`` is float32 (float64 for a
    float64 ``dtype``). ``ranks``: on a tensor-parallel rank of that many,
    the state of its heads and its ``x_in`` channels."""
    s = cfg.ssm
    di = s.expansion * cfg.d_model
    dqk = int(di * s.qk_dim_factor)
    nh = cfg.n_heads
    return {
        "conv": torch.zeros((batch, s.conv_width - 1, di // ranks),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, nh // ranks, dqk // nh, di // nh + 1),
                           dtype=_state_dtype(dtype), device=device),
    }
