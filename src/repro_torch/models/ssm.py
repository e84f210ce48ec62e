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
from repro_torch.models.layers import P, rms_norm, widen

SSD_CHUNK = 64


# under tensor parallelism a partitioner reshards the blocks' split
# projections (permutes, gathers) where the dry run derives none
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


def _mamba2_split(cfg, p, x):
    s = cfg.ssm
    d = cfg.d_model
    di = s.expansion * d
    n = s.state_dim
    nh = di // s.head_dim
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * n]
    dt_pre = zxbcdt[..., -nh:]
    return z, xbc, dt_pre, di, n, nh


def mamba2_block(cfg: ArchConfig, p: dict, x, state: Optional[dict] = None):
    """x (B,S,d). state = {"conv": (B,W-1,conv_dim), "ssm": (B,H,N,P)} or None.
    Returns (y, new_state or None)."""
    s = cfg.ssm
    b, seq, _ = x.shape
    step_analysis.short(_RESHARDED, step_analysis.MODEL_AXIS)
    z, xbc, dt_pre, di, n, nh = _mamba2_split(cfg, p, x)
    hd = s.head_dim

    conv_state = state["conv"] if state is not None else None
    xbc, new_conv = causal_conv1d(xbc, p["conv_w"], p["conv_b"], conv_state)
    xbc = F.silu(xbc)
    xs = xbc[..., :di].reshape(b, seq, nh, hd)
    bmat = xbc[..., di:di + n]
    cmat = xbc[..., di + n:]

    dt = F.softplus(widen(dt_pre) + widen(p["dt_bias"]))
    a = -torch.exp(widen(p["a_log"]))
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

    y = y + xs * p["d_skip"].to(x.dtype)[None, None, :, None]
    y = y.reshape(b, seq, di)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"].to(x.dtype), new_state


def mamba2_init_state(cfg: ArchConfig, batch: int, dtype=torch.float32,
                      device=None) -> dict:
    """Zero state of one Mamba2 layer; ``ssm`` is float32 (float64 for a
    float64 ``dtype``)."""
    s = cfg.ssm
    di = s.expansion * cfg.d_model
    nh = di // s.head_dim
    return {
        "conv": torch.zeros((batch, s.conv_width - 1, di + 2 * s.state_dim),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, nh, s.state_dim, s.head_dim),
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


def mlstm_block(cfg: ArchConfig, p: dict, x, state: Optional[dict] = None):
    """x (B,S,d). state = {"conv", "ssm" (B,H,Nqk,Pv+1)} or None."""
    s = cfg.ssm
    b, seq, d = x.shape
    step_analysis.short(_RESHARDED, step_analysis.MODEL_AXIS)
    di = s.expansion * d
    nh = cfg.n_heads
    up = x @ p["up_proj"].to(x.dtype)
    x_in, z = up[..., :di], up[..., di:]

    conv_state = state["conv"] if state is not None else None
    x_c, new_conv = causal_conv1d(x_in, p["conv_w"], p["conv_b"], conv_state)
    x_c = F.silu(x_c)

    dqk = p["wq"].shape[1]
    hqk, hv = dqk // nh, di // nh
    q = (x_c @ p["wq"].to(x.dtype)).reshape(b, seq, nh, hqk)
    k = (x_c @ p["wk"].to(x.dtype)).reshape(b, seq, nh, hqk)
    v = (x_in @ p["wv"].to(x.dtype)).reshape(b, seq, nh, hv)
    # sqrt in float32, then cast to x's dtype, as the reference does
    q = q / torch.sqrt(torch.tensor(float(hqk), dtype=torch.float32,
                                    device=x.device)).to(x.dtype)

    ig = x_in @ p["w_igate"].to(x.dtype) + p["b_igate"].to(x.dtype)
    fg = x_in @ p["w_fgate"].to(x.dtype) + p["b_fgate"].to(x.dtype)
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
        y_aug, new_ssm = chunked_linear_attention(q, k, v_aug, log_f, i_gate,
                                                  initial_state=state["ssm"],
                                                  chunk=s.chunk_size)
        new_state = {"conv": new_conv, "ssm": new_ssm}

    num = widen(y_aug[..., :hv])
    den = widen(y_aug[..., hv:])
    y = (num / torch.clamp_min(den.abs(), 1e-6)).to(x.dtype)
    y = y.reshape(b, seq, di)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"].to(x.dtype), new_state


def mlstm_init_state(cfg: ArchConfig, batch: int, dtype=torch.float32,
                     device=None) -> dict:
    """Zero state of one mLSTM layer; ``ssm`` is float32 (float64 for a
    float64 ``dtype``)."""
    s = cfg.ssm
    di = s.expansion * cfg.d_model
    dqk = int(di * s.qk_dim_factor)
    nh = cfg.n_heads
    return {
        "conv": torch.zeros((batch, s.conv_width - 1, di), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, nh, dqk // nh, di // nh + 1),
                           dtype=_state_dtype(dtype), device=device),
    }
