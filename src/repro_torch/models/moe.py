"""Mixture-of-Experts: GShard-style one-hot capacity dispatch.

``moe_dense_dispatch`` routes every token to its top-k experts (softmax
router, renormalised gates), gives each expert ``capacity`` slots per group
of tokens, claimed slot-major (the first choice of every token before any
second choice), drops what does not fit, and combines the experts' outputs
with the gates. It returns a Switch-style load-balance aux loss beside the
output. DeepSeek-V3's sigmoid+bias aux-free router is approximated by this
classic router, as in the reference.

The reference also has an expert-parallel path (``moe_ep_shard_map``:
experts sharded over a mesh's lane axis, tokens moved by ``all_to_all``).
On one device the reference always takes the one-hot dispatch, and so does
the port: the expert-parallel path waits for the multi-device machinery
(ROADMAP Queue A 13), and :func:`moe_block` takes no mesh context.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import P, activation_fn
from repro_torch.models.mlp import mlp

DENSE_PATH_MAX_TOKENS = 16384   # above this, tokens form groups of 64


def moe_template(cfg: ArchConfig) -> dict:
    """The router keeps ``n_experts`` columns; the expert tables have
    ``n_experts_padded`` rows (granite pads 40 to 48 with dead experts,
    which the router never picks)."""
    m = cfg.moe
    d = cfg.d_model
    ep = m.n_experts_padded
    e_axis = "experts" if (m.expert_parallel or m.pad_experts_to) \
        else "experts_np"
    t = {
        "router": P((d, m.n_experts), ("embed", None), "fan_in"),
        "w_gate": P((ep, d, m.expert_d_ff), (e_axis, "embed", "experts_ffn"),
                    "fan_in"),
        "w_up": P((ep, d, m.expert_d_ff), (e_axis, "embed", "experts_ffn"),
                  "fan_in"),
        "w_down": P((ep, m.expert_d_ff, d), (e_axis, "experts_ffn", "embed"),
                    "fan_in"),
    }
    if m.n_shared_experts:
        ff = m.expert_d_ff * m.n_shared_experts
        t["shared"] = {
            "w_gate": P((d, ff), ("embed", "ffn"), "fan_in"),
            "w_up": P((d, ff), ("embed", "ffn"), "fan_in"),
            "w_down": P((ff, d), ("ffn", "embed2"), "fan_in"),
        }
    return t


def _route(x_tokens, router_w, top_k: int, n_experts: int):
    """x (T,d) -> gates (T,k), ids (T,k) int32, aux loss scalar (fp32).

    The top k are taken by a stable descending sort, so that equal
    probabilities keep index order, as ``jax.lax.top_k`` does
    (``torch.topk`` promises no order among ties). The router runs in fp32
    (float64 for float64 tokens)."""
    wide = torch.promote_types(x_tokens.dtype, torch.float32)
    logits = x_tokens.to(wide) @ router_w.to(wide)
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[:, :top_k], ids[:, :top_k]
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    # Switch aux loss: E * sum_e f_e * P_e
    f = torch.zeros((n_experts,), dtype=wide, device=x_tokens.device)
    f = f.index_add(0, ids.reshape(-1), torch.ones_like(ids.reshape(-1),
                                                        dtype=wide))
    f = f / f.sum().clamp_min(1.0)
    aux = n_experts * torch.sum(f * probs.mean(dim=0))
    return gates, ids.to(torch.int32), aux


def _dispatch_combine(ids, gates, group_len, top_k, n_experts, capacity):
    """Build the (Sg, E, C) dispatch (0/1) and combine (gated) tensors of
    one group from its ids and gates (Sg, k); leading dimensions before
    them are groups, computed at once. Token-choice pairs claim an expert's
    slots in slot-major order (all first choices, then all second choices,
    ...); a pair whose slot index reaches ``capacity`` is dropped: its slot
    one-hot is all zeros.

    The reference forms the (Sg, k, E, C) product of the two one-hots and
    sums over k; here one product over k does both (``einsum``). A token
    picks an expert at most once, so each output is a single term either
    way and the two agree exactly, without the k-fold intermediate (8.6 GB
    for 2048 tokens of deepseek-v3-671b at capacity factor 8)."""
    dev, lead = ids.device, ids.shape[:-2]
    sel = (ids.long()[..., None]
           == torch.arange(n_experts, device=dev)).to(gates.dtype)  # (Sg,k,E)
    flat = sel.reshape(lead + (group_len * top_k, n_experts))      # slot-major
    pos = torch.cumsum(flat, dim=-2) - flat                         # (P,E)
    pos_sel = torch.sum(flat * pos, dim=-1).to(torch.int64)         # (P,)
    slot_oh = (pos_sel[..., None] == torch.arange(capacity, device=dev)
               ).to(gates.dtype).reshape(lead + (group_len, top_k,
                                                 capacity))      # (Sg,k,C)
    dispatch = torch.einsum("...ske,...skc->...sec", sel, slot_oh)
    combine = torch.einsum("...ske,...skc->...sec", sel * gates[..., None],
                           slot_oh)
    return dispatch, combine


def moe_dense_dispatch(cfg: ArchConfig, p: dict, x_tokens, *,
                       group_size: Optional[int] = None):
    """x_tokens (T, d) -> (T, d), aux. Grouped one-hot dispatch: tokens form
    groups of ``group_size`` (default: one group, or groups of 64 above
    DENSE_PATH_MAX_TOKENS tokens), each with ``max(int(sg*k*cf/E), k)``
    slots per expert. Only the first ``n_experts`` rows of the (padded)
    expert tables are used."""
    m = cfg.moe
    t_len, d = x_tokens.shape
    act = activation_fn(cfg.activation)
    gates, ids, aux = _route(x_tokens, p["router"], m.top_k, m.n_experts)

    sg = group_size or min(t_len,
                           64 if t_len > DENSE_PATH_MAX_TOKENS else t_len)
    n_groups = -(-t_len // sg)
    if n_groups * sg != t_len:
        raise ValueError(f"moe_dense_dispatch: {t_len} tokens do not form "
                         f"whole groups of {sg}")
    capacity = max(int(sg * m.top_k * m.capacity_factor / m.n_experts),
                   m.top_k)

    xg = x_tokens.reshape(n_groups, sg, d)
    idsg = ids.reshape(n_groups, sg, m.top_k)
    gatesg = gates.reshape(n_groups, sg, m.top_k)
    dispatch, combine = _dispatch_combine(idsg, gatesg, sg, m.top_k,
                                          m.n_experts, capacity)
    dispatch = dispatch.to(x_tokens.dtype)
    combine = combine.to(x_tokens.dtype)

    w_gate = p["w_gate"][:m.n_experts]
    w_up = p["w_up"][:m.n_experts]
    w_down = p["w_down"][:m.n_experts]
    buf = torch.einsum("gsec,gsd->gecd", dispatch, xg)           # (G,E,C,d)
    gate_h = torch.einsum("gecd,edf->gecf", buf, w_gate.to(buf.dtype))
    up_h = torch.einsum("gecd,edf->gecf", buf, w_up.to(buf.dtype))
    hidden = act(gate_h) * up_h
    out_buf = torch.einsum("gecf,efd->gecd", hidden, w_down.to(buf.dtype))
    y = torch.einsum("gsec,gecd->gsd", combine, out_buf)
    return y.reshape(t_len, d), aux


def moe_block(cfg: ArchConfig, p: dict, x, ctx=None):
    """x (B,S,d) -> (B,S,d), aux_loss. The shared experts, where the config
    has them, are one gated-SiLU MLP added to every token (SiLU whatever
    ``cfg.activation`` is, as in the reference). ``ctx`` (the reference's
    mesh context) must be None."""
    if ctx is not None:
        raise NotImplementedError(
            "moe_block runs on one device; a mesh context (expert "
            "parallelism) waits for the multi-device machinery (ROADMAP "
            "Queue A 13)")
    b, s, d = x.shape
    y, aux = moe_dense_dispatch(cfg, p, x.reshape(b * s, d))
    y = y.reshape(b, s, d)
    if "shared" in p:
        y = y + mlp(p["shared"], x, "silu")
    return y, aux
