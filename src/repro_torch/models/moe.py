"""Mixture-of-Experts with the reference's two dispatch strategies.

1. ``moe_dense_dispatch`` routes every token to its top-k experts (softmax
   router, renormalised gates), gives each expert ``capacity`` slots per
   group of tokens, claimed in token order, drops what does not fit, and
   combines the experts' outputs with the gates. Used for small token
   counts, for configs whose experts do not divide the lanes, and without
   a mesh. On a mesh of processes whose ranks each hold a block of the
   batch's rows (the train step's), the group and the aux loss are still
   the global batch's: the ranks gather each other's per-expert counts,
   and each claims its slots after the ranks before it; with ``model >
   1`` each rank runs its ``experts_ffn`` block of every expert
   (Megatron's pairing, as the dense FFN), or, where the config splits
   the experts over ``model`` (``expert_parallel``), its block of the
   experts whole.
2. ``moe_ep_shard_map``: expert parallelism — experts sharded over the
   mesh's ``model`` (lane) axis, tokens over every axis, moved to the lane
   that owns their expert by ``all_to_all``, computed there and moved back,
   strip-mined in chunks of ``EP_CHUNK_TOKENS``: three counted
   ``all_to_all`` calls a chunk. The mesh is held as tensor dimensions on
   one device, or is a mesh of processes (``core/compat.py``), on which
   each rank passes its own block of the experts (``compat.Held``):
   deepseek-v3-671b's ``experts`` block (under FSDP, gathered over data),
   or granite-moe-3b-a800m's ``experts_ffn`` blocks re-laid as ``experts``
   blocks by an all-to-all (``models.sharding.relay_experts``), as the
   reference's partitioner reshards them; the tokens are the rank's rows
   where the batch axes are local (the train step), cut over ``model``.

Both return a Switch-style load-balance aux loss beside the output.
DeepSeek-V3's sigmoid+bias aux-free router is approximated by this
classic router, as in the reference.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import compat, step_analysis
from repro_torch.core.compat import PartitionSpec as PS
from repro_torch.models.layers import P, activation_fn
from repro_torch.models.mlp import mlp
from repro_torch.models.sharding import (MeshCtx, around_split, held_experts,
                                         relay_experts)

DENSE_PATH_MAX_TOKENS = 16384   # below this, one-hot dispatch is cheaper
EXPERT_TABLES = ("w_gate", "w_up", "w_down")   # a row per (padded) expert
EP_CHUNK_TOKENS = 8192          # strip-mine unit for the EP a2a pipeline
# a list to which each one-hot dispatch appends a :class:`Dispatch` of the
# tokens it holds; a checkpoint's recompute appends nothing. None: nothing
# is recorded.
DISPATCH_LOG: Optional[list] = None


class Dispatch(NamedTuple):
    """One dispatch of :data:`DISPATCH_LOG`: the int count of token-choice
    pairs of the tokens it held, a 0-d device tensor of those that found a
    slot (the rest are dropped), the (T, k) expert ids those tokens chose
    (in token order) and the group's slots an expert. ``device``: None
    for a one-hot dispatch; on the expert-parallel route, one dispatch a
    device a chunk, the device's row-major index on the mesh: its pairs
    less those it dropped, both its own pairs that found no slot to their
    lane (``keep``, of ``cap_send`` slots, the capacity) and the rows it
    received that found no slot of their expert (``keep2``)."""
    pairs: int
    kept: torch.Tensor
    ids: torch.Tensor
    capacity: int
    device: Optional[int] = None


def dropped_pairs(log) -> int:
    """The pairs that the dispatches of a ``DISPATCH_LOG`` list dropped
    (it reads each kept count: a wait for the device)."""
    return int(sum(d.pairs - float(d.kept) for d in log))


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


def _topk(x_tokens, router_w, top_k: int):
    """x (...,T,d) -> probs (...,T,E), gates (...,T,k), ids (...,T,k)
    int64; leading dimensions (the devices of a mesh's stacks) route
    independently.

    The top k are taken by a stable descending sort, so that equal
    probabilities keep index order, as ``jax.lax.top_k`` does
    (``torch.topk`` promises no order among ties). The router runs in fp32
    (float64 for float64 tokens)."""
    wide = torch.promote_types(x_tokens.dtype, torch.float32)
    logits = x_tokens.to(wide) @ router_w.to(wide)
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[..., :top_k], ids[..., :top_k]
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return probs, gates, ids


def _expert_counts(ids, n_experts: int):
    """ids (...,T,k) -> the pairs each expert was chosen for (...,E),
    int32."""
    flat = ids.reshape(ids.shape[:-2] + (-1,)).long()
    counts = torch.zeros(flat.shape[:-1] + (n_experts,), dtype=torch.int32,
                         device=ids.device)
    return counts.scatter_add(-1, flat, torch.ones_like(flat,
                                                        dtype=torch.int32))


def _switch_aux(counts, probs, n_experts: int):
    """The Switch aux loss ``E * sum_e f_e * P_e``: ``f`` the share of the
    pairs ``counts`` (...,E) gives each expert, ``P`` the router's mean
    probability over the tokens of ``probs`` (...,T,E)."""
    f = counts.to(probs.dtype)
    f = f / f.sum(dim=-1, keepdim=True).clamp_min(1.0)
    return n_experts * torch.sum(f * probs.mean(dim=-2), dim=-1)


def _route(x_tokens, router_w, top_k: int, n_experts: int):
    """x (...,T,d) -> gates (...,T,k), ids (...,T,k) int32, aux loss (...)
    fp32 (:func:`_topk`, then :func:`_switch_aux` over these tokens)."""
    probs, gates, ids = _topk(x_tokens, router_w, top_k)
    aux = _switch_aux(_expert_counts(ids, n_experts), probs, n_experts)
    return gates, ids.to(torch.int32), aux


def _dispatch_combine(ids, gates, group_len, top_k, n_experts, capacity,
                      offset=None, experts=None):
    """Build the (Sg, E, C) dispatch (0/1) and combine (gated) tensors of
    one group from its ids and gates (Sg, k); leading dimensions before
    them are groups, computed at once. ``experts``: the global indices of
    the E experts whose columns are built (a range, by default all
    ``n_experts``; each expert's slots depend on its own column alone).
    Token-choice pairs claim an expert's slots in token order (a token's
    own choices are of distinct experts); a pair whose slot index reaches
    ``capacity`` is dropped: its slot one-hot is all zeros. ``offset``
    (E,): the slots of each of those experts that the group's earlier
    tokens, held elsewhere, have claimed (a group spanning the ranks of a
    process mesh); the pairs here claim the slots after them.

    The reference forms the (Sg, k, E, C) product of the two one-hots and
    sums over k; here one product over k does both (``einsum``). A token
    picks an expert at most once, so each output is a single term either
    way and the two agree exactly, without the k-fold intermediate (8.6 GB
    for 2048 tokens of deepseek-v3-671b at capacity factor 8)."""
    dev, lead = ids.device, ids.shape[:-2]
    experts = range(n_experts) if experts is None else experts
    sel = (ids.long()[..., None] == torch.arange(
        experts.start, experts.stop, device=dev)).to(gates.dtype)  # (Sg,k,E)
    flat = sel.reshape(lead + (group_len * top_k, len(experts)))  # token-major
    pos = torch.cumsum(flat, dim=-2) - flat                         # (P,E)
    if offset is not None:
        pos = pos + offset.to(pos.dtype)
    pos_sel = torch.sum(flat * pos, dim=-1).to(torch.int64)         # (P,)
    slot_oh = (pos_sel[..., None] == torch.arange(capacity, device=dev)
               ).to(gates.dtype).reshape(lead + (group_len, top_k,
                                                 capacity))      # (Sg,k,C)
    dispatch = torch.einsum("...ske,...skc->...sec", sel, slot_oh)
    combine = torch.einsum("...ske,...skc->...sec", sel * gates[..., None],
                           slot_oh)
    return dispatch, combine


NO_BLOCKS = (None, (), 1, 1)


def row_blocks(ctx: Optional[MeshCtx], rows: int) -> tuple:
    """(mesh, axes, n, held) of ``rows`` batch rows on ``ctx``: the batch
    axes that split them into ``n`` blocks (those of the mesh that divide
    the global rows, as the reference's sanitized batch spec keeps them;
    on a process mesh those declared local, along which each rank holds
    its own block, as the train step declares them), and how many blocks
    the caller holds: 1 on a process mesh, all ``n`` on the stacked route
    (the global batch). :data:`NO_BLOCKS` on one device."""
    if ctx is None or ctx.mesh is None:
        return NO_BLOCKS
    mesh = ctx.mesh
    if compat.is_process_mesh(mesh):
        axes = tuple(a for a in ctx.batch_axes if a in mesh.local)
        held = 1
    else:
        axes = tuple(a for a in ctx.batch_axes if a in ctx.axis_sizes)
        held = math.prod(ctx.axis_sizes[a] for a in axes)
        if rows % held:
            return NO_BLOCKS
    n = math.prod(ctx.axis_sizes[a] for a in axes)
    return (mesh, axes, n, held) if n > 1 else NO_BLOCKS


def moe_dense_dispatch(cfg: ArchConfig, p: dict, x_tokens, *,
                       group_size: Optional[int] = None,
                       ctx: Optional[MeshCtx] = None, rows: int = 1,
                       tp=None):
    """x_tokens (T, d) -> (T, d), aux. Grouped one-hot dispatch: tokens form
    groups of ``group_size`` (default: one group of the global batch, or
    groups of 64 above DENSE_PATH_MAX_TOKENS global tokens), each with
    ``max(int(sg*k*cf/E), k)`` slots per expert. Only the first
    ``n_experts`` rows of the (padded) expert tables are used.

    ``ctx``: the mesh context; ``rows``: the batch rows the tokens came
    from. Where the rows are split over batch axes (:func:`row_blocks`),
    every block's per-expert pair counts are gathered (``compat.gather_blocks``:
    an all-gather of an (E,) int32 vector on a process mesh, counted on
    the stacked route as the ranks would move it): the aux loss's ``f``
    is the global batch's, ``P`` the mean over these tokens (the mean of
    the ranks' aux is then the global one, value and gradient, the blocks
    being equal). On a process mesh a group that spans the ranks (the one
    group) keeps a pair where its slot, after the slots that the blocks
    before the rank's claimed, is below the group's capacity: the
    reference's one group exactly, each rank computing its own tokens;
    groups of 64 must lie inside the rank's rows. ``tp``
    (``models.sharding.TensorParallel``), where the model axis splits each
    expert's FFN: ``p`` holds the rank's ``experts_ffn`` columns of
    ``w_gate`` / ``w_up`` and rows of ``w_down``; Megatron's ``copy_to``
    at each column-split product's input, ``reduce_from`` on the (G,E,C,d)
    buffer after ``w_down``. Where it splits the experts
    (``expert_parallel``): ``p`` holds the rank's block of experts; the
    routing, the aux loss and the per-expert counts stay whole on every
    rank, the rank builds its experts' columns of the dispatch and
    combine and runs its experts' products, between ``copy_to`` on the
    tokens and their gates and ``reduce_from`` on the combined (T, d)
    output."""
    m = cfg.moe
    t_len, d = x_tokens.shape
    act = activation_fn(cfg.activation)
    # on a mesh, a partitioner reshards the one group's dispatched buffers
    # and splits its products unevenly; the dry run's count cannot
    step_analysis.short("collective: moe one-hot dispatch resharded")
    step_analysis.short("flops: even split of the moe dispatch")
    probs, gates, ids = _topk(x_tokens, p["router"], m.top_k)
    mesh, axes, n_blocks, held = row_blocks(ctx, rows)
    if n_blocks > 1:
        # the pairs of each block held here, then of every block
        every = compat.gather_blocks(_expert_counts(
            ids.reshape(held, t_len // held, m.top_k), m.n_experts), mesh,
            axes)
        counts = every.sum(dim=0)
    else:
        every, counts = None, _expert_counts(ids, m.n_experts)
    aux = _switch_aux(counts, probs, m.n_experts)

    n_tokens = t_len * n_blocks // held              # the global batch's
    sg = group_size or min(n_tokens, 64 if n_tokens > DENSE_PATH_MAX_TOKENS
                           else n_tokens)
    capacity = max(int(sg * m.top_k * m.capacity_factor / m.n_experts),
                   m.top_k)
    # a group wider than a block spans the blocks: each rank holds the
    # whole of its buffer (else its share of the groups)
    spans = n_blocks > 1 and sg > t_len // held
    offset = None
    if spans and held == 1:
        if sg != n_tokens:
            raise ValueError(f"moe_dense_dispatch: groups of {sg} tokens "
                             f"do not lie in a rank's {t_len}")
        # one group over the ranks: the slots that the blocks before this
        # one claimed (``every`` is in the group's rank order)
        mine = mesh.block(axes)
        before = torch.tensor([mesh.block(axes, r) < mine
                               for r in mesh.group(axes)[1]],
                              device=every.device)
        offset = every[before].sum(dim=0)
        sg = t_len
    n_groups = -(-t_len // sg)
    if n_groups * sg != t_len:
        raise ValueError(f"moe_dense_dispatch: {t_len} tokens do not form "
                         f"whole groups of {sg}")

    idsg = ids.reshape(n_groups, sg, m.top_k)
    if DISPATCH_LOG is not None \
            and torch._C._current_autograd_node() is None:
        # each expert of each group keeps the pairs that find a slot
        room = torch.tensor(capacity, device=ids.device) if offset is None \
            else (capacity - offset).clamp_min(0)
        DISPATCH_LOG.append(Dispatch(t_len * m.top_k, torch.minimum(
            _expert_counts(idsg, m.n_experts), room).sum(), ids.detach(),
            capacity))
    experts = held_experts(cfg, tp)
    if offset is not None:
        offset = offset[experts.start:experts.stop]
    # where the model axis splits the experts, Megatron's pair joins the
    # ranks' experts around the tokens (their gates too: a pair's gate
    # meets its expert's output on one rank); where it splits each
    # expert's FFN, around the buffer's expert products
    identity = (lambda t: t), (lambda t: t), contextlib.nullcontext()
    if m.expert_parallel:
        tok_in, tok_out, tok_scope = around_split(ctx, tp, 1 / n_blocks)
        buf_in, buf_out, buf_scope = identity
    else:
        tok_in, tok_out, tok_scope = identity
        buf_in, buf_out, buf_scope = around_split(
            ctx, tp, 1.0 if spans else 1 / n_blocks)
    with tok_scope:
        xg = tok_in(x_tokens).reshape(n_groups, sg, d)
        gatesg = tok_in(gates).reshape(n_groups, sg, m.top_k)
        dispatch, combine = _dispatch_combine(idsg, gatesg, sg, m.top_k,
                                              m.n_experts, capacity, offset,
                                              experts)
        dispatch = dispatch.to(x_tokens.dtype)
        combine = combine.to(x_tokens.dtype)

        buf = torch.einsum("gsec,gsd->gecd", dispatch, xg)       # (G,E,C,d)
        with buf_scope:
            w_gate = p["w_gate"][:len(experts)]
            w_up = p["w_up"][:len(experts)]
            w_down = p["w_down"][:len(experts)]
            gate_h = torch.einsum("gecd,edf->gecf", buf_in(buf),
                                  w_gate.to(buf.dtype))
            up_h = torch.einsum("gecd,edf->gecf", buf_in(buf),
                                w_up.to(buf.dtype))
            hidden = act(gate_h) * up_h
            out_buf = buf_out(torch.einsum("gecf,efd->gecd", hidden,
                                           w_down.to(buf.dtype)))
        y = torch.einsum("gsec,gecd->gsd", combine, out_buf)
        y = tok_out(y.reshape(t_len, d))
    return y, aux


# ---------------------------------------------------------------------------
# Path 2: expert-parallel all_to_all (shard_map)
# ---------------------------------------------------------------------------


def _one_hot(idx, n: int):
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(
        torch.int32)


def _ep_device_fn(cfg: ArchConfig, n_lanes: int, model_axis: str,
                  all_axes: tuple,
                  x_loc, router_w, w_gate, w_up, w_down):
    """The body, on the stacks (every device at once): x_loc (*mesh,
    T_loc, d); router_w (*mesh, d, E), one copy; w_* (*mesh, E_loc, ...),
    each lane its experts.

    The reference's per-device body, with the devices flattened into a
    leading dimension ``D`` for the routing, the scatters and the expert
    products; the capacities are the reference's, truncation included
    (they decide which tokens drop): ``cap_send`` slots per destination
    lane, ``cap_local`` per local expert; overflow goes to a scratch row
    that is then cut off. ``yc.at[pair_tok].add`` is ``index_add``, whose
    float order on CUDA is not fixed.

    One deliberate difference: an empty send slot carries "no expert"
    (``e_loc``) and claims no capacity. The reference tags it local expert
    0, so the empty slots a lane receives take expert 0's ``cap_local``
    slots ahead of the real tokens of the lanes after it, which are then
    dropped: wherever ``cap_local`` is less than the rows a lane receives
    (``e_loc > 2``; granite-moe-3b-a800m's 48 experts over 4 lanes drop 40 %
    of the tokens at capacity factor 16 that the one-hot dispatch keeps).
    Where ``e_loc <= 2`` no row is dropped there and the two agree
    exactly."""
    m = cfg.moe
    act = activation_fn(cfg.activation)
    lead = compat.stack_shape()
    n_dev = math.prod(lead)
    t_loc, d = x_loc.shape[-2:]
    e_loc = m.n_experts_padded // n_lanes   # dead padded experts own slots
    k = m.top_k
    dev = x_loc.device

    xs = x_loc.reshape(n_dev, t_loc, d)
    gates, ids, aux = _route(xs, router_w.reshape((n_dev,)
                                                  + router_w.shape[-2:]),
                             k, m.n_experts)
    wg, wu, wd = (w.reshape((n_dev,) + w.shape[len(lead):])
                  for w in (w_gate, w_up, w_down))

    chunk = min(EP_CHUNK_TOKENS, t_loc)
    n_chunks = -(-t_loc // chunk)
    if n_chunks * chunk != t_loc:
        raise ValueError(f"moe_ep_shard_map: {t_loc} tokens a device do "
                         f"not form whole chunks of {chunk}")
    cap_send = max(int(chunk * k * m.capacity_factor / n_lanes), k)
    cap_local = max(int(n_lanes * cap_send * 2 / e_loc), 1)
    pairs = chunk * k
    pair_tok = torch.arange(chunk, device=dev).repeat_interleave(k)
    row = torch.arange(n_dev, device=dev)[:, None]    # each device's row

    ys = []
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        xc = xs[:, sl]                                # (D, chunk, d)
        eid = ids[:, sl].reshape(n_dev, pairs).long()
        gval = gates[:, sl].reshape(n_dev, pairs)
        dest = eid // e_loc                           # destination lane
        local_e = eid % e_loc

        lane_oh = _one_hot(dest, n_lanes)
        pos = torch.sum(lane_oh * (torch.cumsum(lane_oh, dim=1) - lane_oh),
                        dim=-1)                       # slot in dest lane
        keep = pos < cap_send
        pos_c = torch.where(keep, pos, cap_send)      # overflow -> scratch

        send = xs.new_zeros((n_dev, n_lanes, cap_send + 1, d))
        send[row, dest, pos_c] = xc[:, pair_tok]
        # int32 expert tags, as the reference's; e_loc: an empty slot
        send_e = torch.full((n_dev, n_lanes, cap_send + 1), e_loc,
                            dtype=torch.int32, device=dev)
        send_e[row, dest, pos_c] = local_e.to(torch.int32)

        recv = compat.all_to_all(
            send[:, :, :cap_send].reshape(lead + (n_lanes, cap_send, d)),
            model_axis, 0, 0, tiled=False)
        recv_e = compat.all_to_all(
            send_e[:, :, :cap_send].reshape(lead + (n_lanes, cap_send)),
            model_axis, 0, 0, tiled=False)

        pr = n_lanes * cap_send
        xr = recv.reshape(n_dev, pr, d)
        er = recv_e.reshape(n_dev, pr).long()
        real = er < e_loc
        e_oh = _one_hot(er, e_loc)            # an empty slot's row: zeros
        pos2 = torch.sum(e_oh * (torch.cumsum(e_oh, dim=1) - e_oh), dim=-1)
        keep2 = (pos2 < cap_local) & real
        if DISPATCH_LOG is not None \
                and torch._C._current_autograd_node() is None:
            kept = keep.sum(-1) - real.sum(-1) + keep2.sum(-1)
            for i, device in enumerate(compat.stack_devices()):
                DISPATCH_LOG.append(Dispatch(pairs, kept[i],
                                             ids[i, sl].detach(), cap_send,
                                             device))
        pos2_c = torch.where(keep2, pos2, cap_local)
        er = torch.where(real, er, 0)         # empties -> a scratch row

        buf = xs.new_zeros((n_dev, e_loc, cap_local + 1, d))
        buf[row, er, pos2_c] = xr
        buf = buf[:, :, :cap_local]

        gh = torch.einsum("xecd,xedf->xecf", buf, wg.to(buf.dtype))
        uh = torch.einsum("xecd,xedf->xecf", buf, wu.to(buf.dtype))
        ob = torch.einsum("xecf,xefd->xecd", act(gh) * uh, wd.to(buf.dtype))

        out_pairs = ob[row, er, pos2_c % cap_local] \
            * keep2[..., None].to(ob.dtype)
        back = out_pairs.reshape(lead + (n_lanes, cap_send, d))
        got = compat.all_to_all(back, model_axis, 0, 0, tiled=False)
        got = got.reshape(n_dev, n_lanes, cap_send, d)

        mine = got[row, dest, pos_c % cap_send] * keep[..., None].to(got.dtype)
        yc = xs.new_zeros((n_dev, chunk, d)).index_add(
            1, pair_tok, mine * gval[..., None].to(mine.dtype))
        ys.append(yc)
    y = torch.cat(ys, dim=1).reshape(lead + (t_loc, d))
    aux = compat.pmean(aux.reshape(lead), all_axes)
    return y, aux


def moe_ep_shard_map(cfg: ArchConfig, p: dict, x_tokens, ctx: MeshCtx,
                     tp=None):
    """x_tokens (T, d) -> (T, d), aux. Experts sharded over the lane axis;
    tokens over every mesh axis (lanes included) so routing work is not
    duplicated. A token count or expert table that the mesh does not
    divide raises ``ValueError`` (``moe_block``'s gate never sends one).
    ``tp``: the rank's ``models.sharding.TensorParallel`` on a process
    mesh, where ``p`` holds the rank's blocks: its block of the experts
    (``expert_parallel``), or of each expert's FFN, which is first re-laid
    as its block of the experts (``models.sharding.relay_experts``); the
    body takes either as it is (``compat.Held``). None: ``p``'s tables are
    whole, cut by the in_spec (the stacked route: under a count of the
    step, an FFN split of the tables is re-laid there by a counted
    all-to-all, as the ranks re-lay it). The router is whole on every
    rank."""
    mesh = ctx.mesh
    all_axes = tuple(mesh.axis_names)
    fn = functools.partial(_ep_device_fn, cfg, ctx.n_lanes, ctx.model_axis,
                           all_axes)
    if tp is not None and not cfg.moe.expert_parallel:
        p = relay_experts(p, tp)
    lane = (PS if tp is None else compat.Held)(ctx.model_axis, None, None)
    y, aux = compat.shard_map(
        fn, mesh=mesh,
        in_specs=(PS(all_axes, None), PS(None, None), lane, lane, lane),
        out_specs=(PS(all_axes, None), PS()),
    )(x_tokens, p["router"], p["w_gate"], p["w_up"], p["w_down"])
    return y, aux


# ---------------------------------------------------------------------------
# Public block
# ---------------------------------------------------------------------------


def global_tokens(ctx: Optional[MeshCtx], rows: int, seq: int) -> int:
    """The global batch's tokens of ``rows`` x ``seq`` tokens held here
    (:func:`row_blocks`: on a process mesh whose batch axes are local, the
    rank's rows of it)."""
    _, _, n, held = row_blocks(ctx, rows)
    return rows * seq * n // held


def ep_route(cfg: ArchConfig, ctx: Optional[MeshCtx], n_tokens: int) -> bool:
    """The reference's gate: whether ``n_tokens`` tokens of the global
    batch take the expert-parallel route on ``ctx`` (a mesh of more than
    one lane whose lanes divide the (padded) experts, at least
    ``DENSE_PATH_MAX_TOKENS`` tokens, and a token count that the mesh
    divides)."""
    if ctx is None or ctx.mesh is None or ctx.n_lanes <= 1:
        return False
    m = cfg.moe
    n_dev = math.prod(ctx.axis_sizes.values())
    return (m.expert_parallel or m.pad_experts_to > 0) \
        and m.n_experts_padded % ctx.n_lanes == 0 \
        and n_tokens >= DENSE_PATH_MAX_TOKENS and n_tokens % n_dev == 0


def moe_block(cfg: ArchConfig, p: dict, x, ctx: Optional[MeshCtx] = None,
              tp=None):
    """x (B,S,d) -> (B,S,d), aux_loss. The expert-parallel route where
    :func:`ep_route` takes it for the global batch's tokens; the one-hot
    dispatch otherwise (on a process mesh whose batch axes are local, the
    rank's rows of the global batch: see :func:`moe_dense_dispatch`). The
    shared experts, where the config has them, are one gated-SiLU MLP
    added to every token (SiLU whatever ``cfg.activation`` is, as in the
    reference). ``tp``: the rank's ``models.sharding.TensorParallel``
    (its blocks of ``p``), or None. On a process mesh the expert-parallel
    route runs, in training and in serving, on the rank's tokens (its
    rows of the batch where the batch axes are local, else the global
    batch's) and its block of the experts (:func:`moe_ep_shard_map`).
    Under FSDP ``p`` holds what the forward gathered
    (``models.transformer.forward``): the rank's ``model`` block of each
    leaf, of the expert tables the live experts' rows on the one-hot
    dispatch and every row on the expert-parallel route."""
    b, s, d = x.shape
    x_tokens = x.reshape(b * s, d)
    if ep_route(cfg, ctx, global_tokens(ctx, b, s)):
        y, aux = moe_ep_shard_map(cfg, p, x_tokens, ctx, tp)
    else:
        y, aux = moe_dense_dispatch(cfg, p, x_tokens, ctx=ctx, rows=b,
                                    tp=tp)
    y = y.reshape(b, s, d)
    if "shared" in p:
        y = y + mlp(p["shared"], x, "silu", tp)
    return y, aux
