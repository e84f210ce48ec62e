"""The train step, and the serve steps, with their sharding specs.

``make_train_step`` returns a bundle whose ``step_fn(state, batch) ->
(state, metrics)`` is the reference's train step: the loss and its
gradients by autograd (strip-mined over ``grad_accum`` micro-batches when
asked: core/stripmine.py), then AdamW. The metric keys are the reference's:
``loss``, ``ce``, ``aux``, ``lr``, ``grad_norm``.

With a mesh context (``models.sharding.MeshCtx``) the step is the
reference's sharded step: the same global math, with the mixture-of-experts
layers on their expert-parallel route where the reference takes it
(``models.moe.moe_block``). The bundle carries the reference's spec trees
(``state_specs``, ``batch_specs``) and ``abstract_state`` (``meta``
tensors). The reference hands them to ``jax.jit`` as shardings; one card
holds every leaf whole, so here they describe the layout
(``named_for`` gives each leaf's shard shape) and place nothing.

On a mesh of processes (``launch.mesh.make_process_mesh``) the step is
the reference's data-parallel step (``Trainer(mesh=make_mesh(n, 1))``
with ``fsdp=False``: the batch sharded over the batch axes, the
parameters replicated): each rank holds its block of the batch (the
batch axes are declared local, ``core.compat.ProcessMesh.with_local``),
runs the same forward and backward on it, and averages every gradient
leaf over the batch axes in place (``core.compat.pmean_in_place``, one
call a leaf, counted as ``pmean``), and the loss metrics in one more;
AdamW then updates the same parameters on every rank. With a ``model``
axis above 1 every family's step is also tensor-parallel, as
the reference's partitioner runs it from the same specs: each rank holds its
blocks of every leaf (the specs after :func:`sanitize_specs`; the
bundle's ``abstract_state`` gives their shapes), runs the forward and
backward on its heads, FFN columns and vocab block
(``models.transformer.forward``), and the grad norm sums the split
leaves' squares once (``optim.adamw.global_norm``). With ``cfg.fsdp``
and batch axes above 1 the step is also FSDP, as the reference's
partitioner runs it from the same specs (every family's on a model axis
of 1, the dense and MoE families' on any): every ``embed`` dimension is
split over the batch axes too, each leaf is gathered where a layer uses
it and again for the backward (``models.sharding.Fsdp``; the hybrid
family's shared block once a forward for all its groups,
``models.sharding.Reused``; a leaf FSDP leaves whole, as the mix
layers' without ``embed``, is averaged as in the data-parallel step),
its gradient reduce-scattered back to the rank's block, which is divided
by the batch axes' extent once and kept out of the gradient mean; AdamW
updates the rank's blocks. A mixture-of-experts model trains on (d,1),
(1,m) and (d,m): its one-hot dispatch groups and its aux loss are the
global batch's (``models.moe.moe_dense_dispatch`` gathers the ranks'
per-expert counts), its experts' FFN (granite-moe-3b-a800m) or its
experts (deepseek-v3-671b, ``expert_parallel``) split over ``model``,
MLA's heads too, and the mean moves the live experts of a padded table
alone (:func:`live_slices`); at or above the reference's gate its MoE
layers take the expert-parallel route, as the reference's do
(``models.moe.moe_block``: tokens over every axis, each rank on its
block of the experts, held or re-laid from its block of their FFN), and
the mean moves every padded slot (:func:`takes_ep`); with ``cfg.fsdp``
(deepseek-v3-671b as configured) its steps are FSDP as the dense
family's, each MoE layer gathering the rank's ``model`` block of its
leaves (of a padded expert table, on the one-hot dispatch, the live
experts' rows alone), the MTP module its own. In micro-batches
(``grad_accum``) a MoE model's step first re-lays the rank's rows
micro-major (:func:`micro_major`: the token and label ids gathered over
the batch axes, each rank keeping its block of every global
micro-batch), so that each strip's dispatch group, capacities,
expert-parallel lanes and aux loss are the one-device micro-batch's; a
micro-batch whose rows the batch axes do not split raises
``ValueError``. The SSM and hybrid families (``fsdp=False``) train
tensor-parallel at ``model > 1`` too, in micro-batches on the dense
family's contiguous strips: each rank holds its blocks of every
``d_inner`` leaf and runs its heads, re-laying the fused projections on
the activations (``models.sharding.InnerSplit``); so do the vision and
encoder-decoder families (``fsdp=False``), their cross layers and the
audio encoder on the rank's heads and FFN columns, the frontend's
embeddings cut by the tokens' rows (the caller's block on a data rank,
each micro-batch's strip of it). Those four families under FSDP with
``model > 1`` raise ``NotImplementedError`` naming their queue item
(2.6).

``make_prefill_step`` / ``make_decode_step`` are the reference's serve
steps: the way the vision and encoder-decoder models serve, since they take
the frontend's embeddings in the batch. With a stacked mesh, MLA's
prefill runs its lane-local route (``models.attention.mla_chunked``). On
a tensor-parallel mesh of processes every family serves with the rank's
blocks and a cache of its kv heads (MLA: the latent cache whole; a GQA
cache the reference splits over ``kv_seq`` raises; a MoE model's layers
on the expert-parallel route at or above the gate; the audio model's
encoder output, ``memory``, whole on every rank), and the returned
logits are gathered whole (``models.transformer.last_logits``); an SSM
or hybrid model's cache holds its heads' states
(``models.transformer.init_cache``). Under FSDP
each rank serves its rows of the batch (the batch axes are its own, as in
training: a MoE model's one dispatch group spans the ranks) with a cache
of those rows,
its weights gathered a layer at a time, and the returned logits are the
global batch's.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import compat
from repro_torch.core.compat import PartitionSpec as PS
from repro_torch.core.compat import entry_axes
from repro_torch.core.precision import torch_dtype
from repro_torch.core.stripmine import stripmined_grads
from repro_torch.models import transformer as tf
from repro_torch.models.moe import (EXPERT_TABLES, ep_route, global_tokens,
                                    row_blocks)
from repro_torch.models.layers import (P, abstract_params, param_specs,
                                       tree_leaves, tree_map,
                                       value_and_grad)
from repro_torch.models.sharding import (MeshCtx, NamedSharding, check_fsdp,
                                         check_tensor_parallel, fsdp_split,
                                         held_experts, kv_cache_rules,
                                         make_rules, sanitize_specs,
                                         serve_ctx, tensor_parallel)
from repro_torch.models.sharding import named_sharding_tree as named
from repro_torch.optim import adamw


# ---------------------------------------------------------------------------
# Spec plumbing
# ---------------------------------------------------------------------------


def batch_pspecs(cfg: ArchConfig, shape_kind: str, ctx: MeshCtx) -> dict:
    b_axes = tuple(ctx.batch_axes)
    specs = {"tokens": PS(b_axes, None)}
    if shape_kind == "train":
        specs["labels"] = PS(b_axes, None)
    if cfg.frontend_seq:
        specs["frontend_emb"] = PS(b_axes, None, None)
    return specs


def cache_pspecs(cfg: ArchConfig, ctx: MeshCtx) -> dict:
    """PartitionSpecs matching init_cache's tree, the reference's. On a
    tensor-parallel rank of the hybrid family the port's ``conv`` state
    holds its heads' x channels, then B and C whole, not the contiguous
    block this spec cuts (ROADMAP Queue C)."""
    rules = kv_cache_rules(cfg, ctx)
    b = PS(tuple(ctx.batch_axes))

    def spec(axes):
        return rules.spec_for(P(tuple(1000 for _ in axes), tuple(axes)))

    fam = cfg.family
    c = {"lengths": b}
    kv_axes = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    if fam in ("dense", "vlm", "audio"):
        c["k"] = spec(kv_axes)
        c["v"] = spec(kv_axes)
        if fam == "audio":
            c["memory"] = spec(("batch", "seq", "embed"))
    elif fam == "moe":
        keys = ("c_kv", "k_rope") if cfg.use_mla else ("k", "v")
        axes = {"c_kv": ("layers", "batch", "kv_seq", "kv_lora"),
                "k_rope": ("layers", "batch", "kv_seq", "kv_lora"),
                "k": kv_axes, "v": kv_axes}
        for k in keys:
            c[k] = spec(axes[k])
            if cfg.moe.n_dense_layers:
                c["dense_" + k] = spec(axes[k])
    elif fam == "ssm":
        c["conv"] = spec(("layers", "batch", "seq", "d_inner"))
        c["ssm"] = spec(("layers", "batch", "heads", "ssm_state", "head_dim"))
    elif fam == "hybrid":
        c["conv"] = spec(("layers", "batch", "seq", "d_inner"))
        c["ssm"] = spec(("layers", "batch", "heads", "ssm_state", "head_dim"))
        c["attn_k"] = spec(("groups", "batch", "kv_seq", "kv_heads",
                            "head_dim"))
        c["attn_v"] = spec(("groups", "batch", "kv_seq", "kv_heads",
                            "head_dim"))
    return c


def named_for(spec_tree, aval_tree, mesh):
    return named(sanitize_specs(spec_tree, aval_tree, mesh), mesh)


@dataclasses.dataclass(frozen=True)
class AttnOverrides:
    """Per-run attention-path overrides (long-context training knobs).

    Each field, when set, replaces the matching ArchConfig field before the
    step closes over it: ``flash`` routes chunked_attention through the
    blockwise-attention kernel ("auto" | "on" | "off"), ``chunk`` sets the
    KV chunk of the blockwise loop, ``threshold`` caps the materialized
    quadratic fast path, ``block_remat`` names the per-q-block checkpoint
    policy (see models.attention.checkpoint_policy)."""
    flash: Optional[str] = None
    chunk: Optional[int] = None
    threshold: Optional[int] = None
    block_remat: Optional[str] = None


def apply_attn_overrides(cfg: ArchConfig,
                         attn: Optional[AttnOverrides]) -> ArchConfig:
    """cfg with any set AttnOverrides fields swapped in (frozen-safe)."""
    if attn is None:
        return cfg
    upd = {}
    if attn.flash is not None:
        upd["attn_flash"] = attn.flash
    if attn.chunk is not None:
        upd["attn_chunk"] = attn.chunk
    if attn.threshold is not None:
        upd["attn_threshold"] = attn.threshold
    if attn.block_remat is not None:
        upd["attn_block_remat"] = attn.block_remat
    return dataclasses.replace(cfg, **upd) if upd else cfg


@dataclasses.dataclass(frozen=True)
class TrainStepBundle:
    step_fn: object          # (state, batch) -> (state, metrics)
    state_specs: dict        # PartitionSpec tree for state
    batch_specs: dict
    abstract_state: dict     # meta-tensor tree (shapes and dtypes)
    cfg: ArchConfig          # the config the step closes over


def make_train_state_abstract(cfg: ArchConfig, opt_cfg: adamw.OptConfig):
    tmpl = tf.model_template(cfg)
    aparams = abstract_params(tmpl, torch_dtype(cfg.param_dtype))
    return {"params": aparams, "opt": adamw.abstract_state(opt_cfg, aparams)}


def train_state_specs(cfg: ArchConfig, ctx: MeshCtx) -> dict:
    tmpl = tf.model_template(cfg)
    rules = make_rules(cfg, ctx)
    pspecs = param_specs(tmpl, rules)
    return {"params": pspecs,
            "opt": {"m": pspecs, "v": pspecs, "step": PS()}}


def _check_process_route(cfg: ArchConfig, ctx: MeshCtx):
    """What the process route trains: the data-parallel step of every
    family; every family's tensor-parallel step (``model > 1``; MLA's
    heads, the experts or their FFN split over it, on the one-hot dispatch
    or the expert-parallel route; the mix layers' ``d_inner`` and heads,
    ``models.sharding.InnerSplit``; the cross layers' and the audio
    encoder's heads and FFN columns); every family's FSDP step
    (``fsdp=True``; every embed, q_lora and kv_lora dimension over the
    batch axes too), the SSM, hybrid, vision and encoder-decoder families'
    on a model axis of 1; each in micro-batches too (a MoE model's re-laid
    micro-major, :func:`micro_major`, which raises ``ValueError`` where
    the batch axes do not split a micro-batch's rows). Anything else
    raises ``NotImplementedError`` naming its queue item (item 2.6: those
    four families under FSDP with ``model > 1``; a head count or FFN width
    that the model axis does not divide)."""
    check_fsdp(cfg, ctx)
    check_tensor_parallel(cfg, ctx)


def micro_major(cfg: ArchConfig, ctx: MeshCtx, batch: dict,
                grad_accum: int) -> dict:
    """``batch`` (on a process mesh whose batch axes are local, the rank's
    block of rows) laid so that its contiguous strip ``i`` of
    ``grad_accum`` is the rank's block of the global micro-batch ``i``, as
    the reference's ``stripmined_grads`` cuts the global batch: global
    rows ``[i mb + r mb/d, i mb + (r+1) mb/d)`` for ``mb = B / grad_accum``
    and the rank's block ``r`` of ``d`` along the batch axes. A MoE
    model's micro-batch couples its rows (the one-hot dispatch's group and
    capacities, the expert-parallel route's gate and lanes, the aux loss's
    ``f``), so its step needs them; a dense model's rows are independent
    and keep the rank's contiguous strips. On a process mesh each leaf is
    gathered over the batch axes (``compat.gather_blocks``: one counted
    all-gather a leaf) and the rank keeps its rows; a micro-batch of rows
    that the batch axes do not split raises ``ValueError`` (the reference
    runs it through its partitioner). On the stacked route the batch is
    global, its strips already the global micro-batches: returned as it
    is, the ranks' gathers counted."""
    if not cfg.is_moe or grad_accum == 1:
        return batch
    rows = batch["tokens"].shape[0]
    mesh, axes, d, held = row_blocks(ctx, rows)
    if d == 1:
        return batch
    if held == d:
        for v in batch.values():
            compat.gather_blocks(v, mesh, axes)
        return batch
    if rows % grad_accum:
        raise ValueError(
            f"{cfg.name} on a process mesh: grad_accum={grad_accum} cuts the "
            f"global batch's {rows * d} rows into micro-batches of "
            f"{rows * d / grad_accum:g} rows, which {d} data ranks do not "
            f"split evenly (ROADMAP Queue C)")
    r = mesh.block(axes)

    def relay(v):
        whole = compat.gather_blocks(v, mesh, axes)
        lead = (grad_accum, d, rows // grad_accum)
        return whole.reshape(lead + whole.shape[1:])[:, r].reshape(
            (rows,) + whole.shape[1:])
    return {k: relay(v) for k, v in batch.items()}


def live_slices(cfg: ArchConfig, tree, tp=None, ep: bool = False) -> dict:
    """A tree over ``tree`` (the parameters or their gradients, global or,
    with ``tp``, a tensor-parallel rank's blocks): the index of each
    leaf's extent that the step reads, or None where it reads the leaf
    whole. The one-hot dispatch reads the live experts of a padded table
    (``models.moe``; where the model axis splits the experts, those of the
    rank's block); the other slots' gradients are identically zero, so the
    data-parallel mean moves the live ones alone, as the dry run's count
    and the reference's partitioner reduce them. With ``ep`` (the step's
    MoE layers take the expert-parallel route, :func:`takes_ep`), which
    reads every padded slot: every leaf whole."""
    live = tree_map(lambda _: None, tree)
    m = cfg.moe
    if cfg.is_moe and m.n_experts_padded > m.n_experts and not ep:
        held = slice(0, len(held_experts(cfg, tp)))
        for k in EXPERT_TABLES:
            live["layers"]["moe"][k] = (slice(None), held)
    return live


def takes_ep(cfg: ArchConfig, ctx: MeshCtx, tokens,
             grad_accum: int = 1) -> bool:
    """Whether a step of ``cfg`` on ``tokens`` (the batch's, a process
    mesh's rank's rows where its batch axes are local) in ``grad_accum``
    micro-batches takes the expert-parallel route in its MoE layers
    (``models.moe.ep_route`` on the global micro-batch)."""
    rows, seq = tokens.shape
    return cfg.is_moe and ep_route(cfg, ctx, global_tokens(
        ctx, rows // grad_accum, seq))


def cut_axes(specs, mesh) -> dict:
    """A tree of the axes of ``mesh`` (in its order) that each sanitized
    spec cuts the leaf over: () where the rank holds it whole."""
    return tree_map(lambda s: tuple(a for a in mesh.axis_names if any(
        a in entry_axes(e) for e in s) and mesh.shape[a] > 1), specs)


def mean_over_batch(grads, metrics: dict, mesh, batch_axes,
                    scattered=None, live=None) -> tuple:
    """Each rank's gradients and loss metrics of its block of the batch ->
    the global batch's, on every rank, in place: one
    ``compat.pmean_in_place`` a gradient leaf and one for the metrics
    (stacked in their widest dtype, each cast back). ``scattered``: a tree
    of bools over ``grads``, True where FSDP's reduce-scatter has already
    summed the leaf's gradient over the batch axes (it is divided by their
    extent, once, and not averaged again). ``live``: a tree of indices
    over ``grads`` (:func:`live_slices`): the extent of each leaf that is
    averaged (None: the whole leaf)."""
    keys = sorted(metrics)
    wide = functools.reduce(torch.promote_types,
                            (metrics[k].dtype for k in keys))
    stacked = torch.stack([metrics[k].to(wide) for k in keys])
    leaves = list(tree_leaves(grads))
    if live is not None:
        leaves = [g if ix is None else g[ix]
                  for g, ix in zip(leaves, tree_leaves(live))]
    done = [False] * len(leaves) if scattered is None \
        else list(tree_leaves(scattered))
    n = math.prod(mesh.shape[a] for a in entry_axes(tuple(batch_axes)))
    for g, d in zip(leaves, done):
        if d:
            g.div_(n)
    compat.pmean_in_place([g for g, d in zip(leaves, done) if not d]
                          + [stacked], mesh, batch_axes)
    return grads, {k: stacked[i].to(metrics[k].dtype)
                   for i, k in enumerate(keys)}


def local_abstract(abstract, specs, mesh):
    """The ``meta`` tree of a rank's blocks of the global ``abstract`` tree
    on a process mesh (``specs`` sanitized against it)."""
    return tree_map(lambda s, t: torch.empty(
        NamedSharding(mesh, s).shard_shape(t.shape), dtype=t.dtype,
        device="meta"), specs, abstract)


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.OptConfig,
                    ctx: Optional[MeshCtx] = None, grad_accum: int = 1,
                    attn: Optional[AttnOverrides] = None) -> TrainStepBundle:
    """state = {"params", "opt"} (trees of tensors on one device), batch =
    {"tokens", "labels"} (B,S) integer tensors on the same device. The
    state's tensors are updated in place (see ``optim.adamw.update``) and
    returned. ``ctx`` None is one device. On a process mesh the batch is
    the rank's block, the step is data-parallel and, at ``model > 1``,
    tensor-parallel, with ``cfg.fsdp`` FSDP: the state is then the rank's
    blocks, whose shapes the bundle's ``abstract_state`` gives (see the
    module's docstring)."""
    ctx = ctx or MeshCtx(mesh=None)
    cfg = apply_attn_overrides(cfg, attn)
    process = compat.is_process_mesh(ctx.mesh)
    specs = train_state_specs(cfg, ctx)
    abstract = make_train_state_abstract(cfg, opt_cfg)
    norm = None
    if process:
        _check_process_route(cfg, ctx)
        ctx = dataclasses.replace(
            ctx, mesh=ctx.mesh.with_local(ctx.batch_axes))
    fs = fsdp_split(cfg, ctx)
    scattered = None
    if tensor_parallel(cfg, ctx) is not None or fs is not None:
        sane = sanitize_specs(specs, abstract, ctx.mesh)
        cut = cut_axes(sane["params"], ctx.mesh)
        abstract = local_abstract(abstract, sane, ctx.mesh)
        if fs is not None:
            scattered = tree_map(lambda s: fs.dim(s) is not None,
                                 sane["params"])

        def norm(grads):
            return adamw.global_norm(grads, cut, ctx.mesh)

    def loss_fn(params, batch):
        return tf.lm_loss(cfg, params, batch, ctx=ctx)

    def train_step(state, batch):
        params = state["params"]
        if grad_accum > 1:
            (loss, metrics), grads = stripmined_grads(
                loss_fn, params, micro_major(cfg, ctx, batch, grad_accum),
                grad_accum)
        else:
            (loss, metrics), grads = value_and_grad(loss_fn)(params, batch)
        if process:
            live = live_slices(cfg, grads, tensor_parallel(cfg, ctx),
                               takes_ep(cfg, ctx, batch["tokens"],
                                        grad_accum))
            with torch.no_grad():
                grads, metrics = mean_over_batch(
                    grads, dict(metrics, loss=loss), ctx.mesh,
                    ctx.batch_axes, scattered, live)
            loss = metrics.pop("loss")
        new_params, new_opt, opt_metrics = adamw.update(
            opt_cfg, grads, state["opt"], params, norm=norm)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return {"params": new_params, "opt": new_opt}, metrics

    return TrainStepBundle(train_step, specs, batch_pspecs(cfg, "train", ctx),
                           abstract, cfg)


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ArchConfig, ctx: Optional[MeshCtx] = None,
                      max_seq: int = 0, cache_dtype=None):
    """``prefill(params, batch) -> (logits_last, cache)``: a fresh cache of
    ``max_seq`` rows on the tokens' device (``cache_dtype``: the
    reference's bfloat16 by default), filled by one forward under the
    from-zero prefill hint. ``batch`` = {"tokens" (B,S)[, "frontend_emb"]}.
    """
    if max_seq < 1:
        raise ValueError(f"make_prefill_step: max_seq must be positive, got "
                         f"{max_seq}")
    check_tensor_parallel(cfg, ctx, cache=True)
    check_fsdp(cfg, ctx)
    ctx = serve_ctx(cfg, ctx)

    def prefill(params, batch):
        tokens = batch["tokens"]
        kw = {} if cache_dtype is None else {"cache_dtype": cache_dtype}
        cache = tf.init_cache(cfg, tokens.shape[0], max_seq,
                              device=tokens.device, ctx=ctx, **kw)
        tf.set_prefill_hint(True)
        try:
            logits, _, cache = tf.forward(
                cfg, params, tokens, ctx=ctx, cache=cache,
                frontend_emb=batch.get("frontend_emb"))
        finally:
            tf.set_prefill_hint(False)
        return tf.last_logits(cfg, logits, ctx), cache
    return prefill


def make_decode_step(cfg: ArchConfig, ctx: Optional[MeshCtx] = None):
    """``decode(params, cache, batch) -> (logits, new_cache)``, the cache's
    tensors written in place (see ``models.transformer.forward``)."""
    check_tensor_parallel(cfg, ctx, cache=True)
    check_fsdp(cfg, ctx)
    ctx = serve_ctx(cfg, ctx)

    def decode(params, cache, batch):
        logits, _, cache = tf.forward(
            cfg, params, batch["tokens"], ctx=ctx, cache=cache,
            frontend_emb=batch.get("frontend_emb"))
        return tf.last_logits(cfg, logits, ctx), cache
    return decode
