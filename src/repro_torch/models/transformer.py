"""Model zoo: template + forward, every family of the reference.

Families: **dense** (GQA decoder blocks), **moe** (GQA or MLA attention
with mixture-of-experts FFNs, optional leading dense layers and a
multi-token-prediction module: granite-moe-3b-a800m, deepseek-v3-671b),
**ssm** (mLSTM blocks, xlstm-1.3b), **hybrid** (Mamba2 layers with one
weight-shared attention+FFN block after every ``attn_every`` of them,
zamba2-7b), **vlm** (a tanh-gated cross-attention block after every
``cross_attn_every`` self-attention layers, llama-3.2-vision-11b) and
**audio** (a non-causal encoder over the frontend's frames, decoder layers
with cross-attention to its output, seamless-m4t-medium). The vlm and
audio frontends are stubs, as in the reference: the caller passes their
embeddings as ``frontend_emb``.

Layer parameters are stacked along a leading ``layers`` axis, as in the
reference. PyTorch runs eagerly, so ``cfg.scan_layers`` has no meaning
here: the stack is walked by a Python loop either way, each layer a view
of the stacked tensors. ``cfg.remat`` wraps each layer of the no-cache
forward when autograd records it: "full" is ``torch.utils.checkpoint`` per
layer (the layer runs again in the backward pass), the named policies
("dots", ...) share ``models.attention.checkpoint_policy``'s vocabulary
with the per-q-block knob of the blockwise attention path. Training
attention routes through ``chunked_attention`` — and from there the
blockwise-attention kernel when ``cfg.attn_flash`` allows; so does the
hybrid family's shared attention block in a no-cache forward.

Decode uses per-sequence KV caches (see attention.py) and recurrent states
(ssm.py): ``forward`` with a cache writes the new KV rows (or MLA's
compressed rows), the new ``conv``/``ssm`` states and the encoder's
``memory`` **into the cache tensors it was given** and returns them.

``forward`` takes the reference's mesh context (``models.sharding.
MeshCtx``): the mixture-of-experts layers take their expert-parallel route
with it (``moe.moe_block``) and MLA's prefill its lane-local one
(``attention.set_mesh_ctx``), each on a mesh held as tensor dimensions on
one device (``core/compat.py``); everything else is the same math with or
without a mesh. On a mesh of processes whose ``model`` axis is above 1
(``models.sharding.tensor_parallel``) the dense, MoE, SSM and hybrid
families run tensor-parallel on the rank's blocks of the parameters (a
mix layer on its heads, its fused projections re-laid onto them on the
activations: ``models.sharding.InnerSplit``; on a stacked mesh the same
collectives are counted), and so do the vision and encoder-decoder
families (the cross layers and the audio encoder on the rank's heads and
FFN columns; the gate after the all-reduce, the encoder's output whole on
every rank and in the cache): the lookup into
its vocab block of the embedding, masked and all-reduced; the attention
heads (GQA's, or MLA's over the whole latent cache), the FFN columns, the
experts or each expert's FFN columns (``moe.moe_dense_dispatch``) and the
head's vocab columns of its own, between Megatron's ``copy_to`` /
``reduce_from`` (on the expert-parallel route the rank's block of the
experts, held or re-laid: ``moe.moe_ep_shard_map``); the logits its
vocab block of them, and the cross-entropy vocab-parallel (:func:`_ce`),
the MTP module's too. Where
the axis does not divide the vocab, the rank holds the table whole and
the lookup, the head and the cross-entropy are unsplit. Under FSDP
(``models.sharding.fsdp_split``: ``cfg.fsdp`` on a mesh of processes
whose batch axes are above 1; a family outside the dense and MoE ones
only where its model axis is 1) the parameters are the rank's blocks over
the batch axes as well: each layer gathers its leaves inside the function
that its checkpoint wraps (so the recompute gathers them again) and
casts them to the compute dtype after the gather, while a leaf that FSDP
leaves whole keeps its stored dtype (the router, which routes in fp32;
the mix layers' leaves without an ``embed`` dimension, mLSTM's ``wq``,
``wk``, ``wv`` and gates, the convolution, ``a_log``, ``dt_bias``,
``d_skip`` and ``norm``, which the data mean reduces whole); without a
checkpoint the layer runs under ``Fsdp.regather``, so that the backward
gathers them again instead of keeping them. So gather a MoE layer (its
attention, norms, router, the live rows of its expert tables, or every
row on the expert-parallel route, and its shared expert), a dense or
decoder layer (the audio model's ``xattn`` and ``ln_x`` among its
leaves), a mix layer (``up_proj`` / ``in_proj``, ``out_proj`` and
``ln1``; in the cache path too), the vision model's cross layers (but
the ``q_norm`` that nothing reads) and the audio model's encoder layers;
``enc_norm`` is gathered under ``Fsdp.regather``. The hybrid family's shared block is gathered
once a forward, at its first use, and that copy is read by every group
(``models.sharding.Reused``); the backward gathers it once more. The
table is gathered for the lookup, the final norm and the head where the
head uses them, and the MTP module (:func:`lm_loss`) gathers its own
leaves and reads the table and the head's leaf that the forward
gathered.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core import compat
from repro_torch.core.precision import torch_dtype
from repro_torch.device import resolve_device
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import attention as attn_mod
from repro_torch.models.attention import (checkpointed, cross_attention,
                                          gqa_attention, gqa_template,
                                          mla_attention, mla_template)
from repro_torch.models.layers import (P, rms_norm, tree_leaves, tree_map,
                                       widen)
from repro_torch.models.mlp import mlp, mlp_template
from repro_torch.models.moe import (EXPERT_TABLES, ep_route, global_tokens,
                                    moe_block, moe_template)
from repro_torch.models.sharding import (InnerSplit, Reused, check_fsdp,
                                         check_tensor_parallel, fsdp_split,
                                         held_experts, inner_split,
                                         tensor_parallel, vocab_split)


# ---------------------------------------------------------------------------
# Templates
# ---------------------------------------------------------------------------


def _stack(tmpl, n: int):
    """Add a leading stacked-layers dim to every leaf."""
    if isinstance(tmpl, P):
        return P((n,) + tmpl.shape, ("layers",) + tmpl.axes, tmpl.init,
                 tmpl.std)
    return {k: _stack(v, n) for k, v in tmpl.items()}


def _attn_layer_template(cfg: ArchConfig, cross=False) -> dict:
    t = {"ln1": P((cfg.d_model,), ("embed",), "ones")}
    t["attn"] = mla_template(cfg) if cfg.use_mla \
        else gqa_template(cfg, cross=cross)
    return t


def _dense_layer_template(cfg: ArchConfig) -> dict:
    t = _attn_layer_template(cfg)
    t["ln2"] = P((cfg.d_model,), ("embed",), "ones")
    t["mlp"] = mlp_template(cfg.d_model, cfg.d_ff, cfg.activation)
    return t


def _moe_layer_template(cfg: ArchConfig) -> dict:
    t = _attn_layer_template(cfg)
    t["ln2"] = P((cfg.d_model,), ("embed",), "ones")
    t["moe"] = moe_template(cfg)
    return t


def _dense_ffn_cfg(cfg: ArchConfig, **upd) -> ArchConfig:
    """The config of a MoE model's dense layers (and of its MTP layer): the
    dense FFN width ``moe.dense_d_ff`` (0 -> ``d_ff``)."""
    return dataclasses.replace(cfg, d_ff=cfg.moe.dense_d_ff or cfg.d_ff,
                               **upd)


def model_template(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    t: dict = {
        "embed": P((cfg.vocab_size, d), ("vocab", "embed"), "normal", 0.02),
        "final_norm": P((d,), ("embed",), "ones"),
    }
    if not cfg.tie_embeddings:
        t["unembed"] = P((d, cfg.vocab_size), ("embed", "vocab"), "normal",
                         0.02)
    fam = cfg.family
    if fam == "dense":
        t["layers"] = _stack(_dense_layer_template(cfg), cfg.n_layers)
    elif fam == "moe":
        m = cfg.moe
        if m.n_dense_layers:
            t["dense_layers"] = _stack(
                _dense_layer_template(_dense_ffn_cfg(cfg)), m.n_dense_layers)
        t["layers"] = _stack(_moe_layer_template(cfg),
                             cfg.n_layers - m.n_dense_layers)
        if cfg.mtp_depth:
            t["mtp"] = {
                "proj": P((2 * d, d), (None, "embed"), "fan_in"),
                "norm_h": P((d,), ("embed",), "ones"),
                "norm_e": P((d,), ("embed",), "ones"),
                "layer": _dense_layer_template(
                    _dense_ffn_cfg(cfg, use_mla=False)),
            }
    elif fam == "ssm":
        layer = {"ln1": P((d,), ("embed",), "ones"),
                 "mix": ssm_mod.mlstm_template(cfg)}
        t["layers"] = _stack(layer, cfg.n_layers)
    elif fam == "hybrid":
        layer = {"ln1": P((d,), ("embed",), "ones"),
                 "mix": ssm_mod.mamba2_template(cfg)}
        t["layers"] = _stack(layer, cfg.n_layers)
        t["shared_attn"] = _dense_layer_template(cfg)
    elif fam == "vlm":
        if cfg.n_layers % cfg.cross_attn_every:
            raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a "
                             f"multiple of cross_attn_every "
                             f"{cfg.cross_attn_every}")
        t["layers"] = _stack(_dense_layer_template(cfg), cfg.n_layers)
        xt = _attn_layer_template(cfg, cross=True)
        xt["ln2"] = P((d,), ("embed",), "ones")
        xt["mlp"] = mlp_template(d, cfg.d_ff, cfg.activation)
        t["cross_layers"] = _stack(xt, cfg.n_layers // cfg.cross_attn_every)
    elif fam == "audio":
        t["enc_layers"] = _stack(_dense_layer_template(cfg),
                                 cfg.n_encoder_layers)
        t["enc_norm"] = P((d,), ("embed",), "ones")
        dec = _dense_layer_template(cfg)
        dec["ln_x"] = P((d,), ("embed",), "ones")
        dec["xattn"] = gqa_template(cfg)
        t["layers"] = _stack(dec, cfg.n_layers)
    else:
        raise ValueError(fam)
    return t


# ---------------------------------------------------------------------------
# Blocks (forward)
# ---------------------------------------------------------------------------


_PREFILL_FROM_ZERO = False


def set_prefill_hint(value: bool):
    """Static hint from the serving layer: the incoming cache is fresh
    (lengths == 0, the prompt fills it end to end), so MLA's prefill may
    walk the causal triangle only (``_mla_triangular``). A module-level
    flag, as in the reference; ``train.step.make_prefill_step`` sets it
    around one forward and clears it in a ``finally``."""
    global _PREFILL_FROM_ZERO
    _PREFILL_FROM_ZERO = bool(value)


def _attn_block(cfg, p, x, positions, cache=None, causal=True, tp=None):
    """Pre-norm attention (MLA or GQA). Returns (attention output, the
    normed input, the layer's new cache entries or None)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.use_mla:
        a, new_cache = mla_attention(cfg, p["attn"], h, positions,
                                     cache=cache,
                                     prefill_from_zero=_PREFILL_FROM_ZERO,
                                     tp=tp)
    else:
        a, new_cache = gqa_attention(cfg, p["attn"], h, positions,
                                     cache=cache, causal=causal, tp=tp)
    return a, h, new_cache


def dense_block(cfg, p, x, positions, cache=None, causal=True, memory=None,
                tp=None):
    """Attention + FFN; an encoder-decoder layer (``xattn`` in ``p``) adds
    cross-attention to ``memory`` between the two. ``tp``: the rank's
    ``models.sharding.TensorParallel`` (its blocks of ``p``), or None."""
    a, h, new_cache = _attn_block(cfg, p, x, positions, cache, causal, tp)
    if cfg.parallel_block:
        return x + a + mlp(p["mlp"], h, cfg.activation, tp), new_cache
    x = x + a
    if memory is not None and "xattn" in p:
        hx = rms_norm(x, p["ln_x"], cfg.norm_eps)
        x = x + cross_attention(cfg, p["xattn"], hx, memory, tp=tp)
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + mlp(p["mlp"], h2, cfg.activation, tp)
    return x, new_cache


def moe_layer(cfg, p, x, positions, ctx=None, cache=None, tp=None):
    """Attention + mixture-of-experts FFN. Returns (x, aux, new cache
    entries or None). ``ctx``: the mesh context (see ``moe.moe_block``);
    ``tp``: the rank's ``models.sharding.TensorParallel``, or None."""
    a, _, new_cache = _attn_block(cfg, p, x, positions, cache, tp=tp)
    x = x + a
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    y, aux = moe_block(cfg, p["moe"], h2, ctx, tp)
    return x + y, aux, new_cache


def _cross_block(cfg, p, x, memory, tp=None):
    """The vision model's gated cross-attention layer + FFN. ``tp``: the
    rank's ``models.sharding.TensorParallel`` (its blocks of ``p``), or
    None."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + cross_attention(cfg, p["attn"], h, memory, tp=tp)
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + mlp(p["mlp"], h2, cfg.activation, tp)
    return x, None


def mix_layer(cfg, p, x, state=None, split=None):
    """ssm/hybrid mixing layer (mamba2 or mlstm). ``split``: the model
    axis over the block (``models.sharding.InnerSplit``), or None."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    block = ssm_mod.mamba2_block if cfg.ssm.kind == "mamba2" \
        else ssm_mod.mlstm_block
    split = split or InnerSplit()
    # on a stacked mesh the block counts its own collectives
    with split.scope():
        y, new_state = block(cfg, p["mix"], h, state, split)
    return x + y, new_state


def _maybe_remat(fn, cfg: ArchConfig):
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return lambda *args: _ckpt.checkpoint(fn, *args, use_reentrant=False)
    # named policies share models.attention's vocabulary; "dots" keeps its
    # historical meaning (no-batch-dims dots, the scan-body default)
    name = "dots_no_batch" if cfg.remat == "dots" else cfg.remat
    return checkpointed(fn, name)


# ---------------------------------------------------------------------------
# Full forward
# ---------------------------------------------------------------------------


def _frontend(cfg: ArchConfig, frontend_emb, dtype):
    if frontend_emb is None:
        raise ValueError(
            f"{cfg.name} ({cfg.family}) needs frontend_emb, the stub "
            f"frontend's embeddings (B, {cfg.frontend_seq}, "
            f"{cfg.frontend_dim or cfg.d_model})")
    return frontend_emb.to(dtype)


def forward(cfg: ArchConfig, params: dict, tokens, *, ctx=None,
            cache: Optional[dict] = None, frontend_emb=None, head_fn=None):
    """Shared forward. tokens (B,S) integer, on the parameters' device.

    cache=None  -> full causal forward (training / scoring), returns
                   (logits, aux, extras); with autograd recording, each
                   layer runs under ``cfg.remat``
    cache=dict  -> prefill (lengths=0, S=prompt) or decode (S small);
                   returns (logits, aux, new_cache). Every tensor of the
                   cache but ``lengths`` (``k``/``v``; ``c_kv``/``k_rope``
                   and their ``dense_`` twins; ``conv``/``ssm``;
                   ``attn_k``/``attn_v``; ``memory``) is updated in place
                   and is the same tensor in ``new_cache``;
                   ``new_cache["lengths"]`` is a new tensor,
                   ``cache["lengths"]`` is left as it was.
    frontend_emb -> (B, frontend_seq, frontend_dim) stub embeddings: the
                   vlm family's cross-attention memory, needed at every
                   call; the audio family's encoder input, needed except
                   for a one-token step with ``memory`` in the cache (the
                   encoder's output, stored there by the prefill).
    head_fn     -> optional ``(x, unembed) -> logits`` replacing the final
                   product — the serving degrade ladder routes the logits
                   head through the CUDA kernels here
                   (``kernels.ops.lm_head``).

    Tensor-parallel over processes (see the module's docstring), the
    logits are the rank's vocab block of them (:func:`last_logits`
    gathers a serve step's).

    ``aux`` is the mixture-of-experts load-balance loss summed over the MoE
    layers (zero for the other families). ``ctx`` is the mesh context
    (None: one device); as in the reference, it is also left set for MLA's
    lane-local route until the next forward.
    """
    mesh_ctx = ctx if ctx is not None and ctx.mesh is not None else None
    attn_mod.set_mesh_ctx(mesh_ctx)
    check_tensor_parallel(cfg, mesh_ctx, cache=cache is not None)
    check_fsdp(cfg, mesh_ctx)
    tp = tensor_parallel(cfg, mesh_ctx)
    fs = fsdp_split(cfg, mesh_ctx)
    b, s = tokens.shape
    dev = tokens.device
    compute_dtype = torch_dtype(cfg.compute_dtype)
    # the MTP module (lm_loss) reads the table and the head this gathers
    mtp = cache is None and bool(cfg.mtp_depth) and "mtp" in params
    # FSDP: a leaf's blocks are gathered where it is used (inside a block's
    # function, so that a checkpoint's recompute gathers them again)
    table = params["embed"] if fs is None else fs.gather_leaf(
        params["embed"], fs.specs["embed"])
    x = embed_lookup(table, tokens, vocab_split(tp)).to(compute_dtype)
    if not (cfg.tie_embeddings or mtp):
        del table

    steps = torch.arange(s, dtype=torch.int32, device=dev)[None, :]
    if cache is not None:
        lengths = cache["lengths"]
        positions = lengths[:, None].to(torch.int32) + steps
    else:
        lengths = None
        positions = steps.expand(b, s)

    aux = torch.zeros((), dtype=torch.float32, device=dev)
    remat = cache is None and torch.is_grad_enabled()

    def run(fn, x):
        """One block of the no-cache forward: under ``cfg.remat`` when
        autograd records it; under FSDP without a checkpoint, its gathered
        leaves gathered again for the backward (``Fsdp.regather``)."""
        if not remat:
            return fn(x)
        if fs is not None and cfg.remat == "none":
            with fs.regather():
                return fn(x)
        return _maybe_remat(fn, cfg)(x)

    def gathered(p, key):
        """A layer's parameters: under FSDP its blocks gathered and cast to
        the compute dtype (``key``: its stack's key in the parameters);
        a leaf that FSDP leaves whole keeps its stored dtype."""
        return p if fs is None else fs.gather(p, fs.specs[key],
                                              compute_dtype, lead=1)

    # each block below is a function of its own parameters: a checkpoint
    # recomputes it in the backward pass, after the layer loop has moved on

    def layer_cache(i, keys, prefix=""):
        """Layer ``i``'s views of the cache tensors ``prefix + key``, which
        its attention writes in place; None without a cache."""
        if cache is None:
            return None
        c = {k: cache[prefix + k][i] for k in keys}
        c["lengths"] = lengths
        return c

    def attn_block(load, x, c, memory=None):
        """A dense block; ``load()`` gives its parameters (called inside
        the function a checkpoint wraps, so that under FSDP the recompute
        gathers them again); ``c`` = its cache views, or None."""
        if cache is None:
            return run(lambda x: dense_block(
                cfg, load(), x, positions, memory=memory, tp=tp)[0], x)
        return dense_block(cfg, load(), x, positions, cache=c,
                           memory=memory, tp=tp)[0]

    # the MoE layers' route (moe.moe_block's gate, on the global batch)
    ep = cfg.is_moe and ep_route(cfg, mesh_ctx,
                                 global_tokens(mesh_ctx, b, s))

    def moe_params(p):
        """A MoE layer's parameters: under FSDP its blocks gathered, of the
        expert tables on the one-hot dispatch the live experts' rows alone
        (it reads no other row of a padded table; the expert-parallel
        route reads every row), cast to the compute dtype but the router,
        which routes in fp32 whatever that is (``moe._topk``)."""
        if fs is None:
            return p
        live = None if ep else len(held_experts(cfg, tp))
        rest = {k: v[:live] if k in EXPERT_TABLES else v
                for k, v in p["moe"].items() if k != "router"}
        out = gathered(dict(p, moe=rest), "layers")
        out["moe"]["router"] = fs.gather_leaf(
            p["moe"]["router"], fs.specs["layers"]["moe"]["router"], lead=1)
        return out

    def moe(p, x, c):
        """A MoE layer: (x, aux)."""
        if cache is None:
            return run(lambda x: moe_layer(cfg, moe_params(p), x, positions,
                                           mesh_ctx, tp=tp)[:2], x)
        return moe_layer(cfg, moe_params(p), x, positions, mesh_ctx,
                         cache=c, tp=tp)[:2]

    def cross_params(p):
        """A cross layer's parameters (under FSDP gathered, but its
        ``q_norm``, which the layer never reads, as in the reference)."""
        if fs is None:
            return p
        attn = {k: v for k, v in p["attn"].items() if k != "q_norm"}
        return gathered(dict(p, attn=attn), "cross_layers")

    def cross_block(p, x, memory):
        return run(lambda x: _cross_block(cfg, cross_params(p), x,
                                          memory, tp)[0], x)

    def encoder_block(p, x, enc_pos):
        return run(lambda x: dense_block(cfg, gathered(p, "enc_layers"), x,
                                         enc_pos, causal=False, tp=tp)[0], x)

    def mix(p, x, i):
        """Mixing layer ``i`` (under FSDP its blocks gathered, in the cache
        path too); its recurrent state is read from and written back into
        the cache in place."""
        if cache is None:
            return run(lambda x: mix_layer(cfg, gathered(p, "layers"), x,
                                           split=split)[0], x)
        x, new = mix_layer(cfg, gathered(p, "layers"), x,
                           {"conv": cache["conv"][i], "ssm": cache["ssm"][i]},
                           split)
        cache["conv"][i].copy_(new["conv"])
        cache["ssm"][i].copy_(new["ssm"])
        return x

    def unstack(tree):
        """One view per layer; unbind's backward stacks the layers'
        gradients once, where indexing would add a zero-padded copy of the
        whole stack per layer."""
        per = tree_map(lambda a: a.unbind(0), tree)
        n = next(tree_leaves(tree)).shape[0]
        return [tree_map(lambda a: a[i], per) for i in range(n)]

    fam = cfg.family
    memory, fresh_memory = None, False
    if fam == "vlm":
        memory = _frontend(cfg, frontend_emb, compute_dtype)
    elif fam == "audio":
        # a one-token step reads the encoder's output from the cache; a
        # prefill or a full forward runs the encoder and stores it
        if cache is not None and "memory" in cache and s == 1:
            memory = cache["memory"].to(compute_dtype)
        else:
            memory = _frontend(cfg, frontend_emb, compute_dtype)
            enc_pos = torch.arange(memory.shape[1], dtype=torch.int32,
                                   device=dev)[None, :].expand(
                                       memory.shape[:2])
            for p_i in unstack(params["enc_layers"]):
                memory = encoder_block(p_i, memory, enc_pos)
            with contextlib.nullcontext() if fs is None else fs.regather():
                norm = params["enc_norm"] if fs is None else \
                    fs.gather_leaf(params["enc_norm"], fs.specs["enc_norm"],
                                   compute_dtype)
                memory = rms_norm(memory, norm, cfg.norm_eps)
                del norm
            fresh_memory = True

    if fam in ("dense", "vlm", "audio"):
        cross = unstack(params["cross_layers"]) if fam == "vlm" else None
        for i, p_i in enumerate(unstack(params["layers"])):
            x = attn_block(lambda p=p_i: gathered(p, "layers"), x,
                           layer_cache(i, ("k", "v")),
                           memory if fam == "audio" else None)
            # vlm: a cross block closes each group of cross_attn_every
            if fam == "vlm" and (i + 1) % cfg.cross_attn_every == 0:
                x = cross_block(cross[i // cfg.cross_attn_every], x, memory)
    elif fam == "moe":
        kv_keys = ("c_kv", "k_rope") if cfg.use_mla else ("k", "v")
        if cfg.moe.n_dense_layers:
            for i, p_i in enumerate(unstack(params["dense_layers"])):
                x = attn_block(lambda p=p_i: gathered(p, "dense_layers"), x,
                               layer_cache(i, kv_keys, "dense_"))
        for i, p_i in enumerate(unstack(params["layers"])):
            x, a = moe(p_i, x, layer_cache(i, kv_keys))
            aux = aux + a
    elif fam in ("ssm", "hybrid"):
        split = inner_split(cfg, mesh_ctx, tp)
        if fam == "hybrid":
            # under FSDP the shared block is gathered at its first use and
            # that copy read by every group (``Reused``)
            shared = (lambda: params["shared_attn"]) if fs is None else \
                Reused(fs, params["shared_attn"], fs.specs["shared_attn"],
                       compute_dtype, cfg.n_layers // cfg.attn_every).get
        for i, p_i in enumerate(unstack(params["layers"])):
            x = mix(p_i, x, i)
            # hybrid: the shared block closes each whole group of
            # attn_every layers; the tail layers after the last group have
            # none
            if fam == "hybrid" and (i + 1) % cfg.attn_every == 0:
                g = i // cfg.attn_every
                c = None if cache is None else {
                    "k": cache["attn_k"][g], "v": cache["attn_v"][g],
                    "lengths": lengths}
                x = attn_block(shared, x, c)
    else:
        raise ValueError(fam)

    with contextlib.nullcontext() if fs is None else fs.regather():
        head = "embed" if cfg.tie_embeddings else "unembed"
        norm, unembed = params["final_norm"], params[head]
        if fs is not None:
            norm = fs.gather_leaf(norm, fs.specs["final_norm"],
                                  compute_dtype)
            unembed = fs.gather_leaf(
                unembed, fs.specs[head], compute_dtype,
                gathered=table if cfg.tie_embeddings else None)
        head_leaf = unembed if mtp else None
        x = rms_norm(x, norm, cfg.norm_eps)
        if cfg.tie_embeddings:
            unembed = unembed.T
        unembed = unembed.to(compute_dtype)
        if head_fn is not None:
            logits = head_fn(x, unembed)
        else:
            tv = vocab_split(tp)
            logits = (x if tv is None else tv.copy(x)) @ unembed
        del norm, unembed

    if cache is not None:
        new_cache = {k: v for k, v in cache.items() if k != "lengths"}
        if fresh_memory:
            if "memory" in cache:
                cache["memory"].copy_(memory)
            else:
                new_cache["memory"] = memory
        new_cache["lengths"] = lengths + s
        return logits, aux, new_cache
    extras = {"final_hidden": x}
    if mtp:
        extras.update(table=table, head=head_leaf)
    return logits, aux, extras


# ---------------------------------------------------------------------------
# Losses / steps-facing API
# ---------------------------------------------------------------------------


def lm_loss(cfg: ArchConfig, params, batch, ctx=None):
    """Next-token CE + 0.01 x the MoE aux loss (+ 0.3 x the MTP loss where
    the model has an MTP module). batch = {"tokens", "labels"} (B,S)
    integer tensors on the parameters' device, and ``frontend_emb`` for
    the vlm and audio families; ``ctx`` the mesh context (None: one
    device). Returns (total, {"ce", "aux"[, "mtp"]})."""
    logits, aux, extras = forward(cfg, params, batch["tokens"], ctx=ctx,
                                  frontend_emb=batch.get("frontend_emb"))
    tp = tensor_parallel(cfg, ctx)
    loss = _ce(logits, batch["labels"], vocab_split(tp))
    total = loss + 0.01 * aux
    metrics = {"ce": loss, "aux": aux}
    if cfg.mtp_depth and "mtp" in params:
        mtp_loss = _mtp_loss(cfg, params, batch, extras, tp,
                             fsdp_split(cfg, ctx))
        total = total + 0.3 * mtp_loss
        metrics["mtp"] = mtp_loss
    return total, metrics


def _ce(logits, labels, tp=None):
    """Mean cross-entropy in fp32 (float64 for float64 logits). With
    ``tp`` the logits are the rank's vocab block and the loss is the
    global one, on every rank (:class:`_VocabParallelCE`)."""
    logits = widen(logits)
    if tp is not None:
        return _VocabParallelCE.apply(logits, labels, tp)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


class _VocabParallelCE(torch.autograd.Function):
    """The mean cross-entropy of logits split over the vocab: the running
    max all-reduced (MAX), the sum of exponentials and the gold logit
    (a masked local gather) all-reduced (SUM), the three terms the dry run
    derives on the vocab-sharded logits. The backward is local, ``softmax
    - onehot`` over the rank's block: autograd through the collectives
    would add backward all-reduces that the reference does not run."""

    @staticmethod
    def forward(ctx, logits, labels, tp):
        n_tok = labels.numel()
        v_loc = logits.shape[-1]
        gmax = tp.all_reduce(logits.amax(dim=-1), "MAX")
        e = torch.exp(logits - gmax[..., None])
        total = tp.all_reduce(e.sum(dim=-1))
        ids, inside = _local_ids(labels, tp.start(v_loc), v_loc)
        gold = torch.gather(logits, -1, ids[..., None])[..., 0]
        gold = tp.all_reduce(torch.where(inside, gold,
                                         torch.zeros_like(gold)))
        ctx.save_for_backward(e, total, ids, inside)
        ctx.n_tok = n_tok
        return torch.mean(torch.log(total) + gmax - gold)

    @staticmethod
    def backward(ctx, g):
        e, total, ids, inside = ctx.saved_tensors
        grad = e / total[..., None]
        grad.scatter_add_(-1, ids[..., None],
                          -inside[..., None].to(grad.dtype))
        return grad * (g / ctx.n_tok), None, None


def _local_ids(ids, start: int, n: int):
    """(``ids`` less ``start``, clamped into ``[0, n)``; the mask of those
    that were inside): a rank's view of global ids into its block of
    ``n`` rows from ``start``."""
    local = ids.long() - start
    inside = (local >= 0) & (local < n)
    return local.clamp(0, n - 1), inside


def embed_lookup(table, tokens, tp=None):
    """``table[tokens]``; with ``tp`` the table is the rank's vocab block:
    the rows of the ids inside it, zeros for the others, all-reduced over
    the model axis (``reduce_from``: its backward scatters into the local
    block only)."""
    if tp is None:
        return table[tokens.long()]
    ids, inside = _local_ids(tokens, tp.start(table.shape[0]),
                             table.shape[0])
    rows = torch.where(inside[..., None], table[ids],
                       torch.zeros((), dtype=table.dtype,
                                   device=table.device))
    return tp.reduce(rows)


def last_logits(cfg: ArchConfig, logits, ctx=None):
    """A serve step's logits at the last position, ``(B, vocab)``: on a
    tensor-parallel rank its vocab block of them all-gathered over the
    model axis (one counted all-gather), so every rank holds them whole;
    under FSDP, where each rank serves its rows of the batch, then its
    rows all-gathered over the batch axes (one more), so every rank holds
    the global batch's, as the reference's step returns them. A batch
    that every rank holds whole under FSDP (the batch axes not declared
    local: the serving engine's prefill of one prompt) is not gathered."""
    tp = vocab_split(tensor_parallel(cfg, ctx))
    last = logits[:, -1]
    if tp is not None:
        last = tp.gather(last, dim=-1)
    fs = fsdp_split(cfg, ctx)
    axes = () if fs is None else tuple(a for a in fs.axes
                                       if a in fs.mesh.local)
    return compat.gather_over(last, fs.mesh, axes, dim=0) if axes else last


def _mtp_loss(cfg, params, batch, extras, tp=None, fs=None):
    """DeepSeek MTP (depth 1): predict t+2 from [h_t ; emb(label_t)].
    ``extras``: the forward's (its final hidden state, the table its lookup
    read and its head's leaf). ``tp``: the rank's
    ``models.sharding.TensorParallel``, or None: the lookup, the GQA layer
    and the head run on the rank's blocks as the main stack's do, and the
    cross-entropy is vocab-parallel. ``fs``: the rank's
    ``models.sharding.Fsdp``, or None: the module's leaves are gathered
    under ``Fsdp.regather``; the lookup reads the table that the forward
    gathered, and the head the leaf that the main head gathered, whose
    gather for the backward the two heads share."""
    p = params["mtp"]
    compute_dtype = torch_dtype(cfg.compute_dtype)
    labels = batch["labels"]
    tv = vocab_split(tp)
    with contextlib.nullcontext() if fs is None else fs.regather():
        w = extras["head"]
        if fs is not None:
            head = "embed" if cfg.tie_embeddings else "unembed"
            p = fs.gather(p, fs.specs["mtp"], compute_dtype)
            w = fs.gather_leaf(params[head], fs.specs[head], compute_dtype,
                               gathered=w)
        emb = embed_lookup(extras["table"], labels, tv).to(compute_dtype)
        h = torch.cat([rms_norm(extras["final_hidden"], p["norm_h"],
                                cfg.norm_eps),
                       rms_norm(emb, p["norm_e"], cfg.norm_eps)], dim=-1)
        h = h @ p["proj"].to(compute_dtype)
        b, s = batch["tokens"].shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=h.device)[None, :].expand(b, s)
        h, _ = dense_block(_dense_ffn_cfg(cfg, use_mla=False), p["layer"], h,
                           positions, tp=tp)
        unembed = w.T if cfg.tie_embeddings else w
        logits = (h if tv is None else tv.copy(h)) @ unembed.to(compute_dtype)
        # labels shifted one more step: predict labels[t+1] at position t
        mtp_labels = torch.cat([labels[:, 1:], labels[:, -1:]], dim=1)
        return _ce(logits, mtp_labels, tv)


# ---------------------------------------------------------------------------
# Cache init
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               cache_dtype=torch.bfloat16, device=None, ctx=None):
    """Decode cache tree of zeros on ``device`` (default: the card; raises
    without one), with int32 ``lengths`` (batch,) and, by family:

    - dense, vlm, audio: ``k``/``v`` (n_layers, batch, max_seq, n_kv_heads,
      head_dim); audio also ``memory`` (batch, frontend_seq, frontend_dim),
      the encoder's output;
    - moe: per MoE layer ``k``/``v`` as above, or with MLA ``c_kv``
      (n_moe, batch, max_seq, kv_lora_rank) and ``k_rope`` (n_moe, batch,
      max_seq, qk_rope_head_dim); the leading dense layers' twins under
      ``dense_k`` ... ``dense_k_rope`` (n_dense, ...);
    - ssm: ``conv`` (n_layers, batch, conv_width-1, d_inner) and ``ssm``
      (n_layers, batch, heads, d_qk/heads, d_inner/heads + 1);
    - hybrid: ``conv`` (n_layers, batch, conv_width-1, d_inner + 2N),
      ``ssm`` (n_layers, batch, ssm heads, N, ssm head_dim), and the shared
      block's ``attn_k``/``attn_v`` (n_groups, batch, max_seq, n_kv_heads,
      head_dim).

    ``ssm`` and ``memory`` are float32 whatever ``cache_dtype`` is, as in
    the reference — float64 for a float64 cache, the port's convention.
    ``ctx``: on a tensor-parallel rank (``models.sharding.
    tensor_parallel``) ``k``/``v`` and ``attn_k``/``attn_v`` hold its
    block of the kv heads, ``ssm`` its heads, and ``conv`` its block of
    ``d_inner`` (ssm) or its heads' x channels beside B and C whole
    (hybrid: the reference's spec cuts the contiguous ``d_inner + 2N``,
    ROADMAP Queue C)."""
    check_tensor_parallel(cfg, ctx, cache=True)
    tp = tensor_parallel(cfg, ctx)
    device = resolve_device(device)
    dt = torch_dtype(cache_dtype)
    wide = torch.promote_types(dt, torch.float32)
    c = {"lengths": torch.zeros((batch,), dtype=torch.int32, device=device)}

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    kv_heads = cfg.n_kv_heads // (1 if tp is None else tp.size)
    kv_shape = (max_seq, kv_heads, cfg.resolved_head_dim)
    fam = cfg.family
    if fam in ("dense", "vlm", "audio"):
        for key in ("k", "v"):
            c[key] = zeros((cfg.n_layers, batch) + kv_shape)
        if fam == "audio":
            c["memory"] = zeros((batch, cfg.frontend_seq,
                                 cfg.frontend_dim or cfg.d_model), wide)
        return c
    if fam == "moe":
        n_dense = cfg.moe.n_dense_layers
        if cfg.use_mla:
            shapes = {"c_kv": (max_seq, cfg.mla.kv_lora_rank),
                      "k_rope": (max_seq, cfg.mla.qk_rope_head_dim)}
        else:
            shapes = {"k": kv_shape, "v": kv_shape}
        for key, sh in shapes.items():
            c[key] = zeros((cfg.n_layers - n_dense, batch) + sh)
            if n_dense:
                c["dense_" + key] = zeros((n_dense, batch) + sh)
        return c
    if fam not in ("ssm", "hybrid"):
        raise ValueError(fam)
    init_state = ssm_mod.mlstm_init_state if fam == "ssm" \
        else ssm_mod.mamba2_init_state
    one = init_state(cfg, batch, dtype=dt, device="meta",
                     ranks=1 if tp is None else tp.size)
    for key in ("conv", "ssm"):
        c[key] = zeros((cfg.n_layers,) + tuple(one[key].shape),
                       one[key].dtype)
    if fam == "hybrid":
        n_groups = cfg.n_layers // cfg.attn_every
        for key in ("attn_k", "attn_v"):
            c[key] = zeros((n_groups, batch) + kv_shape)
    return c


def input_specs(cfg: ArchConfig, shape: ShapeConfig, device="meta") -> dict:
    """Stand-ins for every model input of this cell (int32 tokens, float32
    frontend embeddings; for decode, one new token against a cache of the
    cell's length), on ``meta`` by default: the reference's
    ``ShapeDtypeStruct`` tree."""
    b, s = shape.global_batch, shape.seq_len

    def tok(*sh):
        return torch.zeros(sh, dtype=torch.int32, device=device)
    front = {}
    if cfg.frontend_seq:
        front["frontend_emb"] = torch.zeros(
            (b, cfg.frontend_seq, cfg.frontend_dim or cfg.d_model),
            dtype=torch.float32, device=device)
    if shape.kind == "train":
        return {"tokens": tok(b, s), "labels": tok(b, s), **front}
    if shape.kind == "prefill":
        return {"tokens": tok(b, s), **front}
    return {"tokens": tok(b, 1),
            "cache": init_cache(cfg, b, s, device=device), **front}
