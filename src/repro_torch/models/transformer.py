"""Model zoo: template + forward.

Ported families: **dense** (GQA decoder blocks), **ssm** (mLSTM blocks,
xlstm-1.3b) and **hybrid** (Mamba2 layers with one weight-shared
attention+FFN block after every ``attn_every`` of them, zamba2-7b). The
reference's other families (moe, vlm, audio) and MLA attention raise
``NotImplementedError`` naming the ROADMAP item that ports them.

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
(ssm.py): ``forward`` with a cache writes the new KV rows and the new
``conv``/``ssm`` states **into the cache tensors it was given** and returns
them.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch.configs.base import ArchConfig
from repro_torch.core.precision import torch_dtype
from repro_torch.device import resolve_device
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import checkpointed, gqa_attention, \
    gqa_template
from repro_torch.models.layers import P, rms_norm, tree_map, widen
from repro_torch.models.mlp import mlp, mlp_template

_PORTED_FAMILIES = ("dense", "ssm", "hybrid")
_NOT_PORTED_FAMILIES = ("moe", "vlm", "audio")


def _require_ported(cfg: ArchConfig):
    if cfg.family in _PORTED_FAMILIES and not cfg.use_mla:
        return
    if cfg.family not in _PORTED_FAMILIES + _NOT_PORTED_FAMILIES:
        raise ValueError(cfg.family)
    what = "MLA attention" if cfg.family in _PORTED_FAMILIES \
        else f"model family {cfg.family!r}"
    raise NotImplementedError(
        f"{what} ({cfg.name}) is not ported yet: see ROADMAP.md Queue A, "
        f"item A9 'Remaining model families'")


# ---------------------------------------------------------------------------
# Templates
# ---------------------------------------------------------------------------


def _stack(tmpl, n: int):
    """Add a leading stacked-layers dim to every leaf."""
    if isinstance(tmpl, P):
        return P((n,) + tmpl.shape, ("layers",) + tmpl.axes, tmpl.init,
                 tmpl.std)
    return {k: _stack(v, n) for k, v in tmpl.items()}


def _dense_layer_template(cfg: ArchConfig) -> dict:
    return {
        "ln1": P((cfg.d_model,), ("embed",), "ones"),
        "attn": gqa_template(cfg),
        "ln2": P((cfg.d_model,), ("embed",), "ones"),
        "mlp": mlp_template(cfg.d_model, cfg.d_ff, cfg.activation),
    }


def model_template(cfg: ArchConfig) -> dict:
    _require_ported(cfg)
    d = cfg.d_model
    t: dict = {
        "embed": P((cfg.vocab_size, d), ("vocab", "embed"), "normal", 0.02),
        "final_norm": P((d,), ("embed",), "ones"),
    }
    if not cfg.tie_embeddings:
        t["unembed"] = P((d, cfg.vocab_size), ("embed", "vocab"), "normal",
                         0.02)
    if cfg.family == "dense":
        t["layers"] = _stack(_dense_layer_template(cfg), cfg.n_layers)
    elif cfg.family == "ssm":
        layer = {"ln1": P((d,), ("embed",), "ones"),
                 "mix": ssm_mod.mlstm_template(cfg)}
        t["layers"] = _stack(layer, cfg.n_layers)
    else:                                                    # hybrid
        layer = {"ln1": P((d,), ("embed",), "ones"),
                 "mix": ssm_mod.mamba2_template(cfg)}
        t["layers"] = _stack(layer, cfg.n_layers)
        t["shared_attn"] = _dense_layer_template(cfg)
    return t


# ---------------------------------------------------------------------------
# Blocks (forward)
# ---------------------------------------------------------------------------


def dense_block(cfg, p, x, positions, cache=None, causal=True):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    a, new_cache = gqa_attention(cfg, p["attn"], h, positions, cache=cache,
                                 causal=causal)
    if cfg.parallel_block:
        return x + a + mlp(p["mlp"], h, cfg.activation), new_cache
    x = x + a
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + mlp(p["mlp"], h2, cfg.activation)
    return x, new_cache


def mix_layer(cfg, p, x, state=None):
    """ssm/hybrid mixing layer (mamba2 or mlstm)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.ssm.kind == "mamba2":
        y, new_state = ssm_mod.mamba2_block(cfg, p["mix"], h, state)
    else:
        y, new_state = ssm_mod.mlstm_block(cfg, p["mix"], h, state)
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


def forward(cfg: ArchConfig, params: dict, tokens, *,
            cache: Optional[dict] = None, head_fn=None):
    """Shared forward. tokens (B,S) integer, on the parameters' device.

    cache=None  -> full causal forward (training / scoring), returns
                   (logits, aux, extras); with autograd recording, each
                   layer runs under ``cfg.remat``
    cache=dict  -> prefill (lengths=0, S=prompt) or decode (S small);
                   returns (logits, aux, new_cache). Every tensor of the
                   cache but ``lengths`` (``k``/``v``; ``conv``/``ssm``;
                   ``attn_k``/``attn_v``) is updated in place and is the
                   same tensor in ``new_cache``; ``new_cache["lengths"]``
                   is a new tensor, ``cache["lengths"]`` is left as it was.
    head_fn     -> optional ``(x, unembed) -> logits`` replacing the final
                   product — the serving degrade ladder routes the logits
                   head through the CUDA kernels here
                   (``kernels.ops.lm_head``).

    ``aux`` is the (zero) auxiliary loss the mixture-of-experts families
    will fill; it is kept so the return shape matches the reference.
    """
    _require_ported(cfg)
    b, s = tokens.shape
    dev = tokens.device
    compute_dtype = torch_dtype(cfg.compute_dtype)
    x = params["embed"][tokens.long()].to(compute_dtype)

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
        autograd records it."""
        return _maybe_remat(fn, cfg)(x) if remat else fn(x)

    def attn_block(p, x, kv=None):
        """A dense block; ``kv`` = its (k, v) cache tensors, or None."""
        if cache is None:
            return run(lambda x: dense_block(cfg, p, x, positions)[0], x)
        c = {"k": kv[0], "v": kv[1], "lengths": lengths}
        return dense_block(cfg, p, x, positions, cache=c)[0]

    def mix(p, x, i):
        """Mixing layer ``i``; its recurrent state is read from and written
        back into the cache in place."""
        if cache is None:
            return run(lambda x: mix_layer(cfg, p, x)[0], x)
        x, new = mix_layer(cfg, p, x, {"conv": cache["conv"][i],
                                       "ssm": cache["ssm"][i]})
        cache["conv"][i].copy_(new["conv"])
        cache["ssm"][i].copy_(new["ssm"])
        return x

    # one view per layer; unbind's backward stacks the layers' gradients
    # once, where indexing would add a zero-padded copy of the whole stack
    # per layer
    layers = tree_map(lambda a: a.unbind(0), params["layers"])
    for i in range(cfg.n_layers):
        p_i = tree_map(lambda a: a[i], layers)
        if cfg.family == "dense":
            kv = None if cache is None else (cache["k"][i], cache["v"][i])
            x = attn_block(p_i, x, kv)
            continue
        x = mix(p_i, x, i)
        # hybrid: the shared block closes each whole group of attn_every
        # layers; the tail layers after the last group have none
        if cfg.family == "hybrid" and (i + 1) % cfg.attn_every == 0:
            g = i // cfg.attn_every
            kv = None if cache is None \
                else (cache["attn_k"][g], cache["attn_v"][g])
            x = attn_block(params["shared_attn"], x, kv)

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    unembed = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    unembed = unembed.to(compute_dtype)
    if head_fn is not None:
        logits = head_fn(x, unembed)
    else:
        logits = x @ unembed

    if cache is not None:
        new_cache = {k: v for k, v in cache.items() if k != "lengths"}
        new_cache["lengths"] = lengths + s
        return logits, aux, new_cache
    return logits, aux, {"final_hidden": x}


# ---------------------------------------------------------------------------
# Losses / steps-facing API
# ---------------------------------------------------------------------------


def lm_loss(cfg: ArchConfig, params, batch):
    """Next-token CE (+ the MoE aux loss, zero for the dense family).
    batch = {"tokens", "labels"} (B,S) integer tensors on the parameters'
    device. Returns (total, {"ce", "aux"})."""
    logits, aux, _ = forward(cfg, params, batch["tokens"])
    loss = _ce(logits, batch["labels"])
    total = loss + 0.01 * aux
    return total, {"ce": loss, "aux": aux}


def _ce(logits, labels):
    """Mean cross-entropy in fp32 (float64 for float64 logits)."""
    logits = widen(logits)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


# ---------------------------------------------------------------------------
# Cache init
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               cache_dtype=torch.bfloat16, device=None):
    """Decode cache tree of zeros on ``device`` (default: the card; raises
    without one), with int32 ``lengths`` (batch,) and, by family:

    - dense: ``k``/``v`` (n_layers, batch, max_seq, n_kv_heads, head_dim);
    - ssm: ``conv`` (n_layers, batch, conv_width-1, d_inner) and ``ssm``
      (n_layers, batch, heads, d_qk/heads, d_inner/heads + 1);
    - hybrid: ``conv`` (n_layers, batch, conv_width-1, d_inner + 2N),
      ``ssm`` (n_layers, batch, ssm heads, N, ssm head_dim), and the shared
      block's ``attn_k``/``attn_v`` (n_groups, batch, max_seq, n_kv_heads,
      head_dim).

    ``ssm`` is float32 whatever ``cache_dtype`` is, as in the reference —
    float64 for a float64 cache, the port's convention."""
    _require_ported(cfg)
    device = resolve_device(device)
    dt = torch_dtype(cache_dtype)
    c = {"lengths": torch.zeros((batch,), dtype=torch.int32, device=device)}
    kv_shape = (max_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
    if cfg.family == "dense":
        for key in ("k", "v"):
            c[key] = torch.zeros((cfg.n_layers, batch) + kv_shape, dtype=dt,
                                 device=device)
        return c
    init_state = ssm_mod.mlstm_init_state if cfg.family == "ssm" \
        else ssm_mod.mamba2_init_state
    one = init_state(cfg, batch, dtype=dt, device="meta")
    for key in ("conv", "ssm"):
        c[key] = torch.zeros((cfg.n_layers,) + tuple(one[key].shape),
                             dtype=one[key].dtype, device=device)
    if cfg.family == "hybrid":
        n_groups = cfg.n_layers // cfg.attn_every
        for key in ("attn_k", "attn_v"):
            c[key] = torch.zeros((n_groups, batch) + kv_shape, dtype=dt,
                                 device=device)
    return c
