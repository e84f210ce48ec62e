"""Model zoo: template + forward.

Only the **dense** family (GQA decoder blocks) is ported so far; the other
families of the reference (moe, ssm, hybrid, vlm, audio) raise
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
blockwise-attention kernel when ``cfg.attn_flash`` allows.

Decode uses per-sequence KV caches (see attention.py): ``forward`` with a
cache writes the new KV rows **into the cache tensors it was given** and
returns them.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch.configs.base import ArchConfig
from repro_torch.core.precision import torch_dtype
from repro_torch.device import resolve_device
from repro_torch.models.attention import checkpointed, gqa_attention, \
    gqa_template
from repro_torch.models.layers import P, rms_norm, tree_map, widen
from repro_torch.models.mlp import mlp, mlp_template

# where each family that is not ported yet stands in ROADMAP.md
_FAMILY_ROADMAP = {
    "moe": "Queue A, 'Remaining model families'",
    "vlm": "Queue A, 'Remaining model families'",
    "audio": "Queue A, 'Remaining model families'",
    "ssm": "Queue A, 'SSM family'",
    "hybrid": "Queue A, 'SSM family'",
}


def _require_dense(cfg: ArchConfig):
    if cfg.family == "dense" and not cfg.use_mla:
        return
    if cfg.family != "dense" and cfg.family not in _FAMILY_ROADMAP:
        raise ValueError(cfg.family)
    where = _FAMILY_ROADMAP.get(cfg.family,
                                "Queue A, 'Remaining model families'")
    raise NotImplementedError(
        f"model family {cfg.family!r} ({cfg.name}) is not ported yet: see "
        f"ROADMAP.md {where}")


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
    _require_dense(cfg)
    d = cfg.d_model
    t: dict = {
        "embed": P((cfg.vocab_size, d), ("vocab", "embed"), "normal", 0.02),
        "final_norm": P((d,), ("embed",), "ones"),
    }
    if not cfg.tie_embeddings:
        t["unembed"] = P((d, cfg.vocab_size), ("embed", "vocab"), "normal",
                         0.02)
    t["layers"] = _stack(_dense_layer_template(cfg), cfg.n_layers)
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
                   returns (logits, aux, new_cache). ``cache["k"]`` and
                   ``cache["v"]`` are updated in place and are the tensors
                   in ``new_cache``; ``new_cache["lengths"]`` is a new
                   tensor, ``cache["lengths"]`` is left as it was.
    head_fn     -> optional ``(x, unembed) -> logits`` replacing the final
                   product — the serving degrade ladder routes the logits
                   head through the CUDA kernels here
                   (``kernels.ops.lm_head``).

    ``aux`` is the (zero) auxiliary loss the mixture-of-experts families
    will fill; it is kept so the return shape matches the reference.
    """
    _require_dense(cfg)
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
    # one view per layer; unbind's backward stacks the layers' gradients
    # once, where indexing would add a zero-padded copy of the whole stack
    # per layer
    layers = tree_map(lambda a: a.unbind(0), params["layers"])
    remat = cache is None and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        p_i = tree_map(lambda a: a[i], layers)
        if cache is None:
            def layer(x, p_i=p_i):
                return dense_block(cfg, p_i, x, positions)[0]
            x = _maybe_remat(layer, cfg)(x) if remat else layer(x)
            continue
        c_i = {"k": cache["k"][i], "v": cache["v"][i], "lengths": lengths}
        x, _ = dense_block(cfg, p_i, x, positions, cache=c_i)

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    unembed = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    unembed = unembed.to(compute_dtype)
    if head_fn is not None:
        logits = head_fn(x, unembed)
    else:
        logits = x @ unembed

    if cache is not None:
        return logits, aux, {"k": cache["k"], "v": cache["v"],
                             "lengths": lengths + s}
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
    without one): ``k``/``v`` (n_layers, batch, max_seq, n_kv_heads,
    head_dim) and int32 ``lengths`` (batch,)."""
    _require_dense(cfg)
    device = resolve_device(device)
    dt = torch_dtype(cache_dtype)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"lengths": torch.zeros((batch,), dtype=torch.int32,
                                   device=device),
            "k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}
