"""The train step.

``make_train_step`` returns a bundle whose ``step_fn(state, batch) ->
(state, metrics)`` is the reference's train step on one device: the loss
and its gradients by autograd (strip-mined over ``grad_accum`` micro-batches
when asked: core/stripmine.py), then AdamW. The metric keys are the
reference's: ``loss``, ``ce``, ``aux``, ``lr``, ``grad_norm``.

The reference's bundle also carries PartitionSpec trees (``state_specs``,
``batch_specs``, ``abstract_state``: ``batch_pspecs``, ``cache_pspecs``,
``named``, ``sanitize_specs``, ``train_state_specs``) for ``jax.jit``'s
shardings. On one card they have no meaning; they wait for the
multi-device machinery (ROADMAP Queue A 13), and this bundle omits them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.core.stripmine import stripmined_grads
from repro_torch.models import transformer as tf
from repro_torch.models.layers import value_and_grad
from repro_torch.optim import adamw


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
    cfg: ArchConfig          # the config the step closes over


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.OptConfig, ctx=None,
                    grad_accum: int = 1,
                    attn: Optional[AttnOverrides] = None) -> TrainStepBundle:
    """state = {"params", "opt"} (trees of tensors on one device), batch =
    {"tokens", "labels"} (B,S) integer tensors on the same device. The
    state's tensors are updated in place (see ``optim.adamw.update``) and
    returned. ``ctx`` (the reference's mesh context) must be None."""
    if ctx is not None:
        raise NotImplementedError(
            "make_train_step runs on one device; a mesh context waits for "
            "the multi-device machinery (ROADMAP Queue A 13)")
    cfg = apply_attn_overrides(cfg, attn)

    def loss_fn(params, batch):
        return tf.lm_loss(cfg, params, batch)

    def train_step(state, batch):
        params = state["params"]
        if grad_accum > 1:
            (loss, metrics), grads = stripmined_grads(
                loss_fn, params, batch, grad_accum)
        else:
            (loss, metrics), grads = value_and_grad(loss_fn)(params, batch)
        new_params, new_opt, opt_metrics = adamw.update(
            opt_cfg, grads, state["opt"], params)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return {"params": new_params, "opt": new_opt}, metrics

    return TrainStepBundle(train_step, cfg)
