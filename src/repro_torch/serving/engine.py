"""Hardened batched serving engine: continuous batching over a fixed-size
slot pool with admission control, invariant checks, and graceful
degradation.

Prefill fills a slot's KV rows at its own offset (per-sequence ``lengths``
make slots independent); decode advances every active slot one token per
step. The serving analogue of the paper's decoupled dispatch queue
(§III-A: Ara keeps eight instructions in flight; the engine keeps
``slots`` sequences in flight) — and, like Ara's dispatch discipline,
in-flight state is *protected*: every step runs named invariant checks
and every failure has a documented recovery policy (docs/serving.md).

Layering:

- ``serving/scheduler.py`` owns host-side admission (bounded queue,
  structured :class:`RejectReason`), deadlines/TTL, retry-with-backoff and
  the poison-request quarantine.
- This module owns the slot pool, the device steps, the per-step invariant
  checks, and the degrade ladder (configured precision -> bf16 compute ->
  int8 logits head through the CUDA kernel, ``kernels.ops.lm_head``).

The device steps are plain functions under ``torch.inference_mode()``:
PyTorch runs eagerly, there is nothing to trace or cache per config.

Invariant codes (events in ``ServingEngine.events`` / ``counters``):

==================  ======================================================
``I_NAN_LOGITS``    finite-logits guard tripped for a slot (NaN/inf)
``I_KV_BOUNDS``     a slot's KV length left [0, max_seq] or disagrees
                    with the engine's own accounting
``I_KV_CAPACITY``   a slot reached ``max_seq`` with budget remaining
                    (retired EVICTED with partial output — never clamps)
``I_SLOT_LEAK``     a slot is marked busy by a terminal/phantom request,
                    or a free slot carries a nonzero KV length
``I_SLOT_STALL``    per-slot watchdog: no progress for ``watchdog`` ticks
==================  ======================================================

``hardened=False`` reproduces the legacy engine (no admission checks, no
invariants, no eviction — the clamped KV write of
``models.attention.update_cache`` then overwrites the last KV row on
overflow).

What differs from the reference, and changes no result:

- The KV pool is updated **in place** (the reference's arrays are
  immutable). As there, a decode step writes a KV row at ``lengths[slot]``
  for *every* slot, active or not; an inactive slot's length does not
  advance, and the next prefill into that slot overwrites the whole row
  range (``_scatter_slot`` copies all ``max_seq`` rows).
- Weights are cast to the compute dtype at use. So that a decode step
  does not re-cast 1.1 B parameters, the engine keeps **one copy of the
  parameter tree per compute dtype**, made at first use.
- Sampling draws Gumbel noise from the engine's own ``torch.Generator``;
  the bits differ from the reference's, greedy decoding does not.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Set

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import compat
from repro_torch.core.precision import cast_tree, torch_dtype
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import transformer as tf
from repro_torch.models.layers import tree_leaves
from repro_torch.models.sharding import (MeshCtx, check_fsdp, fsdp_split,
                                         serve_ctx)
from repro_torch.serving.scheduler import (Request, RejectReason, Scheduler,
                                           State)

__all__ = ["Request", "RejectReason", "Scheduler", "State",
           "ServingEngine", "DegradeLadder"]


@dataclasses.dataclass(frozen=True)
class DegradeLadder:
    """Pressure -> decode-mode policy (graceful degradation under load).

    ``pressure = (queued + active) / slots``. Below ``bf16_at`` decode
    runs at the model's configured precision; at or above it the decode
    step switches to bfloat16 compute (fp32 accumulation); at or above
    ``int8_at`` the logits head additionally runs through the int8 CUDA
    kernel (``kernels.ops.lm_head`` -> ``matmul_int8``, dynamic symmetric
    quantization). Throughput-for-accuracy shedding, recorded per step in
    ``ServingEngine.counters['degraded_steps']``.
    """
    bf16_at: float = 2.0
    int8_at: float = float("inf")

    def mode_for(self, pressure: float) -> str:
        if pressure >= self.int8_at:
            return "int8"
        if pressure >= self.bf16_at:
            return "bf16"
        return "fp32"


def _mode_cfg(cfg: ArchConfig, mode: str) -> ArchConfig:
    """``fp32`` is the model's *configured* precision (bfloat16 compute at
    full width, float32 for ``reduced()`` configs)."""
    if mode == "fp32":
        return cfg
    return dataclasses.replace(cfg, compute_dtype="bfloat16")


def _int8_head(x, unembed):
    return kernel_ops.lm_head(x, unembed, compute_dtype="int8")


@torch.inference_mode()
def prefill(cfg: ArchConfig, params, tokens, max_seq: int,
            ctx: Optional[MeshCtx] = None):
    """Batch-1 prefill on a fresh fp32 cache. Returns (next_tok (1,),
    single-sequence cache). Under FSDP over processes the batch axes of
    ``ctx`` are not local: every rank runs the same forward of the one
    prompt, joining each gather, and a MoE model's dispatch group is the
    prompt alone, as on one device."""
    cache = tf.init_cache(cfg, 1, max_seq, cache_dtype=torch.float32,
                          device=tokens.device, ctx=ctx)
    logits, _, new_cache = tf.forward(cfg, params, tokens, ctx=ctx,
                                      cache=cache)
    next_tok = torch.argmax(tf.last_logits(cfg, logits, ctx), dim=-1).to(
        torch.int32)
    return next_tok, new_cache


@torch.inference_mode()
def decode_step(cfg: ArchConfig, mode: str, params, cache, tokens,
                active_mask, temps, nan_mask, generator,
                ctx: Optional[MeshCtx] = None, rows: slice = slice(None)):
    """One decode step (all slots). ``mode`` picks the degrade rung: fp32
    (the model's configured precision), bf16 compute, or bf16 compute with
    the int8 logits head. Every tensor of the cache but ``lengths`` (KV
    rows, MLA's compressed rows, recurrent states, by family) is written
    in place. Returns (next_tok (slots,), finite (slots,), new_cache).
    The mixture-of-experts families route every slot, inactive ones too,
    so that they take expert capacity as in the reference. With a mesh
    context this is the reference's mesh decode (``_build_mesh_decode``),
    which takes the rung's compute dtype but no int8 head; on a
    tensor-parallel mesh of processes each rank decodes with its blocks of
    the weights and of the cache's kv heads, and samples from the logits
    gathered whole (``models.transformer.last_logits``). Under FSDP over
    processes ``cache`` holds the rank's ``rows`` of the slots (``ctx``
    with the batch axes local, ``models.sharding.serve_ctx``): the rank
    decodes those rows, the logits of every slot are gathered to every
    rank, which samples them all as one device does, and only its rows of
    ``lengths`` are masked. ``tokens`` and the masks are every slot's."""
    mcfg = _mode_cfg(cfg, mode)
    mesh = ctx is not None and ctx.mesh is not None
    head_fn = _int8_head if mode == "int8" and not mesh else None
    logits, _, new_cache = tf.forward(mcfg, params, tokens[rows], ctx=ctx,
                                      cache=cache, head_fn=head_fn)
    last = tf.last_logits(cfg, logits, ctx).float()
    # fault-injection port (the mask is all-False in normal operation)
    last = torch.where(nan_mask[:, None],
                       torch.full_like(last, float("nan")), last)
    finite = torch.isfinite(last).all(dim=-1)
    greedy = torch.argmax(last, dim=-1).to(torch.int32)
    # categorical sampling as Gumbel-argmax under the engine's generator
    scaled = last / temps.clamp_min(1e-6)[:, None]
    u = torch.rand(last.shape, generator=generator, dtype=torch.float32,
                   device=last.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    sampled = torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)
    next_tok = torch.where(temps > 0, sampled, greedy)
    # inactive slots must not advance their lengths
    new_cache["lengths"] = torch.where(active_mask[rows],
                                       new_cache["lengths"], cache["lengths"])
    return next_tok, finite, new_cache


class ServingEngine:
    """``device`` defaults to the card and raises without one; ``params``
    must already live there (``init_params(..., device=...)`` or
    ``convert.params_from_numpy``). ``seed`` seeds the sampling generator.
    ``timers`` accumulates host-clock ``[calls, seconds]`` per device step
    kind (``decode_<mode>``, ``prefill_<prompt length>``); each such step
    already ends in a device-to-host copy of its tokens, so the clock
    covers the device work and adds no synchronisation. ``ctx``: the
    reference's mesh context (``models.sharding.MeshCtx``; the mesh held
    as tensor dimensions on ``device``, or a mesh of processes), passed to
    every prefill and decode step. On a process mesh whose model axis is
    above 1, ``params`` are the rank's blocks (``models.sharding.
    shard_params``), the KV pool holds its kv heads (an SSM or hybrid
    model's pool its heads' states), and every rank runs
    the same scheduler on the same requests: each emits the same tokens
    (the same generator seed draws the same noise). Under FSDP over a
    process mesh (``cfg.fsdp`` with batch axes above 1; every family that
    serves on one device, the SSM and hybrid families where the model
    axis is 1, ``models.sharding.check_fsdp``) ``params`` are the rank's
    blocks as well, and every rank is again given the same requests and
    runs the same scheduler; each data rank holds its block of
    ``slots / d`` rows of the KV pool (global slot ``s`` on data rank
    ``s // (slots / d)``, :meth:`_home`), so ``slots`` must be a multiple
    of the data extent ``d`` (``ValueError``). A decode step runs each
    rank's rows, the weights gathered a layer at a time; a prefill runs
    the one prompt on every rank (each joins every gather), and its owner
    keeps the cache row. Nothing is gathered whole: between steps a rank
    holds its blocks alone."""

    def __init__(self, cfg: ArchConfig, params, *, slots: int = 4,
                 max_seq: int = 512, ctx: Optional[MeshCtx] = None,
                 greedy: bool = True,
                 hardened: bool = True, max_queue: int = 256,
                 max_retries: int = 2, watchdog: int = 8,
                 degrade: Optional[DegradeLadder] = None,
                 scheduler: Optional[Scheduler] = None,
                 device=None, seed: int = 0):
        check_fsdp(cfg, ctx)
        self.device = resolve_device(device)
        leaf = next(tree_leaves(params))
        if leaf.device.type != self.device.type:
            raise ValueError(f"params live on {leaf.device}, the engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_seq = max_seq
        self.ctx = ctx or MeshCtx(mesh=None)
        self.greedy = greedy
        self.hardened = hardened
        self.watchdog = watchdog
        self.degrade = degrade
        # FSDP over processes: each data rank's block of the pool, decoded
        # with the batch axes local; the prefill's ctx keeps them global
        self._fs = fsdp_split(cfg, self.ctx)
        self._step_ctx = serve_ctx(cfg, self.ctx)
        self._prefill_ctx = self.ctx
        d = 1 if self._fs is None else self._fs.size
        if slots % d:
            raise ValueError(
                f"{cfg.name} under FSDP over {d} data ranks: {slots} slots "
                f"do not split; the slots must be a multiple of the data "
                f"extent (each data rank holds slots / {d} rows of the "
                f"pool)")
        self._rows = slots // d
        self._data_rank = 0 if self._fs is None else \
            self._fs.mesh.block(self._fs.axes)
        first = self._data_rank * self._rows
        self._mine = slice(first, first + self._rows)
        self.cache = tf.init_cache(cfg, self._rows, max_seq,
                                   cache_dtype=torch.float32,
                                   device=self.device, ctx=self._step_ctx)
        self.active: Dict[int, Request] = {}     # slot -> request
        self.sched = scheduler or Scheduler(
            slots=slots, max_seq=max_seq, max_queue=max_queue,
            max_retries=max_retries)
        self.tick = 0
        self.events: List[dict] = []             # named detections
        self.counters = self.sched.counters      # one shared counter set
        self.finished: List[Request] = []        # all terminal requests
        self.timers: Dict[str, List[float]] = {}
        # fault-injection surface
        self.fault_hooks: List[Callable[["ServingEngine"], None]] = []
        self._inject_nan_slots: Set[int] = set()
        self._suppress_slots: Set[int] = set()
        # per-slot host accounting (the invariant checks' ground truth)
        self._slot_len: Dict[int, int] = {}
        self._slot_progress: Dict[int, int] = {}
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        self._params_by_dtype: Dict[torch.dtype, dict] = {}

    # -- legacy-compatible queue view ---------------------------------------

    @property
    def queue(self):
        return self.sched.queue

    # -- device steps ---------------------------------------------------------

    def _params_for(self, cfg: ArchConfig) -> dict:
        """The parameter tree at ``cfg``'s compute dtype (cached copy)."""
        dt = torch_dtype(cfg.compute_dtype)
        tree = self._params_by_dtype.get(dt)
        if tree is None:
            tree = self._params_by_dtype[dt] = cast_tree(self.params, dt)
        return tree

    def _timed(self, key: str, t0: float):
        rec = self.timers.setdefault(key, [0, 0.0])
        rec[0] += 1
        rec[1] += time.perf_counter() - t0

    def _prefill_one(self, prompt: np.ndarray) -> tuple:
        t0 = time.perf_counter()
        toks = torch.as_tensor(np.asarray(prompt, np.int32),
                               device=self.device)[None, :]
        next_tok, single = prefill(self.cfg, self._params_for(self.cfg),
                                   toks, self.max_seq, self._prefill_ctx)
        tok = int(next_tok[0])
        self._timed(f"prefill_{len(prompt)}", t0)
        return tok, single

    @staticmethod
    def _batch_dim(key: str) -> int:
        return 0 if key in ("lengths", "memory") else 1

    def _home(self, slot: int) -> tuple:
        """(data rank, row) of global ``slot``: the data rank whose block of
        the pool holds it, and its row there (0 and ``slot`` off FSDP)."""
        return divmod(slot, self._rows)

    def _row(self, slot: int) -> Optional[int]:
        """``slot``'s row in this rank's block of the pool, or None where
        another data rank holds it."""
        owner, row = self._home(slot)
        return row if owner == self._data_rank else None

    def _scatter_slot(self, pool: dict, single: dict, slot: int) -> dict:
        """Copy a single-sequence cache into ``slot`` of the pool, in
        place: the whole ``max_seq`` row range, so nothing of the slot's
        previous occupant survives. Under FSDP only the slot's data rank
        keeps it; the others drop theirs."""
        row = self._row(slot)
        if row is None:
            return pool
        for k, v in pool.items():
            if self._batch_dim(k) == 0:
                v[row] = single[k][0].to(v.dtype)
            else:
                v[:, row] = single[k][:, 0].to(v.dtype)
        return pool

    # -- bookkeeping helpers -------------------------------------------------

    def _event(self, code: str, **detail):
        self.events.append({"tick": self.tick, "code": code, **detail})
        self.counters[code] += 1

    def _set_length(self, slot: int, value: int):
        row = self._row(slot)
        if row is not None:
            self.cache["lengths"][row] = value

    def _lengths(self) -> np.ndarray:
        """Every slot's KV length on the host (under FSDP each data rank's
        rows all-gathered: every rank audits every slot)."""
        lengths = self.cache["lengths"]
        if self._fs is not None:
            lengths = compat.gather_over(lengths, self._fs.mesh,
                                         self._fs.axes, dim=0)
        # a snapshot, as the reference's: ``_free_slot`` writes the pool in
        # place, and on a CPU tensor ``.numpy()`` would share its memory
        return lengths.cpu().numpy().copy()

    def _free_slot(self, slot: int):
        self.active.pop(slot, None)
        self._slot_len.pop(slot, None)
        self._slot_progress.pop(slot, None)
        self._set_length(slot, 0)

    def _finish(self, slot: Optional[int], req: Request, state: State,
                reason: str, finished: List[Request]):
        req.finish(state, self.tick, reason)
        if slot is not None:
            self._free_slot(slot)
        finished.append(req)
        self.finished.append(req)

    def _retry_or_quarantine(self, slot: int, req: Request, cause: str,
                             finished: List[Request]):
        """Recovery policy for transient step failures: evict the slot,
        requeue with backoff; quarantine after max_retries."""
        self._free_slot(slot)
        if not self.sched.requeue(req, self.tick, cause):
            finished.append(req)
            self.finished.append(req)

    # -- invariant checks ----------------------------------------------------

    def _audit_slots(self, finished: List[Request]):
        """Host-side slot/KV consistency: the I_SLOT_LEAK and I_KV_BOUNDS
        detectors. Runs before admission so reclaimed capacity is reusable
        in the same step."""
        lengths = self._lengths()
        for slot in list(self.active):
            req = self.active[slot]
            if req is None or req.state.terminal():
                self._event("I_SLOT_LEAK", slot=slot,
                            detail="terminal/phantom request holds a slot")
                self._free_slot(slot)
                continue
            expect = self._slot_len.get(slot)
            actual = int(lengths[slot])
            if expect is None or actual != expect \
                    or not (0 <= actual <= self.max_seq):
                self._event("I_KV_BOUNDS", slot=slot, uid=req.uid,
                            expected=expect, actual=actual)
                self._retry_or_quarantine(slot, req, "kv-bounds", finished)
        for slot in range(self.slots):
            if slot not in self.active and int(lengths[slot]) != 0:
                self._event("I_SLOT_LEAK", slot=slot,
                            detail="free slot with nonzero KV length")
                self._set_length(slot, 0)

    # -- host scheduling -----------------------------------------------------

    def submit(self, req: Request) -> Optional[RejectReason]:
        """Admit to the bounded queue; returns the structured reject
        reason (also recorded on ``req``) or None on acceptance. The
        legacy engine (``hardened=False``) accepts everything."""
        if not self.hardened:
            req.submit_tick = self.tick
            self.sched.queue.append(req)
            return None
        return self.sched.submit(req, self.tick)

    def _admit(self, finished: List[Request]):
        for slot in range(self.slots):
            if slot in self.active:
                continue
            req = self.sched.next_ready(self.tick) if self.hardened else (
                self.sched.queue.popleft() if self.sched.queue else None)
            if req is None:
                return
            plen = len(req.prompt)
            if self.hardened and plen > self.max_seq:
                # defense in depth: submit() already rejects this
                self._finish(None, req, State.REJECTED,
                             RejectReason.PROMPT_TOO_LONG.value, finished)
                continue
            req.state = State.PREFILL
            tok, single = self._prefill_one(req.prompt)
            self.cache = self._scatter_slot(self.cache, single, slot)
            req.out_tokens.append(tok)
            req.first_token_tick = self.tick
            self._slot_len[slot] = plen
            self._slot_progress[slot] = self.tick
            self.active[slot] = req
            req.state = State.DECODE
            # budget of 1 / instant eos: done without holding the slot
            if tok == req.eos_id or len(req.out_tokens) >= req.max_new_tokens:
                self._finish(slot, req, State.DONE, "", finished)
            elif self.hardened and plen >= self.max_seq:
                self._event("I_KV_CAPACITY", slot=slot, uid=req.uid,
                            length=plen)
                self._finish(slot, req, State.EVICTED, "I_KV_CAPACITY",
                             finished)

    def _pick_mode(self) -> str:
        if self.degrade is None:
            return "fp32"
        mode = self.degrade.mode_for(self.sched.pressure(len(self.active)))
        if mode != "fp32":
            self.counters["degraded_steps"] += 1
            self.counters[f"degraded_steps_{mode}"] += 1
        return mode

    def _decode_step(self, finished: List[Request]):
        tokens = np.zeros((self.slots, 1), np.int32)
        mask = np.zeros((self.slots,), bool)
        temps = np.zeros((self.slots,), np.float32)
        nan_mask = np.zeros((self.slots,), bool)
        for slot, req in self.active.items():
            tokens[slot, 0] = req.out_tokens[-1] if req.out_tokens else 0
            mask[slot] = slot not in self._suppress_slots
            temps[slot] = req.temperature
            nan_mask[slot] = slot in self._inject_nan_slots
        self._inject_nan_slots.clear()

        mode = self._pick_mode()
        t0 = time.perf_counter()
        dev = self.device
        next_tok, finite, self.cache = decode_step(
            self.cfg, mode, self._params_for(_mode_cfg(self.cfg, mode)),
            self.cache, torch.as_tensor(tokens, device=dev),
            torch.as_tensor(mask, device=dev),
            torch.as_tensor(temps, device=dev),
            torch.as_tensor(nan_mask, device=dev), self._generator,
            self._step_ctx, self._mine)
        next_tok = next_tok.cpu().numpy()
        finite = finite.cpu().numpy()
        self._timed(f"decode_{mode}", t0)

        for slot, req in list(self.active.items()):
            if not mask[slot]:
                pass                      # suppressed: no progress made
            elif self.hardened and not finite[slot]:
                self._event("I_NAN_LOGITS", slot=slot, uid=req.uid)
                self._retry_or_quarantine(slot, req, "nan-logits", finished)
                continue
            else:
                tok = int(next_tok[slot])
                req.out_tokens.append(tok)
                self._slot_len[slot] += 1
                self._slot_progress[slot] = self.tick
                if tok == req.eos_id \
                        or len(req.out_tokens) >= req.max_new_tokens:
                    self._finish(slot, req, State.DONE, "", finished)
                    continue
                dl = req.deadline_tick() if self.hardened else None
                if dl is not None and self.tick >= dl:
                    self._finish(slot, req, State.TIMED_OUT,
                                 "T_DEADLINE_EXPIRED", finished)
                    self.counters["T_DEADLINE_EXPIRED"] += 1
                    continue
                if self.hardened and self._slot_len[slot] >= self.max_seq:
                    self._event("I_KV_CAPACITY", slot=slot, uid=req.uid,
                                length=self._slot_len[slot])
                    self._finish(slot, req, State.EVICTED, "I_KV_CAPACITY",
                                 finished)
                    continue
            if self.hardened and slot in self.active and \
                    self.tick - self._slot_progress[slot] >= self.watchdog:
                self._event("I_SLOT_STALL", slot=slot, uid=req.uid,
                            stalled=self.tick - self._slot_progress[slot])
                self._retry_or_quarantine(slot, req, "slot-stall", finished)

    @torch.inference_mode()
    def step(self) -> List[Request]:
        """One engine step: run fault hooks, maintain the queue (deadline
        sheds), audit slot invariants, admit, decode one token for every
        active slot, retire. Returns requests that reached a terminal
        state this step (DONE / EVICTED / TIMED_OUT / FAILED). The whole
        step runs under ``torch.inference_mode()``: the device steps make
        inference tensors, and the bookkeeping writes into them in place."""
        self.tick += 1
        for hook in list(self.fault_hooks):
            hook(self)
        finished: List[Request] = []
        if self.hardened:
            for req in self.sched.tick(self.tick):
                finished.append(req)
                self.finished.append(req)
            self._audit_slots(finished)
        self._admit(finished)
        if self.active:
            self._decode_step(finished)
        return finished

    def run_to_completion(self, max_steps: int = 1000) -> List[Request]:
        done = []
        for _ in range(max_steps):
            done += self.step()
            if not self.active and not self.sched.queue:
                break
        return done

    def stats(self) -> dict:
        states = {}
        for r in self.finished:
            states[r.state.value] = states.get(r.state.value, 0) + 1
        return {"tick": self.tick, "active": len(self.active),
                "finished_states": states, "events": len(self.events),
                **self.sched.stats()}
