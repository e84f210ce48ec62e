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
from repro_torch.core.precision import cast_tree, torch_dtype
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import transformer as tf
from repro_torch.models.layers import tree_leaves
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
def prefill(cfg: ArchConfig, params, tokens, max_seq: int):
    """Batch-1 prefill on a fresh fp32 cache. Returns (next_tok (1,),
    single-sequence cache)."""
    cache = tf.init_cache(cfg, 1, max_seq, cache_dtype=torch.float32,
                          device=tokens.device)
    logits, _, new_cache = tf.forward(cfg, params, tokens, cache=cache)
    next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    return next_tok, new_cache


@torch.inference_mode()
def decode_step(cfg: ArchConfig, mode: str, params, cache, tokens,
                active_mask, temps, nan_mask, generator):
    """One decode step (all slots). ``mode`` picks the degrade rung: fp32
    (the model's configured precision), bf16 compute, or bf16 compute with
    the int8 logits head. ``cache["k"]``/``["v"]`` are written in place.
    Returns (next_tok (slots,), finite (slots,), new_cache)."""
    mcfg = _mode_cfg(cfg, mode)
    head_fn = _int8_head if mode == "int8" else None
    logits, _, new_cache = tf.forward(mcfg, params, tokens, cache=cache,
                                      head_fn=head_fn)
    last = logits[:, -1].float()
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
    new_cache["lengths"] = torch.where(active_mask, new_cache["lengths"],
                                       cache["lengths"])
    return next_tok, finite, new_cache


class ServingEngine:
    """``device`` defaults to the card and raises without one; ``params``
    must already live there (``init_params(..., device=...)`` or
    ``convert.params_from_numpy``). ``seed`` seeds the sampling generator.
    ``timers`` accumulates host-clock ``[calls, seconds]`` per device step
    kind (``decode_<mode>``, ``prefill_<prompt length>``); each such step
    already ends in a device-to-host copy of its tokens, so the clock
    covers the device work and adds no synchronisation."""

    def __init__(self, cfg: ArchConfig, params, *, slots: int = 4,
                 max_seq: int = 512, greedy: bool = True,
                 hardened: bool = True, max_queue: int = 256,
                 max_retries: int = 2, watchdog: int = 8,
                 degrade: Optional[DegradeLadder] = None,
                 scheduler: Optional[Scheduler] = None,
                 device=None, seed: int = 0):
        self.device = resolve_device(device)
        leaf = next(tree_leaves(params))
        if leaf.device.type != self.device.type:
            raise ValueError(f"params live on {leaf.device}, the engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_seq = max_seq
        self.greedy = greedy
        self.hardened = hardened
        self.watchdog = watchdog
        self.degrade = degrade
        self.cache = tf.init_cache(cfg, slots, max_seq,
                                   cache_dtype=torch.float32,
                                   device=self.device)
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
                                   toks, self.max_seq)
        tok = int(next_tok[0])
        self._timed(f"prefill_{len(prompt)}", t0)
        return tok, single

    @staticmethod
    def _batch_dim(key: str) -> int:
        return 0 if key in ("lengths", "memory") else 1

    def _scatter_slot(self, pool: dict, single: dict, slot: int) -> dict:
        """Copy a single-sequence cache into ``slot`` of the pool, in
        place: the whole ``max_seq`` row range, so nothing of the slot's
        previous occupant survives."""
        for k, v in pool.items():
            if self._batch_dim(k) == 0:
                v[slot] = single[k][0].to(v.dtype)
            else:
                v[:, slot] = single[k][:, 0].to(v.dtype)
        return pool

    # -- bookkeeping helpers -------------------------------------------------

    def _event(self, code: str, **detail):
        self.events.append({"tick": self.tick, "code": code, **detail})
        self.counters[code] += 1

    def _set_length(self, slot: int, value: int):
        self.cache["lengths"][slot] = value

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
        lengths = self.cache["lengths"].cpu().numpy()
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
            torch.as_tensor(nan_mask, device=dev), self._generator)
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
