"""Serving fault injection: the runtime half of the serving cross-audit.

The idiom is ``testing/faults.py``'s, lifted from programs to requests:
every fault class in :data:`REGISTRY` must BOTH

- be **detected** by a named signal — an engine invariant code
  (``I_NAN_LOGITS``, ``I_KV_BOUNDS``, ``I_KV_CAPACITY``, ``I_SLOT_LEAK``,
  ``I_SLOT_STALL``), a structured admission reject
  (:class:`~repro_torch.serving.scheduler.RejectReason`), or a scheduler
  shed code (``T_DEADLINE_*``) — and
- be **recovered** from per its documented policy (reject / shed /
  evict-partial / evict-requeue / reclaim / quarantine), with surviving
  requests still matching the full-forward greedy oracle bit-exactly.

:func:`verify` additionally runs every scenario against the *legacy*
engine (``hardened=False``, the pre-scheduler code path) and requires
observable damage — divergence from the oracle, a KV length past
``max_seq``, unbounded queue growth, a wedged slot, or a crash. A
detector whose fault class does no damage would be vacuous; silent
corruption or undetected degradation is a test failure in either
direction. ``tests/test_torch_serving_faults.py`` and
``benchmarks/torch_serving_load.py`` (the escape gate) both consume this
registry.

The registry's names, codes, policies, damage strings, scenarios and the
:func:`verify` / :func:`verify_all` contract are the reference's
(``repro.serving.faults``), line for line. What the port changes:

- The hooks write the engine's KV pool **in place** (the engine updates
  it in place; see ``serving/engine.py``).
- The default fixture is reduced tinyllama-1.1b drawn by the port's own
  ``init_params`` from a ``torch.Generator`` seeded 0, on the card unless
  asked otherwise (:func:`default_fixture`). The oracle is greedy decode
  by repeated full forward through the port's ``models.transformer.
  forward``; on the card that forward runs its attention through the
  ``flash_fwd`` kernel.
- :func:`use_fixture` is the one addition to the reference's API: it
  installs another ``(cfg, params)`` (the card's full-width model, or the
  reference's converted parameters) and clears the oracle's cache, which
  is keyed by the prompt alone. Engines and the oracle run on the device
  that holds ``params``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.layers import tree_leaves
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.scheduler import (Q_QUARANTINED, Request,
                                           RejectReason, State, T_EXPIRED,
                                           T_INFEASIBLE)

MAX_SEQ = 32


# ---------------------------------------------------------------------------
# Shared fixture (one tiny model for every scenario)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=2)
def default_fixture(device=None) -> Tuple[object, dict]:
    """Reduced tinyllama-1.1b, parameters from the port's ``init_params``
    and a ``torch.Generator`` seeded 0 on ``device`` (default: the card;
    raises without one)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.device import resolve_device
    from repro_torch.models.layers import init_params
    from repro_torch.models.transformer import model_template
    dev = resolve_device(device)
    cfg = reduced(get_config("tinyllama-1.1b"))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(model_template(cfg), gen, device=dev)
    return cfg, params


_installed: list = []        # the (cfg, params) set by use_fixture, if any


def use_fixture(cfg, params) -> None:
    """Run every scenario and the oracle on ``(cfg, params)`` from here on,
    on the device that holds ``params``. Clears the oracle's cache: it is
    keyed by the prompt, and another model's tokens would be stale."""
    _installed[:] = [(cfg, params)]
    _oracle_cached.cache_clear()


def fixture() -> Tuple[object, dict]:
    """The installed fixture, else :func:`default_fixture` on the card."""
    return _installed[0] if _installed else default_fixture()


def _device():
    return next(tree_leaves(fixture()[1])).device


def prompt(seed: int, n: int) -> np.ndarray:
    cfg, _ = fixture()
    rng = np.random.RandomState(seed)
    return rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)


@functools.lru_cache(maxsize=64)
def _oracle_cached(prompt_key: Tuple[int, ...], n: int) -> Tuple[int, ...]:
    from repro_torch.models.transformer import forward
    cfg, params = fixture()
    toks = list(prompt_key)
    with torch.inference_mode():
        for _ in range(n):
            lg, _, _ = forward(cfg, params, torch.tensor(
                [toks], dtype=torch.int32, device=_device()))
            toks.append(int(torch.argmax(lg[0, -1])))
    return tuple(toks[len(prompt_key):])


def oracle(p: np.ndarray, n: int) -> List[int]:
    """Greedy continuation by repeated full forward (no KV cache)."""
    return list(_oracle_cached(tuple(int(t) for t in p), n))


def make_engine(hardened: bool = True, **kw) -> ServingEngine:
    cfg, params = fixture()
    kw.setdefault("slots", 2)
    kw.setdefault("max_seq", MAX_SEQ)
    return ServingEngine(cfg, params, hardened=hardened, device=_device(),
                         **kw)


def slot_of(eng: ServingEngine, uid: int) -> Optional[int]:
    for s, r in eng.active.items():
        if r is not None and r.uid == uid:
            return s
    return None


def _codes(eng: ServingEngine) -> List[str]:
    return [e["code"] for e in eng.events]


def _matches_oracle(req: Request) -> bool:
    return req.out_tokens == oracle(req.prompt, len(req.out_tokens)) \
        and len(req.out_tokens) > 0


# ---------------------------------------------------------------------------
# Injection hooks (the engine's fault surface). They run inside
# ``ServingEngine.step`` (under ``torch.inference_mode()``) and write the
# engine's tensors in place.
# ---------------------------------------------------------------------------


def corrupt_kv_once(uid: int, at_tick: int):
    """NaN a cached KV row (row 1, all layers/heads) of uid's slot."""
    def hook(eng: ServingEngine):
        if eng.tick == at_tick:
            s = slot_of(eng, uid)
            if s is not None:
                eng.cache["k"][:, s, 1] = float("nan")
    return hook


def nan_logits_once(uid: int, at_tick: int):
    def hook(eng: ServingEngine):
        if eng.tick == at_tick:
            s = slot_of(eng, uid)
            if s is not None:
                eng._inject_nan_slots.add(s)
    return hook


def nan_logits_always(uid: int):
    """The poison request: every decode of uid produces NaN logits."""
    def hook(eng: ServingEngine):
        s = slot_of(eng, uid)
        if s is not None:
            eng._inject_nan_slots.add(s)
    return hook


def corrupt_length_once(uid: int, at_tick: int, value: int):
    def hook(eng: ServingEngine):
        if eng.tick == at_tick:
            s = slot_of(eng, uid)
            if s is not None:
                eng.cache["lengths"][s] = value
    return hook


def leak_slot_once(slot: int, at_tick: int):
    """A phantom terminal request holds a slot (a forgotten free)."""
    def hook(eng: ServingEngine):
        if eng.tick == at_tick and slot not in eng.active:
            ghost = Request(uid=-99, prompt=np.zeros(1, np.int32),
                            max_new_tokens=10 ** 9, out_tokens=[0])
            ghost.state = State.DONE
            ghost.done = True
            eng.active[slot] = ghost
            eng._slot_len[slot] = 1
            eng._slot_progress[slot] = eng.tick
    return hook


def suppress_always(uid: int):
    """uid's slot never makes progress (a stuck device stream)."""
    def hook(eng: ServingEngine):
        eng._suppress_slots.clear()
        s = slot_of(eng, uid)
        if s is not None:
            eng._suppress_slots.add(s)
    return hook


# ---------------------------------------------------------------------------
# Scenarios — each returns raw observations for verify() to judge
# ---------------------------------------------------------------------------


def _prompt_too_long(hardened: bool) -> dict:
    eng = make_engine(hardened)
    good = Request(uid=0, prompt=prompt(0, 4), max_new_tokens=4)
    bad = Request(uid=1, prompt=prompt(1, MAX_SEQ + 4), max_new_tokens=4)
    eng.submit(good)
    reason = eng.submit(bad)
    if not hardened:
        try:
            eng.run_to_completion(50)
        except Exception:
            return {"damage": True, "detail": "prefill crash on long prompt"}
        return {"damage": False, "detail": "long prompt tolerated"}
    eng.run_to_completion(50)
    return {
        "detected": reason is RejectReason.PROMPT_TOO_LONG
        and bad.state == State.REJECTED,
        "recovered": good.state == State.DONE and _matches_oracle(good)
        and len(eng.sched.queue) == 0,
        "detail": {"reason": getattr(reason, "value", None),
                   "good": good.state.value},
    }


def _decode_overflow(hardened: bool) -> dict:
    max_seq = 16
    eng = make_engine(hardened, max_seq=max_seq)
    # plen 6 + budget 16 > max_seq: capacity allows 1 + (16 - 6) = 11 tokens
    over = Request(uid=0, prompt=prompt(2, 6), max_new_tokens=16)
    good = Request(uid=1, prompt=prompt(3, 4), max_new_tokens=5)
    eng.submit(over)
    eng.submit(good)
    eng.run_to_completion(60)
    lengths_max = int(eng.cache["lengths"].cpu().numpy().max())
    if not hardened:
        seen = int(max(eng._slot_len.get(s, 0) for s in range(eng.slots))) \
            if eng._slot_len else 0
        overran = max(lengths_max, seen,
                      len(over.prompt) + len(over.out_tokens) - 1)
        diverged = over.out_tokens != oracle(over.prompt,
                                             len(over.out_tokens))
        return {"damage": overran > max_seq and diverged,
                "detail": {"kv_len": overran, "diverged": diverged}}
    want = 1 + (max_seq - len(over.prompt))
    return {
        "detected": "I_KV_CAPACITY" in _codes(eng),
        "recovered": over.state == State.EVICTED
        and over.finish_reason == "I_KV_CAPACITY"
        and len(over.out_tokens) == want and _matches_oracle(over)
        and good.state == State.DONE and _matches_oracle(good)
        and lengths_max == 0,
        "detail": {"over": over.state.value, "n_out": len(over.out_tokens),
                   "want": want},
    }


def _kv_corrupt(hardened: bool) -> dict:
    eng = make_engine(hardened)
    victim = Request(uid=0, prompt=prompt(4, 4), max_new_tokens=6)
    neighbor = Request(uid=1, prompt=prompt(5, 6), max_new_tokens=6)
    eng.submit(victim)
    eng.submit(neighbor)
    eng.fault_hooks.append(corrupt_kv_once(uid=0, at_tick=3))
    eng.run_to_completion(60)
    if not hardened:
        return {"damage": not _matches_oracle(victim),
                "detail": victim.out_tokens}
    return {
        "detected": "I_NAN_LOGITS" in _codes(eng),
        "recovered": victim.state == State.DONE and _matches_oracle(victim)
        and victim.retries == 1
        and neighbor.state == State.DONE and _matches_oracle(neighbor),
        "detail": {"victim": victim.state.value, "retries": victim.retries},
    }


def _nan_logits(hardened: bool) -> dict:
    eng = make_engine(hardened)
    victim = Request(uid=0, prompt=prompt(6, 4), max_new_tokens=6)
    neighbor = Request(uid=1, prompt=prompt(7, 6), max_new_tokens=6)
    eng.submit(victim)
    eng.submit(neighbor)
    eng.fault_hooks.append(nan_logits_once(uid=0, at_tick=3))
    eng.run_to_completion(60)
    if not hardened:
        return {"damage": not _matches_oracle(victim),
                "detail": victim.out_tokens}
    return {
        "detected": "I_NAN_LOGITS" in _codes(eng),
        "recovered": victim.state == State.DONE and _matches_oracle(victim)
        and victim.retries == 1 and len(eng.sched.quarantined) == 0
        and neighbor.state == State.DONE and _matches_oracle(neighbor),
        "detail": {"victim": victim.state.value, "retries": victim.retries},
    }


def _poison_request(hardened: bool) -> dict:
    eng = make_engine(hardened, max_retries=2)
    poison = Request(uid=0, prompt=prompt(8, 4), max_new_tokens=6)
    neighbor = Request(uid=1, prompt=prompt(9, 6), max_new_tokens=6)
    eng.submit(poison)
    eng.submit(neighbor)
    eng.fault_hooks.append(nan_logits_always(uid=0))
    done = eng.run_to_completion(80)
    if not hardened:
        return {"damage": not _matches_oracle(poison),
                "detail": poison.out_tokens}
    return {
        "detected": "I_NAN_LOGITS" in _codes(eng),
        "recovered": poison.state == State.FAILED
        and poison.finish_reason.startswith(Q_QUARANTINED)
        and poison in eng.sched.quarantined
        and neighbor.state == State.DONE and _matches_oracle(neighbor)
        and len(eng.active) == 0 and len(done) >= 2,
        "detail": {"poison": poison.finish_reason,
                   "retries": poison.retries},
    }


def _slot_leak(hardened: bool) -> dict:
    eng = make_engine(hardened, slots=1)
    eng.fault_hooks.append(leak_slot_once(slot=0, at_tick=1))
    real = Request(uid=0, prompt=prompt(10, 4), max_new_tokens=4)
    eng.submit(real)
    eng.run_to_completion(40)
    if not hardened:
        return {"damage": real.state not in (State.DONE,)
                and len(real.out_tokens) == 0,
                "detail": {"real": real.state.value, "tick": eng.tick}}
    return {
        "detected": "I_SLOT_LEAK" in _codes(eng),
        "recovered": real.state == State.DONE and _matches_oracle(real)
        and len(eng.active) == 0,
        "detail": {"real": real.state.value},
    }


def _kv_bounds_corrupt(hardened: bool) -> dict:
    eng = make_engine(hardened)
    victim = Request(uid=0, prompt=prompt(11, 4), max_new_tokens=6)
    eng.submit(victim)
    eng.fault_hooks.append(
        corrupt_length_once(uid=0, at_tick=3, value=MAX_SEQ + 3))
    eng.run_to_completion(60)
    if not hardened:
        diverged = not _matches_oracle(victim)
        return {"damage": diverged, "detail": victim.out_tokens}
    return {
        "detected": "I_KV_BOUNDS" in _codes(eng),
        "recovered": victim.state == State.DONE and _matches_oracle(victim)
        and victim.retries == 1,
        "detail": {"victim": victim.state.value,
                   "retries": victim.retries},
    }


def _queue_flood(hardened: bool) -> dict:
    eng = make_engine(hardened, slots=1, max_queue=4)
    reqs = [Request(uid=i, prompt=prompt(20 + i, 4), max_new_tokens=3)
            for i in range(10)]
    reasons = [eng.submit(r) for r in reqs]
    if not hardened:
        return {"damage": len(eng.sched.queue) == 10,
                "detail": {"queued": len(eng.sched.queue)}}
    eng.run_to_completion(80)
    accepted = [r for r, why in zip(reqs, reasons) if why is None]
    rejected = [r for r, why in zip(reqs, reasons)
                if why is RejectReason.QUEUE_FULL]
    return {
        "detected": len(rejected) == 6
        and eng.counters[RejectReason.QUEUE_FULL.value] == 6,
        "recovered": all(r.state == State.DONE and _matches_oracle(r)
                         for r in accepted)
        and all(r.state == State.REJECTED for r in rejected)
        and len(eng.sched.queue) == 0,
        "detail": {"accepted": len(accepted), "rejected": len(rejected)},
    }


def _deadline_storm(hardened: bool) -> dict:
    eng = make_engine(hardened, slots=1)
    blocker = Request(uid=0, prompt=prompt(30, 4), max_new_tokens=6)
    feasible = Request(uid=1, prompt=prompt(31, 4), max_new_tokens=5,
                       deadline=14)
    storm = [Request(uid=2 + i, prompt=prompt(32 + i, 4), max_new_tokens=5,
                     deadline=7) for i in range(3)]
    hopeless = Request(uid=9, prompt=prompt(39, 4), max_new_tokens=8,
                       deadline=2)       # can't fit its budget at all
    eng.submit(blocker)
    eng.submit(feasible)
    for r in storm:
        eng.submit(r)
    reason = eng.submit(hopeless)
    eng.run_to_completion(60)
    if not hardened:
        late = [r for r in (feasible, *storm, hopeless)
                if r.deadline is not None and r.finish_tick >= 0
                and r.finish_tick > r.submit_tick + r.deadline]
        return {"damage": len(late) > 0, "detail": {"late": len(late)}}
    return {
        "detected": reason is RejectReason.DEADLINE_INFEASIBLE
        and eng.counters[T_INFEASIBLE] + eng.counters[T_EXPIRED]
        == len(storm),
        "recovered": blocker.state == State.DONE
        and feasible.state == State.DONE and _matches_oracle(feasible)
        and feasible.finish_tick
        <= feasible.submit_tick + feasible.deadline
        and all(r.state == State.TIMED_OUT for r in storm)
        and len(eng.sched.queue) == 0,
        "detail": {"sheds": dict(eng.sched.counters),
                   "feasible": feasible.state.value},
    }


def _slot_stall(hardened: bool) -> dict:
    eng = make_engine(hardened, watchdog=4, max_retries=1)
    stuck = Request(uid=0, prompt=prompt(40, 4), max_new_tokens=6)
    neighbor = Request(uid=1, prompt=prompt(41, 6), max_new_tokens=6)
    eng.submit(stuck)
    eng.submit(neighbor)
    eng.fault_hooks.append(suppress_always(uid=0))
    eng.run_to_completion(60)
    if not hardened:
        return {"damage": not stuck.state.terminal()
                and len(stuck.out_tokens) < stuck.max_new_tokens,
                "detail": {"stuck": stuck.state.value,
                           "n_out": len(stuck.out_tokens)}}
    return {
        "detected": "I_SLOT_STALL" in _codes(eng),
        "recovered": stuck.state == State.FAILED
        and stuck.finish_reason.startswith(Q_QUARANTINED)
        and neighbor.state == State.DONE and _matches_oracle(neighbor)
        and len(eng.active) == 0,
        "detail": {"stuck": stuck.finish_reason},
    }


# ---------------------------------------------------------------------------
# Registry + bidirectional verification
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ServingFault:
    """One fault class: injection scenario + its detect/recover contract."""
    name: str
    detect_code: str     # named invariant / reject / shed code
    policy: str          # documented recovery (docs/serving.md table)
    damage: str          # what the legacy engine observably does
    scenario: Callable[[bool], dict]


REGISTRY: Tuple[ServingFault, ...] = (
    ServingFault("prompt-too-long", RejectReason.PROMPT_TOO_LONG.value,
                 "reject", "prefill crash", _prompt_too_long),
    ServingFault("decode-overflow", "I_KV_CAPACITY", "evict-partial",
                 "KV length past max_seq + clamped-scatter divergence",
                 _decode_overflow),
    ServingFault("kv-corrupt", "I_NAN_LOGITS", "evict-requeue",
                 "silent divergence from oracle", _kv_corrupt),
    ServingFault("nan-logits", "I_NAN_LOGITS", "evict-requeue",
                 "silent divergence from oracle", _nan_logits),
    ServingFault("poison-request", "I_NAN_LOGITS", "quarantine",
                 "garbage output accepted as DONE", _poison_request),
    ServingFault("slot-leak", "I_SLOT_LEAK", "reclaim",
                 "capacity loss: queued request wedged", _slot_leak),
    ServingFault("kv-bounds-corrupt", "I_KV_BOUNDS", "evict-requeue",
                 "silent divergence from oracle", _kv_bounds_corrupt),
    ServingFault("queue-flood", RejectReason.QUEUE_FULL.value, "shed",
                 "unbounded queue growth", _queue_flood),
    ServingFault("deadline-storm", T_INFEASIBLE, "shed",
                 "deadlines ignored: late completions", _deadline_storm),
    ServingFault("slot-stall", "I_SLOT_STALL", "quarantine",
                 "wedged slot: request never progresses", _slot_stall),
)


def verify(fault: ServingFault) -> dict:
    """One fault through the bidirectional contract; see module doc.

    Returns a report dict on success, raises ``AssertionError`` naming the
    broken direction otherwise.
    """
    obs = fault.scenario(True)
    if not obs.get("detected"):
        raise AssertionError(
            f"{fault.name}: hardened engine missed the fault "
            f"(wanted {fault.detect_code}; detail={obs.get('detail')})")
    if not obs.get("recovered"):
        raise AssertionError(
            f"{fault.name}: recovery policy {fault.policy!r} not observed "
            f"(detail={obs.get('detail')})")
    legacy = fault.scenario(False)
    if not legacy.get("damage"):
        raise AssertionError(
            f"{fault.name}: legacy engine showed no damage ({fault.damage})"
            f" — the detector would be vacuous "
            f"(detail={legacy.get('detail')})")
    return {"name": fault.name, "detect": fault.detect_code,
            "policy": fault.policy, "hardened": obs.get("detail"),
            "legacy": legacy.get("detail")}


def verify_all() -> List[dict]:
    """The whole registry; tests and the load benchmark share this."""
    return [verify(f) for f in REGISTRY]
