"""PyTorch port, the serving slice as a whole: ``repro_torch.serving``
against ``repro.serving`` and against the port's own full-forward oracle.

The oracle is greedy decode by repeated *full forward* with no KV cache
and no batching — any slot-reuse, masking, or eviction bug that touches
neighbouring state shows up as a token mismatch. Both engines run the
same reduced tinyllama on the same (converted) parameters in fp32 on the
CPU; greedy tokens are compared exactly.
"""
import collections
import functools

import jax
import numpy as np
import pytest
import torch

from repro.serving import faults as jfaults
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.models import transformer as ttf
from repro_torch.serving import (DegradeLadder, Request, RejectReason,
                                 Scheduler, ServingEngine, State)
from repro_torch.serving.scheduler import (Q_QUARANTINED, T_EXPIRED,
                                           T_INFEASIBLE)

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

MAX_SEQ = jfaults.MAX_SEQ


@functools.lru_cache(maxsize=1)
def fixture():
    """The reference's serving fixture (reduced tinyllama, its own random
    parameters), converted for the port."""
    _, params_j = jfaults.fixture()
    cfg = reduced(get_config("tinyllama-1.1b"))
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params_j), device="cpu")
    return cfg, params


def prompt(seed, n):
    return jfaults.prompt(seed, n)


@functools.lru_cache(maxsize=64)
def _oracle_cached(prompt_key, n):
    cfg, params = fixture()
    toks = list(prompt_key)
    with torch.inference_mode():
        for _ in range(n):
            lg, _, _ = ttf.forward(cfg, params,
                                   torch.tensor([toks], dtype=torch.int32))
            toks.append(int(torch.argmax(lg[0, -1])))
    return tuple(toks[len(prompt_key):])


def oracle(p, n):
    """The port's greedy continuation by repeated full forward."""
    return list(_oracle_cached(tuple(int(t) for t in p), n))


def make_engine(hardened=True, **kw):
    cfg, params = fixture()
    kw.setdefault("slots", 2)
    kw.setdefault("max_seq", MAX_SEQ)
    return ServingEngine(cfg, params, hardened=hardened, device="cpu", **kw)


def _req(uid=0, plen=4, seed=None, **kw):
    return Request(uid=uid, prompt=prompt(uid if seed is None else seed, plen),
                   **kw)


# ---------------------------------------------------------------------------
# Scheduler copy: the reference's TestScheduler cases
# ---------------------------------------------------------------------------


class TestScheduler:
    def mk(self, **kw):
        kw.setdefault("slots", 1)
        kw.setdefault("max_seq", 32)
        return Scheduler(**kw)

    def test_queue_is_a_deque(self):
        assert isinstance(self.mk().queue, collections.deque)

    def test_reject_codes(self):
        s = self.mk(max_queue=2)
        assert s.submit(Request(0, np.zeros(0, np.int32)), 0) \
            is RejectReason.BAD_REQUEST
        assert s.submit(_req(1, max_new_tokens=0), 0) \
            is RejectReason.BAD_REQUEST
        assert s.submit(_req(2, plen=33), 0) \
            is RejectReason.PROMPT_TOO_LONG
        assert s.submit(_req(3, max_new_tokens=5, deadline=2), 0) \
            is RejectReason.DEADLINE_INFEASIBLE
        assert s.submit(_req(4), 0) is None
        assert s.submit(_req(5), 0) is None
        assert s.submit(_req(6), 0) is RejectReason.QUEUE_FULL
        assert all(r.state == State.REJECTED for r in s.rejected)
        assert s.counters[RejectReason.QUEUE_FULL.value] == 1
        assert s.counters["accepted"] == 2

    def test_deadline_expiry_and_infeasible_shed(self):
        s = self.mk()
        expired = _req(0, max_new_tokens=2, deadline=3)
        infeasible = _req(1, max_new_tokens=4, deadline=6)
        safe = _req(2, max_new_tokens=2)
        for r in (expired, infeasible, safe):
            assert s.submit(r, 0) is None
        dropped = s.tick(3)
        assert set(r.uid for r in dropped) == {0, 1}
        assert expired.state == State.TIMED_OUT
        assert expired.finish_reason == T_EXPIRED
        assert infeasible.finish_reason == T_INFEASIBLE
        assert list(s.queue) == [safe]
        assert s.counters[T_EXPIRED] == 1 and s.counters[T_INFEASIBLE] == 1

    def test_backoff_rotation_preserves_fifo(self):
        s = self.mk()
        backing_off, ready = _req(0), _req(1)
        backing_off.not_before = 10
        s.queue.extend([backing_off, ready])
        assert s.next_ready(now=5) is ready
        assert list(s.queue) == [backing_off]
        assert s.next_ready(now=5) is None
        assert s.next_ready(now=10) is backing_off

    def test_requeue_then_quarantine(self):
        s = self.mk(max_retries=1, backoff_base=3)
        r = _req(0)
        r.out_tokens = [7, 7]
        assert s.requeue(r, now=5, cause="nan-logits") is True
        assert r.retries == 1 and r.out_tokens == []
        assert r.not_before == 5 + 3 and r.state == State.QUEUED
        assert s.queue[0] is r
        assert s.requeue(r, now=9, cause="nan-logits") is False
        assert r.state == State.FAILED
        assert r.finish_reason == f"{Q_QUARANTINED}:nan-logits"
        assert r in s.quarantined and s.counters[Q_QUARANTINED] == 1

    def test_pressure(self):
        s = self.mk(slots=4)
        s.queue.extend(_req(i) for i in range(6))
        assert s.pressure(active=2) == pytest.approx(2.0)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


def test_oracles_agree():
    """The port's full-forward oracle gives the reference's tokens."""
    for seed in (60, 61, 62):
        p = prompt(seed, 5)
        assert oracle(p, 6) == jfaults.oracle(p, 6)


def test_slot_churn_matches_reference_engine_and_oracle():
    """8 requests through 2 slots: every completion equals the port's own
    full-forward oracle AND the reference engine's tokens — slot reuse,
    lengths masking, in-place pool updates and prefill-overwrite leave no
    cross-talk."""
    def reqs():
        return [_req(uid=i, seed=60 + i, plen=4 + (i % 3),
                     max_new_tokens=3 + (i % 4)) for i in range(8)]
    eng = make_engine(slots=2)
    mine = reqs()
    for r in mine:
        assert eng.submit(r) is None
    eng.run_to_completion(200)

    ref_eng = jfaults.make_engine(slots=2)
    theirs = reqs()
    for r in theirs:
        assert ref_eng.submit(r) is None
    ref_eng.run_to_completion(200)

    for r, rr in zip(mine, theirs):
        assert r.state == State.DONE, (r.uid, r.state)
        assert r.out_tokens == oracle(r.prompt, r.max_new_tokens), \
            f"slot churn corrupted uid={r.uid}"
        assert r.out_tokens == rr.out_tokens
        assert (r.first_token_tick, r.finish_tick) \
            == (rr.first_token_tick, rr.finish_tick)
    assert not eng.active and not eng.sched.queue
    assert eng.stats()["finished_states"] == {"done": 8}
    assert eng.tick == ref_eng.tick
    assert not eng.events
    # every device step was timed under its kind
    assert sum(c for c, _ in eng.timers.values()) == 8 + eng.tick
    assert {k.split("_")[0] for k in eng.timers} == {"prefill", "decode"}


def test_budget_and_eos_semantics():
    eng = make_engine()
    one = _req(0, max_new_tokens=1)
    eng.submit(one)
    eng.run_to_completion(10)
    assert one.state == State.DONE
    assert one.out_tokens == oracle(one.prompt, 1)
    assert not eng.active and not eng.sched.queue

    eng = make_engine()
    budget = _req(1, max_new_tokens=5)
    eng.submit(budget)
    eng.run_to_completion(20)
    assert budget.out_tokens == oracle(budget.prompt, 5)

    ref = oracle(prompt(2, 4), 8)
    eos = ref[2]
    first = ref.index(eos)
    eng = make_engine()
    stopper = _req(2, max_new_tokens=8, eos_id=eos)
    eng.submit(stopper)
    eng.run_to_completion(20)
    assert stopper.state == State.DONE
    assert len(stopper.out_tokens) == first + 1
    assert stopper.out_tokens[-1] == eos
    assert stopper.out_tokens == ref[:first + 1]


def test_overflow_evicts_and_neighbor_kv_unchanged():
    max_seq = 16
    neighbor_a = _req(uid=0, seed=70, plen=4, max_new_tokens=12)
    over = _req(uid=1, seed=71, plen=6, max_new_tokens=16)

    eng_a = make_engine(max_seq=max_seq)
    eng_a.submit(neighbor_a)
    eng_a.submit(over)
    for _ in range(40):
        eng_a.step()
        if any(e["code"] == "I_KV_CAPACITY" for e in eng_a.events):
            break
    assert over.state == State.EVICTED
    assert over.finish_reason == "I_KV_CAPACITY"
    want = 1 + (max_seq - len(over.prompt))
    assert len(over.out_tokens) == want
    assert over.out_tokens == oracle(over.prompt, want)
    assert neighbor_a.state == State.DECODE

    neighbor_b = _req(uid=0, seed=70, plen=4, max_new_tokens=12)
    eng_b = make_engine(max_seq=max_seq)
    eng_b.submit(neighbor_b)
    for _ in range(eng_a.tick):
        eng_b.step()
    assert neighbor_a.out_tokens == neighbor_b.out_tokens
    for key in ("k", "v"):
        np.testing.assert_array_equal(
            eng_a.cache[key][:, 0].numpy(), eng_b.cache[key][:, 0].numpy(),
            err_msg=f"neighbor {key} rows differ after eviction")
    assert int(eng_a.cache["lengths"].max()) <= max_seq
    eng_a.run_to_completion(40)
    assert neighbor_a.out_tokens == oracle(neighbor_a.prompt, 12)


def test_legacy_engine_clamps_on_overflow():
    """``hardened=False`` keeps meaning "legacy, clamps": decoding past
    max_seq neither faults nor evicts, and the KV length runs past the
    buffer while the clamped write lands on the last row."""
    eng = make_engine(hardened=False, max_seq=8, slots=1)
    r = _req(uid=0, seed=72, plen=6, max_new_tokens=6)
    eng.submit(r)
    eng.run_to_completion(20)
    assert r.state == State.DONE and len(r.out_tokens) == 6
    assert not eng.events
    assert r.out_tokens[:3] == oracle(r.prompt, 3)   # until the buffer fills


def test_degrade_ladder_under_pressure():
    cfg, _ = fixture()
    eng = make_engine(degrade=DegradeLadder(bf16_at=1.0, int8_at=3.0))
    reqs = [_req(uid=i, seed=50 + i, max_new_tokens=4) for i in range(8)]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion(100)
    assert all(r.state == State.DONE for r in reqs)
    assert eng.counters["degraded_steps_int8"] > 0    # peak pressure
    assert eng.counters["degraded_steps_bf16"] > 0    # draining
    assert eng.counters["degraded_steps"] \
        == eng.counters["degraded_steps_int8"] \
        + eng.counters["degraded_steps_bf16"]
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens)
    # the rungs are the reference engine's, step for step
    ref = jfaults.make_engine(degrade=DegradeLadder(bf16_at=1.0, int8_at=3.0))
    for i in range(8):
        ref.submit(_req(uid=i, seed=50 + i, max_new_tokens=4))
    ref.run_to_completion(100)
    for key in ("degraded_steps", "degraded_steps_bf16",
                "degraded_steps_int8"):
        assert eng.counters[key] == ref.counters[key]
    assert eng.timers["decode_int8"][0] == eng.counters["degraded_steps_int8"]
    assert eng.timers["decode_bf16"][0] == eng.counters["degraded_steps_bf16"]
    # one cached parameter copy per compute dtype
    assert set(eng._params_by_dtype) == {torch.float32, torch.bfloat16}


def test_degrade_off_is_bit_exact():
    eng = make_engine()
    r = _req(uid=0, seed=80, max_new_tokens=6)
    eng.submit(r)
    eng.run_to_completion(20)
    assert r.out_tokens == oracle(r.prompt, 6)
    assert eng.counters["degraded_steps"] == 0


def test_nan_port_trips_the_finite_guard():
    eng = make_engine()
    r = _req(uid=0, seed=81, max_new_tokens=6)
    eng.submit(r)
    eng.step()
    eng._inject_nan_slots.add(0)
    eng.step()
    assert [e["code"] for e in eng.events] == ["I_NAN_LOGITS"]
    assert r.state == State.QUEUED and r.retries == 1
    eng.run_to_completion(40)
    assert r.state == State.DONE
    assert r.out_tokens == oracle(r.prompt, 6)     # a retry is a clean run


def test_sampling_is_reproducible_and_in_range():
    cfg, _ = fixture()

    def run(seed):
        eng = make_engine(seed=seed)
        reqs = [_req(uid=i, seed=90 + i, max_new_tokens=8, temperature=1.5)
                for i in range(3)]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion(60)
        assert all(r.state == State.DONE for r in reqs)
        return [r.out_tokens for r in reqs]
    a, b, c = run(3), run(3), run(4)
    assert a == b                         # deterministic under a seed
    assert a != c                         # and the seed matters
    assert all(0 <= t < cfg.vocab_size for out in a for t in out)
    # hot sampling leaves the greedy path (first token is prefill's argmax)
    greedy = [oracle(prompt(90 + i, 4), 8) for i in range(3)]
    assert [o[0] for o in a] == [g[0] for g in greedy]
    assert a != greedy


def test_default_device_raises_without_a_card():
    """Constructing an engine with the default device on a machine
    without a CUDA device raises; it does not run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    cfg, params = fixture()
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(cfg, params)
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(cfg, params, device="cuda")
