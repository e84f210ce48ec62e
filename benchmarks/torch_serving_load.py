"""Serving load benchmark on the PyTorch port: Poisson arrivals through the
hardened engine, with and without fault injection. The twin of
``benchmarks/serving_load.py``: the same arrivals, campaign, counters,
output rows and exit rules.

Two phases over the same arrival trace (seeded: reproducible):

- ``clean`` — no faults. Measures goodput (tokens of DONE requests per
  wall-second), P50/P99 request latency (in engine ticks and seconds),
  and the shed/reject/timeout/evict/retry counters under load. The
  degrade ladder is armed, so pressure shows up as ``degraded_steps``
  (split by rung in ``degraded_steps_bf16`` / ``degraded_steps_int8``,
  the twin's one addition to the rows: each int8 step launches the
  ``matmul_int8`` kernel once on the card).
- ``faulted`` — the same load plus a scripted injection campaign drawn
  from ``serving/faults.py``'s surface: NaN logits, KV-row corruption,
  KV-length corruption, a leaked slot, a too-long prompt, an overflowing
  request, a queue flood and a deadline storm. Every injection records
  the invariant/reject code it must produce; after the run the engine's
  event log and counters are cross-checked and any injection without its
  named detection counts as an **undetected escape**.

Gate: exit nonzero when ``undetected_escapes > 0`` or clean goodput falls
below ``--min-goodput``. Results land in ``torch_BENCH_serving.json`` and
print as ``serving_load,phase=...,key=value`` lines. What differs from the
reference: the campaign corrupts the KV pool in place (as the engine
updates it); the fixture is the port's reduced tinyllama-1.1b from its
own ``init_params`` (``torch.Generator`` seeded 0); ``bench`` takes an
optional ``fixture=(cfg, params)``, whose parameters' device the engines
use (``chip_smoke.py`` passes the full-width model); ``--device`` picks
the device of the default fixture (default: the card; raises without
one).

  PYTHONPATH=src python benchmarks/torch_serving_load.py \
      [--smoke] [--duration 120] [--rate 0.5] [--slots 4] \
      [--out torch_BENCH_serving.json] [--min-goodput 0.5] [--seed 0] \
      [--device cuda]
"""
import argparse
import json
import platform
import time

import numpy as np
import torch


def build_fixture(device=None):
    from repro_torch.configs import get_config, reduced
    from repro_torch.device import resolve_device
    from repro_torch.models.layers import init_params
    from repro_torch.models.transformer import model_template
    dev = resolve_device(device)
    cfg = reduced(get_config("tinyllama-1.1b"))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(model_template(cfg), gen, device=dev)
    return cfg, params


def make_arrivals(rng, duration, rate, max_seq):
    """Poisson arrivals with a prompt-length / budget / deadline mix.
    Returns {tick: [request-spec, ...]}; specs become Requests per phase
    so the two phases never share mutable state."""
    plens = (4, 6, 8, 12)
    arrivals = {}
    uid = 0
    for t in range(1, duration + 1):
        specs = []
        for _ in range(rng.poisson(rate)):
            plen = int(plens[rng.randint(len(plens))])
            budget = int(rng.randint(3, 9))
            deadline = None
            draw = rng.rand()
            if draw < 0.2:
                deadline = budget + int(rng.randint(2, 12))  # feasible-ish
            elif draw < 0.3:
                deadline = budget + 1                        # tight: may shed
            specs.append({"uid": uid, "seed": 1000 + uid, "plen": plen,
                          "max_new_tokens": budget, "deadline": deadline})
            uid += 1
        if specs:
            arrivals[t] = specs
    return arrivals


def spec_to_request(spec, cfg):
    from repro_torch.serving.scheduler import Request
    rng = np.random.RandomState(spec["seed"])
    prompt = rng.randint(0, cfg.vocab_size,
                         size=spec["plen"]).astype(np.int32)
    return Request(uid=spec["uid"], prompt=prompt,
                   max_new_tokens=spec["max_new_tokens"],
                   deadline=spec["deadline"])


class Campaign:
    """Scripted fault injections; each records the code it must produce."""

    def __init__(self, eng, cfg, max_seq, duration, rng):
        self.eng = eng
        self.cfg = cfg
        self.max_seq = max_seq
        self.rng = rng
        self.expected = []            # (code, tick) per injection
        self.uid = 10 ** 6            # uids for injected requests
        # spread one-shot injections over the middle of the run
        third = max(duration // 3, 8)
        self.plan = {
            third + 0: self.too_long_prompt,
            third + 2: self.overflow_request,
            third + 4: self.queue_flood,
            third + 6: self.deadline_storm,
            third + 8: self.leak_slot,
            third + 10: self.corrupt_kv_length,
            third + 12: self.corrupt_kv_rows,
        }
        self.nan_every = 9            # recurring NaN-logits injections

    def _next_uid(self):
        self.uid += 1
        return self.uid

    def _submit(self, req, code):
        self.eng.submit(req)
        self.expected.append((code, self.eng.tick))

    def _active_slot(self):
        # only target organic load; stacking a second fault on one of the
        # campaign's own probes (uid >= 10**6) would muddy its expectation
        live = [s for s, r in self.eng.active.items()
                if r is not None and not r.state.terminal()
                and r.uid < 10 ** 6]
        return live[self.rng.randint(len(live))] if live else None

    def too_long_prompt(self):
        from repro_torch.serving.scheduler import Request
        prompt = np.zeros(self.max_seq + 4, np.int32)
        self._submit(Request(uid=self._next_uid(), prompt=prompt,
                             max_new_tokens=4), "R_PROMPT_TOO_LONG")

    def overflow_request(self):
        from repro_torch.serving.scheduler import Request
        rng = np.random.RandomState(7)
        prompt = rng.randint(0, self.cfg.vocab_size,
                             size=12).astype(np.int32)
        self._submit(Request(uid=self._next_uid(), prompt=prompt,
                             max_new_tokens=self.max_seq),
                     "I_KV_CAPACITY")

    def queue_flood(self):
        from repro_torch.serving.scheduler import Request
        # burst > remaining queue capacity: at least one R_QUEUE_FULL
        burst = self.eng.sched.max_queue + 4
        for _ in range(burst):
            req = Request(uid=self._next_uid(),
                          prompt=np.ones(4, np.int32), max_new_tokens=3)
            self.eng.submit(req)
        self.expected.append(("R_QUEUE_FULL", self.eng.tick))

    def deadline_storm(self):
        from repro_torch.serving.scheduler import Request
        for _ in range(4):
            req = Request(uid=self._next_uid(),
                          prompt=np.ones(4, np.int32),
                          max_new_tokens=8, deadline=2)
            self.eng.submit(req)
        self.expected.append(("R_DEADLINE_INFEASIBLE", self.eng.tick))

    def leak_slot(self):
        from repro_torch.serving.scheduler import Request, State
        free = [s for s in range(self.eng.slots)
                if s not in self.eng.active]
        if not free:
            return False            # retry next tick
        ghost = Request(uid=-1, prompt=np.zeros(1, np.int32),
                        max_new_tokens=10 ** 9, out_tokens=[0])
        ghost.state = State.DONE
        ghost.done = True
        slot = free[0]
        self.eng.active[slot] = ghost
        self.eng._slot_len[slot] = 1
        self.eng._slot_progress[slot] = self.eng.tick
        self.expected.append(("I_SLOT_LEAK", self.eng.tick))
        return True

    def corrupt_kv_length(self):
        slot = self._active_slot()
        if slot is None:
            return False
        with torch.inference_mode():     # the pool is an inference tensor
            self.eng.cache["lengths"][slot] = self.max_seq + 3
        self.expected.append(("I_KV_BOUNDS", self.eng.tick))
        return True

    def corrupt_kv_rows(self):
        slot = self._active_slot()
        if slot is None:
            return False
        with torch.inference_mode():
            self.eng.cache["k"][:, slot, 0] = float("nan")
        self.expected.append(("I_NAN_LOGITS", self.eng.tick))
        return True

    def before_step(self, tick):
        """Called right before eng.step() each tick."""
        action = self.plan.pop(tick, None)
        if action is not None and action() is False:
            self.plan[tick + 1] = action      # no target yet: retry
        if tick % self.nan_every == 0:
            slot = self._active_slot()
            if slot is not None and slot not in self.eng._suppress_slots:
                self.eng._inject_nan_slots.add(slot)
                self.expected.append(("I_NAN_LOGITS", tick))

    def escapes(self):
        """Injections whose named code never showed up anywhere."""
        observed = {}
        for e in self.eng.events:
            observed[e["code"]] = observed.get(e["code"], 0) + 1
        for code, n in self.eng.counters.items():
            observed[code] = max(observed.get(code, 0), n)
        missing = []
        want = {}
        for code, tick in self.expected:
            want[code] = want.get(code, 0) + 1
        for code, n in want.items():
            if observed.get(code, 0) < n:
                missing.append({"code": code, "expected": n,
                                "observed": observed.get(code, 0)})
        return missing


def run_phase(cfg, params, arrivals, *, slots, max_seq, duration,
              faulted, seed):
    from repro_torch.serving.engine import DegradeLadder, ServingEngine
    from repro_torch.models.layers import tree_leaves
    eng = ServingEngine(cfg, params, slots=slots, max_seq=max_seq,
                        degrade=DegradeLadder(bf16_at=2.0, int8_at=4.0),
                        device=next(tree_leaves(params)).device)
    campaign = Campaign(eng, cfg, max_seq, duration,
                        np.random.RandomState(seed + 1)) if faulted else None
    submitted = []
    t0 = time.perf_counter()
    tick = 0
    while tick < duration or eng.active or eng.sched.queue:
        tick += 1
        if tick > duration + 400:
            break                      # safety valve: report, don't hang
        for spec in arrivals.get(tick, []):
            req = spec_to_request(spec, cfg)
            submitted.append(req)
            eng.submit(req)
        if campaign is not None:
            campaign.before_step(tick)
        eng.step()
    wall = time.perf_counter() - t0

    done = [r for r in submitted if r.state.value == "done"]
    lat = np.array([r.finish_tick - r.submit_tick for r in done]) \
        if done else np.array([0.0])
    tick_s = wall / max(eng.tick, 1)
    c = eng.counters
    out = {
        "requests": len(submitted),
        "done": len(done),
        "goodput_tok_per_s": round(
            sum(len(r.out_tokens) for r in done) / max(wall, 1e-9), 2),
        "p50_latency_ticks": float(np.percentile(lat, 50)),
        "p99_latency_ticks": float(np.percentile(lat, 99)),
        "p50_latency_s": round(float(np.percentile(lat, 50)) * tick_s, 4),
        "p99_latency_s": round(float(np.percentile(lat, 99)) * tick_s, 4),
        "wall_seconds": round(wall, 3),
        "ticks": eng.tick,
        "shed": len(eng.sched.shed),
        "rejected": len(eng.sched.rejected),
        "quarantined": len(eng.sched.quarantined),
        "retries": c.get("retries", 0),
        "timed_out": sum(1 for r in submitted
                         if r.state.value == "timed_out"),
        "evicted": sum(1 for r in submitted
                       if r.state.value == "evicted"),
        "degraded_steps": c.get("degraded_steps", 0),
        "degraded_steps_bf16": c.get("degraded_steps_bf16", 0),
        "degraded_steps_int8": c.get("degraded_steps_int8", 0),
        "events": len(eng.events),
    }
    if campaign is not None:
        missing = campaign.escapes()
        out["injections"] = len(campaign.expected)
        out["undetected_escapes"] = sum(m["expected"] - m["observed"]
                                        for m in missing)
        out["missing_detections"] = missing
    return out


def bench(duration=120, rate=0.5, slots=4, max_seq=32, seed=0,
          fixture=None, device=None):
    from repro_torch.models.layers import tree_leaves
    cfg, params = fixture if fixture is not None else build_fixture(device)
    dev = next(tree_leaves(params)).device
    rng = np.random.RandomState(seed)
    arrivals = make_arrivals(rng, duration, rate, max_seq)
    clean = run_phase(cfg, params, arrivals, slots=slots, max_seq=max_seq,
                      duration=duration, faulted=False, seed=seed)
    faulted = run_phase(cfg, params, arrivals, slots=slots,
                        max_seq=max_seq, duration=duration, faulted=True,
                        seed=seed)
    return {
        "bench": "serving_load",
        "config": {"duration": duration, "rate": rate, "slots": slots,
                   "max_seq": max_seq, "seed": seed,
                   "arrivals": sum(len(v) for v in arrivals.values()),
                   "backend": str(dev),
                   "device_name": torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu",
                   "platform": platform.platform()},
        "clean": clean,
        "faulted": faulted,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="small load for CI: 60 ticks, 2 slots")
    ap.add_argument("--duration", type=int, default=120)
    ap.add_argument("--rate", type=float, default=0.5)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="torch_BENCH_serving.json")
    ap.add_argument("--min-goodput", type=float, default=None,
                    help="exit nonzero if clean goodput (tok/s) is below")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.smoke:
        args.duration, args.slots, args.rate = 60, 2, 0.4

    res = bench(duration=args.duration, rate=args.rate, slots=args.slots,
                max_seq=args.max_seq, seed=args.seed, device=args.device)
    for phase in ("clean", "faulted"):
        row = {k: v for k, v in res[phase].items()
               if k != "missing_detections"}
        print("serving_load," +
              ",".join(f"{k}={v}" for k, v in
                       {"phase": phase, **row}.items()), flush=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=2)
    print(f"wrote {args.out}")

    escapes = res["faulted"].get("undetected_escapes", 0)
    if escapes:
        raise SystemExit(
            f"{escapes} undetected fault escapes: "
            f"{res['faulted']['missing_detections']}")
    if args.min_goodput is not None and \
            res["clean"]["goodput_tok_per_s"] < args.min_goodput:
        raise SystemExit(
            f"clean goodput {res['clean']['goodput_tok_per_s']} tok/s "
            f"< required {args.min_goodput}")


if __name__ == "__main__":
    main()
