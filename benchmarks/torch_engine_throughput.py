"""Engine runtime throughput on the PyTorch port: build-once/run-many vs
per-program builds. The twin of ``benchmarks/engine_throughput.py``: the
same paths, rows, asserts and ``--min-speedup`` rule, on the port's
``ReferenceEngine(..., device=)`` (``--device``, default ``cuda``; raises
without one).

Executing N random differential programs of one shape *signature* through

1. ``uncached`` — the trace cache is cleared before every program, so
   each one builds its runner anew (where the reference re-traces and
   re-compiles with XLA, the port's ``staging.build_runner`` makes the
   per-opcode-group schedule; on the card a group shape that recurs at
   least ``staging.GRAPH_MIN_REPEATS`` times is captured as a CUDA graph).
   Each of its programs runs once before it, so that the first use of a
   torch operation on the device is not charged to a runner build;
2. ``cached`` — one warm build, then per-program ``run()`` calls that
   hit the signature cache;
3. ``cached_batched`` — ``run_many``: the whole batch in ONE runner call.

Reports programs/sec and the shared cache's build counter
(``stats.compiles``, runners built) for each path, plus the
cached_batched/uncached speedup — the reference's acceptance bar is
>= 10× (``--min-speedup``, the same meaning here). A second sweep records
programs/sec for every SEW=8 cell (lmul ∈ {mf4, mf2, 1, 2, 4, 8}) on the
cached+batched path under ``int8_cells``, and a third runs a
mask/compare/reduction-heavy op mix over sampled vtype corners under
``mask_cells``; both must hold one signature (one build). A
``lint_overhead`` section re-runs the batched path with the encode-time
static analyzer enabled (``ReferenceEngine(lint=True)``) and asserts the
build counter does not move — linting is host python — while recording
its per-program cost. Seconds are host-clock seconds around calls that
return host arrays (the engine copies its results back). Results land in
``torch_BENCH_engines.json`` and print as ``engine_throughput,key=value,...``
lines.

  PYTHONPATH=src python benchmarks/torch_engine_throughput.py \
      [--n 24] [--sew 32] [--lmul 2] [--uncached-n 3] \
      [--out torch_BENCH_engines.json] [--min-speedup 10] [--device cuda]
"""
import argparse
import json
import platform
import time

import numpy as np
import torch

from repro_torch.configs.ara import AraConfig
from repro_torch.core import isa, staging
from repro_torch.core.vector_engine import ReferenceEngine
from repro_torch.device import resolve_device
from repro_torch.testing import differential as diff


def make_batch(n, sew, lmul, n_ops=14, seed0=0, ops=diff.DEFAULT_OPS):
    progs, mems, srs = [], [], []
    for i in range(n):
        p, m, s = diff.random_program(np.random.RandomState(seed0 + i),
                                      sew, lmul, n_ops=n_ops, ops=ops)
        progs.append(p)
        mems.append(m)
        srs.append(s)
    return progs, mems, srs


# masking/reduction-heavy op mix: compares, mask logicals, merge and the
# reduction class, leavened with loads/stores and one arithmetic op per
# class so masks have values to govern
MASK_OPS = (diff.INT_CMP_POOL + diff.FP_CMP_POOL + diff.MASK_POOL
            + diff.RED_POOL + ("vadd", "vfadd", "vld", "vst"))


def _rate(n_programs, seconds, compiles):
    return {"programs": n_programs, "seconds": round(seconds, 4),
            "programs_per_sec": round(n_programs / seconds, 2),
            "compiles": compiles}


def bench(n=24, sew=32, lmul=2, uncached_n=3, reps=3, device=None):
    dev = resolve_device(device)
    eng = ReferenceEngine(AraConfig(lanes=2), vlmax=diff.VLMAX64,
                          dtype=torch.float32, cache=staging.TraceCache(),
                          device=dev)
    progs, mems, srs = make_batch(n, sew, lmul)
    win = diff.grid_window(diff.VLMAX64)
    stats = eng.cache.stats

    # the first use of each torch operation on the device (its module's
    # load, library handles) is paid here, once a process, and not by the
    # runner builds timed below: each uncached program runs once first
    for i in range(uncached_n):
        eng.cache.clear()
        eng.run(progs[i], mems[i], dict(srs[i]))

    # 1. per-program builds: clear the cache before every run
    stats.reset()
    t0 = time.perf_counter()
    for i in range(uncached_n):
        eng.cache.clear()
        eng.run(progs[i], mems[i], dict(srs[i]))
    uncached = _rate(uncached_n, time.perf_counter() - t0, stats.compiles)

    # 2. cached per-program: one build, then N cache hits
    eng.cache.clear()
    stats.reset()
    eng.run(progs[0], mems[0], dict(srs[0]))          # warm the signature
    t0 = time.perf_counter()
    for i in range(n):
        eng.run(progs[i], mems[i], dict(srs[i]))
    cached = _rate(n, time.perf_counter() - t0, stats.compiles)

    # 3. cached + batched: the whole batch in one runner call
    eng.cache.clear()
    stats.reset()
    t0 = time.perf_counter()
    eng.run_many(progs, mems, [dict(s) for s in srs], window=win)
    compile_s = time.perf_counter() - t0              # includes the build
    t0 = time.perf_counter()
    for _ in range(reps):
        eng.run_many(progs, mems, [dict(s) for s in srs], window=win)
    batched = _rate(n * reps, time.perf_counter() - t0, stats.compiles)
    batched["compile_seconds_first_call"] = round(compile_s, 4)

    # 4. lint-pass overhead: run_many with the encode-time static
    # analyzer (core/analysis.py) enabled, on the SAME warm cache. The
    # linter is pure host python, so the build counter must not move —
    # asserted here, and the delta vs cached_batched is the recorded
    # cost of linting every program before execution.
    from repro_torch.core import analysis
    lint_eng = ReferenceEngine(AraConfig(lanes=2), vlmax=diff.VLMAX64,
                               dtype=torch.float32, cache=eng.cache,
                               lint=True, device=dev)
    compiles_before = stats.compiles
    t0 = time.perf_counter()
    for _ in range(reps):
        lint_eng.run_many(progs, mems, [dict(s) for s in srs], window=win)
    linted = _rate(n * reps, time.perf_counter() - t0, stats.compiles)
    assert stats.compiles == compiles_before, (
        f"lint pass changed the compile count: {compiles_before} -> "
        f"{stats.compiles}")
    t0 = time.perf_counter()
    for _ in range(reps):
        for p, m in zip(progs, mems):
            analysis.lint_program(p, diff.VLMAX64, mem_words=m.size)
    lint_only_s = time.perf_counter() - t0
    linted["lint_only_ms_per_program"] = round(
        1000.0 * lint_only_s / (n * reps), 4)
    linted["overhead_vs_cached_batched_pct"] = round(
        100.0 * max(batched["programs_per_sec"]
                    / max(linted["programs_per_sec"], 1e-9) - 1.0, 0.0), 1)

    # SEW=8 cells: one batched run_many per legal lmul at the grid-wide
    # window, so every cell hits the one cached signature
    int8_cells = {}
    eng.cache.clear()
    stats.reset()
    for _, lm8 in diff.vtype_combos(sews=(8,)):
        p8, m8, s8 = make_batch(n, 8, lm8)
        eng.run_many(p8, m8, [dict(s) for s in s8], window=win)  # warm
        t0 = time.perf_counter()
        for _ in range(reps):
            eng.run_many(p8, m8, [dict(s) for s in s8], window=win)
        int8_cells[isa.format_lmul(lm8)] = _rate(
            n * reps, time.perf_counter() - t0, stats.compiles)

    # masking/reduction cells: one batched run_many per sampled vtype
    # corner on a mask/compare/reduction-heavy op mix — vm is one more
    # data column, so these ride the same cached signature too
    mask_cells = {}
    eng.cache.clear()
    stats.reset()
    for ms, ml in ((64, 1), (32, 2), (16, isa.parse_lmul("mf2")), (8, 4)):
        pm_, mm_, sm_ = make_batch(n, ms, ml, ops=MASK_OPS)
        eng.run_many(pm_, mm_, [dict(s) for s in sm_], window=win)  # warm
        t0 = time.perf_counter()
        for _ in range(reps):
            eng.run_many(pm_, mm_, [dict(s) for s in sm_], window=win)
        mask_cells[f"sew{ms}_{isa.format_lmul(ml)}"] = _rate(
            n * reps, time.perf_counter() - t0, stats.compiles)

    return {
        "bench": "engine_throughput",
        "engine": "reference(staged)",
        "config": {"n_programs": n, "sew": sew, "lmul": lmul,
                   "vlmax64": diff.VLMAX64, "n_ops": 14,
                   "uncached_n": uncached_n, "reps": reps,
                   "backend": dev.type,
                   "device": torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu",
                   "platform": platform.platform()},
        "uncached": uncached,
        "cached": cached,
        "cached_batched": batched,
        "lint_overhead": linted,
        "int8_cells": int8_cells,
        "mask_cells": mask_cells,
        "speedup_cached_batched_vs_uncached": round(
            batched["programs_per_sec"] / uncached["programs_per_sec"], 1),
        "speedup_cached_vs_uncached": round(
            cached["programs_per_sec"] / uncached["programs_per_sec"], 1),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=24)
    ap.add_argument("--sew", type=int, default=32)
    ap.add_argument("--lmul", type=int, default=2)
    ap.add_argument("--uncached-n", type=int, default=3)
    ap.add_argument("--out", default="torch_BENCH_engines.json")
    ap.add_argument("--min-speedup", type=float, default=None,
                    help="exit nonzero if cached_batched/uncached is below")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    res = bench(n=args.n, sew=args.sew, lmul=args.lmul,
                uncached_n=args.uncached_n, device=args.device)
    for path in ("uncached", "cached", "cached_batched", "lint_overhead"):
        row = {"path": path, **res[path]}
        print("engine_throughput," +
              ",".join(f"{k}={v}" for k, v in row.items()), flush=True)
    for lm, row in res["int8_cells"].items():
        print("engine_throughput," +
              ",".join(f"{k}={v}" for k, v in
                       {"path": f"int8_{lm}", **row}.items()), flush=True)
    for cell, row in res["mask_cells"].items():
        print("engine_throughput," +
              ",".join(f"{k}={v}" for k, v in
                       {"path": f"mask_{cell}", **row}.items()), flush=True)
    print(f"engine_throughput,path=speedup,"
          f"cached_batched_vs_uncached="
          f"{res['speedup_cached_batched_vs_uncached']}")
    with open(args.out, "w") as f:
        json.dump(res, f, indent=2)
    print(f"wrote {args.out}")
    if args.min_speedup is not None and \
            res["speedup_cached_batched_vs_uncached"] < args.min_speedup:
        raise SystemExit(
            f"speedup {res['speedup_cached_batched_vs_uncached']} "
            f"< required {args.min_speedup}")
    return res


if __name__ == "__main__":
    main()
