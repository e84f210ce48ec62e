#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Needs a CUDA device, ``nvcc`` and nothing else: it builds the kernels from
``src/repro_torch/kernels/csrc`` and serves randomly initialised
tinyllama-1.1b at full width and full depth. Without a CUDA device, or in a
directory that lacks the package, it exits non-zero and prints no result.
Phases, one JSON line each:

1. ``env``     the card's name and power limit, torch / CUDA / nvcc versions.
2. ``build``   compiles the kernels (seconds, registers and spills per kernel).
3. ``kernels`` every kernel against its plain PyTorch version on the card,
               at the serving shape (8,2048)@(2048,32000), at 128^3, at a
               small shape with 16-wide blocks and at ragged shapes, and the
               logits head at shapes its default blocks do not tile; then
               times kernel, plain version and library call.
4. ``serve``   tinyllama-1.1b, 8 slots, 16 requests, degrade ladder down to
               the int8 logits head; checks states, tokens, events and that
               the int8 kernel was launched once per int8 step.
5. ``serve_exact`` the same model in float32, depth cut to 4 layers, against
               a greedy full-forward oracle (tokens equal, logits within
               1e-3); the cached decode path at full depth against the full
               forward in float64 (logits within 1e-7, tokens equal), with
               the float32 runs held to that witness; and the bf16
               logits-head route through ``matmul``.

Then one line ``{"kernels": [...]}`` (launch counts of phases 4-5, error,
times and bound per kernel), one line with the card's name and power limit,
and as the last line ``{"ok": true, "device": {...}}``. Any failed check
raises: nothing is caught and passed over.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.precision import (PEAK_BYTES_PER_S,  # noqa: E402
                                        PEAKS_FLOPS)
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import matmul as mm  # noqa: E402
from repro_torch.models.layers import (init_params, tree_map,  # noqa: E402
                                       tree_size_bytes)
from repro_torch.models.transformer import (forward, init_cache,  # noqa: E402
                                            model_template)
from repro_torch.serving import (DegradeLadder, Request,  # noqa: E402
                                 ServingEngine, State)

PATH_SHAPE = (8, 2048, 32000)      # (slots, d_model, vocab) of tinyllama-1.1b
SOURCE = "src/repro_torch/kernels/csrc/matmul.cu"
DEV = "cuda"                       # every tensor of this script lives here


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


_BLOCKER = []


def _hold_the_card():
    """Queue about 3 ms of device work (two large bf16 products, which also
    sweep the L2 cache), so that what the host enqueues next piles up behind
    it and then runs back to back, with no wait for the host in between."""
    if not _BLOCKER:
        _BLOCKER.append(torch.ones((8192, 8192), dtype=torch.bfloat16,
                                   device=DEV))
    big = _BLOCKER[0]
    torch.mm(big, big)
    torch.mm(big, big)


def time_ms(fn, warmup: int = 3, reps: int = 20, inner: int = 10) -> float:
    """Device ms per call of ``fn``: the median over ``reps`` batches of the
    time of ``inner`` back-to-back calls between two CUDA events, over
    ``inner``. The host needs tens of microseconds per call — as long as the
    kernels timed here run — so each batch is enqueued while the card is
    held busy (:func:`_hold_the_card`): the events then bracket device work
    only, not the card waiting for the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        _hold_the_card()
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound_ms(m: int, k: int, n: int, in_bytes: int, out_bytes: int,
             peak_ops: float):
    """Least time the card could take: each input read once and the output
    written once over the memory rate, or the 2*m*k*n operations over the
    peak rate for the operand type — whichever is larger."""
    t_bytes = ((m * k + k * n) * in_bytes + m * n * out_bytes) \
        / PEAK_BYTES_PER_S
    t_ops = 2.0 * m * k * n / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------------------
# phases 1-2
# ---------------------------------------------------------------------------


def phase_env() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True).stdout
    release = re.search(r"release ([\d.]+)", nvcc)
    emit("env", gpu=smi, torch=torch.__version__, cuda=torch.version.cuda,
         nvcc_release=release.group(1) if release else None,
         device_name=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(),
         allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    return smi


def phase_build():
    t0 = time.perf_counter()
    libs = build.build()
    seconds = time.perf_counter() - t0
    mm_lib = build.load("matmul")
    assert mm_lib.repro_matmul and mm_lib.repro_matmul_int8
    ptxas = []
    for path in libs.values():
        log = path.with_suffix(".log").read_text()
        for name, body in re.findall(
                r"Compiling entry function '(\w+)'(.*?)(?=ptxas info\s*:\s*"
                r"Compiling|\Z)", log, flags=re.S):
            regs = re.search(r"Used (\d+) registers", body)
            spill = re.search(r"(\d+) bytes spill stores", body)
            ptxas.append({"kernel": name[:60],
                          "registers": int(regs.group(1)) if regs else None,
                          "spill_store_bytes": int(spill.group(1))
                          if spill else None})
    emit("build", seconds=seconds,
         libraries=[os.path.basename(str(p)) for p in libs.values()],
         ptxas=ptxas)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions, on the card
# ---------------------------------------------------------------------------


ACC_TOL = 3e-5        # fp32 accumulation order, as a share of max|ref|
BF16_ULP = 2.0 ** -7  # one step of a bfloat16 result, relative to the value
F16_ULP = 2.0 ** -10  # ... of a float16 result


def _check_float(name, got, ref, rel, results, **detail):
    """|got - ref| <= rel * |ref| + ACC_TOL * max|ref| elementwise.

    Both sides multiply the same operands exactly and accumulate in fp32, so
    they differ by summation order only: ACC_TOL of the largest result
    (readings are 6e-8 to 1.3e-6 of it). A dropped k row or a wrongly
    unpacked lane moves a result by about 1/sqrt(K) of the scale, hundreds
    of times the allowance. ``rel`` is for a narrow output alone, where the two fp32
    sums may round to neighbouring narrow values: one step of that type."""
    ref = ref.to(torch.float64)
    scale = float(ref.abs().max())
    err = (got.to(torch.float64) - ref).abs()
    ok = bool((err <= rel * ref.abs() + ACC_TOL * scale).all())
    results.append({"check": name, "max_err": float(err.max()),
                    "ref_max": scale, "rel_tol": rel,
                    "abs_tol": ACC_TOL * scale, **detail})
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version: {results[-1]}")


def _check_exact(name, got, ref, results, **detail):
    if got.dtype != ref.dtype or not torch.equal(got, ref):
        bad = int((got.to(torch.int64) != ref.to(torch.int64)).sum())
        raise AssertionError(f"{name}: {bad} elements differ from the plain "
                             f"version (must be exact)")
    results.append({"check": name, "max_err": 0, "tol": 0, **detail})


def check_shape(m, k, n, blocks, seed, results):
    dev = DEV
    tag = f"{m}x{k}x{n}"
    r = np.random.RandomState(seed)
    a32 = torch.from_numpy(r.randn(m, k).astype(np.float32)).to(dev)
    b32 = torch.from_numpy(r.randn(k, n).astype(np.float32)).to(dev)
    # float32: against an fp64 product — true fp32 products, no TF32
    got = mm.matmul(a32, b32, **blocks)
    _check_float(f"matmul f32 {tag}", got, a32.double() @ b32.double(), 0.0,
                 results)
    _check_float(f"matmul f32 vs plain {tag}", got, mm.matmul_plain(a32, b32),
                 0.0, results)
    for dt, ulp in ((torch.bfloat16, BF16_ULP), (torch.float16, F16_ULP)):
        a, b = a32.to(dt), b32.to(dt)
        short = str(dt).replace("torch.", "")
        got = mm.matmul(a, b, out_dtype=torch.float32, **blocks)
        _check_float(f"matmul {short}->f32 {tag}", got,
                     mm.matmul_plain(a, b, out_dtype=torch.float32), 0.0,
                     results)
        _check_float(f"matmul {short}->f32 vs fp64 {tag}", got,
                     a.double() @ b.double(), 0.0, results)
        got = mm.matmul(a, b, **blocks)           # narrow output
        assert got.dtype == dt
        _check_float(f"matmul {short}->{short} {tag}", got,
                     mm.matmul_plain(a, b), ulp, results)
    lo, hi = (-64, 64) if k <= 128 else (-128, 128)
    ai = torch.from_numpy(r.randint(lo, hi, (m, k)).astype(np.int8)).to(dev)
    bi = torch.from_numpy(r.randint(lo, hi, (k, n)).astype(np.int8)).to(dev)
    for kw in ({}, {"shift": 7}, {"shift": 7, "out_dtype": torch.int8}):
        got = mm.matmul_int8(ai, bi, **kw, **blocks)
        _check_exact(f"matmul_int8 {kw or 'int32'} {tag}", got,
                     mm.matmul_int8_plain(ai, bi, **kw), results)
    torch.cuda.synchronize()


def check_ragged_head(results):
    """The logits head at shapes the default blocks do not tile (200 rows;
    a vocabulary of 31900): on the card these too go through the kernels,
    one launch each, and agree with the plain pipeline on the same inputs."""
    m, k, n = PATH_SHAPE
    r = np.random.RandomState(8)
    w = torch.from_numpy(r.randn(k, n).astype(np.float32)).to(DEV) * 0.02
    for rows, cols in ((200, n), (8, 31900)):
        x = torch.from_numpy(r.randn(rows, 1, k).astype(np.float32)).to(DEV)
        wc = w[:, :cols].contiguous()
        tag = f"{rows}x{k}x{cols}"
        for dt in ("bfloat16", "float16", "int8"):
            assert ops.lm_head_route(rows, k, cols, dt, device=x.device) \
                == f"cuda-{dt}"
            assert ops.lm_head_route(rows, k, cols, dt) == "einsum-fallback"
        before = dict(mm.LAUNCHES)
        got = ops.lm_head(x, wc, compute_dtype="bfloat16")
        assert mm.LAUNCHES == {**before, "matmul": before["matmul"] + 1}
        _check_float(f"lm_head bfloat16 ragged {tag}", got[:, 0],
                     mm.matmul_plain(x[:, 0].bfloat16(), wc.bfloat16(),
                                     out_dtype=torch.float32), 0.0, results)
        before = dict(mm.LAUNCHES)
        got = ops.lm_head(x, wc, compute_dtype="int8")
        assert mm.LAUNCHES == {**before,
                               "matmul_int8": before["matmul_int8"] + 1}
        sx = x.abs().max() / 127.0 + 1e-8
        sw = wc.abs().max() / 127.0 + 1e-8
        qx = torch.round(x[:, 0] / sx).clamp(-127, 127).to(torch.int8)
        qw = torch.round(wc / sw).clamp(-127, 127).to(torch.int8)
        want = mm.matmul_int8_plain(qx, qw).float() * (sx * sw)
        if not torch.equal(got[:, 0], want):
            raise AssertionError(f"lm_head int8 ragged {tag}: differs from "
                                 f"the plain pipeline (must be exact)")
        results.append({"check": f"lm_head int8 ragged {tag}", "max_err": 0,
                        "tol": 0})
    torch.cuda.synchronize()


def phase_kernels():
    results: list = []
    check_ragged_head(results)
    check_shape(*PATH_SHAPE, {}, 0, results)
    check_shape(128, 128, 128, {}, 1, results)
    check_shape(32, 48, 64, {"bm": 16, "bn": 16, "bk": 16}, 2, results)
    check_shape(5, 77, 93, {}, 3, results)      # ragged: element-wise loads
    check_shape(16, 100, 80, {}, 4, results)    # ragged: part-filled tile
    check_shape(24, 4224, 256, {}, 5, results)  # several K chunks, 3 row tiles
    check_shape(8, 2627, 256, {"bk": 1}, 6, results)  # K chunks, ragged end

    # times at the serving shape
    m, k, n = PATH_SHAPE
    r = np.random.RandomState(7)
    a32 = torch.from_numpy(r.randn(m, k).astype(np.float32)).to(DEV)
    b32 = torch.from_numpy(r.randn(k, n).astype(np.float32)).to(DEV)
    timed = {}
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        a, b = a32.to(dt), b32.to(dt)
        short = str(dt).replace("torch.", "")
        bnd, by = bound_ms(m, k, n, a.element_size(), 4, PEAKS_FLOPS[short])
        timed[short] = {
            "ms": time_ms(lambda: mm.matmul(a, b, out_dtype=torch.float32)),
            "plain_ms": time_ms(lambda: mm.matmul_plain(
                a, b, out_dtype=torch.float32)),
            "library_ms": time_ms(lambda: torch.matmul(a, b)),
            "bound_ms": bnd, "bound_by": by}
    ai = torch.from_numpy(r.randint(-128, 128, (m, k)).astype(np.int8)).to(DEV)
    bi = torch.from_numpy(r.randint(-128, 128, (k, n)).astype(np.int8)).to(DEV)
    bnd, by = bound_ms(m, k, n, 1, 4, PEAKS_FLOPS["int8"])
    # torch._int_mm is the one library call for this function; it is only
    # a yardstick here, and it refuses some shapes (few rows): then null
    library_ms, library_note = None, None
    if hasattr(torch, "_int_mm"):
        try:
            torch._int_mm(ai, bi)
            library_ms = time_ms(lambda: torch._int_mm(ai, bi))
        except RuntimeError as e:
            library_note = str(e).splitlines()[0][:200]
    else:
        library_note = "this torch build has no _int_mm"
    timed["int8"] = {
        "ms": time_ms(lambda: mm.matmul_int8(ai, bi)),
        "plain_ms": time_ms(lambda: mm.matmul_int8_plain(ai, bi)),
        "library_ms": library_ms, "library_note": library_note,
        "bound_ms": bnd, "bound_by": by}
    # the whole logits head as the engine calls it: quantizes x AND the
    # whole unembedding on every call, then the kernel, then dequantizes
    x = a32.to(torch.bfloat16)[:, None, :]
    w = b32.to(torch.bfloat16)
    timed["lm_head_int8_ms"] = time_ms(
        lambda: ops.lm_head(x, w, compute_dtype="int8"))
    timed["lm_head_bfloat16_ms"] = time_ms(
        lambda: ops.lm_head(x, w, compute_dtype="bfloat16"))
    timed["plain_head_bfloat16_ms"] = time_ms(lambda: x @ w)
    emit("kernels", shape=list(PATH_SHAPE), checks=results, timed=timed)
    return results, timed


# ---------------------------------------------------------------------------
# phase 4: serve tinyllama-1.1b at full width and depth
# ---------------------------------------------------------------------------


def make_requests(cfg, rng, n, max_new):
    reqs = []
    for i in range(n):
        plen = int(rng.randint(32, 129))
        reqs.append(Request(
            uid=i, prompt=rng.randint(0, cfg.vocab_size,
                                      size=plen).astype(np.int32),
            max_new_tokens=max_new))
    return reqs


def phase_serve(cfg, params):
    # warm-up on a throw-away engine held at the int8 rung: first-call costs
    # (library handles, allocator growth) stay out of the timed run
    warm = ServingEngine(cfg, params, slots=8, max_seq=512, device=DEV,
                         degrade=DegradeLadder(bf16_at=0.0, int8_at=0.0))
    for r in make_requests(cfg, np.random.RandomState(1), 2, 4):
        warm.submit(r)
    warm.run_to_completion()
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    engine = ServingEngine(cfg, params, slots=8, max_seq=512, device=DEV,
                           degrade=DegradeLadder(bf16_at=1.0, int8_at=2.0))
    reqs = make_requests(cfg, np.random.RandomState(0), 16, 32)
    mm.reset_launches()            # the main path starts here
    t0 = time.perf_counter()
    for r in reqs:
        assert engine.submit(r) is None
    engine.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    assert all(r.state == State.DONE for r in reqs), \
        [(r.uid, r.state.value, r.finish_reason) for r in reqs]
    assert all(len(r.out_tokens) == 32 for r in reqs)
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens)
    assert not engine.events, engine.events
    assert not any(key.startswith("I_") for key in engine.counters)
    n_int8 = engine.counters["degraded_steps_int8"]
    assert n_int8 > 0, dict(engine.counters)
    assert mm.LAUNCHES["matmul_int8"] == n_int8, (mm.LAUNCHES, n_int8)

    new_tokens = sum(len(r.out_tokens) for r in reqs)
    decode = {k[len("decode_"):]: {"steps": c, "mean_ms": 1e3 * s / c}
              for k, (c, s) in engine.timers.items()
              if k.startswith("decode_")}
    prefill = {int(k[len("prefill_"):]): 1e3 * s / c
               for k, (c, s) in engine.timers.items()
               if k.startswith("prefill_")}
    emit("serve", arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
         vocab=cfg.vocab_size, compute_dtype=cfg.compute_dtype,
         param_bytes=tree_size_bytes(params), slots=8, max_seq=512,
         requests=len(reqs), new_tokens=new_tokens, wall_s=wall,
         tokens_per_s=new_tokens / wall, ticks=engine.tick,
         decode_steps=decode,
         prefill_ms_by_prompt_len=dict(sorted(prefill.items())),
         counters=dict(engine.counters),
         matmul_int8_launches=mm.LAUNCHES["matmul_int8"],
         head_route=ops.lm_head_route(8, cfg.d_model, cfg.vocab_size, "int8"),
         max_memory_allocated=torch.cuda.max_memory_allocated())


# ---------------------------------------------------------------------------
# phase 5: float32 against the full-forward oracle; the bf16 head route
# ---------------------------------------------------------------------------


@torch.inference_mode()
def oracle_tokens(cfg, params, prompt, n):
    """Greedy continuation by repeated full forward (no KV cache)."""
    toks = [int(t) for t in prompt]
    for _ in range(n):
        lg, _, _ = forward(cfg, params, torch.tensor([toks], device=DEV,
                                                     dtype=torch.int32))
        toks.append(int(torch.argmax(lg[0, -1])))
    return toks[len(prompt):]


EXACT_LAYERS = 4
DEPTHS = (1, 2, 4, 8, 16, 22)      # where the rounding drift is read
FP64_TOL = 1e-3                    # cached step against full forward, float64
WITNESS_FACTOR = 8.0               # cached fp32 error over the oracle's own
WITNESS_SLACK = 1e-5


def _cut(cfg, params, n_layers, dtype):
    """The first ``n_layers`` layers of the model, computing in ``dtype``."""
    return (dataclasses.replace(cfg, compute_dtype=dtype, n_layers=n_layers),
            dict(params, layers=tree_map(lambda a: a[:n_layers],
                                         params["layers"])))


def _cached_and_full(cfg, params, prompt, nxt=None):
    """Last-position logits over the same tokens, from the cached path and
    from the full forward: (prefill, full), (one decode step, full), and
    the token that was decoded: ``nxt`` (1,1), or the prefill's best."""
    dt = params["embed"].dtype
    toks = torch.tensor(prompt[None, :], device=DEV, dtype=torch.int32)
    cache = init_cache(cfg, 1, 512, cache_dtype=dt, device=DEV)
    lg_p, _, cache = forward(cfg, params, toks, cache=cache)
    full_p, _, _ = forward(cfg, params, toks)
    if nxt is None:
        nxt = torch.argmax(lg_p[:, -1:], dim=-1).to(torch.int32)
    lg_d, _, cache = forward(cfg, params, nxt, cache=cache)
    full_d, _, _ = forward(cfg, params, torch.cat([toks, nxt], dim=1))
    for lg in (lg_p, lg_d, full_p, full_d):
        assert lg.dtype == dt and torch.isfinite(lg).all()
    return (lg_p[0, -1], full_p[0, -1]), (lg_d[0, -1], full_d[0, -1]), nxt


def _gap(a, b):
    return float((a.double() - b.double()).abs().max())


def _greedy_cached(cfg, params, prompt, n):
    """Greedy continuation through the KV cache: prefill, then n-1 steps."""
    toks = torch.tensor(prompt[None, :], device=DEV, dtype=torch.int32)
    cache = init_cache(cfg, 1, 512, cache_dtype=params["embed"].dtype,
                       device=DEV)
    out = []
    for _ in range(n):
        lg, _, cache = forward(cfg, params, toks, cache=cache)
        toks = torch.argmax(lg[:, -1:], dim=-1).to(torch.int32)
        out.append(int(toks))
    return out


def full_depth_witness(cfg, params, prompts):
    """The cached decode path at full width and FULL depth, with float64 as
    the witness.

    A randomly initialised stack is chaotic: a rounding difference grows by
    orders of magnitude on the way up (``drift`` lines show it by depth), so
    that in float32 the cached step and the full forward, one function in
    two summation orders, end up further apart at 22 layers than the two
    best tokens are. The comparison that holds is made in float64, where the
    same code leaves room for that growth: cached and full logits within
    FP64_TOL and greedy tokens equal, at every depth up to the full one.
    The float32 runs are then held to the float64 full forward at every
    depth: the cached step may be no further from it than WITNESS_FACTOR
    times the float32 full forward is, the oracle's own rounding error
    (plus WITNESS_SLACK, a few float32 steps of the largest logit)."""
    params64 = tree_map(lambda a: a.double(), params)
    by_depth = []
    for n in DEPTHS:
        c32, p32 = _cut(cfg, params, n, "float32")
        c64, p64 = _cut(cfg, params64, n, "float64")
        (pc64, pf64), (dc64, df64), nxt = _cached_and_full(c64, p64,
                                                           prompts[0])
        # float32 decodes the token float64 chose: the same inputs throughout
        (pc32, pf32), (dc32, df32), _ = _cached_and_full(c32, p32, prompts[0],
                                                         nxt)
        row = {"n_layers": n,
               "fp32_cached_vs_full": [_gap(pc32, pf32), _gap(dc32, df32)],
               "fp64_cached_vs_full": [_gap(pc64, pf64), _gap(dc64, df64)],
               "fp32_full_vs_fp64": [_gap(pf32, pf64), _gap(df32, df64)],
               "fp32_cached_vs_fp64": [_gap(pc32, pf64), _gap(dc32, df64)],
               "logit_max": float(pf64.abs().max()),
               "top2_gap": float(torch.topk(df64, 2).values.diff().abs())}
        by_depth.append(row)
        emit("drift", **row)
    for row in by_depth:
        assert max(row["fp64_cached_vs_full"]) < FP64_TOL, row
        for cached, oracle in zip(row["fp32_cached_vs_fp64"],
                                  row["fp32_full_vs_fp64"]):
            assert cached <= WITNESS_FACTOR * oracle + WITNESS_SLACK, row
    assert by_depth[-1]["n_layers"] == cfg.n_layers
    c64, p64 = _cut(cfg, params64, cfg.n_layers, "float64")
    for prompt in prompts:
        got = _greedy_cached(c64, p64, prompt, 8)
        want = oracle_tokens(c64, p64, prompt, 8)
        assert got == want, (got, want)
    return by_depth


@torch.inference_mode()
def phase_serve_exact(cfg, params):
    """float32 at full width. The engine's tokens are held to the greedy
    full-forward oracle at ``EXACT_LAYERS`` layers, where float32 rounding
    cannot yet flip a token; the cached path at full depth is held by
    :func:`full_depth_witness`."""
    cfg32, cut = _cut(cfg, params, EXACT_LAYERS, "float32")
    engine = ServingEngine(cfg32, cut, slots=8, max_seq=512, degrade=None,
                           device=DEV)
    reqs = make_requests(cfg32, np.random.RandomState(2), 2, 8)
    for r in reqs:
        assert engine.submit(r) is None
    engine.run_to_completion()
    assert all(r.state == State.DONE for r in reqs)
    assert engine.counters["degraded_steps"] == 0 and not engine.events
    for r in reqs:
        want = oracle_tokens(cfg32, cut, r.prompt, 8)
        assert r.out_tokens == want, (r.uid, r.out_tokens, want)
    del engine

    # logits of the cached steps against the full forward's last position
    (pc, pf), (dc, df), _ = _cached_and_full(cfg32, cut, reqs[0].prompt)
    err_prefill, err_decode = _gap(pc, pf), _gap(dc, df)
    assert err_prefill < 1e-3 and err_decode < 1e-3, (err_prefill, err_decode)
    by_depth = full_depth_witness(cfg, params, [r.prompt for r in reqs])
    assert mm.LAUNCHES["matmul"] == 0     # float32 serving launches no kernel

    # the public bf16 logits-head route, which goes through `matmul`
    gen = torch.Generator(device=DEV).manual_seed(3)
    x = torch.randn((8, 1, cfg.d_model), generator=gen, device=DEV)
    w = params["unembed"]
    before = mm.LAUNCHES["matmul"]
    out = ops.lm_head(x, w, compute_dtype="bfloat16")
    ref = torch.einsum("bsd,dv->bsv", x, w)
    rel = float((out - ref).abs().max() / ref.abs().max())
    assert out.dtype == torch.float32 and out.shape == (8, 1, cfg.vocab_size)
    assert rel < 0.05, rel
    assert mm.LAUNCHES["matmul"] == before + 1, mm.LAUNCHES
    emit("serve_exact", n_layers=EXACT_LAYERS, requests=len(reqs),
         new_tokens=16, tokens_equal_oracle=True,
         logits_err_prefill=err_prefill, logits_err_decode=err_decode,
         logits_tol=1e-3, full_depth_layers=cfg.n_layers,
         fp64_tol=FP64_TOL, witness_factor=WITNESS_FACTOR,
         witness_slack=WITNESS_SLACK,
         fp64_tokens_equal_oracle=True,
         fp64_cached_vs_full=by_depth[-1]["fp64_cached_vs_full"],
         fp32_cached_vs_full=by_depth[-1]["fp32_cached_vs_full"],
         lm_head_bf16_route=ops.lm_head_route(8, cfg.d_model, cfg.vocab_size,
                                              "bfloat16"),
         lm_head_bf16_rel_err=rel, lm_head_bf16_tol=0.05,
         matmul_launches=mm.LAUNCHES["matmul"])


# ---------------------------------------------------------------------------


def kernels_line(results, timed, launches):
    def err_of(check):
        return next(r["max_err"] for r in results if r["check"] == check)
    tag = "x".join(map(str, PATH_SHAPE))
    bf16, int8 = timed["bfloat16"], timed["int8"]
    rows = [
        {"name": "matmul", "route": "cuda", "source": SOURCE,
         "replaces": "src/repro/kernels/matmul.py:74",
         "launches": launches["matmul"],
         "max_abs_err": err_of(f"matmul bfloat16->f32 {tag}"),
         "ms": bf16["ms"], "plain_ms": bf16["plain_ms"],
         "bound_ms": bf16["bound_ms"], "bound_by": bf16["bound_by"],
         "library_ms": bf16["library_ms"], "shape": list(PATH_SHAPE),
         "dtype": "bfloat16->float32"},
        {"name": "matmul_int8", "route": "cuda", "source": SOURCE,
         "replaces": "src/repro/kernels/matmul.py:137",
         "launches": launches["matmul_int8"],
         "max_abs_err": err_of(f"matmul_int8 int32 {tag}"),
         "ms": int8["ms"], "plain_ms": int8["plain_ms"],
         "bound_ms": int8["bound_ms"], "bound_by": int8["bound_by"],
         "library_ms": int8["library_ms"], "shape": list(PATH_SHAPE),
         "dtype": "int8->int32"},
    ]
    for row in rows:
        if row["launches"] < 1:
            raise AssertionError(f"the main path never launched "
                                 f"{row['name']}: {launches}")
    return {"kernels": rows}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = phase_env()
    phase_build()
    results, timed = phase_kernels()

    cfg = get_config("tinyllama-1.1b")
    gen = torch.Generator(device=DEV).manual_seed(0)
    params = init_params(model_template(cfg), gen, device=DEV)
    phase_serve(cfg, params)          # sets the launch counts to 0 first
    phase_serve_exact(cfg, params)
    launches = dict(mm.LAUNCHES)      # read right after the main path
    torch.cuda.synchronize()

    print(json.dumps(kernels_line(results, timed, launches)), flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
