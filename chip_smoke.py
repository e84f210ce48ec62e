#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Needs a CUDA device, ``nvcc`` and nothing else: it builds the kernels from
``src/repro_torch/kernels/csrc``, serves randomly initialised tinyllama-1.1b
at full width and full depth, and trains it at full width and depth for a
few steps. Without a CUDA device, or in a directory that lacks the package,
it exits non-zero and prints no result. Phases, one JSON line each:

1. ``env``     the card's name and power limit, torch / CUDA / nvcc versions.
2. ``build``   compiles the kernels (seconds, registers and spills per kernel).
3. ``kernels`` every kernel against its plain PyTorch version on the card,
               at the serving shape (8,2048)@(2048,32000), at 128^3, at a
               small shape with 16-wide blocks and at ragged shapes, and the
               logits head at shapes its default blocks do not tile; then
               times kernel, plain version and library call.
4. ``attention`` the three blockwise-attention kernels (forward, dQ,
               dK/dV) against their plain versions on the card: at the
               training shape (B 4, H 32, S 2048, D 64, bf16, causal), at
               the ragged and small-block shapes of the CPU tests, with
               fully dead rows, in float32, bfloat16, float16 and float64;
               the public autograd path against the CPU's; then times
               kernels, plain versions, bounds and
               ``F.scaled_dot_product_attention`` as a yardstick.
5. ``serve``   tinyllama-1.1b, 8 slots, 16 requests, degrade ladder down to
               the int8 logits head; checks states, tokens, events and that
               the int8 kernel was launched once per int8 step.
6. ``serve_exact`` the same model in float32, depth cut to 4 layers, against
               a greedy full-forward oracle (tokens equal, logits within
               1e-3); the cached decode path at full depth against the full
               forward in float64 (logits within 1e-3, tokens equal), with
               the float32 runs held to that witness; and the bf16
               logits-head route through ``matmul``. The full forward (no
               cache) goes through the attention kernel here.
7. ``train``   tinyllama-1.1b unreduced (bf16 compute, fp32 parameters,
               ``remat="full"``), batch 4 x 2048 of ``SyntheticLM``, 4 steps
               of the port's train step through the attention kernels:
               loss, grad norm, learning rate, changed parameters and the
               exact launch counts per step (2L forward, L dQ, L dK/dV).
8. ``train_exact`` one train step's loss and gradients, kernel route
               against the route forced off: at full width and 2 layers in
               float32, and at full width and depth in float64.

Then one line ``{"kernels": [...]}`` (launch counts of the serving phases
5 and 6 for the matmul kernels and of phase 7 for the attention kernels,
error, times and bound per kernel), one line with the card's name and power
limit, and as the last line ``{"ok": true, "device": {...}}``. Any failed
check raises: nothing is caught and passed over.
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
from repro_torch.data.pipeline import (DataConfig, SyntheticLM,  # noqa: E402
                                       to_device)
from repro_torch.kernels import attention as att  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import matmul as mm  # noqa: E402
from repro_torch.models.layers import (init_params, tree_leaves,  # noqa: E402
                                       tree_map, tree_size_bytes,
                                       value_and_grad)
from repro_torch.models.transformer import (forward, init_cache,  # noqa: E402
                                            lm_loss, model_template)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402
from repro_torch.serving import (DegradeLadder, Request,  # noqa: E402
                                 ServingEngine, State)

PATH_SHAPE = (8, 2048, 32000)      # (slots, d_model, vocab) of tinyllama-1.1b
SOURCE = "src/repro_torch/kernels/csrc/matmul.cu"
TRAIN_ATT = (4, 32, 2048, 64)      # (batch, heads, seq, head_dim) in training
ATT_SOURCE = "src/repro_torch/kernels/csrc/attention.cu"
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


def _check_float(name, got, ref, rel, results, acc=ACC_TOL, **detail):
    """|got - ref| <= rel * |ref| + acc * max|ref| elementwise.

    Both sides multiply the same operands exactly and accumulate in fp32, so
    they differ by summation order only: ACC_TOL of the largest result
    (readings are 6e-8 to 1.3e-6 of it). A dropped k row or a wrongly
    unpacked lane moves a result by about 1/sqrt(K) of the scale, hundreds
    of times the allowance. ``rel`` is for a narrow output alone, where the two fp32
    sums may round to neighbouring narrow values: one step of that type."""
    ref = ref.to(torch.float64)
    scale = float(ref.abs().max())
    err = (got.to(torch.float64) - ref).abs()
    ok = bool((err <= rel * ref.abs() + acc * scale).all())
    results.append({"check": name, "max_err": float(err.max()),
                    "ref_max": scale, "rel_tol": rel,
                    "abs_tol": acc * scale, **detail})
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
# phase 4: the attention kernels against their plain versions, on the card
# ---------------------------------------------------------------------------


# Tolerances of a kernel against its plain version on the same inputs, as
# (rel, share of max|ref|). float32: summation order only (ACC_TOL).
# bfloat16 / float16: the outputs are narrow, and p (forward; dK/dV) and ds
# (backward) are rounded to the narrow type from fp32 values that the two
# sides compute in different summation orders, so a rounding may fall on
# either side of a tie: one step of the output type, relative to the value
# and to the largest value. float64: 1e-12 of the largest value.
ATT_TOL = {torch.float32: (0.0, ACC_TOL),
           torch.bfloat16: (BF16_ULP, BF16_ULP / 2),
           torch.float16: (F16_ULP, F16_ULP / 2),
           torch.float64: (0.0, 1e-12)}


def _att_inputs(b, h, sq, sk, d, dtype, seed, p_valid=1.0, dead=False):
    gen = torch.Generator(device=DEV).manual_seed(seed)
    q, k, v = (torch.randn((b, h, s_, d), generator=gen, device=DEV,
                           dtype=torch.float64).to(dtype)
               for s_ in (sq, sk, sk))
    kv_valid = torch.rand((b, sk), generator=gen, device=DEV) < p_valid
    if dead:
        kv_valid[0] = False                   # batch 0: every row dead
    dout = torch.randn((b, h, sq, d), generator=gen, device=DEV,
                       dtype=torch.float64).to(dtype)
    return q, k, v, kv_valid, dout


def check_attention(tag, b, h, sq, sk, d, dtype, causal, bq, bk, seed,
                    results, p_valid=0.9, dead=False):
    """Forward, dQ and dK/dV kernels against their plain versions on the
    same padded, flattened operands; the probe exactly. Returns the
    operands and the kernels' outputs."""
    q, k, v, kv_valid, dout = _att_inputs(b, h, sq, sk, d, dtype, seed,
                                          p_valid, dead)
    qf, kf, vf, kvm, bq, bk = att._prepare(q, k, v, kv_valid, bq, bk)
    geom = dict(causal=causal, bq=bq, bk=bk)
    out, lse, probe = att.flash_fwd(qf, kf, vf, kvm, **geom)
    p_out, p_lse, p_probe = att.flash_fwd_plain(qf, kf, vf, kvm, **geom)
    torch.cuda.synchronize()
    rel, acc = ATT_TOL[dtype]
    short = str(dtype).replace("torch.", "")
    name = f"{tag} {short}{' causal' if causal else ''}"
    assert out.dtype == dtype and lse.dtype == p_lse.dtype
    _check_float(f"flash_fwd out {name}", out, p_out, rel, results, acc)
    dead_rows = p_lse <= att.NEG_INF * 0.5
    if not torch.equal(lse <= att.NEG_INF * 0.5, dead_rows):
        raise AssertionError(f"flash_fwd lse {name}: dead rows differ")
    # lse is fp32 (fp64) whatever the operands: summation order only
    lse_acc = 1e-12 if dtype == torch.float64 else ACC_TOL
    _check_float(f"flash_fwd lse {name}", lse[~dead_rows], p_lse[~dead_rows],
                 0.0, results, lse_acc)
    _check_exact(f"flash_fwd probe {name}", probe, p_probe, results)
    doutf = torch.nn.functional.pad(
        dout, (0, 0, 0, qf.shape[1] - sq)).reshape(qf.shape).contiguous()
    delta = (doutf.to(p_lse.dtype) * p_out.to(p_lse.dtype)).sum(-1)
    args = (qf, kf, vf, kvm, doutf, p_lse, delta)
    dq = att.flash_bwd_dq(*args, **geom)
    dk, dv = att.flash_bwd_dkv(*args, **geom)
    torch.cuda.synchronize()
    _check_float(f"flash_bwd_dq {name}", dq,
                 att.flash_bwd_dq_plain(*args, **geom), rel, results, acc)
    p_dk, p_dv = att.flash_bwd_dkv_plain(*args, **geom)
    _check_float(f"flash_bwd_dkv dk {name}", dk, p_dk, rel, results, acc)
    _check_float(f"flash_bwd_dkv dv {name}", dv, p_dv, rel, results, acc)
    if dead:
        g0 = h                              # batch 0 holds groups 0..h-1
        for what, t in (("out", out), ("dq", dq), ("dk", dk), ("dv", dv)):
            if float(t[:g0].abs().max()) != 0.0:
                raise AssertionError(f"{name}: dead rows give non-zero {what}")
        results.append({"check": f"dead rows zero {name}", "max_err": 0,
                        "tol": 0})
    return dict(q=q, k=k, v=v, kv_valid=kv_valid, dout=dout, qf=qf, kf=kf,
                vf=vf, kvm=kvm, doutf=doutf, lse=lse, delta=delta, geom=geom,
                probe=probe, n=(qf.shape[1] // bq))


def check_attention_autograd(results):
    """The public path with autograd (padding, flattening, the Function's
    backward) on the card against the same on CPU tensors, where the plain
    versions run: out and the three grads, fp32 and fp64."""
    for dtype in (torch.float32, torch.float64):
        q, k, v, kv_valid, dout = _att_inputs(2, 2, 45, 45, 16, dtype, 31,
                                              p_valid=0.9)
        got, want = [], []
        for dev, dst in ((DEV, got), ("cpu", want)):
            args = [t.detach().to(dev).requires_grad_(True)
                    for t in (q, k, v)]
            o = att.flash_attention(*args, kv_valid=kv_valid.to(dev),
                                    causal=True, bq=16, bk=8)
            dst.extend([o, *torch.autograd.grad(o, args, dout.to(dev))])
        short = str(dtype).replace("torch.", "")
        rel, acc = ATT_TOL[dtype]
        for what, a, b_ in zip(("out", "dq", "dk", "dv"), got, want):
            _check_float(f"flash_attention autograd {what} {short}",
                         a.detach(), b_.detach().to(DEV), rel, results, acc)


def att_bound(op: str, b, h, s, d, elt: int):
    """Least time for one causal call at (b, h, s, d): the bytes of its
    inputs and outputs once over the memory rate, or its products over the
    bf16 tensor-core peak — the products of the causal triangle this input
    needs (S(S+1)/2 pairs per head): forward q.k and p.v, dQ q.k, dO.v and
    ds.k, dK/dV those two plus p.dO and ds.q, each 2*D operations a pair."""
    g, pairs = b * h, s * (s + 1) / 2
    mat = g * s * d * elt                       # one (G,S,D) operand
    vec = g * s * 4                             # one (G,S) fp32 row vector
    n_in, n_out, n_vec, n_prod = {
        "flash_fwd": (3, 1, 3, 2),              # q k v | out | kvm, lse, probe
        "flash_bwd_dq": (4, 1, 3, 3),           # q k v dO | dq | kvm lse delta
        "flash_bwd_dkv": (4, 2, 3, 4)}[op]
    t_bytes = ((n_in + n_out) * mat + n_vec * vec) / PEAK_BYTES_PER_S
    t_ops = n_prod * 2 * d * g * pairs / PEAKS_FLOPS["bfloat16"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_attention():
    results: list = []
    b, h, s, d = TRAIN_ATT
    ops_ = check_attention("train", b, h, s, s, d, torch.bfloat16, True,
                           128, 128, 10, results, p_valid=1.0)
    n = ops_["n"]
    if int(ops_["probe"].sum()) != b * h * n * (n + 1) // 2:
        raise AssertionError("causal probe does not sum to G*n(n+1)/2")
    for dtype in (torch.float32, torch.bfloat16, torch.float64):
        for i, (sq, sk, bq, bk, causal) in enumerate((
                (64, 64, 16, 16, True), (64, 64, 16, 16, False),
                (48, 80, 16, 16, False), (33, 33, 16, 8, True),
                (33, 33, 16, 8, False), (130, 70, 32, 32, False),
                (7, 128, 32, 32, False), (20, 20, 32, 32, True))):
            check_attention(f"{sq}x{sk} b{bq}x{bk}", 2, 2, sq, sk, 16, dtype,
                            causal, bq, bk, 20 + i, results)
        check_attention("dead 32x32 b8x8", 2, 2, 32, 32, 8, dtype, False, 8,
                        8, 30, results, dead=True)
        check_attention("d128 256x256 b128x64", 1, 2, 256, 256, 128, dtype,
                        True, 128, 64, 31, results)
    check_attention("f16 256x256 b32x128", 1, 2, 256, 256, 64,
                    torch.float16, True, 32, 128, 32, results)
    check_attention("train f32", 1, 4, s, s, d, torch.float32, True, 128, 128,
                    33, results, p_valid=1.0)
    check_attention_autograd(results)

    # times at the training shape
    qf, kf, vf, kvm = (ops_[x] for x in ("qf", "kf", "vf", "kvm"))
    bwd = (qf, kf, vf, kvm, ops_["doutf"], ops_["lse"], ops_["delta"])
    geom = ops_["geom"]
    heavy = dict(warmup=2, reps=5, inner=3)
    timed = {
        "flash_fwd": {
            "ms": time_ms(lambda: att.flash_fwd(qf, kf, vf, kvm, **geom)),
            "plain_ms": time_ms(lambda: att.flash_fwd_plain(
                qf, kf, vf, kvm, **geom), **heavy)},
        "flash_bwd_dq": {
            "ms": time_ms(lambda: att.flash_bwd_dq(*bwd, **geom)),
            "plain_ms": time_ms(lambda: att.flash_bwd_dq_plain(*bwd, **geom),
                                **heavy)},
        "flash_bwd_dkv": {
            "ms": time_ms(lambda: att.flash_bwd_dkv(*bwd, **geom)),
            "plain_ms": time_ms(lambda: att.flash_bwd_dkv_plain(
                *bwd, **geom), **heavy)},
    }
    # the library's fused attention, a yardstick only: its forward, and its
    # backward, which yields dQ, dK and dV together
    q4, k4, v4 = (ops_[x].detach().requires_grad_(True) for x in "qkv")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_fwd = time_ms(lambda: sdpa(q4, k4, v4, is_causal=True))
    o4 = sdpa(q4, k4, v4, is_causal=True)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        o4, (q4, k4, v4), ops_["dout"], retain_graph=True))
    for name, lib in (("flash_fwd", lib_fwd), ("flash_bwd_dq", lib_bwd),
                      ("flash_bwd_dkv", lib_bwd)):
        bnd, by = att_bound(name, b, h, s, d, 2)
        timed[name].update(bound_ms=bnd, bound_by=by, library_ms=lib)
    timed["library_note"] = ("F.scaled_dot_product_attention(is_causal=True)"
                             " on (4,32,2048,64) bf16: forward, and its "
                             "backward (dQ, dK, dV together) for both "
                             "backward rows")
    emit("attention", shape=list(TRAIN_ATT), dtype="bfloat16", causal=True,
         blocks=[geom["bq"], geom["bk"]], n_checks=len(results),
         checks=results, timed=timed)
    return results, timed


# ---------------------------------------------------------------------------
# phase 5: serve tinyllama-1.1b at full width and depth
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
# phase 6: float32 against the full-forward oracle; the bf16 head route
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
# phase 7: train tinyllama-1.1b at full width and depth
# ---------------------------------------------------------------------------


TRAIN_STEPS = 4
TRAIN_BATCH, TRAIN_SEQ = 4, 2048   # TinyLlama's context length


def _train_cfgs():
    """The model as configured (fp32 parameters, bf16 compute, full remat,
    attention route "auto" = the kernels on the card) and the optimizer as
    ``launch/train.py`` builds it for this many steps."""
    cfg = get_config("tinyllama-1.1b")
    assert (cfg.param_dtype, cfg.compute_dtype, cfg.remat, cfg.attn_flash) \
        == ("float32", "bfloat16", "full", "auto"), cfg
    opt = adamw.OptConfig(peak_lr=3e-4, warmup_steps=max(TRAIN_STEPS // 10, 1),
                          decay_steps=TRAIN_STEPS)
    return cfg, opt


def phase_train(att_timed):
    cfg, opt = _train_cfgs()
    L = cfg.n_layers
    gen = torch.Generator(device=DEV).manual_seed(0)
    params = init_params(model_template(cfg), gen, dtype=cfg.param_dtype,
                         device=DEV)
    state = {"params": params, "opt": adamw.init(opt, params)}
    step_fn = make_train_step(cfg, opt).step_fn
    source = SyntheticLM(DataConfig(seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH,
                                    vocab_size=cfg.vocab_size, seed=0))
    batches = [to_device(source.batch(i), DEV) for i in range(TRAIN_STEPS)]
    probe = {"embed": params["embed"][:4, :8].clone(),
             "wq": params["layers"]["attn"]["wq"][L - 1, :8, 0, :8].clone()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    att.reset_launches()           # the training path starts here
    rows, per_step = [], []
    for i, batch in enumerate(batches):
        before = dict(att.LAUNCHES)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        m = {k: float(v) for k, v in metrics.items()}
        counts = {k: att.LAUNCHES[k] - before[k] for k in att.LAUNCHES}
        per_step.append(counts)
        rows.append({"step": i + 1, "ms": ms, **m, "launches": counts})
        emit("train_step", **rows[-1])
    launches = dict(att.LAUNCHES)  # read right after the training path
    peak = torch.cuda.max_memory_allocated()

    want = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
    for counts in per_step:
        assert counts == want, (counts, want)
    for r in rows:
        assert np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]), r
        assert r["grad_norm"] > 0, r
        lr = float(adamw.schedule(opt, r["step"]))
        assert r["lr"] == lr, (r["lr"], lr)
    assert abs(rows[0]["loss"] - np.log(cfg.vocab_size)) < 1.0, rows[0]
    assert len({r["loss"] for r in rows}) == len(rows), rows
    p = state["params"]
    assert not torch.equal(p["embed"][:4, :8], probe["embed"])
    assert not torch.equal(p["layers"]["attn"]["wq"][L - 1, :8, 0, :8],
                           probe["wq"])
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(p))

    steady = [r["ms"] for r in rows[1:]]    # the first step is the warm-up
    step_ms = statistics.mean(steady)
    kernel_ms = sum(want[k] * att_timed[k]["ms"] for k in want)
    emit("train", arch=cfg.name, n_layers=L, d_model=cfg.d_model,
         batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, steps=TRAIN_STEPS,
         param_dtype=cfg.param_dtype, compute_dtype=cfg.compute_dtype,
         remat=cfg.remat, losses=[r["loss"] for r in rows],
         step_ms=[r["ms"] for r in rows], steady_step_ms=step_ms,
         tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
         launches_per_step=want, launches_total=launches,
         attention_kernels_ms_per_step=kernel_ms,
         attention_kernels_share=kernel_ms / step_ms,
         max_memory_allocated=peak)
    return launches


# ---------------------------------------------------------------------------
# phase 8: one train step, kernel route against the route forced off
# ---------------------------------------------------------------------------


FP32_LOSS_TOL = 1e-5   # fp32, 2 layers: summation order only
FP32_GRAD_TOL = 1e-4   # ... of max|grad| of each parameter
# float64 at the configured init: the reference's init law takes the fan-in
# of a (d, heads, head_dim) projection from the heads axis (wk, wv std 0.5,
# wq 0.18, wo 0.125, where 1/sqrt(2048) = 0.022 would be the model width's),
# so the random stack is chaotic: the serving witness (phase serve_exact)
# reads 6e-4 between two summation orders of the float64 forward at 22
# layers, and the gradient norm at init is ~1e16. The loss is held to the
# witness's own limit (FP64_TOL) at every depth; the gradients only at 2
# layers, where float64 still resolves them; deeper, their gap is printed.
FP64_GRAD_TOL = 1e-9
TRAIN_DEPTHS = (2, 8, 22)
# float64 at full depth with the attention projections rescaled to the
# model width's fan-in (1/sqrt(2048)), a stack that is not chaotic: loss
# and gradients must then agree as float64 rounding allows, with ~1e10
# room for amplification over 22 layers
CONDITIONED_TOL = 1e-6


def _loss_and_grads(cfg, params, batch, flash):
    cfg = dataclasses.replace(cfg, attn_flash=flash)
    before = dict(att.LAUNCHES)
    (loss, _), grads = value_and_grad(
        lambda p, b: lm_loss(cfg, p, b))(params, batch)
    torch.cuda.synchronize()
    return loss, grads, {k: att.LAUNCHES[k] - before[k] for k in before}


def _route_gap(cfg, params, batch):
    """Loss and gradients on the kernel route ("auto" on the card) and on
    the route forced off; the kernel route's launch counts are exact.
    Returns the loss gap and the largest gradient gap as a share of
    max|grad| of its parameter."""
    l_on, g_on, n_on = _loss_and_grads(cfg, params, batch, "auto")
    l_off, g_off, n_off = _loss_and_grads(cfg, params, batch, "off")
    L = cfg.n_layers
    assert n_on == {"flash_fwd": 2 * L, "flash_bwd_dq": L,
                    "flash_bwd_dkv": L}, n_on
    assert not any(n_off.values()), n_off
    worst = 0.0
    for a, b_ in zip(tree_leaves(g_on), tree_leaves(g_off)):
        assert a.dtype == b_.dtype and bool(torch.isfinite(a).all())
        scale = float(b_.abs().max())
        worst = max(worst, float((a - b_).abs().max()) / max(scale, 1e-30))
    gnorm = float(torch.sqrt(sum((g.double() ** 2).sum()
                                 for g in tree_leaves(g_off))))
    return {"n_layers": L, "loss": float(l_on),
            "loss_gap": abs(float(l_on) - float(l_off)),
            "grad_gap_of_max": worst, "grad_norm": gnorm}


def _conditioned(params, cfg):
    """The same parameters with the attention projections rescaled to the
    model width's fan-in, 1/sqrt(d_model), instead of the init law's
    1/sqrt(heads) (wq, wk, wv) and 1/sqrt(head_dim) (wo)."""
    attn = params["layers"]["attn"]
    d = cfg.d_model
    scaled = {k: w * (w.shape[-2] / d) ** 0.5 if k != "wo"
              else w * (w.shape[-2] / (w.shape[-3] * w.shape[-2])) ** 0.5
              for k, w in attn.items()}
    layers = dict(params["layers"], attn=scaled)
    return dict(params, layers=layers)


def phase_train_exact():
    cfg, _ = _train_cfgs()
    source = SyntheticLM(DataConfig(seq_len=256, global_batch=2,
                                    vocab_size=cfg.vocab_size, seed=1))
    batch = to_device(source.batch(0), DEV)
    c32 = dataclasses.replace(cfg, n_layers=2, compute_dtype="float32")
    gen = torch.Generator(device=DEV).manual_seed(1)
    p32 = init_params(model_template(c32), gen, device=DEV)
    fp32 = _route_gap(c32, p32, batch)
    del p32
    assert fp32["loss_gap"] <= FP32_LOSS_TOL, fp32
    assert fp32["grad_gap_of_max"] <= FP32_GRAD_TOL, fp32

    c64 = dataclasses.replace(cfg, param_dtype="float64",
                              compute_dtype="float64")
    p64 = init_params(model_template(c64), gen, dtype="float64", device=DEV)
    short = {k: v[:1, :128] for k, v in batch.items()}
    by_depth = []
    for n in TRAIN_DEPTHS:
        cn, pn = _cut(c64, p64, n, "float64")
        row = _route_gap(cn, pn, short)
        by_depth.append(row)
        emit("train_drift", init="configured", **row)
    cond = _route_gap(c64, _conditioned(p64, c64), short)
    emit("train_drift", init="conditioned", **cond)
    del p64
    for row in by_depth:
        assert row["loss_gap"] <= FP64_TOL, row
    assert by_depth[0]["grad_gap_of_max"] <= FP64_GRAD_TOL, by_depth[0]
    assert by_depth[-1]["n_layers"] == cfg.n_layers
    assert cond["loss_gap"] <= CONDITIONED_TOL, cond
    assert cond["grad_gap_of_max"] <= CONDITIONED_TOL, cond
    emit("train_exact", fp32={"batch": [2, 256], **fp32,
                              "loss_tol": FP32_LOSS_TOL,
                              "grad_tol": FP32_GRAD_TOL},
         fp64_configured=by_depth, fp64_loss_tol=FP64_TOL,
         fp64_grad_tol_2_layers=FP64_GRAD_TOL,
         fp64_conditioned={"batch": [1, 128], **cond,
                           "tol": CONDITIONED_TOL})


# ---------------------------------------------------------------------------


def kernels_line(results, timed, launches, att_results, att_timed,
                 att_launches):
    def err_of(check, res=results):
        return next(r["max_err"] for r in res if r["check"] == check)
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
    checks = {"flash_fwd": "flash_fwd out train bfloat16 causal",
              "flash_bwd_dq": "flash_bwd_dq train bfloat16 causal",
              "flash_bwd_dkv": "flash_bwd_dkv dk train bfloat16 causal"}
    replaces = {"flash_fwd": "src/repro/kernels/attention.py:131",
                "flash_bwd_dq": "src/repro/kernels/attention.py:276",
                "flash_bwd_dkv": "src/repro/kernels/attention.py:293"}
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        t = att_timed[name]
        err = err_of(checks[name], att_results)
        if name == "flash_bwd_dkv":
            err = max(err, err_of("flash_bwd_dkv dv train bfloat16 causal",
                                  att_results))
        rows.append({"name": name, "route": "cuda", "source": ATT_SOURCE,
                     "replaces": replaces[name],
                     "launches": att_launches[name], "max_abs_err": err,
                     "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"], "shape": list(TRAIN_ATT),
                     "dtype": "bfloat16, causal"})
    for row in rows:
        if row["launches"] < 1:
            raise AssertionError(f"the main path never launched "
                                 f"{row['name']}: {launches} {att_launches}")
    return {"kernels": rows}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = phase_env()
    phase_build()
    results, timed = phase_kernels()
    att_results, att_timed = phase_attention()

    cfg = get_config("tinyllama-1.1b")
    gen = torch.Generator(device=DEV).manual_seed(0)
    params = init_params(model_template(cfg), gen, device=DEV)
    phase_serve(cfg, params)          # sets the matmul counts to 0 first
    phase_serve_exact(cfg, params)
    launches = dict(mm.LAUNCHES)      # read right after the serving path
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    att_launches = phase_train(att_timed)   # sets its counts to 0 first
    torch.cuda.empty_cache()
    phase_train_exact()
    torch.cuda.synchronize()

    print(json.dumps(kernels_line(results, timed, launches, att_results,
                                  att_timed, att_launches)), flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
