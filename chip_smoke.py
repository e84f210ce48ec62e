#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Needs a CUDA device, ``nvcc`` and nothing else: it builds the kernels from
``src/repro_torch/kernels/csrc``, serves randomly initialised tinyllama-1.1b
at full width and full depth, trains it at full width and depth for a few
steps, runs the paper's kernels and the scan kernel at their real shapes,
serves zamba2-7b and xlstm-1.3b, granite-moe-3b-a800m, deepseek-v3-671b
(MLA, depth cut), llama-3.2-vision-11b (one group) and seamless-m4t-medium
at full width, runs the Ara vector engine (one lane, lane-partitioned
and clustered) on the differential grid and the paper's Listing-1 matmul,
and runs the fault-tolerance slice: the serving fault registry and its
load gate on tinyllama-1.1b, and training that checkpoints and resumes.
Without
a CUDA device, or in a directory that lacks the package, it exits
non-zero and prints no result. Phases, one JSON line each:

1. ``env``     the card's name and power limit, torch / CUDA / nvcc versions.
2. ``build``   compiles the kernels (seconds, registers and spills per kernel).
3. ``kernels`` every kernel against its plain PyTorch version on the card,
               at the serving shape (8,2048)@(2048,32000), at 128^3, at a
               small shape with 16-wide blocks and at ragged shapes, at the
               paper's 256^3 and 512^3, at (129,77,93), at M = 16 and 17
               (the skinny / tiled boundary) and at tinyllama-1.1b's MLP
               projection (8192,2048)@(2048,5632), bf16 and f32 (fp64
               references), and the logits head at shapes its default
               blocks do not tile; ``matmul_int8`` exact (int32, shift 7,
               saturated int8) at each of those shapes and at the two SSM
               models' int8 heads and the projection; asserts that all
               four matmul routes (``kernels.matmul.kernel_route``) and
               both int8 routes (``kernel_route_int8``) ran; then times
               kernel, plain version and ``torch.matmul`` at the head
               shape, 256^3, 512^3 and the projection, and ``matmul_int8``
               beside ``torch._int_mm`` (or its refusal) at the three int8
               heads, 256^3, 512^3 and the projection, each with its route.
4. ``attention`` the three blockwise-attention kernels (forward, dQ,
               dK/dV) against their plain versions on the card: at the
               training shape (B 4, H 32, S 2048, D 64, bf16, causal), at
               the ragged and small-block shapes of the CPU tests, with
               fully dead rows, in float32, bfloat16, float16 and float64;
               at zamba2-7b's serving-oracle shape (1, 32, 136, head_dim
               112) in float32 and bfloat16; the public autograd path
               against the CPU's; bfloat16 at (2,8,2048,64) with a dead
               batch, at (1,4,2048,64) with blocks 128 x 64 and at
               (1,4,1024,128), float16 at (1,4,2048,64), where the
               tensor-core tiles split differently, and at
               head_dim 45 (staged element by element); two
               launches of each kernel bit-equal; then times
               kernels, plain versions, bounds and
               ``F.scaled_dot_product_attention`` as a yardstick, and the
               forward at zamba2-7b's oracle shape. A line
               ``attention_ptxas`` before it gives the registers and spills
               of every specialisation of the three kernels (none may
               spill on the tensor cores at 64 head columns).
5. ``serve``   tinyllama-1.1b, 8 slots, 16 requests, degrade ladder down to
               the int8 logits head; checks states, tokens, events and that
               the int8 kernel was launched once per int8 step.
6. ``serve_exact`` the same model in float32, depth cut to 4 layers, against
               a greedy full-forward oracle (tokens equal, logits within
               1e-3); the cached decode path at full depth against the full
               forward in float64 (logits within 1e-3, tokens equal), with
               the float32 runs held to that witness; and the bf16
               logits-head route through ``matmul``. The full forward (no
               cache) goes through the attention kernel here; the oracle's
               launches of it are counted from 0.
7. ``train``   tinyllama-1.1b unreduced (bf16 compute, fp32 parameters,
               ``remat="full"``), batch 4 x 2048 of ``SyntheticLM``, 4 steps
               of the port's train step through the attention kernels:
               loss, grad norm, learning rate, changed parameters and the
               exact launch counts per step (2L forward, L dQ, L dK/dV).
8. ``train_exact`` one train step's loss and gradients, kernel route
               against the route forced off: at full width and 2 layers in
               float32, and at full width and depth in float64.
9. ``paper_kernels`` the paper's DAXPY (float64, n 256; float32, n 2^26)
               and DCONV (GoogLeNet layer 1, float32 and bf16 -> f32
               through a Policy) through ``ops.axpy`` / ``ops.conv2d``,
               their launches counted; every case against the plain
               version (bf16 at 2^26, the benchmark's 2^20, an lmul 8
               case, unaligned addresses, float64 and bf16 convolutions,
               the CPU tests' shapes, GoogLeNet's 3x3 layer, 3x3 at 256
               and 512 channels); every
               convolution bit-equal to its plain version, with the
               kernel route it took (compile-time taps or general); the
               contract's ValueErrors on CUDA tensors; times: ``axpy``
               against ``torch.add(y, x, alpha=a)`` in five alternating
               turns at each size, the convolutions against ``F.conv2d``
               with cuDNN's TF32 off.
10. ``ssm_kernel`` ``ops.ssm_scan`` at one layer of zamba2-7b (BH 448, S
               2048, N 64, P 64, chunk 256) and of xlstm-1.3b (BH 16, N
               512, P 1025), float32 and bfloat16, against its plain
               version and the model's ``chunked_linear_attention``; the
               benchmark's shape, S equal to and below the chunk, ragged
               N and P, float64, N 2048 at chunk 256, a chunk of 1024;
               ``S % chunk != 0`` and a chunk past the block's shared
               memory raise; times at both layers in float32 and bfloat16
               (no library call computes this function).
11. ``serve_ssm`` zamba2-7b unreduced (81 layers, d_model 3584) on 8 slots
               with 16 requests, and xlstm-1.3b unreduced (48 layers) on 2
               slots with 4, each through the degrade ladder down to the
               int8 head; checks as in phase 5.
12. ``serve_ssm_exact`` phase 6's first half for each of the two, depth
               cut (zamba2-7b 7 layers: one group, the shared block, one
               tail layer; xlstm-1.3b 4): float32 against the greedy
               full-forward oracle (tokens equal, logits within 1e-3);
               zamba2-7b's oracle runs its shared attention through the
               attention kernel at head_dim 112.
13. ``vector_engine`` the Ara vector engine (``core.vector_engine.
               ReferenceEngine``, which builds no CUDA kernel): the 21-cell
               SEW x LMUL differential grid, 20 programs a cell, in float32
               and float64 against the copied numpy oracle
               (``testing.differential``, ``diff.TOL``), and in float32,
               float64 and int32 (the integer cells) against the same
               engine on the CPU, bit for bit; Listing-1 at n = 64 bit-equal
               to the CPU run, and three Listing-1 programs batched with
               three grid programs, also bit-equal (groups of three replay
               CUDA graphs); Listing-1 at n = 256 on 16 lanes' VLMAX
               (1024 elements) in float64 against numpy's ``A @ B + C``
               (1e-12 of its largest entry), timed, with its scoreboard and
               closed-form cycles; the demo's masked argmax against
               ``np.argmax``; and what a CUDA graph of a group shape costs
               and saves (Listing-1 n = 64 eager and replayed on one
               runner, bit-equal: capture seconds a graph over the seconds
               a replay saves, the repeats at which a capture pays, beside
               ``staging.GRAPH_MIN_REPEATS``). Prints wall
               seconds, rows/s and programs/s on the card, and the same
               grid's seconds on the host CPU.
14. ``vector_engine_lanes`` the lane-partitioned ``LaneEngine`` (2 lanes)
               and the ``ClusterEngine`` at (2,2), (2,4) and (4,2) on the
               grid, 5 programs a cell, in float32, float64 and int32, each
               bit-equal to the card's ReferenceEngine on the same batch and
               to the same engine on the CPU (programs/s beside the
               ReferenceEngine's); Listing-1 at n = 256 on 16 lanes in
               float64 through a flat 16-lane LaneEngine and a 4 x 4
               ClusterEngine, bit-equal to phase 13's ReferenceEngine
               result (wall s, rows/s, encode s, cross-lane folds by unit);
               the scoreboard at 1 and 4 clusters beside the closed form;
               ``benchmarks/torch_scaleout.py``'s ``--verify`` at 2x2 and
               4x2 on the card.
15. ``serve_moe`` granite-moe-3b-a800m unreduced (32 layers of 40 routed
               experts, top 8, in a table padded to 48; vocabulary 49155)
               in float32, 8 slots, 16 requests asking for 18-32 tokens,
               through all three rungs (int8 head, bf16, the model's
               float32); checks as in phase 5. Its int8 head
               (8,1536)@(1536,49155) takes whole-dimension blocks; phase 3
               checks and times ``matmul_int8`` there.
16. ``serve_moe_exact`` the same tree at 2 layers, float32, capacity
               factor 8.0 (no token dropped): the engine's greedy tokens
               equal to the full-forward oracle's, cached logits within
               1e-3; the oracle's attention through ``flash_fwd``.
17. ``serve_mla`` deepseek-v3-671b at full width, 1 dense + 1 MoE layer
               (256 routed experts and a shared one) and the MTP module,
               bf16 as configured (29.8 GB): the serve steps' prefill and
               absorbed decode against the no-cache forward, float32
               compute the witness; a from-zero prefill of 2048 tokens (the
               triangular q-block loop) against the same without the hint;
               ``_mla_triangular`` against ``mla_chunked`` at S 2048;
               ``lm_loss`` with its MTP term; peak memory; then the engine
               (``serve_mla_engine``) as in phase 5 with 8 new tokens, its
               int8 head (8,7168)@(7168,129280).
18. ``serve_cross`` llama-3.2-vision-11b (one group: 5 self layers and a
               cross layer, gate set to 0.5; float32) and
               seamless-m4t-medium (12 + 12 layers; float64): prefill and 4
               decode steps through ``make_prefill_step`` /
               ``make_decode_step`` against the no-cache forward (1e-3),
               the cross layers through ``flash_fwd``'s non-causal mode,
               its launches counted; the forward kernel against its plain
               version at the cross shapes (2,32,Sq,1600,128) and
               (2,16,Sq,512,64), Sq 128 and 1, bf16 and f32, with dead
               rows; times at both in bf16 beside the plain version and
               ``F.scaled_dot_product_attention``.
19. ``serve_faults`` every class of ``serving.faults.REGISTRY`` through
               ``verify`` on tinyllama-1.1b at full width, depth cut to 4
               layers, float32 (installed by ``faults.use_fixture``):
               detected by its code, recovered from with the survivors'
               greedy tokens equal to the full-forward oracle's (its
               attention through ``flash_fwd``, counted), and damage on
               the legacy engine; a token that flips is printed with its
               top-2 logit gap beside the cached-versus-full gap, and fails.
20. ``serving_load`` ``benchmarks/torch_serving_load.py``'s ``bench`` at the
               reference's traffic (120 ticks, 0.5 arrivals a tick, 4
               slots, ``max_seq`` 32, ladder at 2.0 / 4.0) on tinyllama-1.1b
               at full width and depth in its configured precision: zero
               undetected escapes, both rungs in the faulted phase, one
               ``matmul_int8`` launch per int8 decode step; goodput and
               P50/P99 latency in ticks and seconds, every counter.
21. ``train_restart`` the trainer on tinyllama-1.1b at full width, 2 layers,
               batch 4 x 2048 (fp32 parameters, bf16 compute, full remat):
               6 steps straight saving every 3, and 3 + 3 through a
               checkpoint, the resumed state equal to the straight one bit
               for bit (or, if two straight runs differ, within their gap,
               which is printed); ``ft.elastic.recover`` onto the card; a
               ``save(blocking=False)`` then one more in-place step
               restores the values before that step; the seconds the loop
               blocks in ``save`` beside the writer's; the attention
               kernels' launches. Checkpoints under ``tempfile.mkdtemp()``,
               deleted afterwards.

Then one line ``{"kernels": [...]}`` (one row per TPU kernel: launch counts
of the serving phases 5, 6, 11, 15, 17 and 20 for the matmul kernels, of
phases 7 and 21, the oracles of 6, 12, 16 and 19, phase 17's loss and
phase 18's serve steps for the forward attention kernel (each path's count
in ``launches_by_path``), of phases 7 and 21 for the backward ones, of
phases 9-10 for axpy, conv and the scan; error, times and bound per
kernel), one line with the card's name and power limit, and as the last
line ``{"ok": true, "device": {...}}``. Any failed check raises: nothing is caught and passed
over.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.ara import AraConfig  # noqa: E402
from repro_torch.core import isa, staging  # noqa: E402
from repro_torch.core import perfmodel as pm  # noqa: E402
from repro_torch.core.precision import (PEAK_BYTES_PER_S,  # noqa: E402
                                        PEAKS_FLOPS, Policy, torch_dtype)
from repro_torch.data.pipeline import (DataConfig, SyntheticLM,  # noqa: E402
                                       to_device)
from repro_torch.kernels import attention as att  # noqa: E402
from repro_torch.kernels import axpy as ax  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import conv as cv  # noqa: E402
from repro_torch.kernels import matmul as mm  # noqa: E402
from repro_torch.kernels import ssm_scan as ss  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models.layers import (init_params, tree_leaves,  # noqa: E402
                                       tree_map, tree_size_bytes,
                                       value_and_grad)
from repro_torch.models.ssm import chunked_linear_attention  # noqa: E402
from repro_torch.models.transformer import (forward, init_cache,  # noqa: E402
                                            lm_loss, model_template)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.step import (make_decode_step,  # noqa: E402
                                    make_prefill_step, make_train_step)
from repro_torch.core.cluster import ClusterEngine  # noqa: E402
from repro_torch.core.vector_engine import (LaneEngine,  # noqa: E402
                                            ReferenceEngine, make_lane_mesh,
                                            simulate_timing)
from repro_torch.serving import (DegradeLadder, Request,  # noqa: E402
                                 ServingEngine, State)
from repro_torch.testing import differential as diff  # noqa: E402
from repro_torch.ft import elastic  # noqa: E402
from repro_torch.serving import faults  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

PATH_SHAPE = (8, 2048, 32000)      # (slots, d_model, vocab) of tinyllama-1.1b
# tinyllama-1.1b's MLP up-projection at train batch 4 x 2048 tokens
LARGE_SHAPE = (8192, 2048, 5632)
SOURCE = "src/repro_torch/kernels/csrc/matmul.cu"
TRAIN_ATT = (4, 32, 2048, 64)      # (batch, heads, seq, head_dim) in training
# (batch, heads, Sq, Sk, head_dim) of zamba2-7b's shared attention in the
# serving oracle, whose prompts of 32-128 tokens grow by up to 8
ZAMBA_ATT = (1, 32, 136, 136, 112)
ATT_SOURCE = "src/repro_torch/kernels/csrc/attention.cu"
MOE_ARCH, MLA_ARCH = "granite-moe-3b-a800m", "deepseek-v3-671b"
VISION_ARCH, AUDIO_ARCH = "llama-3.2-vision-11b", "seamless-m4t-medium"
DEV = "cuda"                       # every tensor of this script lives here


def free_memory():
    """Collect unreachable objects first (a reference cycle can hold tensors
    that no name reaches), then return the allocator's cached blocks."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


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


def _check_float(name, got, ref, rel, results, acc=ACC_TOL, atol=0.0,
                 **detail):
    """|got - ref| <= rel * |ref| + acc * max|ref| + atol elementwise.

    Both sides multiply the same operands exactly and accumulate in fp32, so
    they differ by summation order only: ACC_TOL of the largest result
    (readings are 6e-8 to 1.3e-6 of it). A dropped k row or a wrongly
    unpacked lane moves a result by about 1/sqrt(K) of the scale, hundreds
    of times the allowance. ``rel`` is for a narrow output alone, where the two fp32
    sums may round to neighbouring narrow values: one step of that type."""
    equal = got.dtype == ref.dtype and torch.equal(got, ref)
    ref = ref.to(torch.float64)
    scale = float(ref.abs().max())
    err = (got.to(torch.float64) - ref).abs()
    ok = bool((err <= rel * ref.abs() + acc * scale + atol).all())
    results.append({"check": name, "max_err": float(err.max()),
                    "ref_max": scale, "rel_tol": rel,
                    "abs_tol": acc * scale + atol, "equal": equal, **detail})
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version: {results[-1]}")


def _check_exact(name, got, ref, results, **detail):
    if got.dtype != ref.dtype or not torch.equal(got, ref):
        bad = int((got.to(torch.int64) != ref.to(torch.int64)).sum())
        raise AssertionError(f"{name}: {bad} elements differ from the plain "
                             f"version (must be exact)")
    results.append({"check": name, "max_err": 0, "tol": 0, **detail})


ROUTES_RAN: set = set()   # matmul routes taken by the checks of phase 3
INT8_ROUTES_RAN: set = set()   # ... and matmul_int8 routes


def _route(m, k, n, dt):
    route = mm.kernel_route(m, k, n, dt)
    ROUTES_RAN.add(route)
    return route


def _route_int8(m, k, n):
    route = mm.kernel_route_int8(m, k, n)
    INT8_ROUTES_RAN.add(route)
    return route


def check_int8(ai, bi, tag, blocks, results):
    """matmul_int8 exact against its plain version: int32, shift 7 with an
    int32 output, shift 7 saturated to int8; the route it took."""
    route = _route_int8(ai.shape[0], ai.shape[1], bi.shape[1])
    for kw in ({}, {"shift": 7}, {"shift": 7, "out_dtype": torch.int8}):
        got = mm.matmul_int8(ai, bi, **kw, **blocks)
        _check_exact(f"matmul_int8 {kw or 'int32'} {tag}", got,
                     mm.matmul_int8_plain(ai, bi, **kw), results,
                     route=route)


def check_shape(m, k, n, blocks, seed, results):
    dev = DEV
    tag = f"{m}x{k}x{n}"
    r = np.random.RandomState(seed)
    a32 = torch.from_numpy(r.randn(m, k).astype(np.float32)).to(dev)
    b32 = torch.from_numpy(r.randn(k, n).astype(np.float32)).to(dev)
    # float32: against an fp64 product — true fp32 products, no TF32
    _route(m, k, n, torch.float32)
    got = mm.matmul(a32, b32, **blocks)
    _check_float(f"matmul f32 {tag}", got, a32.double() @ b32.double(), 0.0,
                 results)
    _check_float(f"matmul f32 vs plain {tag}", got, mm.matmul_plain(a32, b32),
                 0.0, results)
    for dt, ulp in ((torch.bfloat16, BF16_ULP), (torch.float16, F16_ULP)):
        a, b = a32.to(dt), b32.to(dt)
        short = str(dt).replace("torch.", "")
        _route(m, k, n, dt)
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
    check_int8(ai, bi, tag, blocks, results)
    torch.cuda.synchronize()


def _int8_operands(m, k, n, seed):
    gen = torch.Generator(device=DEV).manual_seed(seed)
    ai = torch.randint(-128, 128, (m, k), generator=gen, device=DEV,
                       dtype=torch.int8)
    bi = torch.randint(-128, 128, (k, n), generator=gen, device=DEV,
                       dtype=torch.int8)
    return ai, bi


def int8_shapes():
    """(name, (M, K, N)) of matmul_int8 where it runs or is measured: the
    three served models' int8 heads (slots, d_model, vocab), the paper's
    int8 MATMUL squares (``benchmarks/multiprecision.py``) and
    LARGE_SHAPE, where the tiled route is bound by operations."""
    heads = [("tinyllama-1.1b head", PATH_SHAPE)]
    for arch, slots in [a[:2] for a in SSM_SERVE] + [(MOE_ARCH, 8),
                                                    (MLA_ARCH, 8)]:
        cfg = get_config(arch)
        heads.append((f"{arch} head", (slots, cfg.d_model, cfg.vocab_size)))
    return heads + [("256^3", (256, 256, 256)), ("512^3", (512, 512, 512)),
                    ("projection", LARGE_SHAPE)]


def int8_library_ms(ai, bi, **kw):
    """``torch._int_mm`` on the same operands, the one library call for
    this function: (ms, None), or (None, its refusal) where it does not
    take the shape (few rows). Only a yardstick: the port never calls it."""
    if not hasattr(torch, "_int_mm"):
        return None, "this torch build has no _int_mm"
    try:
        torch._int_mm(ai, bi)
    except RuntimeError as e:
        return None, str(e).splitlines()[0][:200]
    return time_ms(lambda: torch._int_mm(ai, bi), **kw), None


def head_blocks(m, k, n):
    """The blocks ``ops.lm_head`` gives the kernels for an (m,k)@(k,n) head:
    the defaults where they tile it, whole dimensions where not."""
    return {} if ops._block_tiles(m, k, n) else {"bm": m, "bn": n, "bk": k}


def time_matmul_int8(name, m, k, n, seed):
    """Kernel, plain version and ``torch._int_mm`` at one shape, int32
    output, operands from randint(-128, 128), with the bound and route;
    the kernel at the blocks ``ops.lm_head`` would give it."""
    ai, bi = _int8_operands(m, k, n, seed)
    blocks = head_blocks(m, k, n)
    bnd, by = bound_ms(m, k, n, 1, 4, PEAKS_FLOPS["int8"])
    big = m * k * n > 1e10
    kw = dict(warmup=2, reps=5, inner=3) if big else {}
    library_ms, note = int8_library_ms(ai, bi, **kw)
    return {"name": name, "shape": [m, k, n], "dtype": "int8->int32",
            "route": mm.kernel_route_int8(m, k, n),
            "blocks": blocks,
            "ms": time_ms(lambda: mm.matmul_int8(ai, bi, **blocks), **kw),
            "plain_ms": time_ms(lambda: mm.matmul_int8_plain(ai, bi), **kw),
            "library_ms": library_ms, "library_note": note,
            "bound_ms": bnd, "bound_by": by}


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


def check_large(results):
    """tinyllama-1.1b's MLP projection at train batch 4 x 2048, bf16 and
    f32, against the plain version and an fp64 product (the tiled routes
    at a size where they are bound by operations)."""
    m, k, n = LARGE_SHAPE
    tag = f"{m}x{k}x{n}"
    gen = torch.Generator(device=DEV).manual_seed(11)
    a32 = torch.randn((m, k), generator=gen, device=DEV)
    b32 = torch.randn((k, n), generator=gen, device=DEV)
    want64 = a32.to(torch.bfloat16).double() @ b32.to(torch.bfloat16).double()
    a, b = a32.bfloat16(), b32.bfloat16()
    assert _route(m, k, n, torch.bfloat16) == "tiled_mma"
    got = mm.matmul(a, b, out_dtype=torch.float32)
    _check_float(f"matmul bfloat16->f32 {tag}", got,
                 mm.matmul_plain(a, b, out_dtype=torch.float32), 0.0,
                 results)
    _check_float(f"matmul bfloat16->f32 vs fp64 {tag}", got, want64, 0.0,
                 results)
    _check_float(f"matmul bfloat16->bfloat16 {tag}", mm.matmul(a, b),
                 mm.matmul_plain(a, b), BF16_ULP, results)
    del want64, got
    assert _route(m, k, n, torch.float32) == "tiled_fma"
    got = mm.matmul(a32, b32)
    _check_float(f"matmul f32 vs fp64 {tag}", got, a32.double() @ b32.double(),
                 0.0, results)
    torch.cuda.synchronize()


def time_matmul(m, k, n, dt, seed):
    """Kernel, plain version and ``torch.matmul`` at one shape, fp32 out
    for narrow operands (the head's form), with the bound and the route."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    a = torch.randn((m, k), generator=gen, device=DEV).to(dt)
    b = torch.randn((k, n), generator=gen, device=DEV).to(dt)
    short = str(dt).replace("torch.", "")
    out_dt = torch.float32
    bnd, by = bound_ms(m, k, n, a.element_size(), 4, PEAKS_FLOPS[short])
    big = m * k * n > 1e10
    kw = dict(warmup=2, reps=5, inner=3) if big else {}
    return {"shape": [m, k, n], "dtype": f"{short}->float32",
            "route": mm.kernel_route(m, k, n, dt),
            "ms": time_ms(lambda: mm.matmul(a, b, out_dtype=out_dt), **kw),
            "plain_ms": time_ms(lambda: mm.matmul_plain(
                a, b, out_dtype=out_dt), **kw),
            "library_ms": time_ms(lambda: torch.matmul(a, b), **kw),
            "bound_ms": bnd, "bound_by": by}


def phase_kernels():
    results: list = []
    ROUTES_RAN.clear()
    INT8_ROUTES_RAN.clear()
    check_ragged_head(results)
    check_shape(*PATH_SHAPE, {}, 0, results)
    check_shape(128, 128, 128, {}, 1, results)
    check_shape(32, 48, 64, {"bm": 16, "bn": 16, "bk": 16}, 2, results)
    check_shape(5, 77, 93, {}, 3, results)      # ragged: element-wise loads
    check_shape(16, 100, 80, {}, 4, results)    # ragged: part-filled tile
    check_shape(24, 4224, 256, {}, 5, results)  # several K chunks, 3 row tiles
    check_shape(8, 2627, 256, {"bk": 1}, 6, results)  # K chunks, ragged end
    # the paper's square MATMUL sizes (the tiled routes), a ragged tiled
    # shape, and both sides of the skinny / tiled boundary
    check_shape(256, 256, 256, {}, 12, results)
    check_shape(512, 512, 512, {}, 13, results)
    check_shape(129, 77, 93, {"bm": 129, "bn": 93, "bk": 77}, 14, results)
    check_shape(16, 2048, 1000, {"bn": 1000}, 15, results)
    check_shape(17, 2048, 1000, {"bn": 1000}, 16, results)
    check_large(results)
    # matmul_int8 at the other served models' heads (granite-moe-3b-a800m's
    # odd vocabulary of 49155 takes whole-dimension blocks, as lm_head
    # gives them) and the projection shape, full int8 range
    for i, (name, (m, k, n)) in enumerate(int8_shapes()):
        if name.startswith(("zamba2", "xlstm", MOE_ARCH, MLA_ARCH,
                            "projection")):
            ai, bi = _int8_operands(m, k, n, 40 + i)
            check_int8(ai, bi, f"{m}x{k}x{n}", head_blocks(m, k, n), results)
            del ai, bi
    torch.cuda.synchronize()
    assert ROUTES_RAN == set(mm.ROUTES), ROUTES_RAN
    assert INT8_ROUTES_RAN == set(mm.ROUTES_INT8), INT8_ROUTES_RAN

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
    # the whole logits head as the engine calls it: quantizes x AND the
    # whole unembedding on every call, then the kernel, then dequantizes
    x = a32.to(torch.bfloat16)[:, None, :]
    w = b32.to(torch.bfloat16)
    timed["lm_head_int8_ms"] = time_ms(
        lambda: ops.lm_head(x, w, compute_dtype="int8"))
    timed["lm_head_bfloat16_ms"] = time_ms(
        lambda: ops.lm_head(x, w, compute_dtype="bfloat16"))
    timed["plain_head_bfloat16_ms"] = time_ms(lambda: x @ w)
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        timed[str(dt).replace("torch.", "")]["route"] = mm.kernel_route(
            m, k, n, dt)
    # matmul at the paper's square sizes and at a size bound by operations
    timed["shapes"] = [time_matmul(sz, sz, sz, dt, 20 + sz)
                       for sz in (256, 512)
                       for dt in (torch.float32, torch.bfloat16,
                                  torch.float16)]
    timed["shapes"] += [time_matmul(*LARGE_SHAPE, dt, 30)
                        for dt in (torch.bfloat16, torch.float32)]
    # matmul_int8 at the heads, the paper's squares and the projection
    timed["int8_shapes"] = [time_matmul_int8(name, *shape, 50 + i)
                            for i, (name, shape) in enumerate(int8_shapes())]
    timed["int8"] = timed["int8_shapes"][0]           # the serving shape
    emit("kernels", shape=list(PATH_SHAPE), routes=sorted(ROUTES_RAN),
         int8_routes=sorted(INT8_ROUTES_RAN), checks=results, timed=timed)
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


def check_attention_fwd(tag, b, h, sq, sk, d, dtype, causal, bq, bk, seed,
                        results, p_valid=0.9, dead=False):
    """The forward kernel against its plain version on the same padded,
    flattened operands: output, lse (dead rows alike) and the probe
    exactly. Returns the operands, the kernel's outputs and the plain
    ones."""
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
    return dict(q=q, k=k, v=v, kv_valid=kv_valid, dout=dout, qf=qf, kf=kf,
                vf=vf, kvm=kvm, out=out, lse=lse, probe=probe, p_out=p_out,
                p_lse=p_lse, geom=geom, name=name)


def check_attention(tag, b, h, sq, sk, d, dtype, causal, bq, bk, seed,
                    results, p_valid=0.9, dead=False):
    """Forward, dQ and dK/dV kernels against their plain versions on the
    same padded, flattened operands; the probe exactly. Returns the
    operands and the kernels' outputs."""
    f = check_attention_fwd(tag, b, h, sq, sk, d, dtype, causal, bq, bk,
                            seed, results, p_valid, dead)
    qf, kf, vf, kvm, geom = (f[n] for n in ("qf", "kf", "vf", "kvm", "geom"))
    rel, acc = ATT_TOL[dtype]
    name, p_lse = f["name"], f["p_lse"]
    doutf = torch.nn.functional.pad(
        f["dout"], (0, 0, 0, qf.shape[1] - sq)).reshape(qf.shape).contiguous()
    delta = (doutf.to(p_lse.dtype) * f["p_out"].to(p_lse.dtype)).sum(-1)
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
        for what, t in (("out", f["out"]), ("dq", dq), ("dk", dk),
                        ("dv", dv)):
            if float(t[:g0].abs().max()) != 0.0:
                raise AssertionError(f"{name}: dead rows give non-zero {what}")
        results.append({"check": f"dead rows zero {name}", "max_err": 0,
                        "tol": 0})
    return dict(f, doutf=doutf, delta=delta, n=qf.shape[1] // geom["bq"])


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


def check_deterministic(ops_, results):
    """Two launches of each kernel on the same bf16 inputs are bit-equal:
    every output element has one writer, no atomics."""
    fwd = (ops_["qf"], ops_["kf"], ops_["vf"], ops_["kvm"])
    bwd = fwd + (ops_["doutf"], ops_["lse"], ops_["delta"])

    def run():
        return (*att.flash_fwd(*fwd, **ops_["geom"]),
                att.flash_bwd_dq(*bwd, **ops_["geom"]),
                *att.flash_bwd_dkv(*bwd, **ops_["geom"]))
    first, second = run(), run()
    torch.cuda.synchronize()
    for what, a, b_ in zip(("out", "lse", "probe", "dq", "dk", "dv"), first,
                           second):
        if not torch.equal(a, b_):
            raise AssertionError(f"two launches give different {what}")
        results.append({"check": f"two launches bit-equal {what} bfloat16",
                        "max_err": 0, "tol": 0})


_MANGLED_TYPE = {"13__nv_bfloat16": "bfloat16", "6__half": "float16",
                 "f": "float32", "d": "float64"}


def attention_ptxas(log=None):
    """Registers and spills of every specialisation of the forward and the
    two backward kernels, from what ``ptxas -v`` wrote into the attention
    library's build log (or into ``log``)."""
    if log is None:
        log = build.library_path("attention").with_suffix(".log").read_text()
    rows = []
    for name, body in re.findall(
            r"Compiling entry function '(\w+)'(.*?)(?=ptxas info\s*:\s*"
            r"Compiling|\Z)", log, flags=re.S):
        m = re.search(r"(flash_fwd|flash_bwd_dkv|flash_bwd_dq)_(mma|kernel)I"
                      r"(13__nv_bfloat16|6__half|f|d)[fd]?Li(\d+)E", name)
        if not m:
            continue
        regs = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", body)
        rows.append({
            "kernel": m.group(1), "dtype": _MANGLED_TYPE[m.group(3)],
            "head_cols": int(m.group(4)),
            "units": "tensor cores" if m.group(2) == "mma" else "CUDA cores",
            "registers": int(regs.group(1)) if regs else None,
            "spill_store_bytes": int(spill.group(1)) if spill else None,
            "spill_load_bytes": int(spill.group(2)) if spill else None})
    return rows


def att_bound(op: str, b, h, s, d, elt: int, dtype: str = "bfloat16"):
    """Least time for one causal call at (b, h, s, d): the bytes of its
    inputs and outputs once over the memory rate, or its products over the
    peak rate for ``dtype`` (bf16: the tensor cores; float32: the CUDA
    cores, TF32 being off) — the products of the causal triangle this input
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
    t_ops = n_prod * 2 * d * g * pairs / PEAKS_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_attention():
    ptxas = attention_ptxas()
    emit("attention_ptxas", kernels=ptxas)
    # the forward and both backward kernels, bf16 and f16 each
    mma64 = [r for r in ptxas
             if r["units"] == "tensor cores" and r["head_cols"] == 64]
    if len(mma64) != 6 or any(r["spill_store_bytes"] != 0
                              or r["spill_load_bytes"] != 0 for r in mma64):
        raise AssertionError(f"tensor-core kernels at 64 head columns: "
                             f"missing or spilling {mma64}")
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
    # zamba2-7b's shared attention as the serving oracle's full forward
    # gives it: (1, 32, S, 112), the kernel's 128 head columns of which 16
    # are zero, the default 128x128 blocks over a ragged tail
    for i, dtype in enumerate((torch.float32, torch.bfloat16)):
        check_attention(f"zamba2 {ZAMBA_ATT}", *ZAMBA_ATT, dtype, True, 128,
                        128, 34 + i, results, p_valid=1.0)
    check_attention_autograd(results)
    # bfloat16 / float16 geometries where the backward's tensor-core tiles
    # (64 rows a block, streamed tiles of 64 or 32) split differently
    check_attention("dead (2,8,2048,64)", 2, 8, s, s, d, torch.bfloat16, True,
                    128, 128, 40, results, p_valid=0.9, dead=True)
    check_attention("(1,4,2048,64) b128x64", 1, 4, s, s, d, torch.bfloat16,
                    True, 128, 64, 41, results)
    check_attention("(1,4,1024,128)", 1, 4, 1024, 1024, 128, torch.bfloat16,
                    True, 128, 128, 42, results)
    check_attention("f16 (1,4,2048,64)", 1, 4, s, s, d, torch.float16, True,
                    128, 128, 43, results)
    # a head width that is not a multiple of 8: staged element by element
    check_attention("d45 100x100 b32x32", 1, 2, 100, 100, 45, torch.bfloat16,
                    True, 32, 32, 44, results)
    check_deterministic(ops_, results)

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
    # the forward at zamba2-7b's oracle shape, where its shared attention
    # runs (head_dim 112 in the kernel's 128 columns)
    zb, zh, zsq, zsk, zd = ZAMBA_ATT
    for dtype in (torch.float32, torch.bfloat16):
        short = str(dtype).replace("torch.", "")
        q, k, v, kv_valid, _ = _att_inputs(zb, zh, zsq, zsk, zd, dtype, 36,
                                           p_valid=1.0)
        qz, kz, vz, kvz, zbq, zbk = att._prepare(q, k, v, kv_valid, 128, 128)
        zgeom = dict(causal=True, bq=zbq, bk=zbk)
        bnd, by = att_bound("flash_fwd", zb, zh, zsq, zd,
                            q.element_size(), short)
        timed[f"flash_fwd_zamba2_{short}"] = {
            "shape": list(ZAMBA_ATT), "blocks": [zbq, zbk],
            "ms": time_ms(lambda: att.flash_fwd(qz, kz, vz, kvz, **zgeom)),
            "plain_ms": time_ms(lambda: att.flash_fwd_plain(
                qz, kz, vz, kvz, **zgeom), **heavy),
            "library_ms": time_ms(lambda: sdpa(q, k, v, is_causal=True)),
            "bound_ms": bnd, "bound_by": by}
    emit("attention", shape=list(TRAIN_ATT), dtype="bfloat16", causal=True,
         blocks=[geom["bq"], geom["bk"]], n_checks=len(results),
         checks=results, timed=timed)
    return results, timed


# ---------------------------------------------------------------------------
# phase 5 (and 11): serve a model at full width through the degrade ladder
# ---------------------------------------------------------------------------


def make_requests(cfg, rng, n, max_new, spread=0):
    """``n`` requests of 32-128 prompt tokens; request ``i`` asks for
    ``max_new - spread * (7 - i % 8)`` new tokens."""
    reqs = []
    for i in range(n):
        plen = int(rng.randint(32, 129))
        reqs.append(Request(
            uid=i, prompt=rng.randint(0, cfg.vocab_size,
                                      size=plen).astype(np.int32),
            max_new_tokens=max_new - spread * (7 - i % 8)))
    return reqs


def phase_serve(cfg, params, slots=8, n_requests=16, phase="serve",
                max_new=32, spread=0):
    """Serve ``n_requests`` of 32-128 prompt tokens and ``max_new`` new
    tokens on ``slots`` slots through the degrade ladder (pressure 2 ->
    int8 head, then 1 -> bf16), after a warm-up on a throw-away engine; the
    matmul counts are set to 0 right before the path and returned right
    after. With ``spread``, the requests ask for 2 ... ``max_new`` tokens
    in steps of ``spread`` (see :func:`make_requests`), so that the last
    ones finish one by one and the pressure falls below 1: the model's own
    precision (rung ``fp32``) then serves too, and must."""
    # warm-up on a throw-away engine held at the int8 rung: first-call costs
    # (library handles, allocator growth) stay out of the timed run
    warm = ServingEngine(cfg, params, slots=slots, max_seq=512, device=DEV,
                         degrade=DegradeLadder(bf16_at=0.0, int8_at=0.0))
    for r in make_requests(cfg, np.random.RandomState(1), 2, 4):
        warm.submit(r)
    warm.run_to_completion()
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    engine = ServingEngine(cfg, params, slots=slots, max_seq=512, device=DEV,
                           degrade=DegradeLadder(bf16_at=1.0, int8_at=2.0))
    reqs = make_requests(cfg, np.random.RandomState(0), n_requests, max_new,
                         spread)
    mm.reset_launches()            # the serving path starts here
    t0 = time.perf_counter()
    for r in reqs:
        assert engine.submit(r) is None
    engine.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(mm.LAUNCHES)   # read right after the serving path

    assert all(r.state == State.DONE for r in reqs), \
        [(r.uid, r.state.value, r.finish_reason) for r in reqs]
    assert all(len(r.out_tokens) == r.max_new_tokens for r in reqs)
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens)
    assert not engine.events, engine.events
    assert not any(key.startswith("I_") for key in engine.counters)
    n_int8 = engine.counters["degraded_steps_int8"]
    assert n_int8 > 0 and engine.counters["degraded_steps_bf16"] > 0, \
        dict(engine.counters)
    assert launches["matmul_int8"] == n_int8, (launches, n_int8)
    if spread:
        assert "decode_fp32" in engine.timers, dict(engine.timers)
    for key, t in engine.cache.items():
        if key != "lengths":
            assert bool(torch.isfinite(t).all()), key

    new_tokens = sum(len(r.out_tokens) for r in reqs)
    decode = {k[len("decode_"):]: {"steps": c, "mean_ms": 1e3 * s / c}
              for k, (c, s) in engine.timers.items()
              if k.startswith("decode_")}
    prefill = {int(k[len("prefill_"):]): 1e3 * s / c
               for k, (c, s) in engine.timers.items()
               if k.startswith("prefill_")}
    steps = [(c, s) for k, (c, s) in engine.timers.items()
             if k.startswith("decode_")]
    emit(phase, arch=cfg.name, family=cfg.family,
         n_layers=cfg.n_layers, d_model=cfg.d_model, vocab=cfg.vocab_size,
         compute_dtype=cfg.compute_dtype,
         param_count=sum(t.numel() for t in tree_leaves(params)),
         param_bytes=tree_size_bytes(params),
         cache_bytes=tree_size_bytes(engine.cache), slots=slots, max_seq=512,
         requests=len(reqs), new_tokens=new_tokens, wall_s=wall,
         tokens_per_s=new_tokens / wall, ticks=engine.tick,
         decode_steps=decode,
         decode_steps_per_s=sum(c for c, _ in steps) / sum(
             s for _, s in steps),
         prefill_ms_by_prompt_len=dict(sorted(prefill.items())),
         counters=dict(engine.counters),
         matmul_int8_launches=launches["matmul_int8"],
         head_route=ops.lm_head_route(slots, cfg.d_model, cfg.vocab_size,
                                      "int8", device=DEV),
         max_memory_allocated=torch.cuda.max_memory_allocated())
    return launches


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


def _attention_layers(cfg, n_layers):
    """Attention blocks one forward of the first ``n_layers`` layers runs:
    every layer of the dense family, the shared block after each whole group
    of ``attn_every`` Mamba2 layers of the hybrid family, none in the ssm
    family."""
    return {"dense": n_layers, "moe": n_layers, "ssm": 0,
            "hybrid": n_layers // max(cfg.attn_every, 1)}[cfg.family]


@torch.inference_mode()
def phase_serve_exact(cfg, params, n_layers=EXACT_LAYERS, full_depth=True,
                      phase="serve_exact"):
    """float32 at full width, depth cut to ``n_layers``. The engine's tokens
    are held to the greedy full-forward oracle, where float32 rounding
    cannot yet flip a token, and the cached path's logits to within 1e-3 of
    the full forward's. The oracle's full forward runs its attention through
    ``flash_fwd``: that count is set to 0 right before the oracle and
    returned, read right after it. With ``full_depth``, the cached path at
    full depth is held by :func:`full_depth_witness` and the bf16
    logits-head route is checked."""
    cfg32, cut = _cut(cfg, params, n_layers, "float32")
    engine = ServingEngine(cfg32, cut, slots=8, max_seq=512, degrade=None,
                           device=DEV)
    reqs = make_requests(cfg32, np.random.RandomState(2), 2, 8)
    for r in reqs:
        assert engine.submit(r) is None
    engine.run_to_completion()
    assert all(r.state == State.DONE for r in reqs)
    assert engine.counters["degraded_steps"] == 0 and not engine.events
    del engine
    att.reset_launches()           # the oracle's path starts here
    for r in reqs:
        want = oracle_tokens(cfg32, cut, r.prompt, 8)
        assert r.out_tokens == want, (cfg.name, r.uid, r.out_tokens, want)
    flash = att.LAUNCHES["flash_fwd"]    # read right after the oracle
    # 8 full forwards per request
    assert flash == 2 * 8 * _attention_layers(cfg, n_layers), flash

    # logits of the cached steps against the full forward's last position
    (pc, pf), (dc, df), _ = _cached_and_full(cfg32, cut, reqs[0].prompt)
    err_prefill, err_decode = _gap(pc, pf), _gap(dc, df)
    assert err_prefill < 1e-3 and err_decode < 1e-3, (err_prefill, err_decode)
    fields = dict(arch=cfg.name, n_layers=n_layers, requests=len(reqs),
                  new_tokens=16, tokens_equal_oracle=True,
                  logits_err_prefill=err_prefill,
                  logits_err_decode=err_decode, logits_tol=1e-3,
                  flash_fwd_launches=flash, head_dim=cfg.resolved_head_dim)
    if not full_depth:
        emit(phase, **fields)
        return flash
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
    emit(phase, **fields, full_depth_layers=cfg.n_layers,
         fp64_tol=FP64_TOL, witness_factor=WITNESS_FACTOR,
         witness_slack=WITNESS_SLACK,
         fp64_tokens_equal_oracle=True,
         fp64_cached_vs_full=by_depth[-1]["fp64_cached_vs_full"],
         fp32_cached_vs_full=by_depth[-1]["fp32_cached_vs_full"],
         lm_head_bf16_route=ops.lm_head_route(8, cfg.d_model, cfg.vocab_size,
                                              "bfloat16"),
         lm_head_bf16_rel_err=rel, lm_head_bf16_tol=0.05,
         matmul_launches=mm.LAUNCHES["matmul"])
    return flash


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
# phase 9: the paper's kernels (axpy, conv2d_direct) against their plain
# versions, on the card
# ---------------------------------------------------------------------------


AXPY_SOURCE = "src/repro_torch/kernels/csrc/axpy.cu"
CONV_SOURCE = "src/repro_torch/kernels/csrc/conv.cu"
SSM_SOURCE = "src/repro_torch/kernels/csrc/ssm_scan.cu"
AXPY_N = 1 << 26                   # 768 MB moved in f32, far past the L2
GOOGLENET_L1 = (3, 118, 118, 64, 7, 7)   # (C, H, W, OC, KH, KW), pre-padded
# GoogLeNet's 3x3 convolution (conv2/3x3: 64 -> 192 channels at 56 x 56)
GOOGLENET_3X3 = (64, 58, 58, 192, 3, 3)
# tolerances of a kernel against its plain version, elementwise
# |got - ref| <= rtol * |ref| + atol: float32 at the CPU tests' own
# (tests/test_kernels.py: _tol for axpy, 2e-4 for conv, 3e-4 for the scan),
# a narrow output within one step of its type, float64 within 1e-12 of
# the largest value
AXPY_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (BF16_ULP, 0.0)}
CONV_TOL = (2e-4, 2e-4)
SSM_TOL = (3e-4, 3e-4)
FP64_REL = 1e-12


def _check_close(name, got, ref, rtol, atol, results):
    """The tests' form, |got - ref| <= rtol * |ref| + atol elementwise, on a
    result of the plain version's dtype and shape."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{name}: {got.dtype}{tuple(got.shape)} against "
                             f"{ref.dtype}{tuple(ref.shape)}")
    _check_float(name, got, ref, rtol, results, acc=0.0, atol=atol)


def _check_conv(name, got, ref, x, w, results, tol=CONV_TOL, exact=True):
    """A convolution of x, w against a plain version: the tolerance check,
    the kernel route that ran (``conv.kernel_route``: compile-time taps or
    general) and, where ``exact`` (the plain version on the same operands),
    bit-equality: both sum each output's taps in the order c -> kr -> t
    with the same roundings."""
    _check_close(name, got, ref, *tol, results)
    results[-1]["route"] = cv.kernel_route(x, w)
    if exact and not results[-1]["equal"]:
        raise AssertionError(f"{name}: not bit-equal to the plain version: "
                             f"{results[-1]}")


def _raises_value_error(name, fn, results):
    try:
        fn()
    except ValueError as e:
        results.append({"check": name, "raised": str(e)[:120]})
        return
    raise AssertionError(f"{name}: no ValueError")


def _randn(shape, dtype, seed, scale=1.0):
    gen = torch.Generator(device=DEV).manual_seed(seed)
    return (torch.randn(shape, generator=gen, device=DEV,
                        dtype=torch.float32) * scale).to(dtype)


def _axpy_tol(dtype, ref):
    if dtype == torch.float64:
        return 0.0, FP64_REL * float(ref.abs().max())
    return AXPY_TOL[dtype]


def _conv_tol(out_dtype, ref):
    if out_dtype == torch.float64:
        return 0.0, FP64_REL * float(ref.abs().max())
    if out_dtype == torch.bfloat16:
        return BF16_ULP, CONV_TOL[1]
    return CONV_TOL


def paper_bound(kind, shape, elt):
    """Least time for one call: the bytes of inputs and outputs once over
    the memory rate, or the operations over the float32 CUDA-core rate
    (these kernels multiply on the CUDA cores in fp32 or fp64; fp64 is
    taken at the fp32 rate, which flatters it)."""
    if kind == "axpy":
        (n,) = shape
        t_bytes, t_ops = 3 * n * elt / PEAK_BYTES_PER_S, \
            2 * n / PEAKS_FLOPS["float32"]
    else:
        c, h, w, oc, kh, kw = shape
        ho, wo = h - kh + 1, w - kw + 1
        t_bytes = (c * h * w + oc * c * kh * kw + oc * ho * wo) * elt \
            / PEAK_BYTES_PER_S
        t_ops = 2 * oc * c * kh * kw * ho * wo / PEAKS_FLOPS["float32"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


AXPY_TURNS = 5


def axpy_turns(xs, ys, alpha=2.5, turns=AXPY_TURNS):
    """``axpy`` and ``torch.add(y, x, alpha=a)`` (a: alpha rounded to x's
    dtype, so both compute one function) timed in alternating turns, the
    kernel first in even turns: {"axpy": [ms, ...], "torch.add": [...]}."""
    a = float(torch.tensor(alpha, dtype=xs.dtype))
    fns = {"axpy": lambda: ax.axpy(alpha, xs, ys),
           "torch.add": lambda: torch.add(ys, xs, alpha=a)}
    out = {name: [] for name in fns}
    for t in range(turns):
        for name in (list(fns) if t % 2 == 0 else list(fns)[::-1]):
            out[name].append(time_ms(fns[name]))
    return out


def phase_paper_kernels():
    """The paper's DAXPY and DCONV through the public kernel API
    (``ops.axpy``, ``ops.conv2d``) — their path: counts set to 0 before it
    and read after it — then every case against the plain version, the
    contract's ValueErrors on CUDA tensors, and the times."""
    results: list = []
    torch.backends.cudnn.allow_tf32 = False   # F.conv2d is timed below
    x32, y32 = _randn((AXPY_N,), torch.float32, 40), \
        _randn((AXPY_N,), torch.float32, 41)
    xg = _randn(GOOGLENET_L1[:3], torch.float32, 42)
    wg = _randn((GOOGLENET_L1[3], GOOGLENET_L1[0]) + GOOGLENET_L1[4:],
                torch.float32, 43, 0.2)
    x64, y64 = _randn((256,), torch.float64, 44), _randn((256,),
                                                          torch.float64, 45)
    bf16 = Policy(compute_dtype="bfloat16")
    # the path: the paper's kernels as a user calls them
    ax.reset_launches()
    cv.reset_launches()
    path = {
        "daxpy_f64_256": ops.axpy(2.5, x64, y64),
        "axpy_f32_2^26": ops.axpy(2.5, x32, y32),
        "dconv_f32": ops.conv2d(xg, wg),
        "dconv_bf16_to_f32": ops.conv2d(xg, wg, policy=bf16,
                                        out_dtype=torch.float32),
    }
    torch.cuda.synchronize()
    launches = {"axpy": ax.LAUNCHES["axpy"],
                "conv2d_direct": cv.LAUNCHES["conv2d_direct"]}
    assert launches == {"axpy": 2, "conv2d_direct": 2}, launches
    ref = ax.axpy_plain(2.5, x64, y64)
    _check_close("path daxpy f64 256", path["daxpy_f64_256"], ref,
                 *_axpy_tol(torch.float64, ref), results)
    _check_close("path axpy f32 2^26", path["axpy_f32_2^26"],
                 ax.axpy_plain(2.5, x32, y32), *AXPY_TOL[torch.float32],
                 results)
    ref = cv.conv2d_plain(xg, wg)
    _check_conv("path dconv f32 googlenet1", path["dconv_f32"], ref, xg, wg,
                results)
    _check_conv("path dconv f32 vs fp64", path["dconv_f32"],
                cv.conv2d_plain(xg.double(), wg.double()).float(), xg, wg,
                results, exact=False)
    ref = cv.conv2d_plain(xg.bfloat16(), wg.bfloat16(),
                          out_dtype=torch.float32)
    _check_conv("path dconv bf16->f32 googlenet1",
                path["dconv_bf16_to_f32"], ref, xg.bfloat16(), wg.bfloat16(),
                results)
    del path

    # axpy: sizes, dtypes, lmul, an address that is not 16-byte aligned
    for i, (n, dt, block, lmul, offset) in enumerate((
            (AXPY_N, torch.bfloat16, 64 * 1024, 1, 0),
            (1 << 20, torch.float32, 64 * 1024, 1, 0),
            (256, torch.float64, 64 * 1024, 1, 0),
            (4096, torch.float32, 512, 8, 0),
            (1000, torch.float32, 8, 1, 1),
            (1000, torch.bfloat16, 8, 1, 3),
            (12345, torch.float16, 5, 1, 0))):
        xs = _randn((n + offset,), dt, 50 + i)[offset:]
        ys = _randn((n + offset,), dt, 60 + i)[offset:]
        got = ax.axpy(-1.75, xs, ys, block=block, lmul=lmul)
        ref = ax.axpy_plain(-1.75, xs, ys)
        tol = (F16_ULP, 0.0) if dt == torch.float16 else _axpy_tol(dt, ref)
        short = str(dt).replace("torch.", "")
        _check_close(f"axpy {short} n={n} lmul={lmul} offset={offset}", got,
                     ref, *tol, results)
    # conv: GoogLeNet layer 1 in float64 and to a bf16 output; the CPU
    # tests' shapes and GoogLeNet's 3x3 layer (both kernel routes)
    for dt, out_dt in ((torch.float64, None), (torch.bfloat16, None)):
        got = cv.conv2d_direct(xg.to(dt), wg.to(dt), out_dtype=out_dt)
        ref = cv.conv2d_plain(xg.to(dt), wg.to(dt), out_dtype=out_dt)
        short = str(dt).replace("torch.", "")
        _check_conv(f"conv {short} googlenet1", got, ref, xg.to(dt),
                    wg.to(dt), results, tol=_conv_tol(ref.dtype, ref))
    for i, (c, h, w, oc, kh_, kw_) in enumerate(((1, 8, 16, 2, 3, 3),
                                                (3, 12, 20, 4, 7, 7),
                                                (3, 10, 118, 8, 7, 7),
                                                (5, 9, 33, 3, 2, 5),
                                                GOOGLENET_3X3)):
        xr = _randn((c, h, w), torch.float32, 70 + i)
        wr = _randn((oc, c, kh_, kw_), torch.float32, 80 + i, 0.2)
        _check_conv(f"conv f32 {(c, h, w, oc, kh_, kw_)}",
                    cv.conv2d_direct(xr, wr), cv.conv2d_plain(xr, wr), xr,
                    wr, results)
    # 3x3 at many channels, pre-padded (ResNet's last stage at 7x7, VGG's
    # 512 channels at 14x14): the taps route's staging does not fit a block,
    # the general kernel runs them (float64 at 512 x 16 x 16 fits neither)
    for i, (c, h, w, dt) in enumerate(((512, 9, 9, torch.float32),
                                       (512, 16, 16, torch.float32),
                                       (512, 9, 9, torch.float64),
                                       (256, 16, 16, torch.float64))):
        xr = _randn((c, h, w), dt, 100 + i)
        wr = _randn((c, c, 3, 3), dt, 110 + i, 0.05)
        short = str(dt).replace("torch.", "")
        ref = cv.conv2d_plain(xr, wr)
        _check_conv(f"conv {short} {(c, h, w, c, 3, 3)}",
                    cv.conv2d_direct(xr, wr), ref, xr, wr, results,
                    tol=_conv_tol(dt, ref))
        if results[-1]["route"] != "general":
            raise AssertionError(f"{results[-1]['check']}: route "
                                 f"{results[-1]['route']}, not general")
    routes = {r["route"] for r in results if "route" in r}
    if routes != {"taps", "general"}:
        raise AssertionError(f"conv routes exercised: {routes}")
    _raises_value_error("conv channels disagree", lambda: ops.conv2d(
        xg, wg[:, :2].contiguous()), results)
    # 256 channels of 3 rows of width 512 exceed the block's shared memory
    _raises_value_error("conv input rows beyond shared memory",
                        lambda: ops.conv2d(
                            torch.zeros((256, 3, 512), device=DEV),
                            torch.zeros((1, 256, 3, 3), device=DEV)),
                        results)
    _raises_value_error("axpy n not a multiple of block", lambda: ops.axpy(
        1.0, x64[:100], y64[:100], block=64), results)
    torch.cuda.synchronize()

    # times
    timed = {}
    heavy = dict(warmup=2, reps=5, inner=3)
    for key, xs, ys in (("f32_2^26", x32, y32),
                        ("bf16_2^26", x32.bfloat16(), y32.bfloat16()),
                        ("f32_2^20", x32[:1 << 20], y32[:1 << 20]),
                        ("f64_256", x64, y64)):
        bnd, by = paper_bound("axpy", xs.shape, xs.element_size())
        turns = axpy_turns(xs, ys)
        timed[f"axpy_{key}"] = {
            "ms": statistics.median(turns["axpy"]),
            "plain_ms": time_ms(lambda: ax.axpy_plain(2.5, xs, ys)),
            "library_ms": statistics.median(turns["torch.add"]),
            "bound_ms": bnd, "bound_by": by, "turns": turns}
    for key, dt, kw in (("f32", torch.float32, {}),
                        ("bf16_to_f32", torch.bfloat16,
                         {"out_dtype": torch.float32}),
                        ("f64", torch.float64, {})):
        xs, ws = xg.to(dt), wg.to(dt)
        bnd, by = paper_bound("conv", GOOGLENET_L1, xs.element_size())
        lib_x, lib_w = xs[None].to(kw.get("out_dtype", dt)), \
            ws.to(kw.get("out_dtype", dt))
        timed[f"conv_googlenet1_{key}"] = {
            "ms": time_ms(lambda: cv.conv2d_direct(xs, ws, **kw)),
            "plain_ms": time_ms(lambda: cv.conv2d_plain(xs, ws, **kw),
                                **heavy),
            "library_ms": time_ms(lambda: torch.nn.functional.conv2d(
                lib_x, lib_w)),
            "bound_ms": bnd, "bound_by": by,
            "route": cv.kernel_route(xs, ws)}
    c, h, w, oc, kh_, kw_ = GOOGLENET_3X3
    xs, ws = _randn((c, h, w), torch.float32, 90), \
        _randn((oc, c, kh_, kw_), torch.float32, 91, 0.05)
    bnd, by = paper_bound("conv", GOOGLENET_3X3, 4)
    timed["conv_googlenet_3x3_f32"] = {
        "shape": list(GOOGLENET_3X3),
        "ms": time_ms(lambda: cv.conv2d_direct(xs, ws)),
        "plain_ms": time_ms(lambda: cv.conv2d_plain(xs, ws), **heavy),
        "library_ms": time_ms(lambda: torch.nn.functional.conv2d(xs[None],
                                                                 ws)),
        "bound_ms": bnd, "bound_by": by, "route": cv.kernel_route(xs, ws)}
    timed["library_note"] = ("axpy: torch.add(y, x, alpha=a); conv: "
                             "F.conv2d on (1,C,H,W) with cuDNN TF32 off "
                             "(bf16 row: on the same values in f32)")
    emit("paper_kernels", launches=launches, n_checks=len(results),
         checks=results, timed=timed,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    return results, timed, launches


# ---------------------------------------------------------------------------
# phase 10: the scan kernel against its plain version and the model's
# chunked_linear_attention, at the SSM layers' shapes
# ---------------------------------------------------------------------------


def _ssm_layer_shapes():
    """(name, BH, S, N, P, chunk) of one layer of each served SSM model at
    batch 4 and 2048 tokens, from its config: zamba2-7b's Mamba2 heads
    (d_inner / head_dim, state N, head_dim P) and xlstm-1.3b's mLSTM heads
    (d_qk / heads, d_inner / heads + the ones column)."""
    z, x = get_config("zamba2-7b"), get_config("xlstm-1.3b")
    zd = z.ssm.expansion * z.d_model
    xd = x.ssm.expansion * x.d_model
    xqk = int(xd * x.ssm.qk_dim_factor)
    return (("zamba2-7b", 4 * (zd // z.ssm.head_dim), 2048, z.ssm.state_dim,
             z.ssm.head_dim, z.ssm.chunk_size),
            ("xlstm-1.3b", 4 * x.n_heads, 2048, xqk // x.n_heads,
             xd // x.n_heads + 1, x.ssm.chunk_size))


def _ssm_inputs(bh, s, n, p, dtype, seed):
    """The CPU tests' statistics: q, v ~ N(0,1), k ~ 0.3 N(0,1),
    log_decay in (-0.5, 0], scale in [0, 1); log_decay and scale float32."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    q = torch.randn((bh, s, n), generator=gen, device=DEV).to(dtype)
    k = (torch.randn((bh, s, n), generator=gen, device=DEV) * 0.3).to(dtype)
    v = torch.randn((bh, s, p), generator=gen, device=DEV).to(dtype)
    ld = -torch.rand((bh, s), generator=gen, device=DEV) * 0.5
    sc = torch.rand((bh, s), generator=gen, device=DEV)
    return q, k, v, ld, sc


def _as_model(t, b, h):
    """(B*H, S, ...) -> (B, S, H, ...), the model's layout."""
    return t.reshape((b, h) + t.shape[1:]).transpose(1, 2)


def ssm_bound(bh, s, n, p, chunk, elt):
    """Least time for one call: inputs and output once over the memory
    rate, or the products the causal chunked form needs over the float32
    CUDA-core rate (the reference does every product in fp32): per (bh,
    chunk of c) q.k^T and w.v over the c(c+1)/2 causal pairs, q.state and
    the state update over c x N x P, 2 operations a multiply-add."""
    pairs = chunk * (chunk + 1) / 2
    per_chunk = 2 * pairs * (n + p) + 4 * chunk * n * p
    t_ops = bh * (s // chunk) * per_chunk / PEAKS_FLOPS["float32"]
    t_bytes = (bh * s * (2 * n + 2 * p) * elt + 2 * bh * s * 4) \
        / PEAK_BYTES_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_ssm_kernel():
    results: list = []
    layers = _ssm_layer_shapes()
    f32_inputs = {}
    # the path: ops.ssm_scan at both layers' shapes, float32 and bfloat16
    ss.reset_launches()
    outs = {}
    for name, bh, s, n, p, chunk in layers:
        for dt in (torch.float32, torch.bfloat16):
            args = _ssm_inputs(bh, s, n, p, dt, 90)
            if dt == torch.float32:
                f32_inputs[name] = args
            outs[(name, dt)] = (ops.ssm_scan(*args, chunk=chunk), args)
    torch.cuda.synchronize()
    launches = {"ssm_scan": ss.LAUNCHES["ssm_scan"]}
    assert launches["ssm_scan"] == 2 * len(layers), launches
    for (name, dt), (got, args) in outs.items():
        bh, s, n, p, chunk = next(row[1:] for row in layers
                                  if row[0] == name)
        short = str(dt).replace("torch.", "")
        tag = f"{name} ({bh},{s},{n},{p}) c{chunk} {short}"
        ref = ss.ssm_scan_plain(*args, chunk=chunk)
        if dt == torch.float32:
            _check_close(f"ssm_scan {tag}", got, ref, *SSM_TOL, results)
            # the model's core on the same numbers, in its (B,S,H,.) layout
            b, h = 4, bh // 4
            y_model, _ = chunked_linear_attention(
                *(_as_model(t, b, h) for t in args), chunk=chunk)
            y_model = y_model.transpose(1, 2).reshape(bh, s, p)
            _check_close(f"ssm_scan vs chunked_linear_attention {tag}", got,
                         y_model.contiguous(), *SSM_TOL, results)
        else:
            _check_close(f"ssm_scan {tag}", got, ref, BF16_ULP, 1e-5
                         * float(ref.float().abs().max()), results)
    del outs
    # the kernel_bench shape, S equal to the chunk, S below the default
    # chunk, ragged N and P, float64
    for i, (bh, s, n, p, chunk, dt) in enumerate((
            (8, 4096, 64, 64, 128, torch.float32),
            (6, 256, 64, 64, 256, torch.float32),
            (5, 100, 40, 70, 128, torch.float32),
            (3, 96, 33, 65, 32, torch.float32),
            (2, 32, 8, 8, 8, torch.float32),
            (4, 512, 64, 130, 128, torch.float64),
            (2, 256, 512, 33, 128, torch.float64))):
        args = _ssm_inputs(bh, s, n, p, dt, 100 + i)
        got = ss.ssm_scan(*args, chunk=chunk)
        ref = ss.ssm_scan_plain(*args, chunk=chunk)
        tol = SSM_TOL if dt == torch.float32 \
            else (0.0, FP64_REL * float(ref.abs().max()))
        short = str(dt).replace("torch.", "")
        _check_close(f"ssm_scan ({bh},{s},{n},{p}) c{chunk} {short}", got,
                     ref, *tol, results)
    args = _ssm_inputs(2, 300, 8, 8, torch.float32, 120)
    _raises_value_error("ssm_scan S % chunk != 0", lambda: ops.ssm_scan(
        *args, chunk=128), results)
    # shared memory: a state of N 2048 at chunk 256 is staged in slices, so
    # it runs; so does a chunk of 1024 where P fits one column tile (the
    # scores stream a tile of keys at a time); where P spans several tiles,
    # the scores of all the chunk's keys stay resident, and a chunk of 1024
    # exceeds the block
    for i, (bh, s, n, p, chunk) in enumerate(((1, 256, 2048, 8, 256),
                                              (1, 1024, 8, 8, 1024))):
        args = _ssm_inputs(bh, s, n, p, torch.float32, 121 + i)
        _check_close(f"ssm_scan ({bh},{s},{n},{p}) c{chunk} float32",
                     ss.ssm_scan(*args, chunk=chunk),
                     ss.ssm_scan_plain(*args, chunk=chunk), *SSM_TOL, results)
    args = _ssm_inputs(1, 1024, 8, 72, torch.float32, 123)
    _raises_value_error("ssm_scan chunk beyond shared memory",
                        lambda: ops.ssm_scan(*args, chunk=1024), results)
    torch.cuda.synchronize()

    timed = {}
    heavy = dict(warmup=1, reps=5, inner=2)
    for name, bh, s, n, p, chunk in layers:
        for dt in (torch.float32, torch.bfloat16):
            args = f32_inputs[name] if dt == torch.float32 \
                else _ssm_inputs(bh, s, n, p, dt, 90)
            key = name if dt == torch.float32 else f"{name} bfloat16"
            bnd, by = ssm_bound(bh, s, n, p, chunk, args[0].element_size())
            timed[key] = {
                "shape": [bh, s, n, p], "chunk": chunk,
                "dtype": str(dt).replace("torch.", ""),
                "ms": time_ms(lambda: ss.ssm_scan(*args, chunk=chunk),
                              **heavy),
                "plain_ms": time_ms(lambda: ss.ssm_scan_plain(
                    *args, chunk=chunk), **heavy),
                "library_ms": None, "bound_ms": bnd, "bound_by": by}
    timed["library_note"] = ("null: no single PyTorch call computes the "
                             "chunked decayed linear attention")
    emit("ssm_kernel", launches=launches, n_checks=len(results),
         checks=results, timed=timed)
    return results, timed, launches


# ---------------------------------------------------------------------------
# phases 11-12: serve zamba2-7b and xlstm-1.3b at full width
# ---------------------------------------------------------------------------


# (arch, slots, requests): 16 requests over 8 slots and 4 over 2 both start
# at pressure 2 (int8 head) and end at 1 (bf16 compute)
SSM_SERVE = (("zamba2-7b", 8, 16), ("xlstm-1.3b", 2, 4))
SSM_EXACT_LAYERS = {"zamba2-7b": 7, "xlstm-1.3b": 4}


def run_ssm_serving():
    """Both SSM-family models at full width: serve, then the exact check on
    the same random parameters; each tree is freed before the next."""
    out = {}
    for arch, slots, n_requests in SSM_SERVE:
        # what earlier phases still hold: nothing of any size
        emit("serve_ssm_start", arch=arch,
             memory_allocated=torch.cuda.memory_allocated())
        cfg = get_config(arch)
        gen = torch.Generator(device=DEV).manual_seed(0)
        params = init_params(model_template(cfg), gen, device=DEV)
        launches = phase_serve(cfg, params, slots, n_requests, "serve_ssm")
        # zamba2-7b: one group of 6 Mamba2 layers, the shared block and one
        # tail layer; xlstm-1.3b: 4 layers
        flash = phase_serve_exact(cfg, params, SSM_EXACT_LAYERS[arch],
                                  full_depth=False, phase="serve_ssm_exact")
        out[arch] = {"matmul_int8": launches["matmul_int8"],
                     "flash_fwd": flash}
        del params
        free_memory()
    return out


# ---------------------------------------------------------------------------
# phases 15-18: the mixture-of-experts, MLA, vision and encoder-decoder
# families at full width
# ---------------------------------------------------------------------------

MOE_EXACT_LAYERS = 2
EXACT_CAPACITY = 8.0      # no token dropped: cached and full forwards agree
CROSS_GATE = 0.5          # the reference initialises the gate to zero
# (batch, heads, Sq, Sk, head_dim) of the cross layers in phase 18: the
# vision model's 1600 patch embeddings, the audio encoder's 512 frames; Sq
# is the prompt in a prefill and 1 in a decode step
CROSS_ATT = {VISION_ARCH: (2, 32, 128, 1600, 128),
             AUDIO_ARCH: (2, 16, 128, 512, 64)}


def with_capacity(cfg, factor):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=factor))


def run_moe_serving(cfg):
    """Phases 15-16, granite-moe-3b-a800m at full width and depth in
    float32 (``cfg``): serve through all three rungs of the ladder, then
    the exact check at 2 layers with capacity factor 8.0 (no drops, so the
    cached path and the full forward route alike), on one random tree."""
    emit("serve_moe_start", arch=cfg.name,
         memory_allocated=torch.cuda.memory_allocated())
    gen = torch.Generator(device=DEV).manual_seed(0)
    params = init_params(model_template(cfg), gen, device=DEV)
    launches = phase_serve(cfg, params, 8, 16, "serve_moe", spread=2)
    flash = phase_serve_exact(with_capacity(cfg, EXACT_CAPACITY), params,
                              MOE_EXACT_LAYERS, full_depth=False,
                              phase="serve_moe_exact")
    del params
    free_memory()
    return {"matmul_int8": launches["matmul_int8"], "flash_fwd": flash}


def _logit_gap(a, b):
    """max |a - b| over max |b|, in float64."""
    b = b.double()
    return float((a.double() - b).abs().max() / b.abs().max())


def check_mla_triangular(cfg, s_len, results):
    """``_mla_triangular`` (two q blocks of 1024 when S = 2048) against one
    ``mla_chunked`` call over all keys, on the same bf16 inputs at the
    model's widths: the same online softmax, another split of the rows."""
    m = cfg.mla
    gen = torch.Generator(device=DEV).manual_seed(9)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=DEV) * scale).to(
            torch.bfloat16)
    qn = rnd(1, s_len, cfg.n_heads, m.qk_nope_head_dim)
    qr = rnd(1, s_len, cfg.n_heads, m.qk_rope_head_dim)
    ckv, ckr = rnd(1, s_len, m.kv_lora_rank), rnd(1, s_len,
                                                 m.qk_rope_head_dim)
    wkv = rnd(m.kv_lora_rank, cfg.n_heads, m.qk_nope_head_dim + m.v_head_dim,
              scale=m.kv_lora_rank ** -0.5)
    pos = torch.arange(s_len, device=DEV, dtype=torch.int32)[None, :]
    tri = attn_mod._mla_triangular(cfg, qn, qr, ckv, ckr, wkv, pos)
    whole = attn_mod.mla_chunked(
        cfg, qn, qr, ckv, ckr, wkv, pos,
        torch.ones((1, s_len), dtype=torch.bool, device=DEV))
    _check_float(f"mla _mla_triangular vs mla_chunked S={s_len} bfloat16",
                 tri, whole, BF16_ULP, results, BF16_ULP / 2)


@torch.inference_mode()
def phase_serve_mla(cfg, params, prompt=64, steps=4, tri_len=2048):
    """Phase 17, deepseek-v3-671b at full width, 1 dense + 1 MoE layer,
    bf16 parameters and compute (``cfg``, capacity factor 8.0 where a
    cached path is held to the full forward): the serve steps' prefill and
    the absorbed decode against the no-cache forward, with float32 compute
    as the witness (as :func:`full_depth_witness`: the bf16 cached logits
    no further from float32's than WITNESS_FACTOR times bf16's own full
    forward, plus 1e-3 of the largest logit); a from-zero prefill of
    ``tri_len`` tokens that fills its cache (the triangular q-block loop in
    both layers) against the same prompt without the hint, within the
    witness's largest gap; ``_mla_triangular`` against ``mla_chunked`` at
    S = ``tri_len``; ``lm_loss`` with its MTP term, finite; then the engine
    at 8 slots through the ladder (the int8 head at (8,7168)@(7168,129280)).
    Returns the launches of each path."""
    results, gaps = [], {}
    exact = with_capacity(cfg, EXACT_CAPACITY)
    gen = torch.Generator(device=DEV).manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (2, prompt), generator=gen,
                         device=DEV, dtype=torch.int32)
    t0 = time.perf_counter()
    lg, cache = make_prefill_step(exact, None, prompt + steps)(
        params, {"tokens": toks})
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    assert cache["c_kv"].shape == (1, 2, prompt + steps,
                                   cfg.mla.kv_lora_rank)
    decode = make_decode_step(exact)
    cached, seq, decode_s = [lg], toks, 0.0
    for _ in range(steps):
        nxt = torch.argmax(cached[-1], dim=-1).to(torch.int32)[:, None]
        seq = torch.cat([seq, nxt], dim=1)
        t0 = time.perf_counter()
        lg, cache = decode(params, cache, {"tokens": nxt})
        torch.cuda.synchronize()
        decode_s += time.perf_counter() - t0
        cached.append(lg)
    # the no-cache forward over the whole sequence gives every prefix's
    # last logits (causal, and no token dropped at capacity factor 8); in
    # float32 compute it is the witness of bf16's own rounding
    full, _, _ = forward(exact, params, seq)
    full32, _, _ = forward(dataclasses.replace(exact, compute_dtype="float32"),
                           params, seq)
    gaps.update(cached_vs_full32=[], full_vs_full32=[])
    for i, lg in enumerate(cached):
        at = prompt - 1 + i
        assert torch.isfinite(lg).all() and torch.isfinite(full[:, at]).all()
        gaps["cached_vs_full32"].append(_logit_gap(lg, full32[:, at]))
        gaps["full_vs_full32"].append(_logit_gap(full[:, at], full32[:, at]))
    for cached_gap, oracle_gap in zip(gaps["cached_vs_full32"],
                                      gaps["full_vs_full32"]):
        assert cached_gap <= WITNESS_FACTOR * oracle_gap + 1e-3, gaps
    del full, full32

    long = torch.randint(0, cfg.vocab_size, (1, tri_len), generator=gen,
                         device=DEV, dtype=torch.int32)
    calls = []
    tri = attn_mod._mla_triangular
    attn_mod._mla_triangular = lambda *a, **k: calls.append(1) or tri(*a, **k)
    try:
        t0 = time.perf_counter()
        hinted, _ = make_prefill_step(exact, None, tri_len)(
            params, {"tokens": long})
        torch.cuda.synchronize()
        hint_ms = 1e3 * (time.perf_counter() - t0)
        assert len(calls) == cfg.n_layers, calls      # every MLA layer
        cache = init_cache(exact, 1, tri_len, device=DEV)
        plain, _, _ = forward(exact, params, long, cache=cache)  # no hint
        plain = plain[:, -1]
        assert len(calls) == cfg.n_layers, calls      # mla_chunked only
    finally:
        attn_mod._mla_triangular = tri
    # the same arithmetic per query row, split into other row blocks, where
    # a rounding may fall the other way: held to what all of bf16's
    # roundings move the logits by (the witness above), plus the slack
    gaps["hint_vs_no_hint"] = _logit_gap(hinted, plain)
    hint_tol = max(gaps["full_vs_full32"]) + 1e-3
    assert gaps["hint_vs_no_hint"] <= hint_tol, gaps
    check_mla_triangular(cfg, tri_len, results)
    free_memory()

    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    att.reset_launches()             # the loss's path starts here
    total, metrics = lm_loss(cfg, params, batch)
    loss_flash = att.LAUNCHES["flash_fwd"]       # read right after it
    assert loss_flash == 1, att.LAUNCHES          # the MTP layer's GQA
    for key in ("ce", "aux", "mtp"):
        assert bool(torch.isfinite(metrics[key])), metrics
    emit("serve_mla", arch=cfg.name, n_layers=cfg.n_layers,
         n_dense_layers=cfg.moe.n_dense_layers, compute_dtype=cfg.compute_dtype,
         param_count=sum(t.numel() for t in tree_leaves(params)),
         param_bytes=tree_size_bytes(params), prompt=prompt, steps=steps,
         prefill_ms=prefill_ms, decode_ms=1e3 * decode_s / steps,
         from_zero_prefill_len=tri_len, from_zero_prefill_ms=hint_ms,
         triangular_calls=len(calls), rel_gaps=gaps,
         witness_factor=WITNESS_FACTOR, hint_rel_tol=hint_tol,
         loss={k: float(v) for k, v in metrics.items()},
         loss_total=float(total), loss_flash_fwd_launches=loss_flash,
         checks=results,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    launches = phase_serve(cfg, params, 8, 16, "serve_mla_engine", max_new=8)
    return {"matmul_int8": launches["matmul_int8"], "flash_fwd": loss_flash}


def run_mla_serving(cfg):
    emit("serve_mla_start", arch=cfg.name,
         memory_allocated=torch.cuda.memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEV).manual_seed(0)
    params = init_params(model_template(cfg), gen,
                         dtype=torch_dtype(cfg.param_dtype), device=DEV)
    emit("serve_mla_params", param_bytes=tree_size_bytes(params),
         max_memory_allocated=torch.cuda.max_memory_allocated())
    out = phase_serve_mla(cfg, params)
    del params
    free_memory()
    return out


def cross_bound(b, h, sq, sk, d, elt, dtype):
    """Least time for one non-causal forward: q, k, v read and out written
    once plus the key mask and lse, or the two products (q.k and p.v, 2*D
    operations a pair) of every query with every key."""
    g = b * h
    t_bytes = ((2 * sq + 2 * sk) * g * d * elt + g * (sk + sq) * 4) \
        / PEAK_BYTES_PER_S
    t_ops = 2 * 2 * d * g * sq * sk / PEAKS_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_cross_kernel(arch, results):
    """The forward kernel in its non-causal mode at ``arch``'s cross shape,
    against its plain version: bf16 and f32 with every memory row valid
    (as the model calls it), bf16 with some invalid and batch 0 dead, at
    Sq = prompt and Sq = 1 (one-row query blocks); then the times of the
    bf16 calls beside the plain version and F.scaled_dot_product_attention
    on the same operands."""
    b, h, sq, sk, d = CROSS_ATT[arch]
    timed = {}
    for i, rows in enumerate((sq, 1)):
        for j, dtype in enumerate((torch.bfloat16, torch.float32)):
            f = check_attention_fwd(f"cross {arch} ({b},{h},{rows},{sk},{d})",
                                    b, h, rows, sk, d, dtype, False, 128, 128,
                                    60 + 4 * i + j, results, p_valid=1.0)
            if dtype == torch.bfloat16:
                kw = dict(zip(("qf", "kf", "vf", "kvm"),
                              (f[n] for n in ("qf", "kf", "vf", "kvm"))))
                bnd, by = cross_bound(b, h, rows, sk, d, 2, "bfloat16")
                timed[f"sq{rows}"] = {
                    "shape": [b, h, rows, sk, d], "dtype": "bfloat16",
                    "causal": False, "blocks": [f["geom"]["bq"],
                                                f["geom"]["bk"]],
                    "max_abs_err": float((f["out"].double()
                                          - f["p_out"].double()).abs().max()),
                    "ms": time_ms(lambda: att.flash_fwd(**kw, **f["geom"])),
                    "plain_ms": time_ms(lambda: att.flash_fwd_plain(
                        **kw, **f["geom"]), warmup=2, reps=5, inner=3),
                    "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                        f["q"], f["k"], f["v"])),
                    "bound_ms": bnd, "bound_by": by}
        check_attention_fwd(f"cross {arch} dead ({b},{h},{rows},{sk},{d})",
                            b, h, rows, sk, d, torch.bfloat16, False, 128,
                            128, 70 + i, results, p_valid=0.9, dead=True)
    torch.cuda.synchronize()
    return timed


def _cross_layers(cfg):
    """Cross-attention calls in one forward: the vision model's cross
    blocks, every decoder layer of the encoder-decoder model."""
    return cfg.n_layers // cfg.cross_attn_every if cfg.family == "vlm" \
        else cfg.n_layers


@torch.inference_mode()
def serve_cross_steps(cfg, params, prompt=128, steps=4, tol=None):
    """The serve steps of one frontend model: ``make_prefill_step`` into a
    cache of ``prompt + steps`` rows, then ``steps`` greedy
    ``make_decode_step`` calls, the frontend in every batch, each step's
    logits against the no-cache forward's at that position (held within
    ``tol`` where given, else only printed). The cross layers run through
    the kernel's non-causal mode: its launches are counted from 0 right
    before the steps and read right after them. Returns (launches, fields
    to print)."""
    dt = params["embed"].dtype
    b = CROSS_ATT[cfg.name][0]
    gen = torch.Generator(device=DEV).manual_seed(4)
    fe = torch.randn((b, cfg.frontend_seq, cfg.frontend_dim or cfg.d_model),
                     generator=gen, device=DEV, dtype=torch.float32).to(dt)
    toks = torch.randint(0, cfg.vocab_size, (b, prompt), generator=gen,
                         device=DEV, dtype=torch.int32)
    prefill = make_prefill_step(cfg, None, prompt + steps, cache_dtype=dt)
    decode = make_decode_step(cfg)
    att.reset_launches()           # the serving path starts here
    t0 = time.perf_counter()
    lg, cache = prefill(params, {"tokens": toks, "frontend_emb": fe})
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    cached, seq, decode_s = [lg], toks, 0.0
    for _ in range(steps):
        nxt = torch.argmax(cached[-1], dim=-1).to(torch.int32)[:, None]
        seq = torch.cat([seq, nxt], dim=1)
        t0 = time.perf_counter()
        lg, cache = decode(params, cache, {"tokens": nxt, "frontend_emb": fe})
        torch.cuda.synchronize()
        decode_s += time.perf_counter() - t0
        cached.append(lg)
    flash = att.LAUNCHES["flash_fwd"]     # read right after the path
    assert flash == _cross_layers(cfg) * (1 + steps), (flash, cfg.name)
    full, _, _ = forward(cfg, params, seq, frontend_emb=fe)
    gaps, tokens_equal = [], True
    for i, lg in enumerate(cached):
        at = prompt - 1 + i
        assert lg.dtype == dt and torch.isfinite(lg).all()
        gaps.append(_gap(lg, full[:, at]))
        tokens_equal &= bool(torch.equal(torch.argmax(lg, -1),
                                         torch.argmax(full[:, at], -1)))
    if tol is not None:
        assert max(gaps) < tol, (cfg.name, cfg.compute_dtype, gaps)
    return flash, {"compute_dtype": cfg.compute_dtype, "batch": b,
                   "prompt": prompt, "steps": steps, "prefill_ms": prefill_ms,
                   "decode_ms": 1e3 * decode_s / steps, "logits_err": gaps,
                   "logits_tol": tol, "logit_max": float(full.abs().max()),
                   "greedy_tokens_equal": tokens_equal,
                   "flash_fwd_launches": flash}


def phase_serve_cross(cfg, params):
    """Phase 18 for one frontend model at full width (``params`` float32):
    the forward kernel against its plain version at the model's cross
    shape (:func:`check_cross_kernel`); the serve steps in float64 held to
    the no-cache forward within FP64_TOL; the same steps in float32 and in
    bfloat16 (the configured compute, timed), their gaps printed: the
    random stack is chaotic (see :func:`full_depth_witness`), so that in
    float32 one summation order against another moves the vision model's
    logits by far more than 1e-3. Returns ({dtype: launches}, checks,
    times)."""
    results = []
    timed = check_cross_kernel(cfg.name, results)
    launches, runs = {}, {}
    for dtype, tol in (("float64", FP64_TOL), ("float32", None),
                       ("bfloat16", None)):
        run_cfg = dataclasses.replace(cfg, compute_dtype=dtype)
        cast = tree_map(lambda a: a.to(torch_dtype(dtype)), params)
        launches[dtype], runs[dtype] = serve_cross_steps(run_cfg, cast,
                                                         tol=tol)
        del cast
        free_memory()
    emit("serve_cross", arch=cfg.name, family=cfg.family,
         n_layers=cfg.n_layers, n_encoder_layers=cfg.n_encoder_layers,
         d_model=cfg.d_model,
         param_count=sum(t.numel() for t in tree_leaves(params)),
         cross_gate=(float(params["cross_layers"]["attn"]["gate"][0])
                     if "cross_layers" in params else None),
         runs=runs, n_checks=len(results), checks=results, timed=timed,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    return launches, results, timed


def serving_cfgs():
    """The configurations of phases 15-18, at full width:
    granite-moe-3b-a800m at full depth in float32; deepseek-v3-671b cut to
    1 dense + 1 MoE layer (and its MTP module), bf16 as configured;
    llama-3.2-vision-11b cut to one group (5 self layers and a cross
    layer); seamless-m4t-medium at full depth (12 + 12 layers)."""
    ds = get_config(MLA_ARCH)
    vision = get_config(VISION_ARCH)
    return {
        MOE_ARCH: dataclasses.replace(get_config(MOE_ARCH),
                                      compute_dtype="float32"),
        MLA_ARCH: dataclasses.replace(
            ds, n_layers=2, moe=dataclasses.replace(ds.moe,
                                                    n_dense_layers=1)),
        VISION_ARCH: dataclasses.replace(vision,
                                         n_layers=vision.cross_attn_every),
        AUDIO_ARCH: get_config(AUDIO_ARCH)}


def run_cross_serving(cfgs):
    """Phase 18 for each config of ``cfgs``, each tree freed before the
    next; float32 parameters from seed 0, the vision model's gate set to
    CROSS_GATE."""
    out = {}
    for cfg in cfgs:
        emit("serve_cross_start", arch=cfg.name,
             memory_allocated=torch.cuda.memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=DEV).manual_seed(0)
        params = init_params(model_template(cfg), gen, device=DEV)
        if "cross_layers" in params:
            params["cross_layers"]["attn"]["gate"].fill_(CROSS_GATE)
        out[cfg.name] = phase_serve_cross(cfg, params)
        del params
        free_memory()
    return out


# ---------------------------------------------------------------------------
# phase 13: the Ara vector engine (no CUDA kernel of its own)
# ---------------------------------------------------------------------------

ENGINE_GRID_N = 20          # programs per SEW x LMUL cell: 420 a dtype
ENGINE_CHECK_N = 64         # Listing-1 held bit for bit to the CPU run
ENGINE_N = 256              # Listing-1 at the paper's marquee size ...
ENGINE_LANES = 16           # ... on 16 lanes' VLMAX (1024 DP elements)
ENGINE_REL = 1e-12          # against numpy's A @ B + C (another order)


def _same_bits(a, b) -> bool:
    """Equal dtype, shape and bits (any NaN matches any NaN: CPU and card
    may spell a generated NaN differently)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    ua, ub = a.view(f"u{a.itemsize}"), b.view(f"u{b.itemsize}")
    if a.dtype.kind == "f":
        return bool(np.all((ua == ub) | (np.isnan(a) & np.isnan(b))))
    return bool(np.array_equal(ua, ub))


def _engine_results_equal(card, cpu):
    """``run_many`` results of two engines, bit for bit."""
    (m1, s1), (m2, s2) = card, cpu
    return len(m1) == len(m2) and all(
        _same_bits(a, b) for a, b in zip(m1, m2)) and all(
        _same_bits(np.array([x[k] for k in sorted(x)]),
                   np.array([y[k] for k in sorted(y)]))
        for x, y in zip(s1, s2))


def _engine_grid(dtype, device, results):
    """The 21-cell SEW x LMUL grid (integer cells only for int32 storage):
    the engine on ``device`` against the numpy oracle at ``diff.TOL``
    (float storage) and against the same engine on the CPU at tol=0."""
    cfg = AraConfig(lanes=2)
    card = ReferenceEngine(cfg, vlmax=diff.VLMAX64, dtype=dtype,
                           device=device)
    cpu = ReferenceEngine(cfg, vlmax=diff.VLMAX64, dtype=dtype,
                          device="cpu")
    win = diff.grid_window(diff.VLMAX64)
    cells = [c for c in diff.cells(ENGINE_GRID_N)
             if dtype != torch.int32 or c[0] in isa.INT_SEWS]
    ran, clock = [], [0.0]

    def card_batch(progs, mems, srs):
        t0 = time.perf_counter()
        out = card.run_many(progs, mems, srs, window=win)
        clock[0] += time.perf_counter() - t0
        ran.append((progs, mems, srs, out))
        return out

    name = str(dtype).replace("torch.", "")
    if dtype == torch.int32:
        # the oracle keeps a float scalar file where int32 storage
        # truncates it on entry, so int32 is held to the CPU run alone
        for sew, lmul, seeds in cells:
            batch = [diff.random_program(np.random.RandomState(seed), sew,
                                         lmul) for seed in seeds]
            card_batch([b[0] for b in batch], [b[1] for b in batch],
                       [dict(b[2]) for b in batch])
        checked = sum(len(r[0]) for r in ran)
    else:
        storage = np.float64 if dtype == torch.float64 else np.float32
        checked = diff.run_cells(
            card_batch, diff.oracle_batch(diff.VLMAX64, storage=storage),
            cells, label=f"vector_engine {name} vs oracle")
    t0 = time.perf_counter()
    same = all(_engine_results_equal(
        out, cpu.run_many(progs, mems, srs, window=win))
        for progs, mems, srs, out in ran)
    cpu_s = time.perf_counter() - t0
    if not same:
        raise AssertionError(f"vector_engine grid {name}: the card's "
                             "results differ from the CPU run's")
    rows = sum(len(staging.encode_program(p, diff.VLMAX64))
               for progs, *_ in ran for p in progs)
    results.append({"name": f"grid {name}", "programs": checked,
                    "cells": len(cells), "oracle": dtype != torch.int32,
                    "bit_equal_to_cpu": same})
    return {"programs": checked, "rows": rows, "card_s": clock[0],
            "programs_per_s": checked / clock[0],
            "rows_per_s": rows / clock[0], "cpu_s": cpu_s}


def _listing1(n, cfg, seed):
    rng = np.random.RandomState(seed)
    a, b, c = rng.randn(n, n), rng.randn(n, n), rng.randn(n, n)
    mem = np.concatenate([a.ravel(), b.ravel(), c.ravel()])
    prog = isa.matmul_program(n, 0, n * n, 2 * n * n, t=4,
                              vlmax=cfg.vlmax_dp)
    return prog, mem, a @ b + c


def _graph_break_even(cfg, prog, mem, device):
    """One program run with CUDA graphs and then eagerly on one runner
    (bit-equal): the capture seconds a graph, the seconds a replayed group
    saves against its eager branch, and their ratio, the repeats a group
    shape needs in one call before its capture pays."""
    eng = ReferenceEngine(cfg, cache=staging.TraceCache(), device=device)
    eng.run(prog, mem)                                  # build, warm up
    runner, = eng.cache._fns.values()
    inner, stat = runner._graphs, {"graphs": 0, "replays": 0, "s": 0.0}

    def timed_graphs(c, groups):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graphs = inner(c, groups)
        torch.cuda.synchronize()
        stat["s"] += time.perf_counter() - t0
        stat["graphs"] += len(graphs)
        stat["replays"] += sum((key, end - start, nf) in graphs
                               for _, start, end, key, nf in groups)
        return graphs

    runner._graphs = timed_graphs
    t0 = time.perf_counter()
    replayed = eng.run(prog, mem)
    graph_s = time.perf_counter() - t0
    runner.graphs = False
    t0 = time.perf_counter()
    eager = eng.run(prog, mem)
    eager_s = time.perf_counter() - t0
    if not _engine_results_equal(([replayed[0]], [replayed[1]]),
                                 ([eager[0]], [eager[1]])):
        raise AssertionError("vector_engine: replayed graphs differ from "
                             "the eager run")
    capture = stat["s"] / stat["graphs"]
    saved = (eager_s - (graph_s - stat["s"])) / stat["replays"]
    return {"rows": len(prog), "graphs": stat["graphs"],
            "replays": stat["replays"], "graph_s": graph_s,
            "eager_s": eager_s, "capture_ms_per_graph": 1e3 * capture,
            "saved_ms_per_replay": 1e3 * saved,
            "break_even_repeats": capture / saved,
            "min_repeats": staging.GRAPH_MIN_REPEATS}


def phase_vector_engine(smi, device=DEV):
    """Phase 13: the staged ReferenceEngine on the card (float64 storage
    unless named): the grid in float32, float64 and int32; Listing-1 at
    n = 64 bit-equal to the CPU run; Listing-1 at n = 256 on 16 lanes'
    VLMAX against numpy, timed, with its scoreboard cycles; a batch mixing
    Listing-1 and grid programs bit-equal to the CPU run; the demo's
    masked argmax. Wall seconds on the host clock (each call ends in the
    one copy of its results to the host)."""
    results, timed = [], {}
    for dtype in (torch.float32, torch.float64, torch.int32):
        timed[f"grid_{str(dtype).replace('torch.', '')}"] = _engine_grid(
            dtype, device, results)

    cfg = AraConfig(lanes=4)
    prog, mem, _ = _listing1(ENGINE_CHECK_N, cfg, 1)
    t0 = time.perf_counter()
    card = ReferenceEngine(cfg, device=device).run(prog, mem)
    card_s = time.perf_counter() - t0
    cpu = ReferenceEngine(cfg, device="cpu").run(prog, mem)
    if not (_same_bits(card[0], cpu[0])
            and _engine_results_equal(([card[0]], [card[1]]),
                                      ([cpu[0]], [cpu[1]]))):
        raise AssertionError("vector_engine Listing-1 n=64: the card's "
                             "result differs from the CPU run's")
    results.append({"name": f"listing1 n={ENGINE_CHECK_N} lanes=4",
                    "bit_equal_to_cpu": True})
    timed["listing1_64"] = {"rows": len(prog), "card_s": card_s,
                            "rows_per_s": len(prog) / card_s}
    timed["graph_break_even"] = _graph_break_even(cfg, prog, mem, device)

    # one batch of three Listing-1 programs beside three grid programs:
    # the rows the three share recur as groups of 3 (replayed graphs)
    # while the grid programs run beside them
    cfg = AraConfig(lanes=2)
    batch = [_listing1(16, cfg, seed) for seed in range(3)]
    refs = [b[2] for b in batch]
    batch += [diff.random_program(np.random.RandomState(seed), sew, 2,
                                  vlmax64=cfg.vlmax_dp)
              for seed, sew in ((0, 32), (1, 16), (2, 64))]
    progs, mems = [b[0] for b in batch], [b[1] for b in batch]
    srs = [{0: 0.5}] * len(batch)
    got = ReferenceEngine(cfg, device=device).run_many(progs, mems, srs)
    if not _engine_results_equal(got, ReferenceEngine(
            cfg, device="cpu").run_many(progs, mems, srs)):
        raise AssertionError("vector_engine mixed batch: the card's results "
                             "differ from the CPU run's")
    for out, ref in zip(got[0], refs):
        err = np.abs(out[2 * 256:].reshape(16, 16) - ref).max()
        if not err <= ENGINE_REL * np.abs(ref).max():
            raise AssertionError(f"vector_engine mixed batch: Listing-1 "
                                 f"error {err:.3e}")
    results.append({"name": "mixed batch: 3 x listing1 n=16, 3 grid programs",
                    "bit_equal_to_cpu": True})

    cfg = AraConfig(lanes=ENGINE_LANES)
    n = ENGINE_N
    prog, mem, ref = _listing1(n, cfg, 0)
    t0 = time.perf_counter()
    staging.pack_tables([staging.encode_program(prog, cfg.vlmax_dp)])
    encode_s = time.perf_counter() - t0      # the host's share of the run
    eng = ReferenceEngine(cfg, device=device)
    t0 = time.perf_counter()
    out, _ = eng.run(prog, mem)
    wall = time.perf_counter() - t0
    err = float(np.abs(out[2 * n * n:].reshape(n, n) - ref).max()
                / np.abs(ref).max())
    if not err <= ENGINE_REL:
        raise AssertionError(f"vector_engine Listing-1 n={n}: error "
                             f"{err:.3e} relative to max |A B + C| "
                             f"exceeds {ENGINE_REL}")
    tr = simulate_timing(prog, cfg)
    results.append({"name": f"listing1 n={n} lanes={ENGINE_LANES}",
                    "max_rel_err": err})
    timed["listing1_256"] = {
        "n": n, "lanes": ENGINE_LANES, "vlmax": cfg.vlmax_dp,
        "rows": len(prog), "wall_s": wall, "rows_per_s": len(prog) / wall,
        "encode_s": encode_s,
        "max_rel_err": err, "scoreboard_cycles": tr.cycles,
        "closed_form_cycles": pm.matmul_cycles(cfg, n),
        "unit_busy": tr.unit_busy}

    vl = 32
    rng = np.random.RandomState(0)
    vals = rng.randn(vl)
    vals[vl // 3] = vals[2 * vl // 3] = vals.max() + 1.0   # tie
    mem2 = np.zeros(4 * vl + 64)
    mem2[:vl] = vals
    mem2[vl:2 * vl] = np.arange(vl, dtype=float)
    amax = [isa.VSETVL(vl, 32, 1), isa.VLD(4, 0)] \
        + isa.argmax_program(4, vl, sd=0, huge_sreg=1)
    _, s = ReferenceEngine(AraConfig(lanes=4), device=device).run(
        amax, mem2, sregs={1: float(vl + 9)})
    if int(s[0]) != int(np.argmax(vals)):
        raise AssertionError(f"vector_engine argmax {int(s[0])} != "
                             f"numpy's {int(np.argmax(vals))}")
    results.append({"name": f"masked argmax vl={vl}", "argmax": int(s[0])})
    emit("vector_engine", gpu=smi, n_checks=len(results), checks=results,
         timed=timed)
    return results, timed, (prog, mem, out)


# ---------------------------------------------------------------------------
# phase 14: the lane-partitioned and clustered Ara engines (no CUDA kernel)
# ---------------------------------------------------------------------------

LANE_GRID_N = 5             # programs per SEW x LMUL cell: 105 a dtype
LANE_TOPOLOGIES = (("lane", 2), ("cluster", 2, 2), ("cluster", 2, 4),
                   ("cluster", 4, 2))
LISTING_TOPOLOGIES = (("lane", 16), ("cluster", 4, 4))


def _topology_name(t):
    return f"lane{t[1]}" if t[0] == "lane" else f"cluster{t[1]}x{t[2]}"


def _lane_engine(topology, cfg, dtype, device, **kw):
    if topology[0] == "lane":
        return LaneEngine(cfg, make_lane_mesh(topology[1]), dtype=dtype,
                          device=device, **kw)
    return ClusterEngine(cfg, topology[1], topology[2], dtype=dtype,
                         device=device, **kw)


def _lanes_grid(dtype, device, results):
    """The grid (integer cells only for int32 storage), one batch a cell
    through the card's ReferenceEngine and each topology on the card and
    on the CPU: every result bit-equal to the ReferenceEngine's and to the
    CPU run's. Card seconds per engine on the host clock."""
    cfg = AraConfig(lanes=2)
    win = diff.grid_window(diff.VLMAX64)
    ref = ReferenceEngine(cfg, vlmax=diff.VLMAX64, dtype=dtype,
                          cache=staging.TraceCache(), device=device)
    engines = {_topology_name(t): tuple(
        _lane_engine(t, cfg, dtype, dev, vlmax=diff.VLMAX64,
                     cache=staging.TraceCache()) for dev in (device, "cpu"))
        for t in LANE_TOPOLOGIES}
    clock = dict.fromkeys(["ref", *engines], 0.0)
    name, programs = str(dtype).replace("torch.", ""), 0
    for sew, lmul, seeds in diff.cells(LANE_GRID_N):
        if dtype == torch.int32 and sew not in isa.INT_SEWS:
            continue
        batch = [diff.random_program(np.random.RandomState(seed), sew, lmul)
                 for seed in seeds]
        args = [b[0] for b in batch], [b[1] for b in batch]
        t0 = time.perf_counter()
        want = ref.run_many(*args, [dict(b[2]) for b in batch], window=win)
        clock["ref"] += time.perf_counter() - t0
        for eng, (card, cpu) in engines.items():
            t0 = time.perf_counter()
            got = card.run_many(*args, [dict(b[2]) for b in batch],
                                window=win)
            clock[eng] += time.perf_counter() - t0
            if not _engine_results_equal(got, want):
                raise AssertionError(
                    f"vector_engine_lanes grid {name} {eng} sew={sew} "
                    f"lmul={lmul}: differs from the ReferenceEngine")
            if not _engine_results_equal(got, cpu.run_many(
                    *args, [dict(b[2]) for b in batch], window=win)):
                raise AssertionError(
                    f"vector_engine_lanes grid {name} {eng} sew={sew} "
                    f"lmul={lmul}: the card differs from the CPU run")
        programs += len(batch)
    out = {"programs": programs,
           "ref_programs_per_s": programs / clock["ref"]}
    for eng, (card, _) in engines.items():
        st = card.cache.stats
        if st.compiles != 1:
            raise AssertionError(f"vector_engine_lanes grid {name} {eng}: "
                                 f"{st.compiles} runners, not one")
        out[eng] = {"programs_per_s": programs / clock[eng],
                    "vs_ref": clock["ref"] / clock[eng],
                    "folds": dict(st.folds),
                    "fold_stages": dict(st.fold_stages)}
        results.append({"name": f"grid {name} {eng}", "programs": programs,
                        "bit_equal_to_reference_and_cpu": True})
    return out


def _load_script(rel):
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), rel)
    spec = importlib.util.spec_from_file_location(
        "_" + os.path.basename(rel)[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_vector_engine_lanes(smi, listing, device=DEV):
    """Phase 14: the LaneEngine and ClusterEngine on the card. ``listing``
    is phase 13's (program, memory, ReferenceEngine result) of Listing-1
    at n = 256 on 16 lanes' VLMAX, float64."""
    results, timed = [], {}
    for dtype in (torch.float32, torch.float64, torch.int32):
        timed[f"grid_{str(dtype).replace('torch.', '')}"] = _lanes_grid(
            dtype, device, results)

    cfg, n = AraConfig(lanes=ENGINE_LANES), ENGINE_N
    prog, mem, want = listing
    for topology in LISTING_TOPOLOGIES:
        eng = _lane_engine(topology, cfg, torch.float64, device,
                           cache=staging.TraceCache())
        t0 = time.perf_counter()
        staging.pack_tables([staging.encode_program(prog, eng.vlmax64)])
        encode_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out, _ = eng.run(prog, mem)
        wall = time.perf_counter() - t0
        name = _topology_name(topology)
        if not _same_bits(out, want):
            raise AssertionError(f"vector_engine_lanes Listing-1 n={n} "
                                 f"{name}: differs from the ReferenceEngine")
        st = eng.cache.stats
        results.append({"name": f"listing1 n={n} {name}",
                        "bit_equal_to_reference": True})
        timed[f"listing1_256_{name}"] = {
            "n": n, "lanes": eng.lanes, "vlmax": eng.vlmax, "rows": len(prog),
            "wall_s": wall, "rows_per_s": len(prog) / wall,
            "encode_s": encode_s, "folds": dict(st.folds),
            "fold_stages": dict(st.fold_stages)}

    timed["cycles_listing1_256"] = {
        f"clusters_{c}": {"scoreboard": simulate_timing(
            prog, cfg, clusters=c).cycles,
            "closed_form": pm.matmul_cycles(cfg, n, clusters=c)}
        for c in (1, 4)}

    scaleout = _load_script("benchmarks/torch_scaleout.py")
    timed["scaleout_verify"] = scaleout.run_verify([(2, 2), (4, 2)],
                                                   device=device)
    results.append({"name": "torch_scaleout --verify 2x2,4x2",
                    "bit_exact": True})
    emit("vector_engine_lanes", gpu=smi, n_checks=len(results),
         checks=results, timed=timed)
    return results, timed


# ---------------------------------------------------------------------------
# phase 19: the serving fault registry on the card, at full width
# ---------------------------------------------------------------------------


def _flip_report(cfg, params, prompt, out):
    """Where ``out`` (an engine's greedy tokens) first leaves the oracle's:
    the oracle's top-2 logit gap at that token beside the gap between the
    cached path's logits and the full forward's over the same prefix."""
    want = faults.oracle(prompt, len(out))
    i = next(j for j, (a, b) in enumerate(zip(out, want)) if a != b)
    prefix = np.concatenate([np.asarray(prompt, np.int32),
                             np.asarray(want[:i], np.int32)])
    if i == 0:
        (cached, full), _, _ = _cached_and_full(cfg, params, prefix)
    else:
        nxt = torch.tensor([[int(prefix[-1])]], device=DEV, dtype=torch.int32)
        _, (cached, full), _ = _cached_and_full(cfg, params, prefix[:-1], nxt)
    return {"index": i, "got": out[i], "want": want[i],
            "top2_gap": float(torch.topk(full.double(), 2).values.diff()
                              .abs()),
            "cached_vs_full": _gap(cached, full)}


@torch.inference_mode()
def phase_serve_faults(cfg, params, n_layers=EXACT_LAYERS):
    """Every class of ``serving.faults.REGISTRY`` through ``verify`` on the
    card: tinyllama-1.1b at full width, depth cut to ``n_layers``, float32,
    where ``serve_exact`` holds the engine's greedy tokens equal to the
    oracle's. Each class must be detected by its code, recovered from with
    the survivors equal to the oracle, and do damage to the legacy engine.
    Where a survivor's token differs from the oracle's, the flip is printed
    (:func:`_flip_report`) and the phase fails. The oracle's full forwards
    run their attention through ``flash_fwd``: that count is set to 0 right
    before the registry and returned, read right after it."""
    cfg32, cut = _cut(cfg, params, n_layers, "float32")
    faults.use_fixture(cfg32, cut)
    mismatches = []
    matches = faults._matches_oracle

    def recording(req):
        ok = matches(req)
        if not ok and req.out_tokens:
            mismatches.append((np.array(req.prompt), list(req.out_tokens)))
        return ok
    faults._matches_oracle = recording
    reports = []
    att.reset_launches()           # the registry's path starts here
    t0 = time.perf_counter()
    try:
        for fault in faults.REGISTRY:
            mismatches.clear()
            t1 = time.perf_counter()
            try:
                rep = faults.verify(fault)
            except AssertionError:
                emit("serve_faults_flip", fault=fault.name,
                     flips=[_flip_report(cfg32, cut, p, o)
                            for p, o in mismatches])
                raise
            rep["seconds"] = time.perf_counter() - t1
            reports.append(rep)
            emit("serve_faults_class", **rep)
    finally:
        faults._matches_oracle = matches
        # drop the installed fixture: its views hold the model's storage
        faults._installed.clear()
        faults._oracle_cached.cache_clear()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    flash = att.LAUNCHES["flash_fwd"]    # read right after the registry
    per_forward = _attention_layers(cfg, n_layers)
    assert len(reports) == 10 and flash > 0 and flash % per_forward == 0, \
        (len(reports), flash)
    emit("serve_faults", arch=cfg.name, n_layers=n_layers,
         d_model=cfg.d_model, compute_dtype="float32", classes=len(reports),
         detected_recovered_nonvacuous=[r["name"] for r in reports],
         seconds=seconds, flash_fwd_launches=flash,
         oracle_forwards=flash // per_forward)
    return flash


# ---------------------------------------------------------------------------
# phase 20: the load gate (benchmarks/torch_serving_load.py) on the card
# ---------------------------------------------------------------------------


LOAD = dict(duration=120, rate=0.5, slots=4, max_seq=32, seed=0)


def phase_serving_load(cfg, params):
    """``torch_serving_load.bench`` at the reference's traffic (``LOAD``,
    the degrade ladder armed at 2.0 / 4.0) on tinyllama-1.1b at full width
    and depth in its configured precision. Zero undetected escapes, both
    rungs in the faulted phase, and one ``matmul_int8`` launch per int8
    decode step: that count is set to 0 right before the benchmark and
    returned, read right after it."""
    load = _load_script("benchmarks/torch_serving_load.py")
    mm.reset_launches()            # the load's path starts here
    res = load.bench(**LOAD, fixture=(cfg, params))
    torch.cuda.synchronize()
    launches = dict(mm.LAUNCHES)   # read right after the load
    clean, faulted = res["clean"], res["faulted"]
    assert faulted["undetected_escapes"] == 0, faulted["missing_detections"]
    assert faulted["injections"] > 0, faulted
    assert faulted["degraded_steps_bf16"] > 0, faulted
    assert faulted["degraded_steps_int8"] > 0, faulted
    int8_steps = clean["degraded_steps_int8"] + faulted["degraded_steps_int8"]
    assert launches["matmul_int8"] == int8_steps, (launches, int8_steps)
    assert res["config"]["backend"].startswith(DEV), res["config"]
    for phase in ("clean", "faulted"):
        row = {k: v for k, v in res[phase].items()
               if k != "missing_detections"}
        emit("serving_load", load_phase=phase, **row)
    emit("serving_load_config", arch=cfg.name, n_layers=cfg.n_layers,
         compute_dtype=cfg.compute_dtype, **res["config"],
         matmul_int8_launches=launches["matmul_int8"])
    return launches["matmul_int8"]


# ---------------------------------------------------------------------------
# phase 21: training that checkpoints and resumes, on the card
# ---------------------------------------------------------------------------


RESTART_LAYERS = 2
RESTART_STEPS, RESTART_AT = 6, 3


def _leaf_gaps(a, b):
    """{leaf path: (bit-equal, max |a - b|)} over two states, the leaves in
    the checkpoint's order."""
    out = {}
    for (path, x), (path_y, y) in zip(ckpt._flatten(a), ckpt._flatten(b)):
        assert path == path_y and x.dtype == y.dtype \
            and x.shape == y.shape, (path, path_y)
        same = torch.equal(x.reshape(-1).view(torch.uint8),
                           y.reshape(-1).view(torch.uint8))
        out["/".join(path)] = (same, 0.0 if same else
                               float((x.double() - y.double()).abs().max()))
    return out


def phase_train_restart():
    """The trainer's checkpoint/restart on the card: tinyllama-1.1b at full
    width, depth cut to ``RESTART_LAYERS``, as configured (fp32
    parameters, bf16 compute, full remat), batch 4 x 2048 of
    ``SyntheticLM``, a learning-rate schedule that does not depend on
    ``steps``. Run A takes ``RESTART_STEPS`` steps straight, saving every
    ``RESTART_AT``; run B stops at ``RESTART_AT`` in a second directory;
    run C asks for ``RESTART_STEPS`` on B's directory and must resume at
    ``RESTART_AT`` and end on A's state bit for bit. A second straight run
    (A2) shows whether a straight run repeats itself on the card: if it
    does not, the leaves where it differs are printed and C is held, leaf
    by leaf, to that measured gap. Then ``ft.elastic.recover`` must return
    A's saved state bit for bit, and a ``save(blocking=False)`` followed by
    one more in-place step must restore the values before that step. The
    attention kernels' counts are set to 0 before run A and returned, read
    after the last step. The checkpoints live in a temporary directory,
    deleted at the end."""
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"),
                              n_layers=RESTART_LAYERS)
    assert (cfg.param_dtype, cfg.compute_dtype, cfg.remat) \
        == ("float32", "bfloat16", "full"), cfg
    opt = adamw.OptConfig(peak_lr=3e-4, warmup_steps=2, decay_steps=60)
    data = DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                      vocab_size=cfg.vocab_size, seed=0)

    def trainer(ckpt_dir, steps):
        return Trainer(cfg, opt, data,
                       TrainerConfig(steps=steps, ckpt_dir=ckpt_dir,
                                     ckpt_every=RESTART_AT, log_every=1),
                       device=DEV)

    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    dir_a, dir_b, dir_d = (os.path.join(root, n) for n in "abd")
    runs = {}
    try:
        att.reset_launches()       # the restart's path starts here
        for name, d, steps in (("A", dir_a, RESTART_STEPS),
                               ("A2", None, RESTART_STEPS),
                               ("B", dir_b, RESTART_AT)):
            tr = trainer(d, steps)
            t0 = time.perf_counter()
            step, state = tr.run()
            runs[name] = {"tr": tr, "state": state, "step": step,
                          "wall_s": time.perf_counter() - t0}
        del runs["B"]["state"]
        tr_c = trainer(dir_b, RESTART_STEPS)
        start, _ = tr_c.restore_or_init()
        assert start == RESTART_AT, start
        t0 = time.perf_counter()
        step_c, state_c = tr_c.run()
        runs["C"] = {"tr": tr_c, "step": step_c,
                     "wall_s": time.perf_counter() - t0}
        assert step_c == runs["A"]["step"] == RESTART_STEPS
        assert ckpt.latest_steps(dir_a) == [RESTART_AT, RESTART_STEPS]
        assert ckpt.latest_steps(dir_b) == [RESTART_AT, RESTART_STEPS]
        state_a = runs["A"]["state"]
        for r in runs.values():
            assert all(np.isfinite(m["loss"]) for m in r["tr"].metrics_log)

        repeat = _leaf_gaps(runs["A2"].pop("state"), state_a)
        resumed = _leaf_gaps(state_c, state_a)
        del state_c
        straight_repeats = all(same for same, _ in repeat.values())
        if not straight_repeats:
            emit("train_restart_straight_runs_differ",
                 leaves={p: g for p, (same, g) in repeat.items()
                         if not same})
        for path, (same, gap) in resumed.items():
            if straight_repeats:
                assert same, (path, gap)
            else:
                assert gap <= repeat[path][1], (path, gap, repeat[path][1])

        built = []
        step_r, state_r = elastic.recover(dir_a, DEV, lambda: built.append(1))
        assert step_r == RESTART_STEPS and not built
        assert all(same for same, _ in _leaf_gaps(state_r, state_a).values())

        # save without waiting for the disk, then one more in-place step
        batch = to_device(runs["A"]["tr"].source.batch(RESTART_STEPS), DEV)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        writer = ckpt.save(dir_d, RESTART_STEPS, state_a, blocking=False)
        block_s = time.perf_counter() - t0
        state_a, _ = runs["A"]["tr"].step_fn(state_a, batch)
        torch.cuda.synchronize()
        writer.join()
        write_s = time.perf_counter() - t0
        stepped = _leaf_gaps(state_a, state_r)
        assert not stepped["params/embed"][0], "the step changed nothing"
        _, state_d = ckpt.restore(dir_d, device=DEV)
        assert all(same for same, _ in _leaf_gaps(state_d, state_r).values())
        ckpt_bytes = sum(os.path.getsize(os.path.join(dir_d, s, f))
                         for s in os.listdir(dir_d)
                         for f in os.listdir(os.path.join(dir_d, s)))
        del state_a, state_r, state_d
        torch.cuda.synchronize()
        launches = dict(att.LAUNCHES)   # read right after the last step
    finally:
        shutil.rmtree(root, ignore_errors=True)

    n_steps = 2 * RESTART_STEPS + RESTART_AT + (RESTART_STEPS - RESTART_AT) + 1
    L = RESTART_LAYERS
    want = {"flash_fwd": 2 * L * n_steps, "flash_bwd_dq": L * n_steps,
            "flash_bwd_dkv": L * n_steps}
    assert launches == want, (launches, want)
    step_ms = {n: [1e3 * t for t in r["tr"].monitor.times]
               for n, r in runs.items()}
    emit("train_restart", arch=cfg.name, n_layers=L, d_model=cfg.d_model,
         batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, steps=RESTART_STEPS,
         resumed_at=RESTART_AT, param_dtype=cfg.param_dtype,
         compute_dtype=cfg.compute_dtype, remat=cfg.remat,
         straight_runs_bit_equal=straight_repeats,
         resumed_bit_equal=all(s for s, _ in resumed.values()),
         resumed_max_gap=max(g for _, g in resumed.values()),
         leaves=len(resumed), recover_bit_equal=True,
         nonblocking_save_immune=True,
         losses={n: [m["loss"] for m in r["tr"].metrics_log]
                 for n, r in runs.items()},
         step_ms=step_ms,
         steady_step_ms=statistics.median(
             t for n in ("A", "A2") for t in step_ms[n][1:]),
         run_wall_s={n: r["wall_s"] for n, r in runs.items()},
         save_block_ms=1e3 * block_s, save_write_s=write_s,
         checkpoint_bytes=ckpt_bytes, launches=launches)
    return launches


# ---------------------------------------------------------------------------


def kernels_line(results, timed, launches, serve_flash, att_results,
                 att_timed, att_launches, paper, ssm, ssm_serving,
                 moe_serving, mla_serving, cross_serving, faults_flash,
                 load_int8, restart_launches):
    """One row per TPU kernel. ``launches`` / ``att_launches`` are the
    counts read after the tinyllama serving and training paths,
    ``serve_flash`` the forward kernel's count in tinyllama's serving
    oracle, ``paper`` and ``ssm`` the (checks, times, counts) of phases
    9-10, ``ssm_serving``, ``moe_serving`` and ``mla_serving`` the counts
    read after each of those serving paths, ``cross_serving`` phase 18's
    (launches, checks, times) per model, ``faults_flash``, ``load_int8``
    and ``restart_launches`` the counts of phases 19-21: rows 2-5 add what
    those paths launched (the int8 head; the oracles' attention, zamba2-7b's
    shared block at head_dim 112, the MTP layer's, and the cross layers' in
    the kernel's non-causal mode; the restarted training's three attention
    kernels)."""
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
         "dtype": "bfloat16->float32", "kernel_route": bf16["route"],
         "routes_checked": sorted(ROUTES_RAN), "shapes": timed["shapes"]},
        {"name": "matmul_int8", "route": "cuda", "source": SOURCE,
         "replaces": "src/repro/kernels/matmul.py:137",
         "launches": launches["matmul_int8"],
         "max_abs_err": err_of(f"matmul_int8 int32 {tag}"),
         "ms": int8["ms"], "plain_ms": int8["plain_ms"],
         "bound_ms": int8["bound_ms"], "bound_by": int8["bound_by"],
         "library_ms": int8["library_ms"],
         "library_note": int8["library_note"], "shape": list(PATH_SHAPE),
         "dtype": "int8->int32", "kernel_route": int8["route"],
         "routes_checked": sorted(INT8_ROUTES_RAN),
         "shapes": timed["int8_shapes"]},
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
    # rows 2-3 run on more than one path: each path's count, set to 0 just
    # before it and read just after, and their sum
    restart = f"train_restart tinyllama-1.1b ({RESTART_LAYERS} layers)"
    rows[1]["launches_by_path"] = {
        "serve tinyllama-1.1b": launches["matmul_int8"],
        **{f"serve {a}": v["matmul_int8"] for a, v in ssm_serving.items()},
        f"serve_moe {MOE_ARCH}": moe_serving["matmul_int8"],
        f"serve_mla engine {MLA_ARCH}": mla_serving["matmul_int8"],
        "serving_load tinyllama-1.1b": load_int8}
    rows[2]["launches_by_path"] = {
        "train tinyllama-1.1b": att_launches["flash_fwd"],
        restart: restart_launches["flash_fwd"],
        f"serve_faults oracle tinyllama-1.1b ({EXACT_LAYERS} layers)":
            faults_flash,
        "serve_exact oracle tinyllama-1.1b": serve_flash,
        **{f"serve_exact oracle {a}": v["flash_fwd"]
           for a, v in ssm_serving.items()},
        f"serve_moe_exact oracle {MOE_ARCH}": moe_serving["flash_fwd"],
        f"serve_mla lm_loss (MTP layer) {MLA_ARCH}": mla_serving["flash_fwd"],
        **{f"serve_cross {a} {dt} (non-causal)": n
           for a, v in cross_serving.items() for dt, n in v[0].items()}}
    for row in rows[3:5]:
        row["launches_by_path"] = {
            "train tinyllama-1.1b": att_launches[row["name"]],
            restart: restart_launches[row["name"]]}
    for row in rows[1:5]:
        row["launches"] = sum(row["launches_by_path"].values())
    # the forward also at zamba2-7b's oracle shape (its own times and bound)
    rows[2]["zamba2_oracle"] = {
        dt: {k: att_timed[f"flash_fwd_zamba2_{dt}"][k]
             for k in ("shape", "ms", "plain_ms", "library_ms", "bound_ms")}
        for dt in ("float32", "bfloat16")}
    # the non-causal mode at the cross layers' shapes (Sq = prompt and 1)
    rows[2]["cross_shapes"] = {a: v[2] for a, v in cross_serving.items()}
    p_res, p_timed, p_launches = paper
    for name, key, check, shape in (
            ("axpy", "axpy_f32_2^26", "path axpy f32 2^26", [AXPY_N]),
            ("conv2d_direct", "conv_googlenet1_f32",
             "path dconv f32 googlenet1", list(GOOGLENET_L1))):
        t = p_timed[key]
        rows.append({"name": name, "route": "cuda",
                     "source": AXPY_SOURCE if name == "axpy" else CONV_SOURCE,
                     "replaces": "src/repro/kernels/axpy.py:38"
                     if name == "axpy" else "src/repro/kernels/conv.py:50",
                     "launches": p_launches[name],
                     "max_abs_err": err_of(check, p_res),
                     "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"], "shape": shape,
                     "dtype": "float32"})
        if name == "axpy":     # the turns against torch.add, every size
            rows[-1]["turns"] = {k_[5:]: {**v_["turns"],
                                          "bound_ms": v_["bound_ms"]}
                                 for k_, v_ in p_timed.items()
                                 if k_.startswith("axpy_")}
    s_res, s_timed, s_launches = ssm
    t = s_timed["zamba2-7b"]
    bh, s_, n, p = t["shape"]
    rows.append({"name": "ssm_scan", "route": "cuda", "source": SSM_SOURCE,
                 "replaces": "src/repro/kernels/ssm_scan.py:67",
                 "launches": s_launches["ssm_scan"],
                 "max_abs_err": err_of(
                     f"ssm_scan zamba2-7b ({bh},{s_},{n},{p}) c{t['chunk']} "
                     f"float32", s_res),
                 "ms": t["ms"], "plain_ms": t["plain_ms"],
                 "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                 "library_ms": None, "shape": t["shape"],
                 "dtype": f"float32, chunk {t['chunk']}",
                 "layers": {k_: {f: v_[f] for f in ("shape", "dtype", "ms",
                                                     "plain_ms", "bound_ms")}
                            for k_, v_ in s_timed.items()
                            if isinstance(v_, dict)}})
    for row in rows:
        if row["launches"] < 1:
            raise AssertionError(f"the main path never launched "
                                 f"{row['name']}: {rows}")
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
    serve_flash = phase_serve_exact(cfg, params)
    launches = dict(mm.LAUNCHES)      # read right after the serving path
    faults_flash = phase_serve_faults(cfg, params)  # each sets its counts
    load_int8 = phase_serving_load(cfg, params)     # to 0 first
    del params
    free_memory()

    att_launches = phase_train(att_timed)   # sets its counts to 0 first
    free_memory()
    phase_train_exact()
    free_memory()
    restart_launches = phase_train_restart()    # sets its counts to 0 first
    free_memory()

    paper = phase_paper_kernels()           # each sets its counts to 0 first
    ssm = phase_ssm_kernel()
    free_memory()
    ssm_serving = run_ssm_serving()
    free_memory()
    cfgs = serving_cfgs()
    moe_serving = run_moe_serving(cfgs[MOE_ARCH])
    mla_serving = run_mla_serving(cfgs[MLA_ARCH])
    cross_serving = run_cross_serving([cfgs[VISION_ARCH], cfgs[AUDIO_ARCH]])
    _, _, listing = phase_vector_engine(smi)
    phase_vector_engine_lanes(smi, listing)

    print(json.dumps(kernels_line(results, timed, launches, serve_flash,
                                  att_results, att_timed, att_launches, paper,
                                  ssm, ssm_serving, moe_serving, mla_serving,
                                  cross_serving, faults_flash, load_int8,
                                  restart_launches)), flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
