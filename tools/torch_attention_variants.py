#!/usr/bin/env python3
"""Tuning aid for the tensor-core kernels of
``src/repro_torch/kernels/csrc/attention.cu`` (the forward, dQ and dK/dV),
on the card.

    python3 tools/torch_attention_variants.py [--variants base fwd_expf ...]

Builds a copy of the source once per variant — a named set of text
substitutions in the copy (``VARIANTS``; ``a+b`` applies both) — checks the
bfloat16 ``flash_fwd`` (out, lse, probe), ``flash_bwd_dq`` and
``flash_bwd_dkv`` of each against their plain versions at the training
shape (4,32,2048,64), causal, blocks 128 x 128, with
``chip_smoke.ATT_TOL``, and times the three in turns (a, b, ..., b, a)
within this one call, beside the library's fused forward and backward
(``F.scaled_dot_product_attention``). Each variant's line carries the
registers and spills of its tensor-core kernels from ``ptxas -v``.

Timing is ``chip_smoke.time_ms`` (device time of back-to-back launches).
Prints JSON lines. Needs a CUDA device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import attention as att  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

_DQ_ORDER = ("  const int G = gridDim.x / (n_q * parts);\n"
             "  const int g = blockIdx.x % G, rest = blockIdx.x / G;\n"
             "  const int qb = n_q - 1 - rest / parts;\n")
_DKV_ORDER = ("  const int G = gridDim.x / (n_k * parts);\n"
              "  const int g = blockIdx.x % G, rest = blockIdx.x / G;")

# name -> [(text in attention.cu, its replacement, occurrences)]
VARIANTS = {
    "base": [],
    # one head's blocks together in the block order (its streamed operands
    # stay in the L2 cache) instead of the heads fastest
    "dq_head_by_head": [(_DQ_ORDER, "  const int G = gridDim.x / (n_q * "
                         "parts);\n  const int g = blockIdx.x / (n_q * parts),"
                         " rest = blockIdx.x % (n_q * parts);\n  const int qb"
                         " = n_q - 1 - rest / parts;\n", 1)],
    "dkv_head_by_head": [(_DKV_ORDER, "  const int G = gridDim.x / (n_k * "
                          "parts);\n  const int g = blockIdx.x / (n_k * "
                          "parts), rest = blockIdx.x % (n_k * parts);", 1)],
    # the accurate exponential instead of ex2.approx
    "expf": [("__expf(", "expf(", 2)],
    # smaller streamed tiles
    "dq_keys32": [("kDqKeys = 64;", "kDqKeys = 32;", 1)],
    "dkv_queries32": [("kDkvQueries = DP <= 64 ? 64 : 32;",
                       "kDkvQueries = 32;", 1)],
    # no bound on the registers (ptxas's choice) instead of four resident
    # blocks an SM at 64 head columns, or a bound of three
    "min_blocks1": [("kMinBlocks = DP <= 64 ? 4 : 1;", "kMinBlocks = 1;", 1)],
    "min_blocks3": [("kMinBlocks = DP <= 64 ? 4 : 1;",
                     "kMinBlocks = DP <= 64 ? 3 : 1;", 1)],
    # the scores over the whole streamed tile in one pass (dQ: 64 keys;
    # dK/dV: 64 queries) or in passes of 32 queries (dK/dV)
    "dq_pass64": [("kDqPass = 32;", "kDqPass = kDqKeys;", 1)],
    "dkv_pass64": [("kDkvPass = 16;", "kDkvPass = kDkvQueries;", 1)],
    "dkv_pass32": [("kDkvPass = 16;", "kDkvPass = 32;", 1)],
    # forward: tiles of 128 keys (a p rounded against the running max of
    # 128 keys, not the plain version's 64)
    "fwd_keys128": [("kFwdKeys = 64;", "kFwdKeys = 128;", 1)],
    # eight warps, 128 rows a block, no register bound: the block of all
    # three tensor-core kernels is the one constant kMmaWarps (compare the
    # forward's time; the backward's spill under its four-block bound)
    "fwd_warps8": [("constexpr int kMmaWarps = 4;",
                    "constexpr int kMmaWarps = 8;", 1),
                   ("kFwdMinBlocks = DP <= 64 ? 3 : 1;", "kFwdMinBlocks = 1;",
                    1)],
    # forward: Q's fragments re-read by ldmatrix per k16 step, not held in
    # registers across the key loop
    "fwd_q_reread": [("kFwdHoldQ = DP <= 64;", "kFwdHoldQ = false;", 1)],
    # forward: the accurate exp2f instead of ex2.approx
    "fwd_expf": [('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                  "y = exp2f(x);", 1)],
    # forward: no register bound, or bounds of two or four blocks an SM at
    # 64 head columns (255 or 128 registers a thread) for the default three
    # (168)
    "fwd_min_blocks1": [("kFwdMinBlocks = DP <= 64 ? 3 : 1;",
                         "kFwdMinBlocks = 1;", 1)],
    "fwd_min_blocks2": [("kFwdMinBlocks = DP <= 64 ? 3 : 1;",
                         "kFwdMinBlocks = DP <= 64 ? 2 : 1;", 1)],
    "fwd_min_blocks4": [("kFwdMinBlocks = DP <= 64 ? 3 : 1;",
                         "kFwdMinBlocks = DP <= 64 ? 4 : 1;", 1)],
}
# what a run without --variants builds: the forward's variants (the
# backward's were measured when they were chosen)
DEFAULT = ["base", "fwd_keys128", "fwd_keys128+fwd_min_blocks2", "fwd_warps8",
           "fwd_q_reread", "fwd_expf", "fwd_min_blocks2", "fwd_min_blocks4",
           "fwd_q_reread+fwd_min_blocks4"]


def variant_source(key: str) -> str:
    text = (build.CSRC / "attention.cu").read_text()
    for name in key.split("+"):
        for old, new, count in VARIANTS[name]:
            found = text.count(old)
            if found != count:
                raise ValueError(f"variant {name}: {old!r} occurs {found} "
                                 f"times in attention.cu, expected {count}")
            text = text.replace(old, new)
    return text


def build_variants(keys):
    out_dir = build.build_dir() / "attention_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for key in keys:
        cu = out_dir / f"attention_{key.replace('+', '_')}.cu"
        cu.write_text(variant_source(key))
        so = cu.with_suffix(".so")
        cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
               "-o", str(so), str(cu)]
        procs[key] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {key}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in build.SIGNATURES["attention"].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        ptxas = [{k: r[k] for k in ("kernel", "head_cols", "registers",
                                    "spill_store_bytes")}
                 for r in cs.attention_ptxas(log)
                 if r["units"] == "tensor cores" and r["dtype"] == "bfloat16"]
        libs[key] = (lib, ptxas)
    return libs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", nargs="*", default=DEFAULT)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    libs = build_variants(args.variants)

    b, h, s, d = cs.TRAIN_ATT
    q, k, v, kv_valid, dout = cs._att_inputs(b, h, s, s, d, torch.bfloat16,
                                             10, p_valid=1.0)
    qf, kf, vf, kvm, bq, bk = att._prepare(q, k, v, kv_valid, 128, 128)
    geom = dict(causal=True, bq=bq, bk=bk)
    fwd = (qf, kf, vf, kvm)
    out, lse, probe = att.flash_fwd_plain(*fwd, **geom)
    doutf = dout.reshape(qf.shape).contiguous()
    delta = (doutf.float() * out.float()).sum(-1)
    bwd = (qf, kf, vf, kvm, doutf, lse, delta)
    ref_dq = att.flash_bwd_dq_plain(*bwd, **geom)
    ref_dk, ref_dv = att.flash_bwd_dkv_plain(*bwd, **geom)
    rel, acc = cs.ATT_TOL[torch.bfloat16]

    times = {key: [] for key in libs}
    failed = {}
    for key in list(libs) + list(libs)[::-1]:
        if key in failed:
            continue
        build._LIBS["attention"] = libs[key][0]
        results: list = []
        got_out, got_lse, got_probe = att.flash_fwd(*fwd, **geom)
        dq = att.flash_bwd_dq(*bwd, **geom)
        dk, dv = att.flash_bwd_dkv(*bwd, **geom)
        torch.cuda.synchronize()
        try:    # a variant that disagrees is reported, not timed
            for what, got, ref in (("out", got_out, out), ("dq", dq, ref_dq),
                                   ("dk", dk, ref_dk), ("dv", dv, ref_dv)):
                cs._check_float(f"{key} {what}", got, ref, rel, results, acc)
            cs._check_float(f"{key} lse", got_lse, lse, 0.0, results)
            cs._check_exact(f"{key} probe", got_probe, probe, results)
        except AssertionError as e:
            failed[key] = str(e)[:300]
            continue
        times[key].append({
            "flash_fwd": cs.time_ms(lambda: att.flash_fwd(*fwd, **geom)),
            "flash_bwd_dq": cs.time_ms(lambda: att.flash_bwd_dq(*bwd, **geom)),
            "flash_bwd_dkv": cs.time_ms(
                lambda: att.flash_bwd_dkv(*bwd, **geom))})
    build._LIBS.pop("attention")
    for key, (_, ptxas) in libs.items():
        print(json.dumps({"variant": key, "ptxas": ptxas, "ms": times[key],
                          "check_failed": failed.get(key)}))

    q4, k4, v4 = (t.detach().requires_grad_(True) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    o4 = sdpa(q4, k4, v4, is_causal=True)
    print(json.dumps({"library_forward_ms": cs.time_ms(
        lambda: sdpa(q, k, v, is_causal=True))}))
    print(json.dumps({"library_backward_ms": cs.time_ms(
        lambda: torch.autograd.grad(o4, (q4, k4, v4), dout,
                                    retain_graph=True))}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
