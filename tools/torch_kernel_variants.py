#!/usr/bin/env python3
"""Tuning aid for ``src/repro_torch/kernels/csrc/matmul.cu``, on the card.

    python3 tools/torch_kernel_variants.py [--variants 1,1 4,2 8,2 8,4]
        [--widths 4096 16384 32000 128000]

1. Builds a copy of the source once per variant ``U,UI`` — how many rows
   of ``b`` a thread loads before it uses the first (the constants ``kU``
   for matmul and ``kUI``, groups of four rows, for matmul_int8, rewritten
   in the copy) — checks each against the plain version and times it at
   the serving shape
   (8,2048)@(2048,32000), in turns (a, b, ..., b, a) within this one call.
2. Times the default build against the width N of ``b``, from an operand
   that fits the L2 cache to one far larger, with the bytes of ``b`` over the
   time as a rate.

Timing is ``chip_smoke.time_ms`` (device time of back-to-back launches).
Prints JSON lines. Needs a CUDA device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import matmul as mm  # noqa: E402

M, K, N = cs.PATH_SHAPE


def build_variants(variants):
    out_dir = build.build_dir() / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (build.CSRC / "matmul.cu").read_text()
    procs = {}
    for u, ui in variants:
        text, n_u = re.subn(r"constexpr int kU = \d+;",
                            f"constexpr int kU = {u};", source)
        text, n_ui = re.subn(r"constexpr int kUI = \d+;",
                             f"constexpr int kUI = {ui};", text)
        assert (n_u, n_ui) == (1, 1), "kU / kUI not found in matmul.cu"
        cu = out_dir / f"matmul_u{u}_ui{ui}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)]
        procs[(u, ui)] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {key}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in build.SIGNATURES["matmul"].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        regs = sorted({int(line.split("Used")[1].split("registers")[0])
                       for line in log.splitlines() if "Used" in line})
        libs[key] = (lib, regs)
    return libs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", nargs="*",
                    default=["1,1", "4,2", "8,2", "8,4"])
    ap.add_argument("--widths", nargs="*", type=int,
                    default=[4096, 16384, 32000, 128000])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    variants = [tuple(int(x) for x in v.split(",")) for v in args.variants]
    libs = build_variants(variants)

    r = np.random.RandomState(7)
    a32 = torch.from_numpy(r.randn(M, K).astype(np.float32)).cuda()
    b32 = torch.from_numpy(r.randn(K, N).astype(np.float32)).cuda()
    ab, bb = a32.bfloat16(), b32.bfloat16()
    ai = torch.from_numpy(r.randint(-128, 128, (M, K)).astype(np.int8)).cuda()
    bi = torch.from_numpy(r.randint(-128, 128, (K, N)).astype(np.int8)).cuda()
    ref_b = mm.matmul_plain(ab, bb, out_dtype=torch.float32)
    ref_i = mm.matmul_int8_plain(ai, bi)
    stream = torch.cuda.current_stream().cuda_stream

    def run_fp(lib, a, b, code):
        out = torch.empty((M, N), dtype=torch.float32, device="cuda")
        err = lib.repro_matmul(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                               M, K, N, code, 0, stream)
        assert err == 0, err
        return out

    def run_i8(lib):
        out = torch.empty((M, N), dtype=torch.int32, device="cuda")
        err = lib.repro_matmul_int8(ai.data_ptr(), bi.data_ptr(),
                                    out.data_ptr(), M, K, N, 0, 0, stream)
        assert err == 0, err
        return out

    times = {key: [] for key in libs}
    for key in list(libs) + list(libs)[::-1]:
        lib, _ = libs[key]
        assert torch.allclose(run_fp(lib, ab, bb, 1), ref_b, rtol=1e-3,
                              atol=1e-2)
        assert torch.equal(run_i8(lib), ref_i)
        times[key].append({
            "bfloat16": cs.time_ms(lambda: run_fp(lib, ab, bb, 1)),
            "float32": cs.time_ms(lambda: run_fp(lib, a32, b32, 0)),
            "int8": cs.time_ms(lambda: run_i8(lib))})
    for key, (_, regs) in libs.items():
        print(json.dumps({"variant": {"U": key[0], "UI": key[1]},
                          "registers": regs, "ms": times[key]}))
    print(json.dumps({"library_ms": {
        "bfloat16": cs.time_ms(lambda: torch.matmul(ab, bb)),
        "float32": cs.time_ms(lambda: torch.matmul(a32, b32))}}))

    for n in args.widths:
        b32 = torch.from_numpy(r.randn(K, n).astype(np.float32)).cuda()
        bb = b32.bfloat16()
        bi = torch.from_numpy(
            r.randint(-128, 128, (K, n)).astype(np.int8)).cuda()
        row = {"n": n, "blocks": -(-n // 128)}
        for name, fn, nbytes in (
                ("bfloat16", lambda: mm.matmul(ab, bb,
                                               out_dtype=torch.float32), 2),
                ("float32", lambda: mm.matmul(a32, b32), 4),
                ("int8", lambda: mm.matmul_int8(ai, bi), 1)):
            ms = cs.time_ms(fn)
            row[name] = {"ms": ms, "TB_per_s": K * n * nbytes / ms / 1e9}
        row["library_bfloat16_ms"] = cs.time_ms(lambda: torch.matmul(ab, bb))
        print(json.dumps(row))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
