#!/usr/bin/env python3
"""Tuning aid for ``src/repro_torch/kernels/csrc/matmul.cu`` and
``csrc/conv.cu``, on the card.

    python3 tools/torch_kernel_variants.py [--variants 1,1 4,2 8,2 8,4]
        [--widths 4096 16384 32000 128000]
    python3 tools/torch_kernel_variants.py --conv [4,16,4,4 4,8,4,4 general ...]

1. Builds a copy of the source once per variant ``U,UI`` — how many rows
   of ``b`` a thread loads before it uses the first (the constants ``kU``
   for matmul and ``kUI``, groups of four rows, for matmul_int8, rewritten
   in the copy) — checks each against the plain version and times it at
   the serving shape
   (8,2048)@(2048,32000), in turns (a, b, ..., b, a) within this one call.
2. Times the default build against the width N of ``b``, from an operand
   that fits the L2 cache to one far larger, with the bytes of ``b`` over the
   time as a rate.

With ``--conv``, instead: builds a copy of ``conv.cu`` once per tile
variant ``R,G,C,O`` of its compile-time-taps route — output rows a block
(``kTapRows``), output channels a block (``kOcGroup``), adjacent output
columns a thread (``kColsThread``) and output channels a thread
(``kOcThread``), or ``general``, the compile-time-taps route switched off
so that every shape runs the general kernel (runtime taps) — checks each
for bit-equality with ``conv2d_plain`` at GoogLeNet layer 1 and at
GoogLeNet's 3x3 layer (float32), and times both in turns beside
``F.conv2d`` (cuDNN, TF32 off).

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
from repro_torch.kernels import conv as cv  # noqa: E402
from repro_torch.kernels import matmul as mm  # noqa: E402

M, K, N = cs.PATH_SHAPE
CONV_CONSTANTS = ("kTapRows", "kOcGroup", "kColsThread", "kOcThread")
CONV_DEFAULT = ["4,16,4,4", "4,8,4,4", "2,16,4,4", "8,16,4,4", "4,32,4,4",
                "general"]
# the compile-time-taps route's tap shapes, and the variant that has none
_FIXED_TAPS = ("constexpr bool fixed_taps(int KH, int KW) { return (KH == 7 "
               "&& KW == 7) || (KH == 3 && KW == 3); }")
_NO_FIXED_TAPS = "constexpr bool fixed_taps(int, int) { return false; }"


def _compile(cu, so):
    return subprocess.Popen(
        [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _collect(procs, name):
    """{variant: (library, registers of its kernels)} once every build of
    ``procs`` ({variant: (library path, nvcc process)}) has ended."""
    libs = {}
    for key, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {key}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in build.SIGNATURES[name].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        regs = sorted({int(line.split("Used")[1].split("registers")[0])
                       for line in log.splitlines() if "Used" in line})
        libs[key] = (lib, regs)
    return libs


def build_conv_variants(variants):
    out_dir = build.build_dir() / "conv_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (build.CSRC / "conv.cu").read_text()
    procs = {}
    for key in variants:
        text = source
        if key == "general":
            assert text.count(_FIXED_TAPS) == 1, "fixed_taps not in conv.cu"
            text = text.replace(_FIXED_TAPS, _NO_FIXED_TAPS)
        for name, value in zip(CONV_CONSTANTS, () if key == "general"
                               else key):
            text, n = re.subn(rf"constexpr int {name} = \d+;",
                              f"constexpr int {name} = {value};", text)
            assert n == 1, f"{name} not found in conv.cu"
        tag = key if key == "general" else "_".join(map(str, key))
        cu = out_dir / f"conv_{tag}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[key] = (so, _compile(cu, so))
    return _collect(procs, "conv")


def conv_main(variants):
    torch.backends.cudnn.allow_tf32 = False
    libs = build_conv_variants(variants)
    stream = torch.cuda.current_stream().cuda_stream
    shapes = {"googlenet1": cs.GOOGLENET_L1, "googlenet_3x3": cs.GOOGLENET_3X3}
    ops = {}
    for tag, (c, h, w, oc, kh, kw) in shapes.items():
        x = cs._randn((c, h, w), torch.float32, 42)
        wt = cs._randn((oc, c, kh, kw), torch.float32, 43, 0.2)
        ops[tag] = (x, wt, cv.conv2d_plain(x, wt))

    def run(lib, x, wt):
        c, h, w = x.shape
        oc, _, kh, kw = wt.shape
        out = torch.empty((oc, h - kh + 1, w - kw + 1), device="cuda")
        err = lib.repro_conv2d(x.data_ptr(), wt.data_ptr(), out.data_ptr(),
                               c, h, w, oc, kh, kw, 0, 0, stream)
        assert err == 0, err
        return out

    times = {key: [] for key in libs}
    for key in list(libs) + list(libs)[::-1]:
        lib, _ = libs[key]
        row = {}
        for tag, (x, wt, ref) in ops.items():
            if not torch.equal(run(lib, x, wt), ref):
                raise AssertionError(f"variant {key} at {tag}: not "
                                     f"bit-equal to conv2d_plain")
            row[tag] = cs.time_ms(lambda: run(lib, x, wt))
        times[key].append(row)
    for key, (_, regs) in libs.items():
        print(json.dumps({"variant": key if key == "general"
                          else dict(zip(CONV_CONSTANTS, key)),
                          "registers": regs, "bit_equal": True,
                          "ms": times[key]}))
    print(json.dumps({"library_ms": {
        tag: cs.time_ms(lambda: torch.nn.functional.conv2d(x[None], wt))
        for tag, (x, wt, _) in ops.items()}}))


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
        procs[(u, ui)] = (so, _compile(cu, so))
    return _collect(procs, "matmul")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", nargs="*",
                    default=["1,1", "4,2", "8,2", "8,4"])
    ap.add_argument("--widths", nargs="*", type=int,
                    default=[4096, 16384, 32000, 128000])
    ap.add_argument("--conv", nargs="*", default=None, metavar="R,G,C,O",
                    help="time conv.cu tile variants instead (default set "
                    "without values)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    if args.conv is not None:
        conv_main([key if key == "general"
                   else tuple(int(v) for v in key.split(","))
                   for key in args.conv or CONV_DEFAULT])
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
        return 0
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
