#!/usr/bin/env python3
"""Tuning aid for ``src/repro_torch/kernels/csrc/matmul.cu``, ``conv.cu``
and ``ssm_scan.cu``, on the card.

    python3 tools/torch_kernel_variants.py [--variants 1,1 4,2 8,2 8,4]
        [--widths 4096 16384 32000 128000]
    python3 tools/torch_kernel_variants.py --conv [4,16,4,4 4,8,4,4 general ...]
    python3 tools/torch_kernel_variants.py [--mm [VARIANT ...]] [--axpy]
        [--ssm] [--ssm-variants [NAME ...]]

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

With ``--mm``, instead: builds a copy of ``matmul.cu`` once per tile
variant of its tensor-core routes and times all of them in turns at the
serving head (8,2048)@(2048,32000), at 256^3 and 512^3 and at
(8192,2048)@(2048,5632), bf16 with fp32 output, each checked against
``matmul_plain``, beside ``torch.matmul``. ``sk:BN,BK,STAGES`` rewrites
the skinny route's most columns a block, k per stage and ring depth
(``kSkBN``, ``kSkBK``, ``kSkStages``); ``t:BM,BN,BK,WM,WN,STAGES,MINB``
the tiled route's large tile (``kTBM`` ... ``kTMinBlocks``) and
``s:...`` its small one (``kSBM`` ...); ``base`` is the source as it
stands, and ``file:PATH`` builds another ``matmul.cu`` (a parent
commit's, for a comparison in one call).

With ``--axpy``: ``axpy`` and ``torch.add(y, x, alpha=a)`` timed in turns,
five turns in one call, at n = 2^26 in float32 and bfloat16.

With ``--ssm``: the scan's passes (``chunk_states``, ``pass_states``,
``chunk_cross`` where it runs, ``chunk_outputs``) timed by
``torch.profiler`` at one layer of zamba2-7b and of xlstm-1.3b, float32
and bfloat16, beside the whole call. With ``--ssm-variants``: source
variants of ``ssm_scan.cu`` (``SSM_VARIANTS``), each checked against
``ssm_scan_plain`` and timed in turns at both layers in float32.

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
from repro_torch.kernels import axpy as ax  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import conv as cv  # noqa: E402
from repro_torch.kernels import matmul as mm  # noqa: E402
from repro_torch.kernels import ssm_scan as ss  # noqa: E402

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

MM_SKINNY = ("kSkBN", "kSkBK", "kSkStages")
MM_TILED = ("kTBM", "kTBN", "kTBK", "kTWM", "kTWN", "kTStages", "kTMinBlocks")
MM_SMALL = ("kSBM", "kSBN", "kSBK", "kSWM", "kSWN", "kSStages", "kSMinBlocks")
MM_DEFAULT = ["base", "sk:128,32,4", "sk:256,64,3", "sk:256,32,6",
              "t:128,128,32,64,32,4,2", "s:64,64,32,32,32,6,4"]
MM_SHAPES = ((8, 2048, 32000), (256, 256, 256), (512, 512, 512),
             (8192, 2048, 5632))


def _set_constants(text, names, values):
    for name, value in zip(names, values):
        text, n = re.subn(rf"\b{name} = \d+", f"{name} = {value}", text)
        assert n == 1, f"{name} not found in matmul.cu"
    return text


def build_mm_variants(keys):
    out_dir = build.build_dir() / "mm_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (build.CSRC / "matmul.cu").read_text()
    procs = {}
    for i, key in enumerate(keys):
        if key.startswith("file:"):
            text = open(key[5:]).read()
        elif key == "base":
            text = source
        else:
            kind, vals = key.split(":")
            vals = vals.split(",")
            text = _set_constants(source, {"sk": MM_SKINNY, "t": MM_TILED,
                                           "s": MM_SMALL}[kind], vals)
        cu = out_dir / f"matmul_v{i}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[key] = (so, subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
             "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {key}:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.repro_matmul.argtypes = list(
            build.SIGNATURES["matmul"]["repro_matmul"])
        lib.repro_matmul.restype = ctypes.c_int
        regs = sorted({int(line.split("Used")[1].split("registers")[0])
                       for line in log.splitlines() if "Used" in line})
        spills = sorted({int(line.split("bytes spill stores")[0]
                             .split(",")[-1]) for line in log.splitlines()
                         if "bytes spill stores" in line})
        libs[key] = (lib, regs, spills)
    return libs


def mm_main(keys):
    libs = build_mm_variants(keys)
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(5)
    ops = {}
    for m, k, n in MM_SHAPES:
        a = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
        b = torch.randn((k, n), generator=gen, device="cuda").bfloat16()
        ops[(m, k, n)] = (a, b, mm.matmul_plain(a, b, out_dtype=torch.float32))

    def run(lib, a, b):
        m, k = a.shape
        n = b.shape[1]
        out = torch.empty((m, n), dtype=torch.float32, device="cuda")
        err = lib.repro_matmul(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                               m, k, n, 1, 0, stream)
        assert err == 0, err
        return out

    times = {key: [] for key in libs}
    for key in list(libs) + list(libs)[::-1]:
        lib = libs[key][0]
        row = {}
        for shape, (a, b, ref) in ops.items():
            got = run(lib, a, b)
            err = float((got - ref).abs().max())
            tol = cs.ACC_TOL * float(ref.abs().max())
            if err > tol:
                raise AssertionError(f"variant {key} at {shape}: max error "
                                     f"{err} > {tol}")
            big = shape[0] * shape[1] * shape[2] > 1e10
            kw = dict(warmup=2, reps=5, inner=3) if big else {}
            row["x".join(map(str, shape))] = cs.time_ms(
                lambda: run(lib, a, b), **kw)
        times[key].append(row)
    for key, (_, regs, spills) in libs.items():
        print(json.dumps({"variant": key, "registers": regs,
                          "spill_store_bytes": spills, "ms": times[key]}))
    print(json.dumps({"library_ms": {
        "x".join(map(str, shape)): cs.time_ms(lambda: torch.matmul(a, b))
        for shape, (a, b, _) in ops.items()}}))


def axpy_main(turns=5):
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device="cuda").manual_seed(3)
        x = torch.randn(cs.AXPY_N, generator=gen, device="cuda").to(dt)
        y = torch.randn(cs.AXPY_N, generator=gen, device="cuda").to(dt)
        alpha = 2.5
        assert torch.equal(ax.axpy(alpha, x, y), ax.axpy_plain(alpha, x, y))
        rows = {"axpy": [], "torch.add": []}
        for _ in range(turns):
            rows["axpy"].append(cs.time_ms(lambda: ax.axpy(alpha, x, y)))
            rows["torch.add"].append(cs.time_ms(
                lambda: torch.add(y, x, alpha=alpha)))
        bound, _ = cs.paper_bound("axpy", (cs.AXPY_N,), x.element_size())
        out[str(dt).replace("torch.", "")] = {"n": cs.AXPY_N, **rows,
                                              "bound_ms": bound}
    print(json.dumps({"axpy_vs_add": out}))


def ssm_main():
    from torch.profiler import ProfilerActivity, profile
    for name, bh, s, n, p, chunk in cs._ssm_layer_shapes():
        for dt in (torch.float32, torch.bfloat16):
            args = cs._ssm_inputs(bh, s, n, p, dt, 90)
            ss.ssm_scan(*args, chunk=chunk)
            torch.cuda.synchronize()
            reps = 3
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    ss.ssm_scan(*args, chunk=chunk)
                torch.cuda.synchronize()
            passes = {}
            for e in prof.key_averages():
                t = getattr(e, "device_time_total", 0)
                for kname in ("chunk_states", "pass_states", "chunk_cross",
                              "chunk_outputs"):
                    if kname in e.key:
                        passes[kname] = passes.get(kname, 0) + t / reps / 1e3
            print(json.dumps({
                "layer": name, "shape": [bh, s, n, p], "chunk": chunk,
                "dtype": str(dt).replace("torch.", ""), "passes_ms": passes,
                "call_ms": cs.time_ms(lambda: ss.ssm_scan(*args, chunk=chunk),
                                      warmup=1, reps=5, inner=2)}))


# scan source variants: (name, [(text in ssm_scan.cu, replacement), ...])
_P1_BOUND = ("__launch_bounds__(kThreads, TM == 4 && sizeof(Acc) == 4 ? 3 : {})"
             "\nchunk_states")
SSM_VARIANTS = {
    "base": [],
    "bk16": [("{ return 64 / TM; }", "{ return 16; }")],
    "p1_one_block": [(_P1_BOUND.format(2), _P1_BOUND.format(1))],
    "bk16_p1_one_block": [("{ return 64 / TM; }", "{ return 16; }"),
                          (_P1_BOUND.format(2), _P1_BOUND.format(1))],
}


def ssm_variants_main(names):
    out_dir = build.build_dir() / "ssm_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (build.CSRC / "ssm_scan.cu").read_text()
    procs = {}
    for i, name in enumerate(names):
        text = source
        for old, new in SSM_VARIANTS[name]:
            assert text.count(old) == 1, f"{old!r} not in ssm_scan.cu"
            text = text.replace(old, new)
        cu = out_dir / f"ssm_v{i}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[name] = (so, subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
             "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = _collect(procs, "ssm_scan")
    stream = torch.cuda.current_stream().cuda_stream
    cases = {}
    for name, bh, s, n, p, chunk in cs._ssm_layer_shapes():
        args = cs._ssm_inputs(bh, s, n, p, torch.float32, 90)
        cases[name] = (args, chunk, ss.ssm_scan_plain(*args, chunk=chunk))

    def run(lib, args, chunk):
        q, k, v, ld, sc = args
        bh, s, n = q.shape
        p = v.shape[-1]
        nc1 = s // chunk - 1
        states = torch.empty((bh, nc1, n, p), device="cuda")
        dec = torch.empty((bh, nc1), device="cuda")
        cross = lib.repro_ssm_scan_cross_scratch(n, p, chunk, 0)
        yx = torch.empty((bh, s, p) if cross else (0,), device="cuda")
        y = torch.empty_like(v)
        err = lib.repro_ssm_scan(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 ld.data_ptr(), sc.data_ptr(), y.data_ptr(),
                                 states.data_ptr(), dec.data_ptr(),
                                 yx.data_ptr(), bh, s, n, p, chunk, 0, stream)
        assert err == 0, err
        return y

    times = {name: [] for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        lib = libs[name][0]
        row = {}
        for layer, (args, chunk, ref) in cases.items():
            got = run(lib, args, chunk)
            err = (got - ref).abs()
            assert bool((err <= 3e-4 + 3e-4 * ref.abs()).all()), (name, layer)
            row[layer] = cs.time_ms(lambda: run(lib, args, chunk), warmup=1,
                                    reps=5, inner=2)
        times[name].append(row)
    for name, (_, regs) in libs.items():
        print(json.dumps({"ssm_variant": name, "registers": regs,
                          "ms": times[name]}))


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
    ap.add_argument("--mm", nargs="*", default=None, metavar="VARIANT",
                    help="time matmul.cu tensor-core tile variants instead "
                    "(default set without values)")
    ap.add_argument("--axpy", action="store_true",
                    help="time axpy against torch.add in turns instead")
    ap.add_argument("--ssm", action="store_true",
                    help="time the scan's three passes instead")
    ap.add_argument("--ssm-variants", nargs="*", default=None,
                    metavar="NAME", help="time source variants of "
                    "ssm_scan.cu instead: " + ", ".join(SSM_VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    if args.mm is not None or args.axpy or args.ssm \
            or args.ssm_variants is not None:
        if args.mm is not None:
            mm_main(args.mm or MM_DEFAULT)
        if args.axpy:
            axpy_main()
        if args.ssm:
            ssm_main()
        if args.ssm_variants is not None:
            ssm_variants_main(args.ssm_variants or list(SSM_VARIANTS))
        print(smi)
        return 0
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
