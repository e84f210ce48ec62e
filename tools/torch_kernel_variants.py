#!/usr/bin/env python3
"""Tuning aid for ``src/repro_torch/kernels/csrc/matmul.cu``, ``conv.cu``
and ``ssm_scan.cu``, on the card.

    python3 tools/torch_kernel_variants.py [--variants 1 4 8 16]
        [--widths 4096 16384 32000 128000]
    python3 tools/torch_kernel_variants.py --conv [4,16,4,4 4,8,4,4 general ...]
    python3 tools/torch_kernel_variants.py [--mm [VARIANT ...]]
        [--axpy [VARIANT ...]] [--ssm] [--ssm-variants [NAME ...]]

1. Builds a copy of the source once per variant ``U`` — how many rows of
   ``b`` a thread of the float32 skinny route loads before it uses the
   first (the constant ``kU``, rewritten in the copy) — checks each
   against the plain version and times it at the serving shape
   (8,2048)@(2048,32000), in turns (a, b, ..., b, a) within this one call,
   with matmul_int8 beside it.
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
``matmul_plain``, beside ``torch.matmul``; and matmul_int8 with an int32
output at the six shapes of ``chip_smoke.int8_shapes`` (the three int8
heads, 256^3, 512^3, the projection), each exact against
``matmul_int8_plain``, beside ``torch._int_mm`` where it takes the shape
(its refusal where it does not). ``sk:BN,BK,STAGES`` rewrites the bf16
skinny route's most columns a block, k per stage and ring depth
(``kSkBN``, ``kSkBK``, ``kSkStages``); ``t:BM,BN,BK,WM,WN,STAGES,MINB``
the bf16 tiled route's large tile (``kTBM`` ... ``kTMinBlocks``) and
``s:...`` its small one (``kSBM`` ...); ``qk:``, ``q:`` and ``qs:`` the
same for the int8 routes (``kI8SkBN`` ..., ``kI8BM`` ..., ``kI8SBM``
...); ``base`` is the source as it stands, and ``file:PATH`` builds
another ``matmul.cu`` (a parent commit's, for a comparison in one call).

With ``--axpy``: source variants of ``axpy.cu`` (``build_axpy_variants``:
``base``, ``file:PATH``, ``onepass:...`` constants, the ``bulk`` design
of ``AXPY_BULK``), each checked for bit-equality with ``axpy_plain``
(every dtype, unaligned addresses), timed in five turns beside
``torch.add(y, x, alpha=a)`` at f32 and bf16 2^26, f32 2^20 and f64 256.

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
MM_I8_SKINNY = ("kI8SkBN", "kI8SkBK", "kI8SkStages")
MM_I8_TILED = ("kI8BM", "kI8BN", "kI8BK", "kI8WM", "kI8WN", "kI8Stages",
               "kI8MinBlocks")
MM_I8_SMALL = ("kI8SBM", "kI8SBN", "kI8SBK", "kI8SWM", "kI8SWN",
               "kI8SStages", "kI8SMinBlocks")
MM_KINDS = {"sk": MM_SKINNY, "t": MM_TILED, "s": MM_SMALL,
            "qk": MM_I8_SKINNY, "q": MM_I8_TILED, "qs": MM_I8_SMALL}
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
            text = _set_constants(source, MM_KINDS[kind], vals.split(","))
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
            if key == "base":
                raise RuntimeError(f"nvcc failed for variant {key}:\n{log}")
            print(json.dumps({"variant": key, "nvcc_failed": log[-2000:]}))
            continue
        lib = ctypes.CDLL(str(so))
        for fn in ("repro_matmul", "repro_matmul_int8"):
            getattr(lib, fn).argtypes = list(build.SIGNATURES["matmul"][fn])
            getattr(lib, fn).restype = ctypes.c_int
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

    ops8 = {}
    for i, (_, shape) in enumerate(cs.int8_shapes()):
        ai, bi = cs._int8_operands(*shape, 50 + i)
        ops8[shape] = (ai, bi, mm.matmul_int8_plain(ai, bi))

    def run8(lib, a, b):
        m, k = a.shape
        n = b.shape[1]
        out = torch.empty((m, n), dtype=torch.int32, device="cuda")
        err = lib.repro_matmul_int8(a.data_ptr(), b.data_ptr(),
                                    out.data_ptr(), m, k, n, 0, 0, stream)
        assert err == 0, err
        return out

    def kw_of(shape):
        big = shape[0] * shape[1] * shape[2] > 1e10
        return dict(warmup=2, reps=5, inner=3) if big else {}

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
            row["x".join(map(str, shape))] = cs.time_ms(
                lambda: run(lib, a, b), **kw_of(shape))
        for shape, (a, b, ref) in ops8.items():
            if not torch.equal(run8(lib, a, b), ref):
                raise AssertionError(f"variant {key}: int8 at {shape} "
                                     f"differs from matmul_int8_plain")
            row["int8 " + "x".join(map(str, shape))] = cs.time_ms(
                lambda: run8(lib, a, b), **kw_of(shape))
        times[key].append(row)
    for key, (_, regs, spills) in libs.items():
        print(json.dumps({"variant": key, "registers": regs,
                          "spill_store_bytes": spills, "ms": times[key]}))
    library = {"x".join(map(str, shape)): cs.time_ms(lambda: torch.matmul(a, b))
               for shape, (a, b, _) in ops.items()}
    for shape, (a, b, _) in ops8.items():
        ms, note = cs.int8_library_ms(a, b, **kw_of(shape))
        library["int8 " + "x".join(map(str, shape))] = ms if note is None \
            else note
    print(json.dumps({"library_ms": library}))


# axpy designs other than the committed one, as whole sources: "bulk",
# Hopper's 1-D bulk copies through a ring of shared stages
AXPY_BULK = r"""
// axpy by Hopper's bulk copies: persistent blocks (kBlocksPerSM an SM), each
// streaming chunks of x and y (kChunk bytes each) by 1-D cp.async.bulk into
// a ring of kStages shared stages (an mbarrier a stage, complete_tx),
// computing y_stage = alpha * x_stage + y_stage in shared memory and writing
// the stage back to `out` by cp.async.bulk shared -> global. Same rounding
// as axpy.cu; unaligned bases go element by element.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16384;     // bytes of x (and of y) a stage
constexpr int kStages = 4;
constexpr int kBlocksPerSM = 1;

__device__ __forceinline__ float axpy1(float a, float x, float y) { return __fadd_rn(__fmul_rn(a, x), y); }
__device__ __forceinline__ double axpy1(double a, double x, double y) { return __dadd_rn(__dmul_rn(a, x), y); }
__device__ __forceinline__ __nv_bfloat16 axpy1(__nv_bfloat16 a, __nv_bfloat16 x, __nv_bfloat16 y) {
  const __nv_bfloat16 p = __float2bfloat16_rn(__fmul_rn(__bfloat162float(a), __bfloat162float(x)));
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(p), __bfloat162float(y)));
}
__device__ __forceinline__ __half axpy1(__half a, __half x, __half y) {
  const __half p = __float2half_rn(__fmul_rn(__half2float(a), __half2float(x)));
  return __float2half_rn(__fadd_rn(__half2float(p), __half2float(y)));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0, spins = 0;
  while (!done) {
    if (++spins > (1u << 22)) __trap();  // a lost copy: fail, do not hang
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void bulk_s2g(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(smem_u32(src)),
               "r"(bytes)
               : "memory");
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
axpy_bulk(T alpha, const T* __restrict__ x, const T* __restrict__ y, T* __restrict__ out, int64_t n) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int E = kChunk / (int)sizeof(T);  // elements a stage
  extern __shared__ __align__(128) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  T* ys = reinterpret_cast<T*>(smem + kStages * kChunk);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 2 * kStages * kChunk);
  const int64_t nbulk = n / VEC * VEC;
  const int64_t nchunks = (nbulk + E - 1) / E;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bar[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int64_t c, int s) {
    const int64_t e0 = c * E;
    const uint32_t bytes = (uint32_t)(min((int64_t)E, nbulk - e0) * sizeof(T));
    mbar_expect_tx(&bar[s], 2 * bytes);
    bulk_g2s(xs + s * E, x + e0, bytes, &bar[s]);
    bulk_g2s(ys + s * E, y + e0, bytes, &bar[s]);
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      const int64_t c = blockIdx.x + (int64_t)s * gridDim.x;
      if (c < nchunks) issue(c, s);
    }
  }
  for (int64_t it = 0;; ++it) {
    const int64_t c = blockIdx.x + it * gridDim.x;
    if (c >= nchunks) break;
    const int s = (int)(it % kStages);
    mbar_wait(&bar[s], (uint32_t)((it / kStages) & 1));
    const int64_t e0 = c * E;
    const int cnt = (int)min((int64_t)E, nbulk - e0);
    const uint4* xv = reinterpret_cast<const uint4*>(xs + s * E);
    uint4* yv = reinterpret_cast<uint4*>(ys + s * E);
    for (int v = tid; v < cnt / VEC; v += kThreads) {
      const uint4 rx = xv[v], ry = yv[v];
      uint4 ro;
      const T* ex = reinterpret_cast<const T*>(&rx);
      const T* ey = reinterpret_cast<const T*>(&ry);
      T* eo = reinterpret_cast<T*>(&ro);
#pragma unroll
      for (int q = 0; q < VEC; ++q) eo[q] = axpy1(alpha, ex[q], ey[q]);
      yv[v] = ro;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0) {
      bulk_s2g(out + e0, ys + s * E, (uint32_t)(cnt * sizeof(T)));
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      if (it >= 1) {
        // the store of the previous stage has read its shared memory: refill it
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
        const int64_t cn = blockIdx.x + (it - 1 + kStages) * gridDim.x;
        if (cn < nchunks) issue(cn, (int)((it - 1) % kStages));
      }
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  const int64_t e = nbulk + tid;  // the ragged tail, fewer than VEC elements
  if (blockIdx.x == 0 && e < n) out[e] = axpy1(alpha, x[e], y[e]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) axpy_elements(T alpha, const T* x, const T* y, T* out, int64_t n) {
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n; i += (int64_t)gridDim.x * kThreads) {
    out[i] = axpy1(alpha, x[i], y[i]);
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1) n = 132;
  }
  return n;
}

template <typename T>
int launch(T alpha, const void* x, const void* y, void* out, int64_t n, cudaStream_t stream) {
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) && (reinterpret_cast<uintptr_t>(y) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const T* px = static_cast<const T*>(x);
  const T* py = static_cast<const T*>(y);
  T* po = static_cast<T*>(out);
  if (!aligned) {
    int64_t blocks = (n + kThreads - 1) / kThreads;
    if (blocks > 4096) blocks = 4096;
    axpy_elements<T><<<(unsigned)blocks, kThreads, 0, stream>>>(alpha, px, py, po, n);
    return (int)cudaGetLastError();
  }
  constexpr int smem = 2 * kStages * kChunk + 8 * kStages;
  auto kernel = axpy_bulk<T>;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t chunks = (n + kChunk / (int64_t)sizeof(T) - 1) / (kChunk / (int64_t)sizeof(T));
  int64_t grid = (int64_t)sm_count() * kBlocksPerSM;
  if (grid > chunks) grid = chunks;
  if (grid < 1) grid = 1;
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(alpha, px, py, po, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_axpy(double alpha, const void* x, const void* y, void* out, int64_t n, int dtype,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return launch<float>((float)alpha, x, y, out, n, s);
    case 1: return launch<__nv_bfloat16>(__float2bfloat16_rn((float)alpha), x, y, out, n, s);
    case 2: return launch<__half>(__float2half_rn((float)alpha), x, y, out, n, s);
    case 3: return launch<double>(alpha, x, y, out, n, s);
  }
  return (int)cudaErrorInvalidValue;
}
"""
AXPY_ONEPASS = ("kU", "kThreads", "kStreamVecBytes", "kResidentVecBytes")
# cache hints for axpy.cu's loads and stores (``hints:LOAD,STORE``)
AXPY_LOADS = {"plain": "return *p;", "nc": "return __ldg(p);",
              "cs": "return __ldcs(p);"}
AXPY_STORES = {"plain": "*p = v;", "cs": "__stcs(p, v);"}
AXPY_BULK_CONSTANTS = ("kChunk", "kStages", "kBlocksPerSM")
AXPY_DEFAULT = ["base", "onepass:1,256,16", "onepass:4,256,16,16",
                "hints:nc,plain", "hints:cs,cs", "bulk", "bulk:32768,3,1",
                "bulk:8192,4,2"]
AXPY_CASES = (("f32_2^26", torch.float32, 1 << 26),
              ("bf16_2^26", torch.bfloat16, 1 << 26),
              ("f32_2^20", torch.float32, 1 << 20),
              ("f64_256", torch.float64, 256))


def build_axpy_variants(keys):
    """``base`` (axpy.cu as it stands), ``file:PATH`` (another axpy.cu,
    e.g. a parent commit's), ``onepass:U,THREADS,VECBYTES[,VECBYTES]``
    (axpy.cu's constants rewritten: vectors a thread, threads a block,
    vector bytes past half the L2 and, optionally, within it),
    ``hints:LOAD,STORE`` (axpy.cu with the cache hints of AXPY_LOADS and
    AXPY_STORES), ``bulk`` or
    ``bulk:CHUNK,STAGES,BLOCKS_PER_SM`` (AXPY_BULK). A variant that does
    not build is reported and left out."""
    out_dir = build.build_dir() / "axpy_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (build.CSRC / "axpy.cu").read_text()
    procs = {}
    for i, key in enumerate(keys):
        kind, _, vals = key.partition(":")
        if kind == "file":
            text = open(vals).read()
        elif kind == "base":
            text = source
        elif kind == "onepass":
            text = _set_constants(source, AXPY_ONEPASS, vals.split(","))
        elif kind == "hints":
            load, store = vals.split(",")
            assert source.count(AXPY_LOADS["plain"]) == 1 \
                and source.count(AXPY_STORES["plain"]) == 1
            text = source.replace(AXPY_LOADS["plain"], AXPY_LOADS[load]) \
                .replace(AXPY_STORES["plain"], AXPY_STORES[store])
        elif kind == "bulk":
            text = AXPY_BULK if not vals else _set_constants(
                AXPY_BULK, AXPY_BULK_CONSTANTS, vals.split(","))
        else:
            raise ValueError(f"unknown axpy variant {key}")
        cu = out_dir / f"axpy_v{i}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[key] = (so, _compile(cu, so))
    libs = {}
    for key, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(json.dumps({"variant": key, "nvcc_failed": log[-2000:]}))
            continue
        lib = ctypes.CDLL(str(so))
        lib.repro_axpy.argtypes = list(build.SIGNATURES["axpy"]["repro_axpy"])
        lib.repro_axpy.restype = ctypes.c_int
        libs[key] = lib
    return libs


def axpy_main(keys, turns=5):
    """Each variant checked for bit-equality with ``axpy_plain`` (every
    dtype, ragged n, unaligned addresses), then all of them and
    ``torch.add(y, x, alpha=a)`` timed in turns, the order reversed every
    other turn."""
    libs = build_axpy_variants(keys)
    stream = torch.cuda.current_stream().cuda_stream
    codes = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
             torch.float64: 3}

    def run(lib, alpha, x, y):
        out = torch.empty_like(x)
        a = float(torch.tensor(alpha, dtype=x.dtype))
        err = lib.repro_axpy(a, x.data_ptr(), y.data_ptr(), out.data_ptr(),
                             x.shape[0], codes[x.dtype], stream)
        assert err == 0, err
        return out

    checks = [(n, dt, off) for n, dt, off in (
        (1 << 20, torch.float32, 0), (12345, torch.float16, 0),
        (4099, torch.bfloat16, 0), (256, torch.float64, 0),
        (1000, torch.float32, 1), (1000, torch.bfloat16, 3),
        (1003, torch.float64, 1), (3, torch.float32, 0))]
    for key, lib in list(libs.items()):
        for i, (n, dt, off) in enumerate(checks):
            x = cs._randn((n + off,), dt, 50 + i)[off:]
            y = cs._randn((n + off,), dt, 60 + i)[off:]
            if not torch.equal(run(lib, -1.75, x, y),
                               ax.axpy_plain(-1.75, x, y)):
                print(json.dumps({"variant": key, "bit_equal": False,
                                  "case": [n, str(dt), off]}))
                del libs[key]
                break
    cases = {tag: (cs._randn((n,), dt, 3), cs._randn((n,), dt, 4))
             for tag, dt, n in AXPY_CASES}
    names = ["torch.add"] + list(libs)
    times = {name: {tag: [] for tag in cases} for name in names}
    for t in range(turns):
        for name in (names if t % 2 == 0 else names[::-1]):
            for tag, (x, y) in cases.items():
                if name == "torch.add":
                    a = float(torch.tensor(2.5, dtype=x.dtype))
                    fn = (lambda x=x, y=y, a=a: torch.add(y, x, alpha=a))
                else:
                    fn = (lambda x=x, y=y, lib=libs[name]: run(lib, 2.5, x, y))
                times[name][tag].append(cs.time_ms(fn))
    bounds = {tag: cs.paper_bound("axpy", x.shape, x.element_size())[0]
              for tag, (x, _) in cases.items()}
    for name in names:
        print(json.dumps({"axpy_variant": name, "bit_equal": name != "torch.add"
                          or None, "ms": times[name], "bound_ms": bounds}))


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
    for u in variants:
        text, n_u = re.subn(r"constexpr int kU = \d+;",
                            f"constexpr int kU = {u};", source)
        assert n_u == 1, "kU not found in matmul.cu"
        cu = out_dir / f"matmul_u{u}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[u] = (so, _compile(cu, so))
    return _collect(procs, "matmul")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", nargs="*", type=int, default=[1, 4, 8, 16])
    ap.add_argument("--widths", nargs="*", type=int,
                    default=[4096, 16384, 32000, 128000])
    ap.add_argument("--conv", nargs="*", default=None, metavar="R,G,C,O",
                    help="time conv.cu tile variants instead (default set "
                    "without values)")
    ap.add_argument("--mm", nargs="*", default=None, metavar="VARIANT",
                    help="time matmul.cu tensor-core tile variants instead "
                    "(default set without values)")
    ap.add_argument("--axpy", nargs="*", default=None, metavar="VARIANT",
                    help="time axpy.cu variants against torch.add in turns "
                    "instead (default set without values)")
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
    if args.mm is not None or args.axpy is not None or args.ssm \
            or args.ssm_variants is not None:
        if args.mm is not None:
            mm_main(args.mm or MM_DEFAULT)
        if args.axpy is not None:
            axpy_main(args.axpy or AXPY_DEFAULT)
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
    libs = build_variants(args.variants)

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
        print(json.dumps({"variant": {"U": key},
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
