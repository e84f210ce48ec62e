"""Builds the CUDA sources in ``kernels/csrc`` and loads them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes one shared
library, ``build/repro_torch/<name>-<hash>.so`` under the repository root
(or under ``$REPRO_TORCH_BUILD_DIR``), compiled by ``nvcc`` for ``sm_90a``
at first use and keyed by a hash of the source, the headers beside it
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt
and an unchanged one is not. Sources are compiled in
parallel, one ``nvcc`` process each. Nothing here includes PyTorch's
headers: a source builds in seconds.

Importing this module needs neither ``nvcc`` nor a card; only
:func:`load` (called by a wrapper right before its first launch) does. A
failed build raises ``RuntimeError`` carrying ``nvcc``'s output — there is
no other path to take.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

from repro_torch.core import step_analysis

CSRC = Path(__file__).resolve().parent / "csrc"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_vp, _int = ctypes.c_void_p, ctypes.c_int
# C signatures per source: every pointer and the stream are c_void_p (a bare
# Python int would be passed as a 32-bit int and cut the pointer).
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "axpy": {
        # alpha, x, y, out; n, dtype; stream
        "repro_axpy": (ctypes.c_double, _vp, _vp, _vp, ctypes.c_int64, _int,
                       _vp),
    },
    "conv": {
        # x, w, out; C, H, W, OC, KH, KW, dtype, out_dtype; stream
        "repro_conv2d": (_vp,) * 3 + (_int,) * 8 + (_vp,),
        # C, H, W, KH, KW, dtype -> output rows per block (0: does not fit)
        "repro_conv2d_rows": (_int,) * 6,
        "repro_conv2d_smem_budget": (),
        # C, H, W, KH, KW, dtype -> 1 compile-time taps, 0 the general
        # (runtime-taps) kernel
        "repro_conv2d_route": (_int,) * 6,
    },
    "ssm_scan": {
        # q, k, v, log_decay, scale, y, states, dec, yx; BH, S, N, P,
        # chunk, dtype; stream
        "repro_ssm_scan": (_vp,) * 9 + (_int,) * 6 + (_vp,),
        # N, P, chunk, dtype -> shared-memory bytes of the largest block
        "repro_ssm_scan_smem_bytes": (_int,) * 4,
        # N, P, chunk, dtype -> 1: the cross-chunk term takes a pass of its
        # own and a (BH, S, P) scratch
        "repro_ssm_scan_cross_scratch": (_int,) * 4,
        "repro_ssm_scan_smem_limit": (),
    },
    "attention": {
        # q, k, v, kvm, out, lse, probe; G, Sq, Sk, D, bq, bk, causal,
        # dtype; stream
        "repro_flash_fwd": (_vp,) * 7 + (_int,) * 8 + (_vp,),
        # q, k, v, kvm, dout, lse, delta, dq; G ... dtype; stream
        "repro_flash_bwd_dq": (_vp,) * 8 + (_int,) * 8 + (_vp,),
        # q, k, v, kvm, dout, lse, delta, dk, dv; G ... dtype; stream
        "repro_flash_bwd_dkv": (_vp,) * 9 + (_int,) * 8 + (_vp,),
    },
    "matmul": {
        "repro_matmul": (_vp, _vp, _vp, _int, _int, _int, _int, _int, _vp),
        # M, K, N, in_dtype -> route code (0 skinny_mma, 1 tiled_mma,
        # 2 skinny_fma, 3 tiled_fma)
        "repro_matmul_route": (_int,) * 4,
        # M, K, N -> matmul_int8's route code (0 skinny_imma, 1 tiled_imma)
        "repro_matmul_int8_route": (_int,) * 3,
        # in_dtype (3: matmul_int8) -> most rows of a one launch takes
        "repro_matmul_max_rows": (_int,),
        "repro_matmul_int8": (_vp, _vp, _vp, _int, _int, _int, _int, _int,
                              _vp),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/build.py -> repository root
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [shutil.which("nvcc")]
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, under $CUDA_HOME and under "
        "/usr/local/cuda): the CUDA kernels cannot be built here")


def source_hash(name: str) -> str:
    """Hash of ``<name>.cu``, of every header ``csrc/*.cuh`` (in sorted
    order: any source may include any of them) and of the flags."""
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return build_dir() / f"{name}-{source_hash(name)}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the named sources (default: all) that are not built yet, all
    ``nvcc`` processes started together. Returns ``{name: library path}``.
    ``<library>.log`` keeps what ``nvcc -Xptxas -v`` printed (registers,
    shared memory and spills of each kernel)."""
    names = sorted(SIGNATURES) if names is None else list(names)
    out = {n: library_path(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    nvcc = find_nvcc()
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = []
    for n in todo:
        # build under a private name, publish by rename: a reader never
        # sees a half-written library
        tmp = out[n].with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failures = []
    for n, tmp, cmd, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"$ {' '.join(cmd)}\n{log}")
            continue
        out[n].with_suffix(".log").write_text(log)
        os.replace(tmp, out[n])
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return out


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built if need be, with
    ``argtypes``/``restype`` set on every exported function."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def device_kind(what: str, t) -> str:
    """The device type of ``t`` if a wrapper takes it: "cpu" (the plain
    version), "cuda" (the kernel) or "meta" (outputs, no launch); any
    other raises ValueError."""
    kind = t.device.type
    if kind not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{what}: unsupported device {t.device}")
    return kind


def launch(fn, device, *args) -> int:
    """Call a C launcher on ``device``'s current stream; returns its
    cudaError. The device is switched only when it is not the current one.
    Under ``core.step_analysis.analyze`` a launch outside a wrapper's work
    count raises."""
    step_analysis.check_launch(getattr(fn, "__name__", str(fn)))
    if device.index is not None \
            and device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return fn(*args, torch.cuda.current_stream().cuda_stream)
    return fn(*args, torch.cuda.current_stream().cuda_stream)


def raise_on_launch_error(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed with cudaError "
                           f"{err}")
