"""Multi-precision sweep (§III-E4) on the PyTorch port: dtype × size, three
rulers. The twin of ``benchmarks/multiprecision.py``.

1. Analytical Ara model: matmul FLOP/cycle at SEW 64/32/16/8 from
   perfmodel.matmul_perf(ew_bits=) — the datapath-split prediction
   (the port's copy of ``core/perfmodel.py``; host code, rows equal to
   the reference's).
2. Instruction scoreboard: simulate_timing over the SEW-parameterized
   matmul program, the SEW=8 row through ``isa.imatmul_program`` (the
   port's copies of ``core/isa.py`` and ``simulate_timing``; rows equal
   to the reference's).
3. Card kernels: the hand-written CUDA matmul through ``ops.matmul`` at
   fp32/bf16/f16 (``Policy(compute_dtype=...)`` casts the fp32 operands;
   fp32 accumulation) per size, plus the int8 row (``ops.matmul_int8``:
   int32 accumulation on the int8 tensor cores). Each call is timed
   between two CUDA events around the reference's 3 iterations after one
   warm call, and stamped ``source=cuda``. On the CPU the wrappers run
   their plain versions and the rows say ``source=plain_cpu``: their
   speedups measure the host's GEMMs, not the card's. ``gflops`` reads as
   GOPS on the int8 row.

Every row carries ``predicted_speedup`` from the shared
precision.ARA_FLOP_PER_CYCLE_PER_LANE table so achieved vs predicted can
be charted directly.

  PYTHONPATH=src python -m benchmarks.torch_multiprecision [--device cuda]
"""
import argparse

import numpy as np
import torch

from benchmarks.torch_timing import seconds_per_call
from repro_torch.configs.ara import AraConfig
from repro_torch.core import isa
from repro_torch.core import perfmodel as pm
from repro_torch.core.precision import Policy, ara_speedup_vs_dp, sew_for_dtype
from repro_torch.core.vector_engine import simulate_timing
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

SEWS = isa.SEWS
DTYPES = ("float32", "bfloat16", "float16")
ITERS = 3                      # the reference's iteration count


def model_rows(lanes=(2, 16), sizes=(64, 256)):
    out = []
    for l in lanes:
        cfg = AraConfig(lanes=l)
        for n in sizes:
            base = pm.matmul_perf(cfg, n, ew_bits=64).flop_per_cycle
            for sew in SEWS:
                perf = pm.matmul_perf(cfg, n, ew_bits=sew)
                out.append({
                    "source": "perfmodel", "lanes": l, "n": n, "sew": sew,
                    "flop_per_cycle": round(perf.flop_per_cycle, 3),
                    "utilization": round(perf.utilization, 4),
                    "achieved_speedup": round(perf.flop_per_cycle / base, 3),
                    "predicted_speedup": ara_speedup_vs_dp(sew),
                })
    return out


def scoreboard_rows(lanes=2, n=256):
    cfg = AraConfig(lanes=lanes)
    flops = 2.0 * n ** 3
    out = []
    base = None
    for sew in SEWS:
        if sew in isa.FP_SEWS:
            prog = isa.matmul_program(n, 0, n * n, 2 * n * n, t=4,
                                      vlmax=n, sew=sew)
        else:
            # SEW=8: the integer spelling (VMUL+VADD, no int MACC)
            prog = isa.imatmul_program(n, 0, n * n, 2 * n * n, t=4,
                                       vlmax=n)
        tr = simulate_timing(prog, cfg, vlmax=n)
        fpc = tr.flop_per_cycle(flops)
        if base is None:
            base = fpc
        out.append({
            "source": "scoreboard", "lanes": lanes, "n": n, "sew": sew,
            "flop_per_cycle": round(fpc, 3),
            "achieved_speedup": round(fpc / base, 3),
            "predicted_speedup": ara_speedup_vs_dp(sew),
        })
    return out


def kernel_operands(n, rng, device):
    """fp32 operands of one size and the int8 ones, drawn as the reference
    draws them (``RandomState`` shared across sizes)."""
    a32 = torch.from_numpy(rng.randn(n, n)).to(device, torch.float32)
    b32 = torch.from_numpy(rng.randn(n, n)).to(device, torch.float32)
    a8 = torch.from_numpy(rng.randint(-64, 64, (n, n))).to(device, torch.int8)
    b8 = torch.from_numpy(rng.randint(-64, 64, (n, n))).to(device, torch.int8)
    return a32, b32, a8, b8


def kernel_calls(a32, b32, a8, b8):
    """{dtype name: the row's call}: ``ops.matmul`` at each Policy's
    compute dtype on the fp32 operands, and ``ops.matmul_int8``."""
    calls = {name: (lambda p=Policy(compute_dtype=name):
                    ops.matmul(a32, b32, policy=p)) for name in DTYPES}
    calls["int8"] = lambda: ops.matmul_int8(a8, b8)
    return calls


def kernel_rows(sizes=(256, 512), device=None):
    dev = resolve_device(device)
    source = "cuda" if dev.type == "cuda" else "plain_cpu"
    rng = np.random.RandomState(0)
    out = []
    with torch.no_grad():
        for n in sizes:
            flops = 2.0 * n ** 3
            base_s = None
            for name, fn in kernel_calls(*kernel_operands(n, rng,
                                                          dev)).items():
                secs = seconds_per_call(fn, dev, ITERS)
                if base_s is None:
                    base_s = secs
                sew = 8 if name == "int8" else sew_for_dtype(name)
                out.append({
                    "source": source, "n": n, "dtype": name,
                    "sew_equiv": sew,
                    "us_per_call": round(secs * 1e6, 2),
                    "gflops": round(flops / secs / 1e9, 2),
                    "achieved_speedup": round(base_s / secs, 3),
                    # kernel baseline is fp32, so normalize the datapath-
                    # split prediction to fp32 (= SEW 32), not to the
                    # 64-bit ruler
                    "predicted_speedup": round(
                        ara_speedup_vs_dp(sew) / ara_speedup_vs_dp(32), 3),
                })
    return out


def main(emit, device=None):
    for r in model_rows():
        emit("multiprecision", r)
    for r in scoreboard_rows():
        emit("multiprecision", r)
    for r in kernel_rows(device=device):
        emit("multiprecision", r)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(lambda table, row: print(
        ",".join([table] + [f"{k}={v}" for k, v in row.items()])),
        args.device)
