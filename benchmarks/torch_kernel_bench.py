"""Kernel micro-bench on the PyTorch port: the twin of
``benchmarks/kernel_bench.py``, with its rows at its shapes and inputs
(numpy ``RandomState(0)``, drawn in the reference's order) and its
iteration count.

Each kernel of the reference's rows gives up to three rows here:

- ``<row>_cuda``: the hand-written CUDA kernel through its wrapper
  (``kernels.ops``), timed between two CUDA events around ``ITERS`` calls
  after one warm call, queued behind held device work so that the events
  read the card and not the host (``benchmarks.torch_timing``). The row
  records ``launches``, how far the wrapper's launch counter moved over
  the timed calls, beside ``calls``: the two are equal when every call
  launched the kernel once. On a CPU tensor the
  wrapper runs its plain version, so there the row is ``<row>_plain_cpu``
  and never ``_cuda``;
- ``<row>_plain``: the kernel's plain PyTorch version on the same inputs;
- ``<row>_library``: the one PyTorch call that ``PERF.md`` uses as the
  kernel's yardstick (``torch.matmul``, ``torch.add(alpha=)``,
  ``F.conv2d`` with cuDNN's TF32 off, ``F.scaled_dot_product_attention``).
  No single call computes the scan, so ``ssm_scan_4k_f32`` has none.

The plain and library rows are timed like the kernel row (CUDA events on
the card, the host clock on the CPU). ``bound_us`` is the least time the
card could take for the call: each input read once and each output written
once over the memory rate, or the operations over the peak rate for the
operand type, whichever is larger (``core.precision``'s H100 table).

  PYTHONPATH=src python -m benchmarks.torch_kernel_bench [--device cuda]
"""
import argparse
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from benchmarks.torch_timing import seconds_per_call
from repro_torch.core.precision import PEAK_BYTES_PER_S, PEAKS_FLOPS
from repro_torch.device import resolve_device
from repro_torch.kernels import attention as att
from repro_torch.kernels import axpy as ax
from repro_torch.kernels import conv as cv
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import ops
from repro_torch.kernels import ssm_scan as ss

ITERS = 3                      # the reference's iteration count
ATT_BLOCK = 256                # the reference's bq = bk


@dataclasses.dataclass
class Case:
    """One reference row: its operands, the kernel's wrapper call on them,
    its plain version, the library yardstick (or None) and the launch
    counter it moves."""
    name: str
    operands: tuple
    kernel: Callable
    plain: Callable
    library: Optional[Callable]
    counter: tuple               # (LAUNCHES dict, key)
    bound_s: float
    rate: Optional[tuple]        # ("gflops", flops) or ("gbytes_per_s", bytes)
    extra: dict                  # the kernel row's own fields


def _bound(n_bytes, n_ops, dtype):
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAKS_FLOPS[dtype])


def _attention_plain(q, bq, bk):
    """The forward kernel's plain version on the public wrapper's padded,
    flattened operands: what ``ops.flash_attention(q, q, q)`` computes."""
    b, h, s, d = q.shape
    qf, kf, vf, kvm, bq, bk = att._prepare(q, q, q, None, bq, bk)
    out, _, _ = att.flash_fwd_plain(qf, kf, vf, kvm, causal=True, bq=bq,
                                    bk=bk)
    return out[:, :s].reshape(b, h, s, d)


def _conv_library(x, w):
    with torch.backends.cudnn.flags(allow_tf32=False):
        return F.conv2d(x[None], w)[0]


def cases(device=None):
    """The reference's rows as :class:`Case` objects on ``device``, with
    its inputs (numpy ``RandomState(0)``, the reference's draw order)."""
    dev = resolve_device(device)
    rng = np.random.RandomState(0)

    def t(x, dtype=torch.float32):
        return torch.from_numpy(np.asarray(x)).to(dev, dtype)

    out = []
    # matmul 256 (paper's size), fp32
    a, b = t(rng.randn(256, 256)), t(rng.randn(256, 256))
    flops = 2 * 256 ** 3
    out.append(Case(
        "matmul256_f32", (a, b), lambda: ops.matmul(a, b),
        lambda: mm.matmul_plain(a, b), lambda: torch.matmul(a, b),
        (mm.LAUNCHES, "matmul"), _bound(3 * 256 * 256 * 4, flops, "float32"),
        ("gflops", flops), {"intensity_flop_per_byte": 16.0}))
    # axpy 1M
    x, y = t(rng.randn(1 << 20)), t(rng.randn(1 << 20))
    n_bytes = 3 * 4 * (1 << 20)
    out.append(Case(
        "axpy_1M_f32", (x, y), lambda: ops.axpy(2.0, x, y),
        lambda: ax.axpy_plain(2.0, x, y),
        lambda: torch.add(y, x, alpha=2.0),
        (ax.LAUNCHES, "axpy"), _bound(n_bytes, 2 * (1 << 20), "float32"),
        ("gbytes_per_s", n_bytes),
        {"intensity_flop_per_byte": round(1 / 6, 4)}))
    # conv GoogLeNet-1 (fp32)
    xc, wc = t(rng.randn(3, 118, 118)), t(rng.randn(64, 3, 7, 7))
    flops = 2 * 64 * 3 * 7 * 7 * 112 * 112
    n_bytes = (3 * 118 * 118 + 64 * 3 * 7 * 7 + 64 * 112 * 112) * 4
    out.append(Case(
        "conv_googlenet1_f32", (xc, wc), lambda: ops.conv2d(xc, wc),
        lambda: cv.conv2d_plain(xc, wc), lambda: _conv_library(xc, wc),
        (cv.LAUNCHES, "conv2d_direct"), _bound(n_bytes, flops, "float32"),
        ("gflops", flops), {"intensity_flop_per_byte": 34.9}))
    # flash attention 1k, bf16, causal, blocks 256 x 256
    q = t(rng.randn(1, 8, 1024, 64), torch.bfloat16)
    g, s, d = 8, 1024, 64
    pairs = s * (s + 1) / 2                   # the causal triangle a head
    n_bytes = 4 * g * s * d * 2 + 3 * g * s * 4   # q k v out | kvm lse
    out.append(Case(
        "attention_1k_bf16", (q,),
        lambda: ops.flash_attention(q, q, q, bq=ATT_BLOCK, bk=ATT_BLOCK),
        lambda: _attention_plain(q, ATT_BLOCK, ATT_BLOCK),
        lambda: F.scaled_dot_product_attention(q, q, q, is_causal=True),
        (att.LAUNCHES, "flash_fwd"),
        _bound(n_bytes, 2 * 2 * d * g * pairs, "bfloat16"),
        None, {"blocks": f"{ATT_BLOCK}x{ATT_BLOCK}"}))
    # ssm scan 4k: q = k = v, scale = -log_decay, chunk 128
    qs = t(rng.randn(8, 4096, 64))
    ld = -t(rng.rand(8, 4096))
    bh, sl, n, p, c = 8, 4096, 64, 64, 128
    n_ops = bh * (sl // c) * (c * (c + 1) * (n + p) + 4 * c * n * p)
    n_bytes = (3 * bh * sl * n + bh * sl * p + 2 * bh * sl) * 4
    out.append(Case(
        "ssm_scan_4k_f32", (qs, ld), lambda: ops.ssm_scan(qs, qs, qs, ld, -ld),
        lambda: ss.ssm_scan_plain(qs, qs, qs, ld, -ld), None,
        (ss.LAUNCHES, "ssm_scan"), _bound(n_bytes, n_ops, "float32"),
        None, {"chunk": c}))
    return out


def _timed_row(case, label, secs):
    row = {"kernel": f"{case.name}_{label}", "source": label,
           "us_per_call": round(secs * 1e6, 2)}
    if case.rate is not None:
        key, amount = case.rate
        row[key] = round(amount / secs / 1e9, 2)
    return row


def rows(device=None, case_list=None):
    """Times every case on ``device``: the kernel row (``_cuda`` on the
    card, ``_plain_cpu`` on the CPU) with its launch count, the plain row
    and the library row."""
    dev = resolve_device(device)
    case_list = cases(dev) if case_list is None else case_list
    on_card = dev.type == "cuda"
    out = []
    with torch.no_grad():
        for c in case_list:
            counts, key = c.counter
            before = counts[key]
            secs = seconds_per_call(c.kernel, dev, ITERS)
            launches = counts[key] - before - 1     # less the warm call
            label = "cuda" if on_card else "plain_cpu"
            row = {**_timed_row(c, label, secs), **c.extra,
                   "bound_us": round(c.bound_s * 1e6, 3)}
            if on_card:
                row.update(launches=launches, calls=ITERS)
            out.append(row)
            for suffix, fn in (("plain", c.plain), ("library", c.library)):
                if fn is not None:
                    out.append(_timed_row(c, suffix,
                                          seconds_per_call(fn, dev, ITERS)))
    return out


def main(emit, device=None):
    for r in rows(device):
        emit("kernel_bench", r)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(lambda table, row: print(",".join(
        [table] + [f"{k}={v}" for k, v in row.items()]), flush=True),
        args.device)
