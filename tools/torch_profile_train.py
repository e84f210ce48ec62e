#!/usr/bin/env python3
"""Where a train step of the PyTorch port goes, on the card.

    python3 tools/torch_profile_train.py [--arch tinyllama-1.1b] [--batch 4]
        [--seq-len 2048] [--steps 2] [--top 15]

Builds randomly initialised parameters (seed 0) at full width and depth,
runs the port's train step (``train/step.py``, AdamW as
``launch/train.py`` configures it) on ``SyntheticLM`` batches, and reads
``--steps`` steady steps twice: with the host clock around steps that end in
a synchronise, and under ``torch.profiler`` (CPU + CUDA activities). Prints
one JSON object: wall ms per step, device-busy ms per step (sum of kernel
times), the device's idle share, kernel launches per step, device ms per
step of the port's attention kernels (by their CUDA names) against the rest,
and the kernels that take most device time. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import (DataConfig, SyntheticLM,  # noqa: E402
                                       to_device)
from repro_torch.kernels import attention as att  # noqa: E402
from repro_torch.models.layers import init_params  # noqa: E402
from repro_torch.models.transformer import model_template  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402

# CUDA kernel names of csrc/attention.cu by wrapper, as prefixes: each
# wrapper launches a tensor-core kernel (``*_mma``: ``flash_fwd_mma``,
# ``flash_bwd_dq_mma``, ``flash_bwd_dkv_mma``) for bfloat16 and float16 and
# a CUDA-core one (``*_kernel``) for float32 and float64
OWN = {"flash_fwd": "flash_fwd_", "flash_bwd_dq": "flash_bwd_dq_",
       "flash_bwd_dkv": "flash_bwd_dkv_"}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1

    cfg = get_config(args.arch)
    total = 2 + 2 * args.steps
    opt = adamw.OptConfig(warmup_steps=max(total // 10, 1),
                          decay_steps=total)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(model_template(cfg), gen, dtype=cfg.param_dtype,
                         device="cuda")
    state = {"params": params, "opt": adamw.init(opt, params)}
    step_fn = make_train_step(cfg, opt).step_fn
    source = SyntheticLM(DataConfig(seq_len=args.seq_len,
                                    global_batch=args.batch,
                                    vocab_size=cfg.vocab_size))
    batches = [to_device(source.batch(i), "cuda") for i in range(total)]
    for b in batches[:2]:                       # warm-up
        state, _ = step_fn(state, b)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for b in batches[2:2 + args.steps]:
        state, _ = step_fn(state, b)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / args.steps

    att.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for b in batches[2 + args.steps:]:
            state, _ = step_fn(state, b)
        torch.cuda.synchronize()

    # device-side events only: a host op (an aten op, or the autograd
    # Function around a kernel launched through ctypes) also carries the
    # device time of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    per = 1e3 * args.steps
    busy_ms = sum(e.self_device_time_total for e in events) / per
    if busy_ms == 0:
        print("the profiler recorded no device time", file=sys.stderr)
        return 1
    own = {name: sum(e.self_device_time_total for e in events
                     if kernel in e.key) / per
           for name, kernel in OWN.items()}
    # which CUDA kernels each wrapper's prefix matched (flash_fwd_mma, ...)
    matched = {name: sorted({re.search(kernel + r"[a-z]+", e.key).group(0)
                             for e in events if kernel in e.key})
               for name, kernel in OWN.items()}
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:args.top]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(json.dumps({
        "gpu": smi, "arch": cfg.name, "batch": args.batch,
        "seq_len": args.seq_len, "remat": cfg.remat,
        "compute_dtype": cfg.compute_dtype, "steps": args.steps,
        "wall_ms_per_step": wall_ms,
        "tokens_per_s": args.batch * args.seq_len / (wall_ms / 1e3),
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "kernel_launches_per_step": sum(e.count for e in events) / args.steps,
        "own_kernel_launches_per_step":
            {k: v / args.steps for k, v in att.LAUNCHES.items()},
        "attention_kernels_ms_per_step": own,
        "attention_kernels_matched": matched,
        "attention_kernels_share_of_busy": sum(own.values()) / busy_ms,
        "top_kernels": [
            {"name": e.key[:80], "calls_per_step": e.count / args.steps,
             "device_ms_per_step": e.self_device_time_total / per}
            for e in top]}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
