#!/usr/bin/env python3
"""Where a decode step of the PyTorch port goes, on the card.

    python3 tools/torch_profile_decode.py [--arch tinyllama-1.1b] [--mode bf16]
        [--slots 8] [--steps 5] [--top 12]

Serves randomly initialised parameters (seed 0) at full width with every
slot busy, holds the engine at one degrade mode (fp32 = the configured
precision, bf16, int8), and reads ``--steps`` steady decode steps twice:
with the host clock around steps that end in a synchronise, and under
``torch.profiler`` (CPU + CUDA activities). Prints one JSON object: wall ms
per step, device-busy ms per step (sum of kernel times), the device's idle
share (1 - busy / wall), kernel launches per step, and the kernels that take
most device time. The profiler itself slows the host, so the wall time comes
from the run without it. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import matmul as mm  # noqa: E402
from repro_torch.models.layers import init_params  # noqa: E402
from repro_torch.models.transformer import model_template  # noqa: E402
from repro_torch.serving import (DegradeLadder, Request,  # noqa: E402
                                 ServingEngine)

LADDERS = {"fp32": None,
           "bf16": DegradeLadder(bf16_at=0.0),
           "int8": DegradeLadder(bf16_at=0.0, int8_at=0.0)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--mode", choices=sorted(LADDERS), default="bf16")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1

    cfg = get_config(args.arch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(model_template(cfg), gen, device="cuda")
    engine = ServingEngine(cfg, params, slots=args.slots, max_seq=512,
                           degrade=LADDERS[args.mode])
    rng = np.random.RandomState(0)
    for i in range(args.slots):
        engine.submit(Request(
            uid=i, prompt=rng.randint(0, cfg.vocab_size,
                                      size=args.prompt_len).astype(np.int32),
            max_new_tokens=3 * args.steps + 8))
    for _ in range(args.steps):          # admission, prefill, warm-up
        engine.step()
    assert len(engine.active) == args.slots
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for _ in range(args.steps):
        engine.step()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / args.steps

    mm.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            engine.step()
        torch.cuda.synchronize()
    assert len(engine.active) == args.slots and not engine.events

    events = [e for e in prof.key_averages()
              if getattr(e, "self_device_time_total", 0) > 0
              and e.key.split("::")[0] != "aten"]      # kernels, not ops
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / args.steps
    launches = sum(e.count for e in events) / args.steps
    if busy_ms == 0:
        print("the profiler recorded no device time", file=sys.stderr)
        return 1
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:args.top]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(json.dumps({
        "gpu": smi, "arch": cfg.name, "mode": args.mode, "slots": args.slots,
        "steps": args.steps, "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "kernel_launches_per_step": launches,
        "own_kernel_launches_per_step":
            {k: v / args.steps for k, v in mm.LAUNCHES.items()},
        "top_kernels": [
            {"name": e.key[:70], "calls_per_step": e.count / args.steps,
             "device_ms_per_step": e.self_device_time_total / 1e3 / args.steps}
            for e in top]}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
