"""Serving example on the PyTorch port: batched requests through the
hardened serving engine (bounded admission, deadlines, degrade ladder,
invariant checks — see docs/serving.md). The twin of
``examples/serve_lm.py``: the same flags and lines, plus ``--device``
(default: the card; raises without one). The parameters are the port's
own (``init_params``, ``torch.Generator`` seeded 0).

  PYTHONPATH=src python examples/torch_serve_lm.py [--requests 12 --slots 4]
      [--device cuda]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.models.layers import init_params
from repro_torch.models.transformer import model_template
from repro_torch.serving import DegradeLadder, Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--deadline", type=int, default=None,
                    help="TTL in engine ticks applied to half the requests")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = reduced(get_config(args.arch))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(model_template(cfg), gen, device=dev)
    engine = ServingEngine(cfg, params, slots=args.slots, max_seq=128,
                           degrade=DegradeLadder(bf16_at=2.0), device=dev)

    rng = np.random.RandomState(0)
    t0 = time.time()
    for i in range(args.requests):
        deadline = args.deadline if (args.deadline and i % 2) else None
        reason = engine.submit(Request(
            uid=i, prompt=rng.randint(0, cfg.vocab_size, 16).astype(np.int32),
            max_new_tokens=args.max_new, deadline=deadline))
        if reason is not None:
            print(f"  req {i} rejected: {reason.value}")
    done = engine.run_to_completion(max_steps=5000)
    dt = time.time() - t0
    tokens = sum(len(r.out_tokens) for r in done)
    print(f"{len(done)} requests, {tokens} new tokens in {dt:.2f}s "
          f"({tokens/dt:.1f} tok/s, {args.slots} slots)")
    for r in done[:3]:
        print(f"  req {r.uid}: {r.state.value} "
              f"first tokens {r.out_tokens[:6]}")
    print(f"  stats: {engine.stats()}")


if __name__ == "__main__":
    main()
