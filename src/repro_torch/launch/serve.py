"""Serving launcher: batched requests through the continuous-batching engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --requests 8 --slots 4 --max-new 16

Runs on the card (``--device cuda``, the default) and fails without one;
``--device cpu --reduced`` is the small CPU rehearsal. Parameters are
randomly initialised from ``--seed``.
"""
from __future__ import annotations

import argparse
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import numpy as np
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.device import resolve_device
    from repro_torch.models.layers import init_params
    from repro_torch.models.transformer import model_template
    from repro_torch.serving.engine import Request, ServingEngine

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(model_template(cfg), gen, device=device)
    engine = ServingEngine(cfg, params, slots=args.slots,
                           max_seq=args.max_seq, device=device,
                           seed=args.seed)

    rng = np.random.RandomState(args.seed)
    t0 = time.time()
    for i in range(args.requests):
        engine.submit(Request(
            uid=i,
            prompt=rng.randint(0, cfg.vocab_size,
                               size=args.prompt_len).astype(np.int32),
            max_new_tokens=args.max_new))
    done = engine.run_to_completion()
    dt = time.time() - t0
    total_new = sum(len(r.out_tokens) for r in done)
    print(f"served {len(done)} requests, {total_new} tokens "
          f"in {dt:.2f}s ({total_new/dt:.1f} tok/s) on {device}")
    for r in done[:3]:
        print(f"  req {r.uid}: {r.out_tokens[:8]}...")


if __name__ == "__main__":
    main()
