"""End-to-end training example on the PyTorch port: train a llama-family
model with checkpointing + restart. The twin of ``examples/train_lm.py``:
the same flags and lines, plus ``--device`` (default: the card; raises
without one). The default runs a scaled-down config so the example
finishes in minutes on the CPU; pass --full-100m on the card. Run it
twice with the same ``--ckpt-dir`` and the second run resumes where the
first one stopped (a run that has reached ``--steps`` only reports).

  PYTHONPATH=src python examples/torch_train_lm.py [--steps 120]
      [--full-100m] [--ckpt-dir DIR] [--device cuda]
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    base = get_config("tinyllama-1.1b")
    if args.full_100m:
        # ~100M llama-family config (12L x 768, 12 heads)
        cfg = dataclasses.replace(
            base, n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
            head_dim=64, d_ff=2048, vocab_size=32000, scan_layers=True,
            remat="full")
    else:
        cfg = reduced(base, n_layers=4, d_model=128,
                      vocab_size=2048, d_ff=512)

    data = DataConfig(seq_len=args.seq_len, global_batch=args.batch,
                      vocab_size=cfg.vocab_size)
    opt = OptConfig(peak_lr=1e-3, warmup_steps=max(args.steps // 20, 1),
                    decay_steps=args.steps)
    tcfg = TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=max(args.steps // 4, 10), log_every=10,
                         fuse_steps=4)
    trainer = Trainer(cfg, opt, data, tcfg, device=args.device)

    print(f"training {cfg.param_count()/1e6:.1f}M params for "
          f"{args.steps} steps (resumes from {args.ckpt_dir} if present)")

    def log(m):
        print(f"step {m['step']:5d}  loss {m['loss']:.4f}  "
              f"lr {m['lr']:.2e}", flush=True)

    step, _ = trainer.run(on_step=log)
    first = trainer.metrics_log[0]["loss"] if trainer.metrics_log else None
    last = trainer.metrics_log[-1]["loss"] if trainer.metrics_log else None
    if first is None:
        print(f"finished at step {step}: nothing left to train")
        return
    print(f"finished at step {step}: loss {first:.3f} -> {last:.3f}; "
          f"median step {trainer.monitor.median*1e3:.0f} ms")


if __name__ == "__main__":
    main()
