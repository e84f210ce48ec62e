"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
      --steps 50 [--reduced] [--ckpt-dir DIR --ckpt-every 25] \
      [--data 2 --model 4] [--fuse-steps 4] [--grad-accum 2] \
      [--seq-len 2048 --batch 4] [--device cuda]

The reference's flags, plus ``--device`` (default: the card; raises
without one). With ``--data/--model`` the trainer takes a (data, model)
mesh, held as tensor dimensions on the one device (``launch/mesh.py``):
the mixture-of-experts configs then train on the expert-parallel route
where the reference takes it.
``--reduced --device cpu`` runs the smoke-scale config on the CPU as a
rehearsal. With ``--ckpt-dir`` the run saves every ``--ckpt-every`` steps
and at its end, and resumes from the latest checkpoint found there.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--fuse-steps", type=int, default=1)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--data", type=int, default=0)
    ap.add_argument("--model", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, reduced
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_config(args.arch)
    if args.reduced:
        over = {}
        if args.layers:
            over["n_layers"] = args.layers
        if args.d_model:
            over["d_model"] = args.d_model
            over["head_dim"] = max(args.d_model // 4, 8)
        cfg = reduced(cfg, **over)

    mesh = None
    if args.data and args.model:
        mesh = make_mesh(args.data, args.model)

    data_cfg = DataConfig(seq_len=args.seq_len, global_batch=args.batch,
                          vocab_size=cfg.vocab_size)
    opt_cfg = OptConfig(peak_lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                        decay_steps=args.steps)
    tcfg = TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every, log_every=5,
                         fuse_steps=args.fuse_steps,
                         grad_accum=args.grad_accum)
    trainer = Trainer(cfg, opt_cfg, data_cfg, tcfg, mesh=mesh,
                      device=args.device)

    def log(m):
        print(f"step {m['step']:5d} loss {m['loss']:.4f} "
              f"ce {m['ce']:.4f} lr {m['lr']:.2e} gnorm {m['grad_norm']:.2f}"
              + (" [STRAGGLER]" if m.get("straggler") else ""), flush=True)

    step, _ = trainer.run(on_step=log)
    print(f"done at step {step}; median step time "
          f"{trainer.monitor.median*1000:.1f} ms")


if __name__ == "__main__":
    main()
