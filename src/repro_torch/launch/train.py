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
Under ``torchrun`` (``WORLD_SIZE`` in the environment) ``--data D --model
M`` takes a mesh of processes instead (``launch.mesh.make_process_mesh``:
NCCL on the cards, gloo with ``--device cpu``) and trains data-parallel
over ``data``, each rank on its block of the batch, and, for the dense
and MoE families at M > 1, tensor-parallel over ``model``, each rank on
its blocks of the parameters (with ``--grad-accum`` a MoE model's rows
re-laid so that each micro-batch is the global one's,
``train.step.micro_major``); the kernels are built by each machine's
local rank 0 while the others wait, and only rank 0 prints and writes
checkpoints (the whole state, gathered):

  torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
      --reduced --device cpu --data 2 --model 2 --steps 3
  torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
      --reduced --arch granite-moe-3b-a800m --device cpu --data 2 \
      --model 2 --grad-accum 2 --steps 3

``--reduced --device cpu`` runs the smoke-scale config on the CPU as a
rehearsal. With ``--ckpt-dir`` the run saves every ``--ckpt-every`` steps
and at its end, and resumes from the latest checkpoint found there.
"""
from __future__ import annotations

import argparse
import os


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
    from repro_torch.launch.mesh import make_mesh, make_process_mesh
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

    mesh, rank0 = None, True
    if args.data and args.model and "WORLD_SIZE" in os.environ:
        mesh = make_process_mesh(args.data, args.model, device=args.device)
        rank0 = mesh.rank == 0
        if mesh.device.type == "cuda":
            build_on_local_rank0(mesh)
    elif args.data and args.model:
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
        if not rank0:
            return
        print(f"step {m['step']:5d} loss {m['loss']:.4f} "
              f"ce {m['ce']:.4f} lr {m['lr']:.2e} gnorm {m['grad_norm']:.2f}"
              + (" [STRAGGLER]" if m.get("straggler") else ""), flush=True)

    step, _ = trainer.run(on_step=log)
    if rank0:
        print(f"done at step {step}; median step time "
              f"{trainer.monitor.median*1000:.1f} ms")
    if trainer.process:
        import torch.distributed as dist
        dist.destroy_process_group()


def build_on_local_rank0(mesh):
    """Each machine's local rank 0 builds the kernels while its other ranks
    wait, so that they never race to write the same libraries."""
    from repro_torch.kernels import build
    if int(os.environ.get("LOCAL_RANK", mesh.rank)) == 0:
        build.build()
    mesh.barrier()


if __name__ == "__main__":
    main()
