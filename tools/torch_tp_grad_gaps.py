"""Per-leaf gradient gaps of the tensor-parallel step against the
one-device step, ranks sharing one card through gloo.

For m = 2 and 4, m ranks on card 0 (``make_process_mesh(1, m,
device="cuda:0", backend="gloo")``) take the gradients of ``lm_loss`` for
tinyllama-1.1b at full width, ``--layers`` layers, float32 compute (TF32
off), batch ``--batch`` x 2048, on their blocks of the seeded init
(optionally ``chip_smoke._conditioned``); rank 0 takes the one-device
gradients of the same parameters and batch. Prints one JSON line per run:
both losses, the tensor-parallel grad norm (``optim.adamw.global_norm``
over the blocks), the one-device one, and per leaf the largest gap of the
gathered gradient as a share of the one-device leaf's largest entry. Runs
the configured step, then with the attention route off and with remat
off, to tell the kernels and the recompute from the split's own order.

  python3 tools/torch_tp_grad_gaps.py [--layers 2] [--batch 4]
      [--conditioned]

Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "src"))

import torch  # noqa: E402


def _leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}/{k}")]
    return [prefix]


def _rank(rank, world, store, out, args, variant):
    import torch.distributed as dist

    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import (init_params, tree_leaves,
                                           value_and_grad)
    from repro_torch.models.sharding import (MeshCtx, gather_params,
                                             sanitize_specs, shard_params)
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_lib
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_process_mesh(1, world, device="cuda:0", backend="gloo",
                             init_method=f"file://{store}", rank=rank,
                             world_size=world)
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"),
                              n_layers=args.layers, compute_dtype="float32",
                              **variant)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(tf.model_template(cfg), gen, dtype=cfg.param_dtype,
                         device="cuda")
    if args.conditioned:
        params = chip_smoke._conditioned(params, cfg)
    ctx = MeshCtx(mesh=mesh.with_local(("data",)))
    specs = step_lib.train_state_specs(cfg, ctx)["params"]
    sane = sanitize_specs(specs, params, mesh)
    blocks = shard_params(params, specs, mesh)
    batch = to_device(SyntheticLM(DataConfig(
        seq_len=2048, global_batch=args.batch, vocab_size=cfg.vocab_size,
        seed=0)).batch(0), "cuda")
    (loss, _), grads = value_and_grad(
        lambda p, b: tf.lm_loss(cfg, p, b, ctx=ctx))(blocks, batch)
    norm = float(adamw.global_norm(grads, step_lib.cut_axes(sane, mesh),
                                   mesh))
    whole = gather_params(grads, sane, mesh)
    if rank == 0:
        (loss1, _), grads1 = value_and_grad(
            lambda p, b: tf.lm_loss(cfg, p, b))(params, batch)
        gaps = {n: float((a - b).abs().max() / b.abs().max())
                for n, a, b in zip(_leaf_names(grads1), tree_leaves(whole),
                                   tree_leaves(grads1))}
        with open(out, "w") as f:
            json.dump({"loss": float(loss), "one_device_loss": float(loss1),
                       "grad_norm": norm,
                       "one_device_grad_norm": float(
                           adamw.global_norm(grads1)),
                       "gap_of_max": gaps}, f)
    dist.barrier()
    dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--conditioned", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_tp_grad_gaps: no CUDA device", file=sys.stderr)
        return 1
    import torch.multiprocessing as mp

    from repro_torch.kernels import build
    build.build(["attention"])      # before the ranks, which would race
    variants = {"configured": {}, "attention route off": {"attn_flash": "off"},
                "remat off": {"remat": "none"}}
    for world in (2, 4):
        for name, variant in variants.items():
            tmp = tempfile.mkdtemp(prefix="tp_grad_gaps_")
            out = os.path.join(tmp, "out.json")
            mp.start_processes(_rank, args=(world, os.path.join(tmp, "store"),
                                            out, args, variant),
                               nprocs=world, start_method="spawn")
            with open(out) as f:
                print(json.dumps({"ranks": world, "variant": name,
                                  "conditioned": args.conditioned,
                                  "device": torch.cuda.get_device_name(0),
                                  **json.load(f)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
