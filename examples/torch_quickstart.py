"""Quickstart on the PyTorch port: build an assigned architecture, run a
forward pass, a train step, and the model-FLOPs estimate — the public API
in ~40 lines. The twin of ``examples/quickstart.py``: the same ``--arch``
and the same five lines, plus ``--device`` (default: the card; raises
without one).

  PYTHONPATH=src python examples/torch_quickstart.py [--arch tinyllama-1.1b]
      [--device cuda]

The reference builds its train step over ``MeshCtx(mesh=None)``; the
port's ``make_train_step`` runs on one device and takes no mesh context
(``ctx=None``), so ``MeshCtx`` has no twin here. Random draws come from
explicit ``torch.Generator``s (seeds 0, 1, 2 as the reference's PRNG keys),
so the values differ from the reference's; the counts and shapes do not.
"""
import argparse

import torch

from repro_torch.configs import SHAPES, get_config, reduced
from repro_torch.core.roofline import model_flops
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.layers import init_params, tree_size_bytes
from repro_torch.optim import adamw
from repro_torch.train import step as step_lib


def run(arch="tinyllama-1.1b", device=None, emit=print):
    """The quickstart on ``device``: emits its five lines and returns what
    they print (the metrics as Python floats)."""
    dev = resolve_device(device)
    full = get_config(arch)
    cfg = reduced(full)  # small same-family config
    emit(f"{full.name}: {full.param_count()/1e9:.2f}B params "
         f"({full.active_param_count()/1e9:.2f}B active), "
         f"family={full.family}")
    emit(f"train_4k model FLOPs: "
         f"{model_flops(full, SHAPES['train_4k']):.3e}")

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    params = init_params(tf.model_template(cfg), gen(0), device=dev)
    size_mb = tree_size_bytes(params) / 1e6
    emit(f"reduced config params: {size_mb:.1f} MB")

    tokens = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen(1),
                           device=dev)
    kw = {}
    if cfg.frontend_seq:
        kw["frontend_emb"] = torch.randn(
            (2, cfg.frontend_seq, cfg.frontend_dim or cfg.d_model),
            generator=gen(2), device=dev)
    with torch.no_grad():
        logits, aux, _ = tf.forward(cfg, params, tokens, **kw)
    emit(f"forward: logits {tuple(logits.shape)}, aux={float(aux):.3f}")

    bundle = step_lib.make_train_step(cfg, adamw.OptConfig())
    state = {"params": params, "opt": adamw.init(adamw.OptConfig(), params)}
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1), **kw}
    state, metrics = bundle.step_fn(state, batch)
    loss, grad_norm = float(metrics["loss"]), float(metrics["grad_norm"])
    emit(f"train step: loss={loss:.4f} grad_norm={grad_norm:.3f}")
    return {"params": full.param_count(),
            "active_params": full.active_param_count(),
            "reduced_params_mb": size_mb,
            "logits_shape": tuple(logits.shape), "aux": float(aux),
            "loss": loss, "grad_norm": grad_norm}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.arch, args.device)


if __name__ == "__main__":
    main()
