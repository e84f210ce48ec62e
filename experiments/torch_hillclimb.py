"""Hillclimb driver on the port's dry run: the twin of
``experiments/hillclimb.py``. Runs tagged variants of the three chosen
cells through ``repro_torch.launch.dryrun.run_cell`` (counted on ``meta``
tensors for the card's routes, no card needed) and prints their roofline
terms.

  PYTHONPATH=src python experiments/torch_hillclimb.py --iter 1 [--cell llama3]

Iteration 2 sets ``repro_torch.models.attention.KV_CHUNK = 2048`` as the
reference's sets its own. On the card's route the triangular train case
takes the attention kernels, whose blocks do not depend on it (and the
blockwise route reads ``cfg.attn_chunk`` first), so the knob moves nothing
there: the driver prints llama3's hc2 count beside its hc1 count (the same
overrides without the knob) to show it.
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.dryrun import OUT, run_cell  # noqa: E402


def show(tag, r):
    rl = r["roofline"]
    print(f"[{tag}] {r['arch']} {r['shape']}: "
          f"c={rl['compute_s']:.2f} m={rl['memory_s']:.2f} "
          f"x={rl['collective_s']:.2f} bottleneck={rl['bottleneck']} "
          f"step={rl['achievable_step_s']:.3g}s mfu={rl['mfu_bound']:.4f}",
          flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iter", type=int, required=True)
    ap.add_argument("--cell", default="all",
                    choices=("all", "llama3", "deepseek", "granite"))
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    it, out = args.iter, args.out

    if it == 1:
        if args.cell in ("all", "llama3"):
            # llama3: remat "dots" — keep matmul outputs, stop recomputing
            # attention in backward (memory-term hypothesis)
            r = run_cell("llama3-8b", "train_4k", False, out,
                         overrides={"remat": "dots"}, tag="hc1")
            show("hc1", r)
        if args.cell in ("all", "deepseek"):
            # deepseek prefill: inference sharding — no FSDP gathers at
            # serve time (weights EP/TP-sharded, stationary)
            r = run_cell("deepseek-v3-671b", "prefill_32k", False, out,
                         overrides={"fsdp": False}, tag="hc1")
            show("hc1", r)
        if args.cell in ("all", "granite"):
            # granite: pad 40 experts -> 48, unlock EP all_to_all path
            cfg = get_config("granite-moe-3b-a800m")
            moe = dataclasses.replace(cfg.moe, pad_experts_to=48)
            r = run_cell("granite-moe-3b-a800m", "train_4k", False, out,
                         overrides={"moe": moe}, tag="hc1")
            show("hc1", r)

    elif it == 0:
        # baselines with the current code
        for arch, shape in (("llama3-8b", "train_4k"),
                            ("deepseek-v3-671b", "prefill_32k"),
                            ("granite-moe-3b-a800m", "train_4k")):
            if args.cell != "all" and not arch.startswith(
                    args.cell.split("-")[0]):
                continue
            r = run_cell(arch, shape, False, out, tag="attnfix")
            show("attnfix", r)

    elif it == 2:
        if args.cell in ("all", "llama3"):
            # llama3: a larger attention chunk (fewer blockwise steps) on
            # top of remat "dots"; hc1 is the same cell without the knob
            from repro_torch.models import attention as attn
            before = run_cell("llama3-8b", "train_4k", False, None,
                              overrides={"remat": "dots"}, tag="hc1")
            attn.KV_CHUNK = 2048
            r = run_cell("llama3-8b", "train_4k", False, out,
                         overrides={"remat": "dots"}, tag="hc2")
            show("hc2", r)
            a, b = before["roofline"], r["roofline"]
            keys = ("hlo_flops_per_dev", "hlo_bytes_per_dev",
                    "coll_bytes_per_dev")
            moved = any(a[k] != b[k] for k in keys)
            print(f"[hc2] KV_CHUNK 1024 -> 2048 on the card's route: "
                  f"FLOPs {a['hlo_flops_per_dev']:.6g} -> "
                  f"{b['hlo_flops_per_dev']:.6g}, bytes "
                  f"{a['hlo_bytes_per_dev']:.6g} -> "
                  f"{b['hlo_bytes_per_dev']:.6g} a device (the train "
                  f"case's attention is the kernels'): "
                  f"{'moved' if moved else 'no change'}", flush=True)
        if args.cell in ("all", "deepseek"):
            # deepseek: inference sharding + bf16 params for serving
            r = run_cell("deepseek-v3-671b", "prefill_32k", False, out,
                         overrides={"fsdp": False,
                                    "param_dtype": "bfloat16"}, tag="hc2")
            show("hc2", r)
        if args.cell in ("all", "granite"):
            # granite: EP + capacity factor 1.0 + remat "dots"
            cfg = get_config("granite-moe-3b-a800m")
            moe = dataclasses.replace(cfg.moe, pad_experts_to=48,
                                      capacity_factor=1.0)
            r = run_cell("granite-moe-3b-a800m", "train_4k", False, out,
                         overrides={"moe": moe, "remat": "dots"}, tag="hc2")
            show("hc2", r)
    else:
        ap.error(f"--iter {it}: iterations 0, 1 and 2 are ported")


if __name__ == "__main__":
    main()
