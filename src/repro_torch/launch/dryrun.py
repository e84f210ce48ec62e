"""Multi-pod dry run of every (arch x shape x mesh) cell, counted on
``meta`` tensors: the twin of the reference's ``launch/dryrun.py``.

The reference lowers and compiles each cell for 512 placeholder host
devices and reads the compiled HLO. Here the cell's step (train, prefill
or decode, built from the same specs) runs on ``meta`` tensors under
``core.step_analysis.analyze``, which counts FLOPs, bytes and collectives
per device of the production mesh (a mesh is named axes and sizes here, no
devices), with the routes the card takes (``target="cuda"``): no card and
no memory are needed. Writes one JSON per cell with the reference's keys,
except: ``fits_h100_80g`` in place of ``fits_v5e_16g``; ``trace_s`` (the
seconds the count took) in place of ``lower_s`` / ``compile_s``;
``memory_analysis`` holds ``argument_size_in_bytes`` (the inputs' exact
shard bytes a device) and ``temp_size_in_bytes`` (an estimate: the largest
bytes live at once in the counted step, divided by the devices); and
``count_short``, the terms of the count known short of, or split more
evenly than, a partitioner's (``core.step_analysis.short``: FSDP, the
one-hot MoE dispatch on a mesh, MLA and the SSM blocks under ``model``),
each "collective: <cause>" or "flops: <cause>"; empty where the count
stands.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
      --shape train_4k [--multi-pod] [--out experiments/dryrun_torch]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback

OUT = "experiments/dryrun_torch"


def cell_config(cfg, shape, overrides: dict | None = None):
    """The config a cell counts: the reference's prefill sharding profile
    (stationary TP/EP weights, no FSDP gathers at serve time; decode keeps
    the config's), then ``overrides``."""
    if shape.kind == "prefill" and cfg.fsdp:
        cfg = dataclasses.replace(cfg, fsdp=False)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def count_step(cfg, shape, mesh, batch_axes=("data",), target="cuda",
               grad_accum=1):
    """The :class:`core.step_analysis.StepStats` of ``cfg``'s step for
    ``shape`` (train, prefill or decode) per device of ``mesh``, built from
    the same specs as the reference's dry run, on ``meta`` tensors, with
    the routes of ``target`` ("cuda": the card's; "cpu": the host's, which
    the reference's host devices take). ``grad_accum``: a train step in
    that many micro-batches, as the ranks run it (each strip's FSDP
    gathers and reduce-scatters, dispatch gathers and all-to-alls; a MoE
    model's batch re-laid micro-major once, ``train.step.micro_major``;
    the gradient mean once)."""
    from repro_torch.core.precision import torch_dtype
    from repro_torch.core.step_analysis import analyze
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import abstract_params
    from repro_torch.models.sharding import MeshCtx
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_lib

    ctx = MeshCtx(mesh=mesh, batch_axes=tuple(batch_axes))
    specs_in = tf.input_specs(cfg, shape)
    count = dict(n_devices=math.prod(mesh.sizes), mesh=mesh, target=target)
    if shape.kind == "train":
        opt_cfg = adamw.OptConfig(moment_dtype=cfg.opt_state_dtype)
        bundle = step_lib.make_train_step(cfg, opt_cfg, ctx,
                                          grad_accum=grad_accum)
        state = bundle.abstract_state
        return analyze(bundle.step_fn, state, specs_in,
                       specs=(bundle.state_specs, bundle.batch_specs),
                       params=state["params"], strips=grad_accum, **count)
    aparams = abstract_params(tf.model_template(cfg),
                              torch_dtype(cfg.param_dtype))
    pspecs = step_lib.train_state_specs(cfg, ctx)["params"]
    bspecs = step_lib.batch_pspecs(cfg, shape.kind, ctx)
    if shape.kind == "prefill":
        prefill = step_lib.make_prefill_step(cfg, ctx, shape.seq_len)
        return analyze(prefill, aparams, specs_in, specs=(pspecs, bspecs),
                       params=aparams, **count)
    # decode / long_decode
    acache = specs_in["cache"]
    batch = {k: v for k, v in specs_in.items() if k != "cache"}
    return analyze(step_lib.make_decode_step(cfg, ctx), aparams, acache,
                   batch, specs=(pspecs, step_lib.cache_pspecs(cfg, ctx),
                                 bspecs),
                   params=aparams, **count)


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             overrides: dict | None = None, tag: str = "") -> dict:
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core import roofline
    from repro_torch.launch.mesh import make_production_mesh

    shape = SHAPES[shape_name]
    cfg = cell_config(get_config(arch), shape, overrides)
    if not cfg.supports_shape(shape):
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": "long_500k requires sub-quadratic token mixing"}

    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    n_dev = math.prod(mesh.sizes)
    batch_axes = ("pod", "data") if multi_pod else ("data",)

    t0 = time.time()
    stats = count_step(cfg, shape, mesh, batch_axes)
    trace_s = time.time() - t0
    rl = roofline.build(cfg, shape, mesh_name, n_dev, stats)

    mem_d = {"argument_size_in_bytes": stats.argument_bytes,
             "temp_size_in_bytes": stats.peak_live_bytes}
    per_dev_bytes = stats.peak_bytes_est
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "tag": tag,
        "n_devices": n_dev, "kind": shape.kind,
        "trace_s": round(trace_s, 1),
        "memory_analysis": mem_d,
        "per_device_state_bytes": mem_d["argument_size_in_bytes"],
        "per_device_peak_bytes_est": per_dev_bytes,
        "fits_h100_80g": per_dev_bytes < 80e9,
        # the terms known short of a partitioner's (ROADMAP Queue C)
        "count_short": sorted(stats.count_short),
        "roofline": rl.row(),
        "params_total": cfg.param_count(),
        "params_active": cfg.active_param_count(),
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"_{tag}" if tag else ""
        path = os.path.join(out_dir,
                            f"{arch}_{shape_name}_{mesh_name}{suffix}.json")
        with open(path, "w") as f:
            json.dump(result, f, indent=1, default=str)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.configs import cells
    todo = []
    if args.all:
        for arch, shape in cells():
            todo.append((arch, shape, False))
            todo.append((arch, shape, True))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all) are required")
        todo.append((args.arch, args.shape, args.multi_pod))

    failures = 0
    for arch, shape, mp in todo:
        mesh_name = "pod2x16x16" if mp else "pod16x16"
        path = os.path.join(args.out, f"{arch}_{shape}_{mesh_name}.json")
        if args.skip_existing and os.path.exists(path):
            print(f"SKIP {arch} {shape} {mesh_name} (exists)", flush=True)
            continue
        try:
            r = run_cell(arch, shape, mp, args.out)
            rl = r.get("roofline", {})
            print(f"OK   {arch:22s} {shape:12s} {mesh_name:10s} "
                  f"trace={r.get('trace_s')}s "
                  f"bottleneck={rl.get('bottleneck')} "
                  f"step={rl.get('achievable_step_s', 0):.4g}s "
                  f"mfu_bound={rl.get('mfu_bound', 0):.3f}", flush=True)
        except Exception:  # noqa: BLE001 — report the cell, go on
            failures += 1
            print(f"FAIL {arch} {shape} {mesh_name}", flush=True)
            traceback.print_exc()
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
