"""The mesh over processes (``core/compat.py``'s process route), case by
case: each case runs on a world of gloo processes on the CPU (``spawn``)
and, on rank 0, on the stacked route (one process holding the mesh as
tensor dimensions) or the one-device step, on the same inputs made from a
seed. ``check`` holds each case's two results to its tolerance.
``tests/test_torch_processes.py`` runs every case once in 4 ranks, and
``chip_smoke.py`` runs them on the chip machine's CPU.

A rank's entry point must pickle under ``spawn``, so it lives here, at
module level; nothing here imports ``jax``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import time
import weakref
import zlib

import numpy as np
import torch
import torch.multiprocessing as mp

from repro_torch import convert
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs import get_config, reduced
from repro_torch.core import chaining, compat
from repro_torch.core.compat import PartitionSpec as PS
from repro_torch.core.precision import torch_dtype
from repro_torch.core.staging import Mesh
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.mesh import make_process_mesh
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.models.layers import init_params, tree_leaves, tree_map
from repro_torch.models.sharding import (MeshCtx, NamedSharding,
                                         gather_params, shard_params)
from repro_torch.optim import adamw
from repro_torch.optim.compression import compressed_psum
from repro_torch.serving import DegradeLadder, Request, ServingEngine
from repro_torch.train import pipeline
from repro_torch.train import step as tstep
from repro_torch.train.trainer import Trainer, TrainerConfig

WORLD = 4
MESHES = ((2, 2), (4, 1), (1, 4))
KINDS = ("psum", "pmean", "pmax", "all_gather", "all_to_all", "ppermute")
# (mesh, axis or axes) of each collective case
COLLECTIVE_AXES = {(2, 2): ("model", ("data", "model")), (4, 1): ("data",)}
INT_KINDS = {"psum": torch.int32, "pmax": torch.int32,
             "all_gather": torch.int8, "all_to_all": torch.int8,
             "ppermute": torch.int8}
CHAIN_SHAPE = (8, 16, 12)
DP = dict(seq_len=32, global_batch=8, steps=3)
TOL = {"collectives": 1e-6, "chaining": 1e-5, "compression": 1e-6,
       "pipeline": 1e-6, "moe_ep": 1e-5, "mla": 1e-4, "local_axes": 1e-6,
       "dp_f32": 1e-5, "dp_f64": 1e-10, "tp_f32": 1e-5, "tp_f64": 1e-10,
       "tp_serve": 1e-5, "tp_reference": 1e-5}
# the FSDP cases are held to the tensor-parallel cases' tolerances
# the tensor-parallel cases: the meshes of the train step, and the serve
# cell of tests/test_torch_dryrun.py ("tinyllama-1.1b prefill 1x4" and
# "decode 1x4": 8 prompts of 64 tokens), then 2 decode steps
TP_MESHES = ((1, 4), (2, 2))
# the other dense configs on (1,4): llama3-8b's GQA, stablelm-1.6b's
# parallel block, starcoder2-3b's tied head, GELU and heads padded to 32
# (their masks read each rank's global head indices; 2 kv heads, whole
# on every rank)
TP_ARCHS = ("llama3-8b", "stablelm-1.6b", "starcoder2-3b")
TP_SERVE = dict(batch=8, prompt=64, steps=2)
ENGINE = dict(requests=4, slots=2, max_seq=24, max_new=5)
# the reference's sharded train step (tests/test_torch_mesh.py's
# ``step_dense``), written into the spawn's directory by a caller that ran
# the reference; without it the case skips that comparison
REFERENCE_STEP = "reference_step_dense.pt"
# the FSDP cases: reduced tinyllama-1.1b with fsdp=True, trained on these
# meshes (the dry run's "4x1 fsdp" and "2x2 fsdp" cells of
# tests/test_torch_dryrun.py, at the tensor-parallel cases' 8 x 32), and
# served on (2,2) as the tensor-parallel serve case (each data rank its 4
# of the 8 prompts); the other dense configs on (2,2)
FSDP_MESHES = ((4, 1), (2, 2))
FSDP_SERVE_MESH = (2, 2)
# the MoE family's train step: reduced granite-moe-3b-a800m (4 experts
# padded to 48, top 2) on every mesh, step by step against the one-device
# step; the cases beside it: capacity factor 0.5 (the one group drops
# pairs, more on the ranks after the first), the group-size rule
# (``DENSE_PATH_MAX_TOKENS`` lowered so that the global count takes groups
# of 64 where a rank's count would take one group: 4 x 64 tokens a rank),
# a vocab of 257 on (1,4), and reduced deepseek-v3-671b data-parallel
MOE_MESHES = ((4, 1), (2, 2), (1, 4))
MOE_GROUPS = dict(seq_len=64, dense_max=256)
MOE_SIDE_STEPS = 2        # the cases beside the three meshes' 3 steps
# per step, relative, the loss, ce, aux, grad norm and lr, and the
# parameters after it; float32's parameters apart: AdamW's first update is
# lr g / (|g| + eps) element by element, so where a gradient element is at
# its own rounding noise (the ranks sum it in another order) the update
# moves by up to lr: held at a tenth of the cases' lr 1e-2 (measured on
# the CPU: 2.7e-5 on (4,1), in wo, 3.6e-5 on (2,2), 6.9e-5 on (1,4), all
# in the first step; 1.2e-7 after it)
MOE_TOL = {"f32": 1e-6, "f64": 1e-10, "f32 params": 1e-3}
REFERENCE_MOE = ((4, 1), (2, 2))
# MLA under the model axis: reduced deepseek-v3-671b with fsdp=False (1
# dense + 1 MoE layer of 4 experts, top 2, a shared expert, MTP 1, vocab
# 256), its heads, experts and vocab split over model, trained on these
# meshes step by step against the one-device step (held to ``MOE_TOL``),
# at capacity factor 0.5 on (2,2), and against the reference's sharded
# step on both; its serve steps are ``case_mla``'s
MLA_MESHES = ((1, 4), (2, 2))
# the MoE family under FSDP: reduced deepseek-v3-671b as configured
# (fsdp=True, remat "full"; experts, MLA's heads and the vocab on model,
# every embed dimension and the latent ranks q_lora / kv_lora where embed
# leaves them on data) trained on these meshes step by step against the
# one-device step (``MOE_TOL``), at capacity factor 0.5 and at remat
# "none" on (2,2), against the reference's FSDP step on both; reduced
# granite-moe-3b-a800m with fsdp=True on (2,2) (its padded expert tables
# gathered and reduce-scattered on their live rows); the serve steps on
# ``MLA_FSDP_SERVE``'s mesh, each data rank its prompts
MLA_FSDP_MESHES = ((4, 1), (2, 2))
MLA_FSDP_SERVE = dict(mesh=(2, 2), batch=4, prompt=6, steps=2)
# the expert-parallel route over processes, ``DENSE_PATH_MAX_TOKENS``
# lowered to the cases' 256 global tokens: reduced deepseek-v3-671b (4
# experts, top 2: 2 a lane at model 2, where the reference's empty-slot
# rule agrees with the port's) on (1,2) without FSDP and on (2,2) as
# configured, each rank on its block of the experts (held); reduced
# granite-moe-3b-a800m (4 experts padded to 48) on (1,4) and (2,2), each
# rank's blocks of the experts' FFN re-laid as blocks of the experts;
# each step held against the stacked route's step on a mesh of the same
# shape
EP_GATE = DP["seq_len"] * DP["global_batch"]
EP_GRANITE_MESHES = ((1, 4), (2, 2))
# the reference's gate in its ``step_moe_ep`` (tests/test_torch_mesh.py)
EP_REFERENCE_GATE = 32
# the serve steps: 4 prompts of 8 tokens (the prefill's 32 at the gate),
# then 2 decode steps (4 tokens: the one-hot dispatch)
EP_SERVE = dict(batch=4, prompt=8, steps=2)
# the MoE step in micro-batches over processes: grad_accum=2 on the cases'
# 8 x 32 (a micro-batch of 4 x 32), each rank's strip its data block of the
# global micro-batch (``train.step.micro_major``); on the expert-parallel
# route the gate lowered to a micro-batch's 128 tokens (``micro_cells``)
MICRO = 2
MICRO_GATE = EP_GATE // MICRO
MICRO_CKPT_STEPS = 2
# the SSM, hybrid, vision and encoder-decoder families under FSDP on (4,1):
# reduced, fsdp=True (zamba2-7b at 4 layers, so that two groups read its
# shared block; the vision cross gate at ``CROSS_GATE``: zero at init, a
# cross layer adds nothing), the stub frontend's embeddings made from a
# seed and cut by the tokens' rows; float32 step by step and float64
# against the one-device step, the serve steps at ``TP_SERVE``'s 8 x 64
# (each data rank its 2 prompts)
FAMILIES = ("xlstm-1.3b", "zamba2-7b", "llama-3.2-vision-11b",
            "seamless-m4t-medium")
FAMILY_MESH = (4, 1)
CROSS_GATE = 0.5
# xlstm-1.3b's float32 grad norm: its mLSTM normaliser's gradient rounding
# (tests/test_torch_train_families.py::LOOSER)
XLSTM_GNORM_RTOL = 1e-3
# the reference's own FSDP steps on (4,1) (tests/test_torch_mesh.py's
# ``step_family_fsdp_*``)
REFERENCE_FAMILIES = ("zamba2-7b", "seamless-m4t-medium")
# the serving engine under FSDP over processes (``case_engine_fsdp``, its
# own spawn in tests/test_torch_engine_processes.py): 6 requests through
# 4 slots (one or two a data rank, so that slots churn), prompts of 4 and
# 6 tokens, 5 new tokens; each config and mesh greedy, and on (4,1) two
# requests sampled at 0.8 with the degrade ladder's bf16 rung while the
# pressure is at 1.25 or above (the first steps); granite-moe-3b-a800m
# at capacity factor 0.5, where a prompt's own group drops pairs; one
# slot's length corrupted, and its logits made NaN, at one tick
ENGINE_FSDP = dict(requests=6, slots=4, max_seq=24, max_new=5, prompts=(4, 6))
ENGINE_FSDP_RUNS = (("tinyllama-1.1b", (4, 1)), ("tinyllama-1.1b", (2, 2)),
                    ("granite-moe-3b-a800m", (4, 1)),
                    ("deepseek-v3-671b", (4, 1)),
                    ("deepseek-v3-671b", (2, 2)),
                    ("xlstm-1.3b", (4, 1)), ("zamba2-7b", (4, 1)))
ENGINE_SAMPLED = dict(temperature=0.8, uids=(0, 1), bf16_at=1.25)
ENGINE_DROP_CF = 0.5
ENGINE_AUDIT = dict(slot=3, tick=3, by=3)
# the reference's serving fixture's parameters (``repro.serving.faults.
# fixture``, a numpy tree), written into the spawn's directory by a caller
# that ran the reference
REFERENCE_ENGINE = "reference_engine.pt"
ENGINE_CASES = ("engine_fsdp",)
# the SSM and hybrid blocks under the model axis over processes
# (``case_ssm_tp``, its own spawn in tests/test_torch_ssm_processes.py):
# reduced xlstm-1.3b and zamba2-7b in float64 with fsdp=False, one train
# step on each of these meshes and one in ``MICRO`` micro-batches, against
# the one-device step; the serve steps (8 prompts of 16 tokens, 2 decode
# steps) and the engine (``ENGINE``, in float32) on (1,4)
SSM_TP = dict(archs=("xlstm-1.3b", "zamba2-7b"), meshes=((1, 4), (2, 2)),
              accum=(2, 2), serve=(1, 4), prompt=16)
SSM_TP_CASES = ("ssm_tp",)
# the reference's init of each of ``SSM_TP["archs"]`` (numpy trees by
# arch), written into the spawn's directory by the caller
REFERENCE_SSM = "reference_ssm.pt"
# the vision and encoder-decoder cross layers under the model axis over
# processes (``case_cross_tp``, its own spawn in
# tests/test_torch_cross_processes.py): reduced llama-3.2-vision-11b (its
# cross gates at ``CROSS_GATE``) and seamless-m4t-medium with a vocab of
# 258 (whole on the 4 ranks of (1,4), split on the 2 of (2,2), as
# 256,206 behaves at full width), in float64 with fsdp=False: one train
# step on each of these meshes and one in ``MICRO`` micro-batches, against
# the one-device step; the serve steps (8 prompts of 16 tokens with the
# frontend's embeddings, 2 decode steps) on both meshes
CROSS_TP = dict(archs=("llama-3.2-vision-11b", "seamless-m4t-medium"),
                meshes=((1, 4), (2, 2)), accum=(2, 2), prompt=16,
                audio_vocab=258)
CROSS_TP_CASES = ("cross_tp",)
# the planted faults' steps on one batch: AdamW's first update is lr
# sign(g) (g far above eps), so a gate gradient left partial but of the
# right sign moves the first step's parameters by eps's share alone; the
# second step's update reads the two steps' gradients' ratio
CROSS_FAULT_STEPS = 2
# the reference's init of each of ``CROSS_TP["archs"]`` (numpy trees by
# arch, the vision gates at ``CROSS_GATE``), written by the caller
REFERENCE_CROSS = "reference_cross.pt"
CASES = ("collectives", "chaining", "compression", "pipeline", "moe_ep",
         "mla", "local_axes", "held", "dp_train", "tp_train", "tp_serve",
         "fsdp_train", "fsdp_serve", "moe_train", "mla_train", "mla_fsdp",
         "mla_fsdp_serve", "ep_train", "ep_serve", "moe_micro",
         "families_fsdp", "refusals")


# ---------------------------------------------------------------------------
# spawning
# ---------------------------------------------------------------------------


def run_ranks(fn, nprocs: int, args: tuple, timeout_s: float):
    """``fn(rank, *args)`` in ``nprocs`` spawned processes. A rank that
    raises fails the call; so does one still running after ``timeout_s``
    (every rank still alive is then killed)."""
    ctx = mp.start_processes(fn, args=args, nprocs=nprocs,
                             start_method="spawn", join=False)
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks ran past {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def spawn(out_dir: str, cases=CASES, world: int = WORLD,
          timeout_s: float = 600.0) -> dict:
    """Run ``cases`` in ``world`` spawned gloo ranks; rank 0's results.
    ``timeout_s`` bounds the whole spawn, a guard against a hang (each
    collective has the group's own 120 s): beside the test suite's other
    workers the spawn has run past 300 s."""
    run_ranks(_rank_main, world, (world, os.path.join(out_dir, "store"),
                                  out_dir, tuple(cases)), timeout_s)
    return torch.load(os.path.join(out_dir, "results.pt"), weights_only=False)


def _rank_main(rank, world, store, out_dir, cases):
    torch.set_num_threads(1)
    meshes = {}
    for d, m in MESHES:
        meshes[d, m] = make_process_mesh(
            d, m, device="cpu", init_method=f"file://{store}", rank=rank,
            world_size=world, timeout_s=120.0)
    # a case that raises on one rank ends that rank, and ``spawn`` the
    # others: caught, it would leave them waiting in a collective
    results = {name: globals()[f"case_{name}"](rank, meshes, out_dir)
               for name in cases}
    if rank == 0:
        torch.save(results, os.path.join(out_dir, "results.pt"))
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()


def _counts(mesh):
    """(forward, backward) counts: per call, bytes summed over the ranks
    (on the stacked route, as they are)."""
    reduce = compat.is_process_mesh(mesh)
    return (compat.read_counts(reduce=reduce),
            compat.read_counts(reduce=reduce, backward=True))


def _both(rank, pmesh, fn):
    """``fn(mesh)`` on the process mesh on every rank, and on rank 0 on the
    stacked mesh of the same shape: {"proc": (out, counts), "stacked":
    ...}."""
    out = {}
    for route, mesh in (("proc", pmesh),
                        ("stacked", Mesh(pmesh.axis_names, pmesh.sizes))):
        if route == "stacked" and rank != 0:
            break
        compat.reset_counts()
        got = fn(mesh)
        out[route] = (got, _counts(mesh))
    return out


def _detach(tree):
    return tree_map(lambda t: t.detach().clone() if isinstance(
        t, torch.Tensor) else t, tree)


def _randn(seed, *shape, dtype=torch.float32):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape)).to(
        dtype)


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------


def _weights(y, lead):
    """A device-dependent weight for each of the body's outputs, so that
    every device's cotangent differs."""
    ix = sum(compat.axis_index(a) * 10.0 ** -(1 + i)
             for i, a in enumerate(("data", "model")))
    ix = ix.reshape(ix.shape + (1,) * (y.dim() - lead))
    n = y[(0,) * lead].numel()
    pat = torch.arange(n, dtype=torch.float64).reshape(
        y.shape[lead:]) / n
    return (1.0 + ix + pat).to(y.dtype)


def _collective(kind, axes, mesh, x):
    def body(s):
        lead = len(mesh.axis_names)
        if kind == "all_to_all":
            s = s.reshape(s.shape[:lead] + (mesh.shape[axes], -1))
        y = {"psum": lambda: compat.psum(s, axes),
             "pmean": lambda: compat.pmean(s, axes),
             "pmax": lambda: compat.pmax(s, axes),
             "all_gather": lambda: compat.all_gather(s, axes),
             "all_to_all": lambda: compat.all_to_all(s, axes, 0, 0),
             "ppermute": lambda: compat.ppermute(
                 s, axes, [(i, (i + 1) % mesh.shape[axes])
                           for i in range(mesh.shape[axes])])}[kind]()
        if not y.is_floating_point():
            return y.reshape(y.shape[:lead] + (1, -1))
        return (y * _weights(y, lead)).reshape(y.shape[:lead] + (1, -1))
    every = PS(("data", "model"))
    return compat.shard_map(body, mesh=mesh, in_specs=(every,),
                            out_specs=every)(x)


def case_collectives(rank, meshes, out_dir):
    """Each collective and its backward on (2,2) and (4,1), float32 and an
    integer dtype (forward only)."""
    out = {}
    for shape, axes_list in COLLECTIVE_AXES.items():
        for axes in axes_list:
            for kind in KINDS:
                if kind in ("all_gather", "all_to_all", "ppermute") \
                        and isinstance(axes, tuple):
                    continue
                tag = f"{shape} {axes} {kind}"

                def run(mesh, kind=kind, axes=axes):
                    x = _randn(7, 16, 6).requires_grad_(True)
                    y = _collective(kind, axes, mesh, x)
                    y.sum().backward()
                    return y.detach(), x.grad
                out[tag] = _both(rank, meshes[shape], run)
                if kind in INT_KINDS:
                    def run_int(mesh, kind=kind, axes=axes):
                        x = torch.from_numpy(np.random.RandomState(8).randint(
                            -9, 9, size=(16, 6))).to(INT_KINDS[kind])
                        return (_collective(kind, axes, mesh, x),)
                    out[tag + " int"] = _both(rank, meshes[shape], run_int)
    return out


def case_chaining(rank, meshes, out_dir):
    m, k, n = CHAIN_SHAPE
    x, w = _randn(0, m, k), _randn(1, k, n)
    out = {}
    for g in (1, 2, 4):
        out[f"ag g{g}"] = _both(rank, meshes[1, 4], lambda mesh, g=g: (
            chaining.all_gather_matmul(x, w, mesh, "model", group=g),))
    out["rs"] = _both(rank, meshes[1, 4], lambda mesh: (
        chaining.matmul_reduce_scatter(x, w, mesh, "model"),))
    return out


def case_compression(rank, meshes, out_dir):
    """test_torch_mesh's two inputs: q (captured at the int8 all_to_all),
    the mean and the residual."""
    out = {}
    for case, (shape, seed, rscale) in enumerate((((16,), 0, 0.0),
                                                  ((3, 5), 1, 1e-2))):
        r = np.random.RandomState(seed)
        g = torch.from_numpy(r.randn(4, *shape).astype(np.float32))
        res = torch.from_numpy((r.randn(4, *shape) * rscale).astype(
            np.float32))

        def run(mesh, g=g, res=res):
            captured, a2a = [], compat.all_to_all

            def spy(x, *a, **kw):
                captured.append(x)
                return a2a(x, *a, **kw)

            def device_fn(g_loc, r_loc):
                (mean_g,), (new_r,) = compressed_psum((g_loc,), (r_loc,),
                                                      mesh, ("data",))
                return mean_g, new_r, captured[-1]
            compat.all_to_all = spy
            try:
                return compat.shard_map(
                    device_fn, mesh=mesh, in_specs=(PS("data"), PS("data")),
                    out_specs=(PS(None), PS("data"), PS("data")))(g, res)
            finally:
                compat.all_to_all = a2a
        out[f"comp{case}"] = _both(rank, meshes[4, 1], run)
    return out


def case_pipeline(rank, meshes, out_dir):
    """pipeline_loss over 4 stages (a tanh layer each), 6 microbatches:
    the loss and the gradients of the stage parameters and the input."""
    s, m, mb, d = 4, 6, 2, 8
    params = {"w": _randn(2, s, d, d) * 0.5, "b": _randn(3, s, d) * 0.1}
    x, t = _randn(4, m, mb, d), _randn(5, m, mb, d)

    def stage(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    def run(mesh):
        ps = tree_map(lambda a: a.clone().requires_grad_(True), params)
        xs = x.clone().requires_grad_(True)
        loss = pipeline.pipeline_loss(
            stage, lambda o, y: torch.mean((o - y) ** 2), ps, xs, t, mesh,
            "data")
        loss.backward()
        return loss.detach(), ps["w"].grad, ps["b"].grad, xs.grad
    return {"pipe": _both(rank, meshes[4, 1], run)}


def _ep_cfg():
    """test_torch_mesh's deepseek EP config: 8 experts, top 2."""
    cfg = reduced(get_config("deepseek-v3-671b"), mtp_depth=0)
    return dataclasses.replace(cfg, d_model=32, moe=dataclasses.replace(
        cfg.moe, n_experts=8, top_k=2, expert_d_ff=16, capacity_factor=16.0,
        n_shared_experts=0, n_dense_layers=0))


def case_moe_ep(rank, meshes, out_dir):
    """moe_ep_shard_map on (2,2), 64 tokens in chunks of 4: output, aux,
    and the gradients of the tokens and of the gate table."""
    cfg = _ep_cfg()
    p = init_params(tmoe.moe_template(cfg), torch.Generator().manual_seed(0),
                    device="cpu")
    x = _randn(1, 64, cfg.d_model)
    c = _randn(2, 64, cfg.d_model)
    saved = tmoe.EP_CHUNK_TOKENS
    tmoe.EP_CHUNK_TOKENS = 4

    def run(mesh):
        ps = dict(p, w_gate=p["w_gate"].clone().requires_grad_(True))
        xs = x.clone().requires_grad_(True)
        y, aux = tmoe.moe_ep_shard_map(cfg, ps, xs, MeshCtx(mesh=mesh))
        ((y * c).sum() + aux).backward()
        return y.detach(), aux.detach(), xs.grad, ps["w_gate"].grad
    try:
        return {"ep": _both(rank, meshes[2, 2], run)}
    finally:
        tmoe.EP_CHUNK_TOKENS = saved


def case_mla(rank, meshes, out_dir):
    """Reduced deepseek-v3-671b's serve steps on (1,4): the prefill and two
    absorbed decode steps, on the process route with the rank's blocks
    (its heads, experts and vocab block; the latent cache whole), on the
    stacked route (the prefill's lane-local MLA route) and on one device,
    with each step's collectives."""
    cfg = reduced(get_config("deepseek-v3-671b"))
    params = init_params(ttf.model_template(cfg),
                         torch.Generator().manual_seed(0), device="cpu")
    r = np.random.RandomState(3)
    toks = torch.from_numpy(r.randint(0, cfg.vocab_size, size=(2, 6)))
    steps = [torch.from_numpy(r.randint(0, cfg.vocab_size, size=(2, 1)))
             for _ in range(2)]
    pmesh = meshes[1, 4]

    def serve(mesh):
        ctx = MeshCtx(mesh=mesh, batch_axes=("data",))
        p = params if mesh is None or not compat.is_process_mesh(mesh) \
            else shard_params(params, tstep.train_state_specs(cfg, ctx)[
                "params"], mesh)
        outs, counts = [], []
        with torch.no_grad():
            compat.reset_counts()
            logits, cache = tstep.make_prefill_step(cfg, ctx, 16)(
                p, {"tokens": toks})
            outs.append(logits)
            counts.append(_counts(mesh) if mesh else None)
            dec = tstep.make_decode_step(cfg, ctx)
            for tok in steps:
                compat.reset_counts()
                logits, cache = dec(p, cache, {"tokens": tok})
                outs.append(logits)
                counts.append(_counts(mesh) if mesh else None)
        ttf.forward(cfg, params, toks[:, :1])     # resets the mesh context
        return tuple(outs), counts, [tuple(cache[k].shape)
                                     for k in ("c_kv", "k_rope")]
    out = {"tp": serve(pmesh)}
    if rank == 0:
        out["stacked"] = serve(Mesh(pmesh.axis_names, pmesh.sizes))
        out["one"] = serve(None)
    # the prefill's 12 tokens at or above a lowered DENSE_PATH_MAX_TOKENS:
    # the expert-parallel route, the ranks on their blocks of the experts
    # and the stacked route on the global tables
    saved = tmoe.DENSE_PATH_MAX_TOKENS
    tmoe.DENSE_PATH_MAX_TOKENS = toks.numel()
    try:
        out["ep"] = _both(rank, pmesh, lambda mesh: _prefill(
            cfg, params, mesh, toks))
    finally:
        tmoe.DENSE_PATH_MAX_TOKENS = saved
    return out


def _prefill(cfg, params, mesh, toks):
    """``cfg``'s prefill of ``toks`` on ``mesh`` (a process mesh: on the
    rank's blocks of ``params``), without autograd: the last logits."""
    ctx = MeshCtx(mesh=mesh, batch_axes=("data",))
    p = shard_params(params, tstep.train_state_specs(cfg, ctx)["params"],
                     mesh) if compat.is_process_mesh(mesh) else params
    with torch.no_grad():
        logits, _ = tstep.make_prefill_step(cfg, ctx, toks.shape[1])(
            p, {"tokens": toks})
    ttf.forward(cfg, params, toks[:, :1])     # resets the mesh context
    return logits


def case_local_axes(rank, meshes, out_dir):
    """The local-axes rule on (2,2) with ``data`` local: the rank passes its
    own rows of the global input (its ``data`` block) and gets its own
    rows of the global output, cut and gathered over ``model`` only; the
    gradient of its block likewise. Beside it, the same body on global
    tensors (no local axis) on both routes."""
    x = _randn(9, 4, 8)
    spec = PS("data", "model")

    def body(s):
        m = compat.axis_index("model")
        return compat.psum(s, "data") * (1.0 + m.reshape(m.shape + (1, 1)))

    weight = torch.arange(1.0, 33.0).reshape(4, 8)

    def run(mesh, rows=slice(None)):
        xs = x[rows].clone().requires_grad_(True)
        y = compat.shard_map(body, mesh=mesh, in_specs=(spec,),
                             out_specs=spec)(xs)
        (y * weight[rows]).sum().backward()
        return y.detach(), xs.grad

    pmesh = meshes[2, 2]
    d = pmesh.coord("data")
    compat.reset_counts()
    local = run(pmesh.with_local(("data",)), slice(2 * d, 2 * d + 2))
    local = (local, _counts(pmesh))
    return {"global": _both(rank, pmesh, run), "data": d, "local": local}


def _dp_run(cfg, mesh, tmp, ckpt_every=0, steps=DP["steps"], grad_accum=1):
    data = DataConfig(seq_len=DP["seq_len"], global_batch=DP["global_batch"],
                      vocab_size=cfg.vocab_size)
    opt = adamw.OptConfig(peak_lr=1e-2, warmup_steps=1, decay_steps=steps)
    tcfg = TrainerConfig(steps=steps, log_every=1, ckpt_dir=tmp,
                         ckpt_every=ckpt_every or 50, grad_accum=grad_accum)
    trainer = Trainer(cfg, opt, data, tcfg, mesh=mesh, device="cpu")
    compat.reset_counts()
    _, state = trainer.run()
    return trainer, state


def case_dp_train(rank, meshes, out_dir):
    """The data-parallel step on (4,1) through the Trainer, 3 steps of
    reduced tinyllama-1.1b, against the one-device Trainer: per-step
    metrics in float32, the final parameters in float64; the step's
    collectives; the parameters equal on every rank; rank 0's checkpoint
    restored on every rank."""
    import torch.distributed as dist
    mesh = meshes[4, 1]
    base = reduced(get_config("tinyllama-1.1b"))
    f64 = dataclasses.replace(base, param_dtype="float64",
                              compute_dtype="float64")
    ckpt = os.path.join(out_dir, "ckpt")
    out = {}
    for tag, cfg in (("f32", base), ("f64", f64)):
        tr, state = _dp_run(cfg, mesh, ckpt if tag == "f32" else None,
                            ckpt_every=2)
        counts = _counts(mesh)
        sums = [float(t.double().sum()) for t in tree_leaves(state["params"])]
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, sums)
        out[tag] = {"log": tr.metrics_log, "params": _detach(state["params"]),
                    "counts": counts, "same_on_every_rank":
                    all(s == every[0] for s in every),
                    "leaves": len(list(tree_leaves(state["params"])))}
        if rank == 0:
            one, ostate = _dp_run(cfg, None, None)
            out[tag]["one"] = {"log": one.metrics_log,
                               "params": _detach(ostate["params"])}
    # every rank restores rank 0's last checkpoint (step 3) and runs no step
    again, restored = _dp_run(base, mesh, ckpt, ckpt_every=2)
    written = sorted(os.listdir(ckpt))
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(restored["params"]), tree_leaves(out["f32"]["params"])))
    flags = [None] * dist.get_world_size()
    dist.all_gather_object(flags, (same, again.metrics_log == []))
    out["restore"] = {"written": written, "every_rank": flags}
    return out


def _all_ranks(value):
    """``value`` of every rank, in rank order."""
    import torch.distributed as dist
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, value)
    return every


def _crc(t) -> int:
    return zlib.crc32(t.detach().contiguous().view(torch.uint8).numpy()
                      .tobytes())


def _frontend(cfg, step: int, batch: int = DP["global_batch"]):
    """The stub frontend's embeddings of global batch ``step`` (None for a
    model without a frontend), from a seed, in the parameters' dtype."""
    if not cfg.frontend_seq:
        return None
    r = np.random.RandomState(1000 + step)
    return torch.from_numpy(r.randn(
        batch, cfg.frontend_seq, cfg.frontend_dim or cfg.d_model)).to(
            torch_dtype(cfg.param_dtype))


def _with_frontend(cfg, batch: dict, step: int) -> dict:
    """``batch`` (numpy, global) as tensors, with :func:`_frontend`'s
    embeddings where ``cfg`` takes them."""
    out = {k: torch.as_tensor(v) for k, v in batch.items()}
    fe = _frontend(cfg, step, out["tokens"].shape[0])
    if fe is not None:
        out["frontend_emb"] = fe
    return out


def _opened(cfg, state):
    """``state`` with the vision model's tanh cross gates (whole on every
    rank) at ``CROSS_GATE``: at their zero init a cross layer adds nothing."""
    if cfg.family == "vlm":
        state["params"]["cross_layers"]["attn"]["gate"].fill_(CROSS_GATE)
    return state


def _tp_step_by_step(cfg, mesh, steps=DP["steps"], grad_accum=1):
    """``steps`` tensor-parallel (or FSDP) steps through the Trainer's
    state, batches and step, each held against the one-device step from
    the same state (the state gathered before the step, on rank 0): per
    step both metrics, and the collectives of the steps on the ranks."""
    data = DataConfig(seq_len=DP["seq_len"], global_batch=DP["global_batch"],
                      vocab_size=cfg.vocab_size)
    opt = adamw.OptConfig(peak_lr=1e-2, warmup_steps=1,
                          decay_steps=DP["steps"])
    tr = Trainer(cfg, opt, data, TrainerConfig(steps=steps,
                                               grad_accum=grad_accum),
                 mesh=mesh, device="cpu")
    one = tstep.make_train_step(cfg, opt).step_fn
    state = _opened(cfg, tr.init_state())
    fresh = ttf.model_template(cfg)
    shapes_ok = all(
        tuple(t.shape) == NamedSharding(mesh, s).shard_shape(p.shape)
        for t, s, p in zip(tree_leaves(state["params"]),
                           tree_leaves(tr.state_specs["params"]),
                           tree_leaves(fresh)))
    rows = []
    compat.reset_counts()
    for i in range(steps):
        whole = gather_params(state, tr.state_specs, mesh)
        glob = _with_frontend(cfg, tr.source.batch(i), i)
        mine = {k: v[tr.rows] for k, v in glob.items()}
        state, m = tr.step_fn(state, mine)
        row = {"tp": {k: float(v) for k, v in m.items()}}
        if mesh.rank == 0:
            _, m1 = one(whole, glob)
            row["one"] = {k: float(v) for k, v in m1.items()}
        rows.append(row)
    counts = _counts(mesh)
    # every leaf equal on the ranks whose coordinates agree along the axes
    # that cut it: a leaf that none cuts on every rank
    cut = list(tree_leaves(tstep.cut_axes(tr.state_specs["params"], mesh)))
    crcs = [_crc(t) for t in tree_leaves(state["params"])]
    every = _all_ranks((mesh.coords_of(mesh.rank), crcs))
    agree = all(e[1][j] == f[1][j] for e in every for f in every
                for j, axes in enumerate(cut)
                if all(e[0][mesh.axis_names.index(a)]
                       == f[0][mesh.axis_names.index(a)] for a in axes))
    return {"rows": rows, "counts": counts, "shapes_ok": shapes_ok,
            "blocks_agree": agree,
            "n_data_cut": sum("data" in c for c in cut),
            "leaves": len(crcs)}


def _tp_trajectory(cfg, mesh, ckpt_dir=None, steps=DP["steps"],
                   grad_accum=1):
    """``steps`` steps (in ``grad_accum`` micro-batches) through
    ``Trainer.run`` on ``mesh`` (None: one device): the metrics log and
    the global parameters at the end."""
    tr, state = _dp_run(cfg, mesh, ckpt_dir, ckpt_every=steps, steps=steps,
                        grad_accum=grad_accum)
    params = state["params"] if mesh is None else gather_params(
        state["params"], tr.state_specs["params"], mesh)
    return {"log": tr.metrics_log, "params": _detach(params)}


def _reference_step(mesh, out_dir, fsdp=False):
    """The reference's sharded float32 step of reduced tinyllama-1.1b on
    (2,2) (``tests/test_torch_mesh.py``'s ``step_dense``, with ``fsdp``
    its FSDP twin), here on the ranks: its parameters and tokens, the
    default ``OptConfig``, each data rank its rows of the batch. None
    without the reference's file."""
    path = os.path.join(out_dir, REFERENCE_STEP)
    if not os.path.exists(path):
        return None
    ref = torch.load(path, weights_only=False)
    cfg = reduced(get_config("tinyllama-1.1b"), compute_dtype="float32",
                  fsdp=fsdp)
    params = convert.params_from_numpy(ref["params"], device="cpu")
    ctx = MeshCtx(mesh=mesh, batch_axes=("data",))
    opt = adamw.OptConfig()
    bundle = tstep.make_train_step(cfg, opt, ctx)
    specs = tstep.train_state_specs(cfg, ctx)["params"]
    blocks = shard_params(params, specs, mesh)
    toks = torch.as_tensor(ref["tokens"]).long()
    rows = toks.shape[0] // mesh.shape["data"]
    mine = slice(mesh.coord("data") * rows, (mesh.coord("data") + 1) * rows)
    batch = {"tokens": toks[mine], "labels": torch.roll(toks, -1, 1)[mine]}
    _, m = bundle.step_fn({"params": blocks, "opt": adamw.init(opt, blocks)},
                          batch)
    return {"got": {k: float(m[k]) for k in ("loss", "ce", "grad_norm")},
            "want": ref["metrics_fsdp" if fsdp else "metrics"]}


def case_tp_train(rank, meshes, out_dir):
    """The dense family's tensor-parallel train step, reduced
    tinyllama-1.1b: on (1,4) and (2,2), float32 step by step against the
    one-device step and float64 through ``Trainer.run`` against the
    one-device trainer; with 2 kv heads on (1,4) (the model axis does not
    divide them), and the other dense configs there; the reference's own
    step on (2,2); and checkpoints between the one-device trainer and the
    (1,4) one, both ways."""
    import torch.distributed as dist
    base = reduced(get_config("tinyllama-1.1b"))
    f64 = dataclasses.replace(base, param_dtype="float64",
                              compute_dtype="float64")
    out = {}
    for shape in TP_MESHES:
        mesh = meshes[shape]
        r = {"f32": _tp_step_by_step(base, mesh),
             "f64": _tp_trajectory(f64, mesh)}
        if rank == 0:
            r["f64_one"] = _tp_trajectory(f64, None)
        out[shape] = r
    kv2 = dataclasses.replace(f64, n_kv_heads=2)
    for name, cfg in [("kv2", kv2)] + [
            (arch, reduced(get_config(arch), param_dtype="float64",
                           compute_dtype="float64")) for arch in TP_ARCHS]:
        out[name] = {"f64": _tp_trajectory(cfg, meshes[1, 4])}
        if rank == 0:
            out[name]["f64_one"] = _tp_trajectory(cfg, None)
    out["reference"] = _reference_step(meshes[2, 2], out_dir)
    out.update(_ckpt_both_ways(rank, base, meshes[1, 4], out_dir, "tp"))
    return out


def _ckpt_both_ways(rank, cfg, mesh, out_dir, tag, steps=DP["steps"],
                    grad_accum=1):
    """A checkpoint of ``mesh``'s trainer (the global state, gathered,
    after ``steps`` steps in ``grad_accum`` micro-batches) restored by the
    one-device trainer, and a one-device checkpoint restored on ``mesh``
    (each rank its blocks): byte for byte."""
    import torch.distributed as dist
    out = {}
    mesh_dir = os.path.join(out_dir, f"{tag}_ckpt")
    one_dir = os.path.join(out_dir, f"{tag}_one_ckpt")
    run = functools.partial(_dp_run, steps=steps, grad_accum=grad_accum)
    got = _tp_trajectory(cfg, mesh, mesh_dir, steps, grad_accum)
    if rank == 0:
        tr, state = run(cfg, None, mesh_dir)
        out["ckpt_to_one"] = {
            "no_step": tr.metrics_log == [],
            "equal": all(torch.equal(a, b) for a, b in zip(
                tree_leaves(state["params"]), tree_leaves(got["params"])))}
        run(cfg, None, one_dir)
    dist.barrier()
    tr, state = run(cfg, mesh, one_dir)
    _, whole = tckpt.restore(one_dir, device="cpu")
    mine = shard_params(whole, tr.state_specs, mesh)
    flags = _all_ranks((tr.metrics_log == [], all(
        torch.equal(a, b) for a, b in zip(tree_leaves(state),
                                          tree_leaves(mine)))))
    out["ckpt_to_tp"] = {"every_rank": flags,
                         "written": sorted(os.listdir(mesh_dir))}
    return out


def case_tp_serve(rank, meshes, out_dir):
    """Reduced tinyllama-1.1b served tensor-parallel on (1,4): the prefill
    of 8 prompts of 64 tokens and 2 decode steps against the one-device
    steps, with their collectives; then one ``ServingEngine`` of 4
    requests, its tokens on every rank against the one-device engine's."""
    cfg = reduced(get_config("tinyllama-1.1b"))
    mesh = meshes[1, 4]
    ctx = MeshCtx(mesh=mesh, batch_axes=("data",))
    params = init_params(ttf.model_template(cfg),
                         torch.Generator().manual_seed(0), device="cpu")
    blocks = shard_params(params, tstep.train_state_specs(cfg, ctx)["params"],
                          mesh)
    r = np.random.RandomState(5)
    b, s, n = TP_SERVE["batch"], TP_SERVE["prompt"], TP_SERVE["steps"]
    toks = torch.from_numpy(r.randint(0, cfg.vocab_size, size=(b, s)))
    steps = [torch.from_numpy(r.randint(0, cfg.vocab_size, size=(b, 1)))
             for _ in range(n)]

    def serve(p, c):
        outs, counts = [], []
        with torch.no_grad():
            compat.reset_counts()
            # a float32 cache: in the reference's bfloat16 one, the
            # projections' last-bit differences (another GEMM shape on a
            # rank) flip a rounding now and then
            logits, cache = tstep.make_prefill_step(
                cfg, c, s + n, cache_dtype=torch.float32)(
                p, {"tokens": toks})
            outs.append(logits)
            counts.append(_counts(mesh) if c else None)
            dec = tstep.make_decode_step(cfg, c)
            for tok in steps:
                compat.reset_counts()
                logits, cache = dec(p, cache, {"tokens": tok})
                outs.append(logits)
                counts.append(_counts(mesh) if c else None)
        return outs, counts, [tuple(cache[k].shape) for k in ("k", "v")]

    out = {"tp": serve(blocks, ctx)}
    if rank == 0:
        out["one"] = serve(params, None)

    def engine(p, c):
        eng = ServingEngine(cfg, p, slots=ENGINE["slots"],
                            max_seq=ENGINE["max_seq"], ctx=c, device="cpu")
        rr = np.random.RandomState(6)
        for uid in range(ENGINE["requests"]):
            eng.submit(Request(uid=uid, prompt=rr.randint(
                0, cfg.vocab_size, size=4 + uid).astype(np.int32),
                max_new_tokens=ENGINE["max_new"]))
        done = eng.run_to_completion()
        return {q.uid: list(q.out_tokens) for q in done}
    out["engine"] = _all_ranks(engine(blocks, ctx))
    if rank == 0:
        out["engine_one"] = engine(params, None)
    return out


def _fsdp_cfg(**kw):
    return dataclasses.replace(reduced(get_config("tinyllama-1.1b")),
                               fsdp=True, **kw)


def _freed_after_forward(cfg, mesh):
    """One FSDP forward of the loss on the rank's blocks (``remat="none"``:
    every layer under ``Fsdp.regather``), then its backward: how many
    gathered tensors each scope held, and how many of them were still
    alive after the forward (none: the products saved handles), with the
    collectives of the forward and of the backward."""
    from repro_torch.models import sharding as tsh
    ctx = MeshCtx(mesh=mesh.with_local(("data",)), batch_axes=("data",))
    whole = init_params(ttf.model_template(cfg),
                        torch.Generator().manual_seed(0), device="cpu")
    blocks = tree_map(lambda t: t.requires_grad_(True), shard_params(
        whole, tstep.train_state_specs(cfg, ctx)["params"], mesh))
    toks = torch.from_numpy(np.random.RandomState(4).randint(
        0, cfg.vocab_size, size=(2, DP["seq_len"])))
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    if cfg.frontend_seq:
        batch["frontend_emb"] = _frontend(cfg, 0, 2)
    scopes, enter = [], tsh._Regather.__enter__

    def spy(self):
        scopes.append(self)
        return enter(self)
    tsh._Regather.__enter__ = spy
    try:
        compat.reset_counts()
        loss, _ = ttf.lm_loss(cfg, blocks, batch, ctx=ctx)
        forward = _counts(mesh)
        alive = sum(ref() is not None for sc in scopes for ref, _ in sc.held)
        loss.backward()
    finally:
        tsh._Regather.__enter__ = enter
    return {"scopes": len(scopes),
            "held": sum(len(sc.held) for sc in scopes), "alive": alive,
            "forward": forward, "after": _counts(mesh)}


def case_fsdp_train(rank, meshes, out_dir):
    """The dense family's FSDP train step, reduced tinyllama-1.1b with
    ``fsdp=True``: on (4,1) and (2,2), float32 step by step against the
    one-device step at ``remat="none"`` (3 steps) and ``"full"`` (1 step),
    and float64 through ``Trainer.run`` against the one-device trainer;
    one step at ``grad_accum=2`` on (4,1); the gathered leaves freed after
    the forward; the other dense configs on (2,2); the reference's own
    FSDP step on (2,2); checkpoints between the one-device trainer and
    the (4,1) one, both ways."""
    base = _fsdp_cfg()
    f64 = dataclasses.replace(base, param_dtype="float64",
                              compute_dtype="float64")
    out = {}
    for shape in FSDP_MESHES:
        mesh = meshes[shape]
        r = {"f32": _tp_step_by_step(base, mesh),
             "full": _tp_step_by_step(dataclasses.replace(base, remat="full"),
                                      mesh, steps=1),
             "f64": _tp_trajectory(f64, mesh)}
        if rank == 0:
            r["f64_one"] = _tp_trajectory(f64, None)
        out[shape] = r
    out["accum"] = _tp_step_by_step(base, meshes[4, 1], steps=1,
                                    grad_accum=2)
    out["freed"] = _freed_after_forward(base, meshes[4, 1])
    for arch in TP_ARCHS:
        cfg = reduced(get_config(arch), param_dtype="float64",
                      compute_dtype="float64", fsdp=True)
        out[arch] = {"f64": _tp_trajectory(cfg, meshes[2, 2])}
        if rank == 0:
            out[arch]["f64_one"] = _tp_trajectory(cfg, None)
    out["reference"] = _reference_step(meshes[2, 2], out_dir, fsdp=True)
    out.update(_ckpt_both_ways(rank, base, meshes[4, 1], out_dir, "fsdp"))
    return out


def case_fsdp_serve(rank, meshes, out_dir):
    """Reduced tinyllama-1.1b with ``fsdp=True`` served on (2,2): each
    data rank prefills its 4 of the 8 prompts of 64 tokens (the
    tensor-parallel serve case's) and decodes them 2 steps, the weights
    gathered a layer at a time; the logits, gathered whole on every rank,
    against the one-device steps', with the collectives of each step."""
    cfg = _fsdp_cfg()
    mesh = meshes[FSDP_SERVE_MESH]
    ctx = MeshCtx(mesh=mesh, batch_axes=("data",))
    params = init_params(ttf.model_template(cfg),
                         torch.Generator().manual_seed(0), device="cpu")
    blocks = shard_params(params, tstep.train_state_specs(cfg, ctx)["params"],
                          mesh)
    r = np.random.RandomState(5)
    b, s, n = TP_SERVE["batch"], TP_SERVE["prompt"], TP_SERVE["steps"]
    toks = torch.from_numpy(r.randint(0, cfg.vocab_size, size=(b, s)))
    steps = [torch.from_numpy(r.randint(0, cfg.vocab_size, size=(b, 1)))
             for _ in range(n)]
    rows = b // mesh.shape["data"]
    mine = slice(mesh.coord("data") * rows, (mesh.coord("data") + 1) * rows)

    def serve(p, c, rows):
        outs, counts = [], []
        with torch.no_grad():
            compat.reset_counts()
            logits, cache = tstep.make_prefill_step(
                cfg, c, s + n, cache_dtype=torch.float32)(
                p, {"tokens": toks[rows]})
            outs.append(logits)
            counts.append(_counts(mesh) if c else None)
            dec = tstep.make_decode_step(cfg, c)
            for tok in steps:
                compat.reset_counts()
                logits, cache = dec(p, cache, {"tokens": tok[rows]})
                outs.append(logits)
                counts.append(_counts(mesh) if c else None)
        return outs, counts, [tuple(cache[k].shape) for k in ("k", "v")]

    out = {"fsdp": serve(blocks, ctx, mine)}
    if rank == 0:
        out["one"] = serve(params, None, slice(None))
    return out


def drops_by_block(log, n_blocks: int) -> list:
    """The pairs that each of ``n_blocks`` equal blocks of the tokens of a
    ``models.moe.DISPATCH_LOG`` list dropped, summed over its dispatches,
    where each dispatch is one group over all of its tokens: block ``b``'s
    pairs claim each expert's slots after blocks ``0 .. b-1`` (a process
    mesh's data ranks split the one-device step's group so)."""
    out = [0] * n_blocks
    for d in log:
        ids = d.ids.long().reshape(n_blocks, -1)
        n = int(ids.max()) + 1
        counts = torch.stack([torch.bincount(r, minlength=n) for r in ids])
        before = counts.cumsum(0) - counts
        kept = torch.minimum(counts, (d.capacity - before).clamp_min(0))
        for b, k in enumerate((counts - kept).sum(dim=1).tolist()):
            out[b] += k
    return out


def route_flips(ids, one_ids) -> int:
    """The (token, expert) pairs among ``ids`` (T, k) that ``one_ids`` (the
    same tokens' choices in another step) does not choose: how many of a
    rank's routes a rounding flipped against the one-device step's."""
    ids, one_ids = ids.long().cpu(), one_ids.long().cpu()
    found = (ids[:, :, None] == one_ids[:, None, :]).any(dim=-1)
    return int((~found).sum())


def _moe_cfg(arch="granite-moe-3b-a800m", dtype="float32", **kw):
    return reduced(get_config(arch), param_dtype=dtype, compute_dtype=dtype,
                   **kw)


def micro_strips(log, n: int) -> list:
    """A ``DISPATCH_LOG`` list of a step in ``n`` micro-batches, cut into
    each micro-batch's dispatches (they run strip by strip)."""
    assert len(log) % n == 0, (len(log), n)
    k = len(log) // n
    return [log[i * k:(i + 1) * k] for i in range(n)]


def _with_cf(cfg, cf):
    """``cfg`` at capacity factor ``cf`` (None: as it is)."""
    return cfg if cf is None else dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def _moe_steps(cfg, mesh, steps=DP["steps"], seq_len=DP["seq_len"],
               resolve=False, grad_accum=1, cf=None):
    """``steps`` train steps through the Trainer's state, batches and step
    on ``mesh``, each held against the one-device step from the same state
    (the state gathered before the step; on rank 0): per step both
    metrics, the largest gap between the parameters after it, the pairs
    that each rank's dispatches dropped beside the one-device step's (and
    its drops by data block, where each dispatch is one group; both also
    by micro-batch, ``drops_micro`` and ``drops_by_block_micro``), and the
    (token, expert) pairs of each rank's routes that the one-device step
    did not choose for the same tokens; the collectives of the steps on
    the ranks. ``resolve``: also the one-device step in float64 from the
    same state, whose gap from the float32 one-device step is what float32
    resolves there. ``grad_accum``: both steps in that many micro-batches;
    ``cf``: the capacity factor (default the config's)."""
    cfg = _with_cf(cfg, cf)
    data = DataConfig(seq_len=seq_len, global_batch=DP["global_batch"],
                      vocab_size=cfg.vocab_size)
    opt = adamw.OptConfig(peak_lr=1e-2, warmup_steps=1,
                          decay_steps=DP["steps"])
    tr = Trainer(cfg, opt, data, TrainerConfig(steps=steps,
                                               grad_accum=grad_accum),
                 mesh=mesh, device="cpu")
    one = tstep.make_train_step(cfg, opt, grad_accum=grad_accum).step_fn
    one64 = tstep.make_train_step(dataclasses.replace(
        cfg, param_dtype="float64", compute_dtype="float64"), opt,
        grad_accum=grad_accum).step_fn
    state = tr.init_state()
    n_data = mesh.shape["data"]

    def whole(st):
        return gather_params(st, tr.state_specs, mesh) if tr.split \
            else _detach(st)
    rows = []
    compat.reset_counts()
    for i in range(steps):
        before = whole(state)
        log = tmoe.DISPATCH_LOG = []
        mine = {k: torch.as_tensor(v) for k, v in tr.batch(i).items()}
        try:
            state, m = tr.step_fn(state, mine)
        finally:
            tmoe.DISPATCH_LOG = None
        every = _all_ranks((tmoe.dropped_pairs(log), mesh.block(("data",)),
                            [d.ids for d in log], [
                                tmoe.dropped_pairs(part)
                                for part in micro_strips(log, grad_accum)]))
        row = {"tp": {k: float(v) for k, v in m.items()},
               "drops": [e[0] for e in every],
               "drops_micro": [e[3] for e in every]}
        after = whole(state)["params"]
        if mesh.rank == 0:
            glob = {k: torch.as_tensor(v)
                    for k, v in tr.source.batch(i).items()}
            if resolve:
                _, m64 = one64(tree_map(lambda t: t.double() if isinstance(
                    t, torch.Tensor) and t.is_floating_point() else t,
                    _detach(before)), glob)
                row["one64"] = {k: float(v) for k, v in m64.items()}
            log = tmoe.DISPATCH_LOG = []
            try:
                _, m1 = one(before, glob)
            finally:
                tmoe.DISPATCH_LOG = None
            row["one"] = {k: float(v) for k, v in m1.items()}
            row["drops_one"] = tmoe.dropped_pairs(log)
            row["drops_by_block"] = drops_by_block(log, n_data)
            row["drops_by_block_micro"] = [
                drops_by_block(part, n_data)
                for part in micro_strips(log, grad_accum)]
            row["flips"] = [sum(route_flips(ids, d.ids.reshape(
                n_data, -1, d.ids.shape[-1])[block]) for ids, d in zip(
                    mine_ids, log)) for _, block, mine_ids, _ in every]
            row["params"] = max(_err(a, b) for a, b in zip(
                tree_leaves(after), tree_leaves(before["params"])))
        rows.append(row)
    cut = tree_leaves(tstep.cut_axes(tr.state_specs["params"], mesh))
    return {"rows": rows, "counts": _counts(mesh),
            "leaves": len(list(tree_leaves(state["params"]))),
            "n_data_cut": sum("data" in c for c in cut)}


def _reference_moe(meshes, out_dir):
    """The reference's sharded float32 step of reduced granite-moe-3b-a800m
    (``tests/test_torch_mesh.py``'s ``step_moe``) on (4,1) and (2,2), here
    on the ranks: its parameters and tokens, the default ``OptConfig``,
    each data rank its rows of the batch. None without the reference's
    file."""
    path = os.path.join(out_dir, REFERENCE_STEP)
    if not os.path.exists(path):
        return None
    ref = torch.load(path, weights_only=False)
    cfg = _moe_cfg()
    params = convert.params_from_numpy(ref["moe_params"], device="cpu")
    toks = torch.as_tensor(ref["moe_tokens"]).long()
    out = {}
    for shape in REFERENCE_MOE:
        mesh = meshes[shape]
        ctx = MeshCtx(mesh=mesh, batch_axes=("data",))
        opt = adamw.OptConfig()
        bundle = tstep.make_train_step(cfg, opt, ctx)
        blocks = shard_params(params, tstep.train_state_specs(cfg, ctx)[
            "params"], mesh)
        rows = toks.shape[0] // mesh.shape["data"]
        mine = slice(mesh.coord("data") * rows,
                     (mesh.coord("data") + 1) * rows)
        batch = {"tokens": toks[mine], "labels": torch.roll(toks, -1, 1)[mine]}
        _, m = bundle.step_fn({"params": blocks,
                               "opt": adamw.init(opt, blocks)}, batch)
        out[shape] = {"got": {k: float(m[k]) for k in
                              ("loss", "ce", "aux", "grad_norm")},
                      "want": ref["moe_metrics"][shape]}
    return out


def case_moe_train(rank, meshes, out_dir):
    """The MoE family's train step over processes, reduced
    granite-moe-3b-a800m: on (4,1), (2,2) and (1,4), 3 steps in float32
    and in float64, each from the same state as the one-device step; in
    float64, ``MOE_SIDE_STEPS`` steps each: at capacity factor 0.5 on
    (4,1) and (2,2) (pairs dropped); with
    ``DENSE_PATH_MAX_TOKENS`` lowered on (4,1) (groups of 64 by the global
    count); a vocab of 257 on (1,4); reduced deepseek-v3-671b with
    ``fsdp=False`` on (4,1) (MTP, shared experts, a dense first layer);
    and the reference's own step on (4,1) and (2,2)."""
    out = {}
    for shape in MOE_MESHES:
        out[shape] = {tag: _moe_steps(_moe_cfg(dtype=dt), meshes[shape])
                      for tag, dt in (("f32", "float32"),
                                      ("f64", "float64"))}
    # the cases beside them, 2 steps each
    n = MOE_SIDE_STEPS
    for shape in ((4, 1), (2, 2)):
        out[f"drops {shape}"] = _moe_steps(_moe_cfg(dtype="float64"),
                                           meshes[shape], steps=n, cf=0.5)
    saved = tmoe.DENSE_PATH_MAX_TOKENS
    tmoe.DENSE_PATH_MAX_TOKENS = MOE_GROUPS["dense_max"]
    try:
        out["groups"] = _moe_steps(_moe_cfg(dtype="float64"), meshes[4, 1],
                                   steps=n, seq_len=MOE_GROUPS["seq_len"])
    finally:
        tmoe.DENSE_PATH_MAX_TOKENS = saved
    out["vocab257"] = _moe_steps(_moe_cfg(dtype="float64", vocab_size=257),
                                 meshes[1, 4], steps=n)
    out["deepseek"] = _moe_steps(_moe_cfg("deepseek-v3-671b", "float64",
                                          fsdp=False), meshes[4, 1], steps=n)
    out["reference"] = _reference_moe(meshes, out_dir)
    return out


def _mla_cfg(dtype="float32", **kw):
    return _moe_cfg("deepseek-v3-671b", dtype, fsdp=False, **kw)


def _reference_mla(meshes, out_dir, fsdp=False):
    """The reference's sharded float32 step of reduced deepseek-v3-671b
    with ``fsdp=False`` (``tests/test_torch_mesh.py``'s ``step_mla``) on
    (1,4) and (2,2), or with ``fsdp`` its FSDP step (``step_mla_fsdp``)
    on (4,1) and (2,2), here on the ranks: its parameters and tokens, the
    default ``OptConfig``, each data rank its rows of the batch. None
    without the reference's file."""
    path = os.path.join(out_dir, REFERENCE_STEP)
    if not os.path.exists(path):
        return None
    ref = torch.load(path, weights_only=False)
    cfg = reduced(get_config("deepseek-v3-671b"), compute_dtype="float32",
                  fsdp=fsdp)
    params = convert.params_from_numpy(ref["mla_params"], device="cpu")
    toks = torch.as_tensor(ref["mla_tokens"]).long()
    want = ref["mla_fsdp_metrics" if fsdp else "mla_metrics"]
    out = {}
    for shape in MLA_FSDP_MESHES if fsdp else MLA_MESHES:
        mesh = meshes[shape]
        ctx = MeshCtx(mesh=mesh, batch_axes=("data",))
        opt = adamw.OptConfig()
        bundle = tstep.make_train_step(cfg, opt, ctx)
        blocks = shard_params(params, tstep.train_state_specs(cfg, ctx)[
            "params"], mesh)
        rows = toks.shape[0] // mesh.shape["data"]
        mine = slice(mesh.coord("data") * rows,
                     (mesh.coord("data") + 1) * rows)
        batch = {"tokens": toks[mine], "labels": torch.roll(toks, -1, 1)[mine]}
        _, m = bundle.step_fn({"params": blocks,
                               "opt": adamw.init(opt, blocks)}, batch)
        out[shape] = {"got": {k: float(m[k]) for k in
                              ("loss", "ce", "aux", "grad_norm")},
                      "want": want[shape]}
    return out


def case_mla_train(rank, meshes, out_dir):
    """MLA under the model axis: reduced deepseek-v3-671b with
    ``fsdp=False`` (its heads, experts and vocab split over model) on
    (1,4) and (2,2), 3 steps in float32 and in float64, each from the same
    state as the one-device step; in float64, ``MOE_SIDE_STEPS`` steps at
    capacity factor 0.5 on (2,2) (pairs dropped); the reference's own step
    on (1,4) and (2,2); checkpoints between the one-device trainer and the
    (1,4) one, both ways."""
    out = {}
    for shape in MLA_MESHES:
        out[shape] = {tag: _moe_steps(_mla_cfg(dt), meshes[shape],
                                      resolve=tag == "f32")
                      for tag, dt in (("f32", "float32"),
                                      ("f64", "float64"))}
    out["drops"] = _moe_steps(_mla_cfg("float64"), meshes[2, 2],
                              steps=MOE_SIDE_STEPS, cf=0.5)
    out["reference"] = _reference_mla(meshes, out_dir)
    out.update(_ckpt_both_ways(rank, _mla_cfg(), meshes[1, 4], out_dir,
                               "mla"))
    return out


def _mla_fsdp_cfg(dtype="float32", **kw):
    """Reduced deepseek-v3-671b as configured: FSDP on, remat "full"."""
    return _moe_cfg("deepseek-v3-671b", dtype, **{
        "fsdp": True, "remat": get_config("deepseek-v3-671b").remat, **kw})


def case_mla_fsdp(rank, meshes, out_dir):
    """The MoE family under FSDP: reduced deepseek-v3-671b as configured
    on (4,1) and (2,2), 3 steps in float32 and in float64, each from the
    same state as the one-device step; in float64, ``MOE_SIDE_STEPS``
    steps at capacity factor 0.5 on (2,2); one float32 step at
    ``remat="none"`` on (2,2) (each layer under ``Fsdp.regather``); the
    gathered leaves freed after the forward on (4,1); reduced
    granite-moe-3b-a800m with ``fsdp=True`` on (2,2), float64, 3 steps;
    the reference's own FSDP step on (4,1) and (2,2); checkpoints between
    the one-device trainer and the (4,1) one, both ways."""
    out = {}
    for shape in MLA_FSDP_MESHES:
        out[shape] = {tag: _moe_steps(_mla_fsdp_cfg(dt), meshes[shape],
                                      resolve=tag == "f32")
                      for tag, dt in (("f32", "float32"),
                                      ("f64", "float64"))}
    out["drops"] = _moe_steps(_mla_fsdp_cfg("float64"), meshes[2, 2],
                              steps=MOE_SIDE_STEPS, cf=0.5)
    none = _mla_fsdp_cfg(remat="none")
    out["none"] = _moe_steps(none, meshes[2, 2], steps=1, resolve=True)
    out["freed"] = _freed_after_forward(none, meshes[4, 1])
    out["granite"] = _moe_steps(_moe_cfg(dtype="float64", fsdp=True),
                                meshes[2, 2])
    out["reference"] = _reference_mla(meshes, out_dir, fsdp=True)
    out.update(_ckpt_both_ways(rank, _mla_fsdp_cfg(), meshes[4, 1], out_dir,
                               "mla_fsdp"))
    return out


def case_mla_fsdp_serve(rank, meshes, out_dir):
    """Reduced deepseek-v3-671b as configured served on (2,2) under FSDP:
    each data rank prefills its 2 of the 4 prompts and decodes them 2
    absorbed steps, the weights gathered a layer at a time, its one-hot
    dispatch one group over the ranks' rows; the logits, gathered whole
    on every rank, against the one-device steps', with the collectives of
    each step."""
    cfg = _mla_fsdp_cfg()
    sv = MLA_FSDP_SERVE
    mesh = meshes[sv["mesh"]]
    ctx = MeshCtx(mesh=mesh, batch_axes=("data",))
    params = init_params(ttf.model_template(cfg),
                         torch.Generator().manual_seed(0), device="cpu")
    blocks = shard_params(params, tstep.train_state_specs(cfg, ctx)["params"],
                          mesh)
    r = np.random.RandomState(7)
    b, s, n = sv["batch"], sv["prompt"], sv["steps"]
    toks = torch.from_numpy(r.randint(0, cfg.vocab_size, size=(b, s)))
    steps = [torch.from_numpy(r.randint(0, cfg.vocab_size, size=(b, 1)))
             for _ in range(n)]
    rows = b // mesh.shape["data"]
    mine = slice(mesh.coord("data") * rows, (mesh.coord("data") + 1) * rows)

    def serve(p, c, rows):
        outs, counts = [], []
        with torch.no_grad():
            compat.reset_counts()
            logits, cache = tstep.make_prefill_step(
                cfg, c, s + n, cache_dtype=torch.float32)(
                p, {"tokens": toks[rows]})
            outs.append(logits)
            counts.append(_counts(mesh) if c else None)
            dec = tstep.make_decode_step(cfg, c)
            for tok in steps:
                compat.reset_counts()
                logits, cache = dec(p, cache, {"tokens": tok[rows]})
                outs.append(logits)
                counts.append(_counts(mesh) if c else None)
        return outs, counts, [tuple(cache[k].shape)
                              for k in ("c_kv", "k_rope")]

    out = {"fsdp": serve(blocks, ctx, mine)}
    if rank == 0:
        out["one"] = serve(params, None, slice(None))
    return out


# -- the expert-parallel route over processes --------------------------------


def pair_mesh(mesh):
    """The (1,2) mesh of the (2,2) process mesh ``mesh``'s model group that
    holds this rank: each data coordinate's two ranks run their own (1,2)
    mesh beside the other's (their counts, summed over the world, are the
    two meshes')."""
    group, ranks = mesh.group("model")
    me = ranks.index(mesh.rank)
    groups = {frozenset({"data"}): (None, [me]),
              frozenset({"model"}): (group, [0, 1]),
              frozenset({"data", "model"}): (group, [0, 1])}
    return compat.ProcessMesh(("data", "model"), (1, 2), me, mesh.device,
                              groups)


@contextlib.contextmanager
def _counts_kept():
    """Collectives counted inside are forgotten after (a rank's comparison
    on the stacked route, beside the process route's counts)."""
    saved = [c.copy() for c in (compat.CALLS, compat.BYTES, compat.CALLS_BWD,
                                compat.BYTES_BWD)]
    try:
        yield
    finally:
        for c, old in zip((compat.CALLS, compat.BYTES, compat.CALLS_BWD,
                           compat.BYTES_BWD), saved):
            c.clear()
            c.update(old)


@contextlib.contextmanager
def ep_gate(tokens: int):
    """``DENSE_PATH_MAX_TOKENS`` lowered to ``tokens`` inside."""
    saved = tmoe.DENSE_PATH_MAX_TOKENS
    tmoe.DENSE_PATH_MAX_TOKENS = tokens
    try:
        yield
    finally:
        tmoe.DENSE_PATH_MAX_TOKENS = saved


@contextlib.contextmanager
def held_as_replicated():
    """A planted fault: each ``compat.Held`` in_spec passed as a replicated
    one, so that a held block's gradient is summed over the model axis
    (the other lanes' experts added to it), as the expert-parallel route
    served before it trained."""
    orig = compat.shard_map

    def shard_map(f, *, mesh, in_specs, out_specs):
        specs = tuple(PS(*(None,) * len(s)) if isinstance(s, compat.Held)
                      else s for s in in_specs)
        return orig(f, mesh=mesh, in_specs=specs, out_specs=out_specs)
    compat.shard_map = shard_map
    try:
        yield
    finally:
        compat.shard_map = orig


def ep_drops(log) -> dict:
    """The pairs that each device dropped on the expert-parallel route, by
    the device's row-major index (``models.moe.Dispatch.device``)."""
    out = {}
    for d in log:
        if d.device is not None:
            out[d.device] = out.get(d.device, 0) + d.pairs - int(d.kept)
    return out


def _ep_steps(cfg, mesh, steps=DP["steps"], resolve=False, cf=None,
              against="stacked", grad_accum=1, gate=EP_GATE):
    """``_moe_steps`` on the expert-parallel route (``EP_GATE``): ``steps``
    train steps through the Trainer's state, batches and step on the
    process mesh ``mesh``, each held against the stacked route's step on
    a mesh of the same shape from the same state (on rank 0; with
    ``resolve`` also its float64 twin, ``one64``), on the global batch:
    per step both metrics, the largest gap between the parameters after
    it, each rank's dropped pairs beside the stacked route's drops of its
    device, and each rank's routes that the stacked route did not choose
    for the same tokens; the collectives of the steps on the ranks.
    ``cf``: the capacity factor (default the config's). ``against="one"``:
    held against the one-device step (the one-hot dispatch) instead, its
    drops in ``drops_one``, each rank's routes against its block of the
    one-device step's tokens. ``grad_accum``: both steps in that many
    micro-batches; ``gate``: the gate the other step runs at (the
    caller's own, set around the call)."""
    cfg = _with_cf(cfg, cf)
    data = DataConfig(seq_len=DP["seq_len"], global_batch=DP["global_batch"],
                      vocab_size=cfg.vocab_size)
    opt = adamw.OptConfig(peak_lr=1e-2, warmup_steps=1,
                          decay_steps=DP["steps"])
    tr = Trainer(cfg, opt, data, TrainerConfig(steps=steps,
                                               grad_accum=grad_accum),
                 mesh=mesh, device="cpu")
    ctx = MeshCtx(mesh=Mesh(mesh.axis_names, mesh.sizes),
                  batch_axes=("data",))
    if against == "one":
        ctx = None
    stacked = tstep.make_train_step(cfg, opt, ctx,
                                    grad_accum=grad_accum).step_fn
    stacked64 = tstep.make_train_step(dataclasses.replace(
        cfg, param_dtype="float64", compute_dtype="float64"), opt,
        ctx, grad_accum=grad_accum).step_fn
    state = tr.init_state()
    n = mesh.sizes[0] * mesh.sizes[1]
    rows = []
    compat.reset_counts()
    for i in range(steps):
        before = gather_params(state, tr.state_specs, mesh)
        log = tmoe.DISPATCH_LOG = []
        mine = {k: torch.as_tensor(v) for k, v in tr.batch(i).items()}
        try:
            state, m = tr.step_fn(state, mine)
        finally:
            tmoe.DISPATCH_LOG = None
        every = _all_ranks((tmoe.dropped_pairs(log), ep_drops(log),
                            [d.ids for d in log]))[:n]
        row = {"tp": {k: float(v) for k, v in m.items()},
               "drops": [e[0] for e in every],
               "devices": [sorted(e[1]) for e in every]}
        after = gather_params(state, tr.state_specs, mesh)["params"]
        if mesh.rank == 0:
            glob = {k: torch.as_tensor(v)
                    for k, v in tr.source.batch(i).items()}
            with _counts_kept(), ep_gate(gate):
                if resolve:
                    _, m64 = stacked64(tree_map(
                        lambda t: t.double() if isinstance(t, torch.Tensor)
                        and t.is_floating_point() else t, _detach(before)),
                        glob)
                    row["one64"] = {k: float(v) for k, v in m64.items()}
                log = tmoe.DISPATCH_LOG = []
                try:
                    _, m1 = stacked(before, glob)
                finally:
                    tmoe.DISPATCH_LOG = None
            row["one"] = {k: float(v) for k, v in m1.items()}
            row["drops_one"] = tmoe.dropped_pairs(log)
            row["drops_by_device"] = [ep_drops(log).get(r, 0)
                                      for r in range(n)]
            row["flips"] = [sum(route_flips(ids, d.ids if d.device == r
                                            else d.ids.reshape(
                                                n, -1, d.ids.shape[-1])[r])
                                for ids, d in zip(mine_ids, [
                                    d for d in log if d.device in (r, None)]))
                            for r, (_, _, mine_ids) in enumerate(every)]
            row["params"] = max(_err(a, b) for a, b in zip(
                tree_leaves(after), tree_leaves(before["params"])))
        rows.append(row)
    cut = tree_leaves(tstep.cut_axes(tr.state_specs["params"], mesh))
    return {"rows": rows, "counts": _counts(mesh),
            "leaves": len(list(tree_leaves(state["params"]))),
            "n_data_cut": sum("data" in c for c in cut)}


@contextlib.contextmanager
def uncounted_recorder():
    """Inside, on a rank of a process mesh, the ``torch.distributed`` calls
    that ``compat``'s counts leave out are recorded: the all-gathers that
    assemble a body's global output and a global input's gradient
    (``compat._assemble``: the EP body's output and its tokens' gradient,
    over model) and the all-reduce of a replicated input's gradient (the
    router's, over model). Yields ``{kind: [calls, payload bytes (the
    tensors the rank passes), bytes by the counts' ring formulas]}``."""
    import torch.distributed as dist
    seen, inside = {}, [0]
    gather, reduce = dist.all_gather, dist.all_reduce
    assemble, split_back = compat._assemble, compat._Split.__dict__[
        "backward"]

    def record(kind, t, group, ring):
        if inside[0]:
            n = dist.get_world_size(group)
            b = t.numel() * t.element_size()
            got = seen.setdefault(kind, [0, 0, 0.0])
            got[0] += 1
            got[1] += b
            got[2] += ring(b, n)

    def all_gather(parts, t, group=None, **kw):
        record("all_gather", t, group, lambda b, n: (n - 1) * b)
        return gather(parts, t, group=group, **kw)

    def all_reduce(t, op=dist.ReduceOp.SUM, group=None, **kw):
        record("all_reduce", t, group, lambda b, n: 2 * (n - 1) / n * b)
        return reduce(t, op=op, group=group, **kw)

    def scoped(fn):
        def call(*a, **kw):
            inside[0] += 1
            try:
                return fn(*a, **kw)
            finally:
                inside[0] -= 1
        return call

    dist.all_gather, dist.all_reduce = all_gather, all_reduce
    compat._assemble = scoped(assemble)
    compat._Split.backward = staticmethod(scoped(split_back.__func__))
    try:
        yield seen
    finally:
        dist.all_gather, dist.all_reduce = gather, reduce
        compat._assemble, compat._Split.backward = assemble, split_back


def uncounted_payloads(cfg, mesh):
    """One train step of ``cfg`` on the expert-parallel route on the
    process mesh ``mesh`` (the trainer's first batch) under
    :func:`uncounted_recorder`: every rank's record, in rank order."""
    data = DataConfig(seq_len=DP["seq_len"], global_batch=DP["global_batch"],
                      vocab_size=cfg.vocab_size)
    tr = Trainer(cfg, adamw.OptConfig(), data, TrainerConfig(steps=1),
                 mesh=mesh, device=mesh.device)
    state = tr.init_state()
    batch = {k: torch.as_tensor(v) for k, v in tr.batch(0).items()}
    with uncounted_recorder() as seen:
        tr.step_fn(state, batch)
    return _all_ranks(seen)


def _reference_ep(mesh, out_dir):
    """The reference's sharded float32 step of reduced deepseek-v3-671b as
    configured on its expert-parallel route (``tests/test_torch_mesh.py``'s
    ``step_moe_ep``: ``DENSE_PATH_MAX_TOKENS`` lowered to 32 below its
    4 x 16 tokens) on (2,2), here on the ranks: its parameters and tokens,
    the default ``OptConfig``, each data rank its rows of the batch, the
    gate lowered as there. None without the reference's file."""
    path = os.path.join(out_dir, REFERENCE_STEP)
    if not os.path.exists(path):
        return None
    ref = torch.load(path, weights_only=False)
    if "moe_ep_params" not in ref:
        return None
    cfg = reduced(get_config("deepseek-v3-671b"), compute_dtype="float32")
    params = convert.params_from_numpy(ref["moe_ep_params"], device="cpu")
    toks = torch.as_tensor(ref["moe_ep_tokens"]).long()
    ctx = MeshCtx(mesh=mesh, batch_axes=("data",))
    opt = adamw.OptConfig()
    bundle = tstep.make_train_step(cfg, opt, ctx)
    blocks = shard_params(params, tstep.train_state_specs(cfg, ctx)["params"],
                          mesh)
    rows = toks.shape[0] // mesh.shape["data"]
    mine = slice(mesh.coord("data") * rows, (mesh.coord("data") + 1) * rows)
    batch = {"tokens": toks[mine], "labels": torch.roll(toks, -1, 1)[mine]}
    compat.reset_counts()
    with ep_gate(EP_REFERENCE_GATE):
        _, m = bundle.step_fn({"params": blocks,
                               "opt": adamw.init(opt, blocks)}, batch)
    return {"got": {k: float(m[k]) for k in ("loss", "ce", "aux",
                                             "grad_norm")},
            "want": ref["moe_ep_metrics"],
            "all_to_all": _counts(mesh)[0]["all_to_all"]["calls"]}


def _ep_granite_cfg(shape):
    """Reduced granite-moe-3b-a800m in float64; on (2,2) at its configured
    remat "full", so that the recompute re-lays the tables again."""
    return _moe_cfg(dtype="float64", **({"remat": "full"}
                                        if shape == (2, 2) else {}))


def case_ep_train(rank, meshes, out_dir):
    """The expert-parallel route in training over processes, the gate
    lowered to ``EP_GATE``: reduced deepseek-v3-671b on (1,2) without
    FSDP and on (2,2) as configured (each rank's experts block held), 3
    steps in float64 and in float32, each from the same state as the
    stacked route's step on a mesh of the same shape; reduced
    granite-moe-3b-a800m (its FFN blocks re-laid) on (1,4) and, at remat
    "full", on (2,2), 3 float64 steps; one float64 step each: granite at
    capacity factor 16 on (2,2) against the one-device one-hot step
    (neither drops a pair),
    deepseek as configured at capacity factor 0.5 on (2,2) (pairs
    dropped), and deepseek on (1,2) with its held tables passed as
    replicated (a planted fault); the reference's own step on (2,2); the
    collectives of one granite (2,2) step that the counts leave out
    (:func:`uncounted_payloads`); checkpoints between the one-device
    trainer and a (2,2) trainer on the route, both ways."""
    out = {}
    pair = pair_mesh(meshes[2, 2])
    with ep_gate(EP_GATE):
        for shape, mesh in (((1, 2), pair), ((2, 2), meshes[2, 2])):
            make = _mla_cfg if shape == (1, 2) else _mla_fsdp_cfg
            out[f"mla {shape}"] = {
                tag: _ep_steps(make(dt), mesh, resolve=tag == "f32")
                for tag, dt in (("f32", "float32"), ("f64", "float64"))}
        for shape in EP_GRANITE_MESHES:
            out[f"granite {shape}"] = _ep_steps(_ep_granite_cfg(shape),
                                                meshes[shape])
        n = 1
        out["no drops"] = _ep_steps(_moe_cfg(dtype="float64"), meshes[2, 2],
                                    steps=n, cf=16.0, against="one")
        out["drops"] = _ep_steps(_mla_fsdp_cfg("float64"), meshes[2, 2],
                                 steps=n, cf=0.5)
        with held_as_replicated():
            out["replicated"] = _ep_steps(_mla_cfg("float64"), pair, steps=n)
        out["uncounted"] = uncounted_payloads(_moe_cfg(), meshes[2, 2])
        out.update(_ckpt_both_ways(rank, _moe_cfg(), meshes[2, 2], out_dir,
                                   "ep"))
    out["reference"] = _reference_ep(meshes[2, 2], out_dir)
    return out


def _ep_serve(cfg, mesh, toks, steps):
    """``cfg``'s prefill of ``toks`` and ``steps`` decode steps on ``mesh``
    (a process mesh: on the rank's blocks of the parameters, each data
    rank its rows under FSDP; else the stacked route's), a float32 cache,
    without autograd: the logits of each, with each step's collectives."""
    ctx = MeshCtx(mesh=mesh, batch_axes=("data",))
    params = init_params(ttf.model_template(cfg),
                         torch.Generator().manual_seed(0), device="cpu")
    rows = slice(None)
    if compat.is_process_mesh(mesh):
        params = shard_params(params, tstep.train_state_specs(cfg, ctx)[
            "params"], mesh)
        if cfg.fsdp and mesh.shape["data"] > 1:
            n = toks.shape[0] // mesh.shape["data"]
            rows = slice(mesh.coord("data") * n, (mesh.coord("data") + 1) * n)
    outs, counts = [], []
    with torch.no_grad():
        compat.reset_counts()
        logits, cache = tstep.make_prefill_step(
            cfg, ctx, toks.shape[1] + len(steps),
            cache_dtype=torch.float32)(params, {"tokens": toks[rows]})
        outs.append(logits)
        counts.append(_counts(mesh))
        dec = tstep.make_decode_step(cfg, ctx)
        for tok in steps:
            compat.reset_counts()
            logits, cache = dec(params, cache, {"tokens": tok[rows]})
            outs.append(logits)
            counts.append(_counts(mesh))
    ttf.forward(cfg, init_params(ttf.model_template(cfg),
                                 torch.Generator().manual_seed(0),
                                 device="cpu"), toks[:1, :1])
    return outs, counts


def case_ep_serve(rank, meshes, out_dir):
    """The expert-parallel route in serving over processes, the gate
    lowered to the prefill's tokens: reduced granite-moe-3b-a800m (its
    FFN blocks re-laid) and deepseek-v3-671b as configured (its experts
    blocks held; on (2,2) under FSDP, each data rank its rows) on (1,4)
    and (2,2): the prefill and ``EP_SERVE["steps"]`` decode steps (the
    one-hot dispatch, below the gate), against the stacked route's."""
    sv = EP_SERVE
    r = np.random.RandomState(11)
    toks = torch.from_numpy(r.randint(0, 256, size=(sv["batch"],
                                                    sv["prompt"])))
    steps = [torch.from_numpy(r.randint(0, 256, size=(sv["batch"], 1)))
             for _ in range(sv["steps"])]
    out = {}
    with ep_gate(toks.numel()):
        for shape in EP_GRANITE_MESHES:
            for name, cfg in (("granite", _moe_cfg()),
                              ("mla", _mla_fsdp_cfg())):
                pmesh = meshes[shape]
                got = {"proc": _ep_serve(cfg, pmesh, toks, steps)}
                if rank == 0:
                    with _counts_kept():
                        got["stacked"] = _ep_serve(
                            cfg, Mesh(pmesh.axis_names, pmesh.sizes), toks,
                            steps)
                out[f"{name} {shape}"] = got
    return out


def case_held(rank, meshes, out_dir):
    """A ``compat.Held`` input on (1,2) and (2,2): on the process route
    each rank passes its own block along model (a block of rows of a
    global (4, 6) tensor), which the body scales by a factor of its device
    and sums over data; the output, and every rank's gradient of its
    block, against the stacked route's on the whole tensor, cut by the
    same spec (the gradient's slice of that block: no sum over model)."""
    x = _randn(21, 4, 6)
    c = _randn(22, 8, 6)

    def body(s):
        i = compat.axis_index("model") + 2 * compat.axis_index("data")
        return compat.psum(s * (1.0 + i.reshape(i.shape + (1, 1))), "data")

    def run(mesh):
        rows = slice(None)
        if compat.is_process_mesh(mesh):
            m = mesh.coord("model")
            rows = slice(2 * m, 2 * m + 2)
        xs = x[rows].clone().requires_grad_(True)
        y = compat.shard_map(body, mesh=mesh,
                             in_specs=(compat.Held("model", None),),
                             out_specs=PS(("data", "model"), None))(xs)
        (y * c[:y.shape[0]]).sum().backward()
        if compat.is_process_mesh(mesh):
            return y.detach(), _all_ranks((mesh.coord("model"), xs.grad))
        return y.detach(), xs.grad
    return {"(1, 2)": _both(rank, pair_mesh(meshes[2, 2]), run),
            "(2, 2)": _both(rank, meshes[2, 2], run)}


def micro_cells() -> dict:
    """(config of a dtype, mesh shape, on the expert-parallel route) of
    each ``case_moe_micro`` cell: deepseek-v3-671b as configured (FSDP) on
    (4,1) and granite-moe-3b-a800m on (2,2) on the one-hot dispatch;
    deepseek-v3-671b as configured, granite-moe-3b-a800m with fsdp=True
    (its FFN blocks re-laid as blocks of the experts) and deepseek-v3-671b
    with fsdp=False on (2,2) on the expert-parallel route."""
    return {"moe": (_mla_fsdp_cfg, (4, 1), False),
            "moe_accum": (lambda dt: _moe_cfg(dtype=dt), (2, 2), False),
            "tp_mla": (_mla_fsdp_cfg, (2, 2), True),
            "tp_moe": (lambda dt: _moe_cfg(dtype=dt, fsdp=True), (2, 2),
                       True),
            "tp_moe_serve": (_mla_cfg, (2, 2), True)}


@contextlib.contextmanager
def no_relay():
    """A planted fault: the step in micro-batches without the micro-major
    re-lay, each rank's strips the contiguous ones of its block of rows
    (other rows of the global batch than the one-device micro-batch's)."""
    orig = tstep.micro_major
    tstep.micro_major = lambda cfg, ctx, batch, grad_accum: batch
    try:
        yield
    finally:
        tstep.micro_major = orig


def case_moe_micro(rank, meshes, out_dir):
    """The MoE train step in micro-batches over processes, ``MICRO`` of
    them: each cell of :func:`micro_cells`, 3 steps in float64 and in
    float32, each from the same state as the one-device step (one-hot)
    or the stacked route's step on a mesh of the same shape (the
    expert-parallel route, the gate at ``MICRO_GATE``; deepseek-v3-671b's
    float32 steps there with the stacked step in float64 beside them) in
    as many micro-batches; one float64 step of granite-moe-3b-a800m on
    (2,2) at capacity factor 0.5 (pairs dropped in each micro-batch) and
    one without the re-lay (a planted fault); a (2,2) granite trainer in
    micro-batches, its checkpoints both ways."""
    out = {}
    for key, (make, shape, ep) in micro_cells().items():
        out[key] = {}
        for tag, dt in (("f32", "float32"), ("f64", "float64")):
            cfg = make(dt)
            if ep:
                with ep_gate(MICRO_GATE):
                    got = _ep_steps(cfg, meshes[shape], grad_accum=MICRO,
                                    resolve=tag == "f32" and cfg.use_mla,
                                    gate=MICRO_GATE)
            else:
                got = _moe_steps(cfg, meshes[shape], grad_accum=MICRO)
            out[key][tag] = got
    granite = _moe_cfg(dtype="float64")
    out["drops"] = _moe_steps(granite, meshes[2, 2], steps=1,
                              grad_accum=MICRO, cf=0.5)
    with no_relay():
        out["no relay"] = _moe_steps(granite, meshes[2, 2], steps=1,
                                     grad_accum=MICRO)
    out.update(_ckpt_both_ways(rank, _moe_cfg(), meshes[2, 2], out_dir,
                               "micro", steps=MICRO_CKPT_STEPS,
                               grad_accum=MICRO))
    return out


# -- the SSM, hybrid, vision and encoder-decoder families under FSDP ---------


def _family_cfg(arch, dtype="float32", **kw):
    """Reduced ``arch`` with ``fsdp=True`` in ``dtype`` (zamba2-7b at 4
    layers: two groups read its shared block)."""
    if arch == "zamba2-7b":
        kw = {"n_layers": 4, **kw}
    return reduced(get_config(arch), fsdp=True, param_dtype=dtype,
                   compute_dtype=dtype, **kw)


def _family_trajectory(cfg, mesh, steps=DP["steps"]):
    """``steps`` steps through the Trainer's state, batches and step
    function on ``mesh`` (None: one device), the frontend's embeddings
    beside the tokens (the Trainer's source makes tokens only): the
    metrics of each step and the global parameters at the end, as
    :func:`_tp_trajectory` gives them."""
    data = DataConfig(seq_len=DP["seq_len"], global_batch=DP["global_batch"],
                      vocab_size=cfg.vocab_size)
    opt = adamw.OptConfig(peak_lr=1e-2, warmup_steps=1, decay_steps=steps)
    tr = Trainer(cfg, opt, data, TrainerConfig(steps=steps), mesh=mesh,
                 device="cpu")
    state = _opened(cfg, tr.init_state())
    log = []
    for i in range(steps):
        glob = _with_frontend(cfg, tr.source.batch(i), i)
        state, m = tr.step_fn(state, {k: v[tr.rows] for k, v in glob.items()})
        log.append(dict({k: float(v) for k, v in m.items()}, step=i + 1))
    params = state["params"] if mesh is None else gather_params(
        state["params"], tr.state_specs["params"], mesh)
    return {"log": log, "params": _detach(params)}


def _family_serve(cfg, mesh):
    """``cfg`` served under FSDP on ``mesh``, each data rank prefilling its
    rows of ``TP_SERVE``'s prompts (the frontend's embeddings of those
    rows beside them) and decoding them 2 steps, the weights gathered a
    block at a time; on rank 0 the same steps on one device: the logits,
    the collectives of each step and the cache after the last."""
    ctx = MeshCtx(mesh=mesh, batch_axes=("data",))
    params = _opened(cfg, {"params": init_params(
        ttf.model_template(cfg), torch.Generator().manual_seed(0),
        device="cpu")})["params"]
    blocks = shard_params(params, tstep.train_state_specs(cfg, ctx)["params"],
                          mesh)
    r = np.random.RandomState(5)
    b, s, n = TP_SERVE["batch"], TP_SERVE["prompt"], TP_SERVE["steps"]
    toks = torch.from_numpy(r.randint(0, cfg.vocab_size, size=(b, s)))
    steps = [torch.from_numpy(r.randint(0, cfg.vocab_size, size=(b, 1)))
             for _ in range(n)]
    fe = _frontend(cfg, 0, b)
    rows = b // mesh.shape["data"]
    mine = slice(mesh.coord("data") * rows, (mesh.coord("data") + 1) * rows)

    def serve(p, c, rows):
        extra = {} if fe is None else {"frontend_emb": fe[rows]}
        outs, counts = [], []
        with torch.no_grad():
            compat.reset_counts()
            logits, cache = tstep.make_prefill_step(
                cfg, c, s + n, cache_dtype=torch.float32)(
                p, {"tokens": toks[rows], **extra})
            outs.append(logits)
            counts.append(_counts(mesh) if c else None)
            dec = tstep.make_decode_step(cfg, c)
            for tok in steps:
                compat.reset_counts()
                logits, cache = dec(p, cache, {"tokens": tok[rows], **extra})
                outs.append(logits)
                counts.append(_counts(mesh) if c else None)
        return outs, counts, {k: v.clone() for k, v in cache.items()}

    out = {"fsdp": serve(blocks, ctx, mine), "rows": (mine.start, mine.stop)}
    if mesh.rank == 0:
        out["one"] = serve(params, None, slice(None))
    return out


def _reference_family(mesh, out_dir):
    """The reference's float64 FSDP steps on (4,1) of ``REFERENCE_FAMILIES``
    (``tests/test_torch_mesh.py``'s ``step_fsdp_*``), here on the ranks:
    its parameters, tokens and frontend embeddings, the default
    ``OptConfig``, each data rank its rows of the batch. None without the
    reference's file."""
    path = os.path.join(out_dir, REFERENCE_STEP)
    if not os.path.exists(path):
        return None
    ref = torch.load(path, weights_only=False)["families"]
    ctx = MeshCtx(mesh=mesh, batch_axes=("data",))
    opt = adamw.OptConfig()
    out = {}
    for arch in REFERENCE_FAMILIES:
        got = ref[arch]
        cfg = _family_cfg(arch, "float64")
        params = convert.params_from_numpy(got["params"], device="cpu")
        bundle = tstep.make_train_step(cfg, opt, ctx)
        blocks = shard_params(params, tstep.train_state_specs(cfg, ctx)[
            "params"], mesh)
        toks = torch.as_tensor(got["tokens"]).long()
        rows = toks.shape[0] // mesh.shape["data"]
        mine = slice(mesh.coord("data") * rows,
                     (mesh.coord("data") + 1) * rows)
        batch = {"tokens": toks[mine], "labels": torch.roll(toks, -1, 1)[mine]}
        if "frontend_emb" in got:
            batch["frontend_emb"] = torch.as_tensor(got["frontend_emb"])[mine]
        _, m = bundle.step_fn({"params": blocks,
                               "opt": adamw.init(opt, blocks)}, batch)
        whole = {k: v for k, v in batch.items()}
        whole.update(tokens=toks, labels=torch.roll(toks, -1, 1))
        if "frontend_emb" in got:
            whole["frontend_emb"] = torch.as_tensor(got["frontend_emb"])
        keys = ("loss", "ce", "grad_norm")
        out[arch] = {"got": {k: float(m[k]) for k in keys},
                     "want": got["metrics"], "want_one": got["metrics_one"]}
        if mesh.rank == 0:
            _, m0 = tstep.make_train_step(cfg, opt).step_fn(
                {"params": params, "opt": adamw.init(opt, params)}, whole)
            out[arch]["one"] = {k: float(m0[k]) for k in keys}
    return out


@contextlib.contextmanager
def gather_each_use():
    """A planted fault: the hybrid family's shared block gathered at each of
    its uses (``models.sharding.Reused`` of one use), so that a forward
    gathers it once a group."""
    orig = ttf.Reused
    ttf.Reused = lambda fs, tree, specs, dtype, uses: orig(fs, tree, specs,
                                                          dtype, 1)
    try:
        yield
    finally:
        ttf.Reused = orig


def case_families_fsdp(rank, meshes, out_dir):
    """The SSM, hybrid, vision and encoder-decoder families under FSDP on
    (4,1), each of ``FAMILIES`` reduced with ``fsdp=True``: float32 step
    by step against the one-device step at ``remat="none"`` (3 steps) and,
    for zamba2-7b (its shared block's gathers under a checkpoint's
    recompute), ``"full"`` (1 step); float64 along 3 steps against the
    one-device run (xlstm-1.3b and zamba2-7b through ``Trainer.run``, the
    two frontend models through the Trainer's step with the frontend's
    embeddings); the serve steps; the gathered leaves freed after the
    forward (zamba2-7b and seamless-m4t-medium); zamba2-7b's shared block gathered at each
    use (a planted fault); xlstm-1.3b in 2 micro-batches; the reference's
    own FSDP steps; zamba2-7b's checkpoints between the one-device trainer
    and the (4,1) one, both ways."""
    mesh = meshes[FAMILY_MESH]
    out = {}
    for arch in FAMILIES:
        cfg, f64 = _family_cfg(arch), _family_cfg(arch, "float64")
        run = _family_trajectory if cfg.frontend_seq else _tp_trajectory
        r = {"f32": _tp_step_by_step(cfg, mesh),
             "f64": run(f64, mesh), "serve": _family_serve(cfg, mesh)}
        if cfg.family == "hybrid":
            r["full"] = _tp_step_by_step(dataclasses.replace(
                cfg, remat="full"), mesh, steps=1)
        if rank == 0:
            r["f64_one"] = run(f64, None)
        out[arch] = r
    out["freed"] = {arch: _freed_after_forward(_family_cfg(arch), mesh)
                    for arch in ("zamba2-7b", "seamless-m4t-medium")}
    zamba = _family_cfg("zamba2-7b")
    with gather_each_use():
        out["each use"] = _tp_step_by_step(zamba, mesh, steps=1)
    out["accum"] = _tp_step_by_step(_family_cfg("xlstm-1.3b"), mesh, steps=1,
                                    grad_accum=MICRO)
    out["reference"] = _reference_family(mesh, out_dir)
    out.update(_ckpt_both_ways(rank, zamba, mesh, out_dir, "families"))
    return out


# ---------------------------------------------------------------------------
# the serving engine under FSDP over processes
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def gathered_leaves():
    """Weak references to every leaf that FSDP gathers
    (``core.compat.gather_from``, which ``models.sharding.Fsdp`` calls)
    while the context is open: a list that grows as they are made."""
    refs, orig = [], compat.gather_from

    def spy(*args, **kw):
        out = orig(*args, **kw)
        refs.append(weakref.ref(out))
        return out
    compat.gather_from = spy
    try:
        yield refs
    finally:
        compat.gather_from = orig


class RecordedEngine(ServingEngine):
    """A ``ServingEngine`` that records each device step (``prefill``,
    ``decode``) and each audit's gather of the lengths (``audit``): its
    kind and shape, the rung, the slots active in a decode, the rank's own
    collectives in it, the MoE dispatches it logged (``(pairs, kept)``,
    where ``models.moe.DISPATCH_LOG`` is a list) and how many of ``refs``
    (:func:`gathered_leaves`) were alive before it: the leaves gathered by
    an earlier step and not freed. With ``keep_logits`` each device
    step's last logits, whole, on the host, in ``logits``."""

    def __init__(self, *args, refs=(), keep_logits=False, **kw):
        super().__init__(*args, **kw)
        self.refs, self.record, self.mode = refs, [], "fp32"
        self.logits = [] if keep_logits else None

    def _recorded(self, kind, shape, fn):
        alive = sum(ref() is not None for ref in self.refs)
        log = tmoe.DISPATCH_LOG
        start = 0 if log is None else len(log)
        active = sorted(self.active)
        compat.reset_counts()
        orig = ttf.last_logits
        if self.logits is not None and kind != "audit":
            def spy(*args, **kw):
                out = orig(*args, **kw)
                self.logits.append(out.float().cpu())
                return out
            ttf.last_logits = spy
        try:
            out = fn()
        finally:
            ttf.last_logits = orig
        self.record.append({
            "kind": kind, "shape": shape, "alive_before": alive,
            "mode": self.mode if kind == "decode" else "fp32",
            "active": active,
            "counts": compat.read_counts(),
            "dispatch": [] if log is None else [(d.pairs, int(d.kept))
                                                for d in log[start:]]})
        return out

    def _prefill_one(self, prompt):
        return self._recorded("prefill", (1, len(prompt)),
                              lambda: super(RecordedEngine,
                                            self)._prefill_one(prompt))

    def _decode_step(self, finished):
        return self._recorded("decode", (self.slots, 1),
                              lambda: super(RecordedEngine,
                                            self)._decode_step(finished))

    def _lengths(self):
        return self._recorded("audit", (self.slots,),
                              lambda: super(RecordedEngine, self)._lengths())

    def _pick_mode(self):
        self.mode = super()._pick_mode()
        return self.mode


def engine_cfg(arch):
    """The reduced config of ``arch`` with ``fsdp=True``, float32, whose
    engine ``case_engine_fsdp`` runs."""
    if arch == "tinyllama-1.1b":
        return _fsdp_cfg()
    if arch == "deepseek-v3-671b":
        return _mla_fsdp_cfg()
    if arch in FAMILIES:
        return _family_cfg(arch)
    return _moe_cfg(arch, fsdp=True)


def engine_requests(cfg, sampled=False) -> list:
    """``ENGINE_FSDP``'s requests of ``cfg`` from a seed: prompts of the
    lengths ``ENGINE_FSDP["prompts"]`` in turn, greedy, or with
    ``sampled`` ``ENGINE_SAMPLED``'s requests at its temperature."""
    r = np.random.RandomState(7)
    out = []
    for uid in range(ENGINE_FSDP["requests"]):
        n = ENGINE_FSDP["prompts"][uid % len(ENGINE_FSDP["prompts"])]
        temp = ENGINE_SAMPLED["temperature"] \
            if sampled and uid in ENGINE_SAMPLED["uids"] else 0.0
        out.append(Request(uid=uid, prompt=r.randint(
            0, cfg.vocab_size, size=n).astype(np.int32),
            max_new_tokens=ENGINE_FSDP["max_new"], temperature=temp))
    return out


def corrupt_length(slot: int, tick: int, by: int):
    """A fault hook: at ``tick`` the KV length of global ``slot`` grows by
    ``by``, written by the rank whose block of the pool holds it."""
    def hook(eng):
        row = eng._row(slot)
        if eng.tick == tick and row is not None:
            eng.cache["lengths"][row] += by
    return hook


def inject_nan(slot: int, tick: int):
    """A fault hook: at ``tick`` the logits of ``slot`` are made NaN (the
    engine's ``_inject_nan_slots``, every slot's on every rank)."""
    def hook(eng):
        if eng.tick == tick:
            eng._inject_nan_slots.add(slot)
    return hook


def _engine_run(cfg, params, ctx, sampled=False, degrade=None, hooks=(),
                refs=(), rows_prefill=False) -> dict:
    """``ENGINE_FSDP``'s requests through a :class:`RecordedEngine` of
    ``params`` on ``ctx`` (None: one device) to completion: the tokens and
    state of each request, the events, the record of each step, the
    gathered leaves alive at the end, and the shapes of the parameter
    tree of each compute dtype it holds. ``rows_prefill``: a planted
    fault, each prompt prefilled as the rank's row of a batch split over
    the data ranks (d copies in one MoE dispatch group)."""
    e = ENGINE_FSDP
    eng = RecordedEngine(cfg, params, slots=e["slots"],
                         max_seq=e["max_seq"], ctx=ctx, degrade=degrade,
                         device="cpu", refs=refs)
    eng.fault_hooks.extend(hooks)
    if rows_prefill:
        eng._prefill_ctx = eng._step_ctx
    for q in engine_requests(cfg, sampled):
        eng.submit(q)
    done = eng.run_to_completion()
    return {"tokens": {q.uid: list(q.out_tokens) for q in done},
            "states": {q.uid: q.state.value for q in done},
            "events": list(eng.events), "tick": eng.tick,
            "record": eng.record,
            "alive_end": sum(ref() is not None for ref in refs),
            "gathered": len(refs),
            "trees": {str(dt)[6:]: [list(t.shape) for t in tree_leaves(tree)]
                      for dt, tree in eng._params_by_dtype.items()}}


def _engine_params(cfg, path=None):
    """The whole parameters of ``cfg``: the reference's, converted from
    the numpy tree at ``path`` where it exists, else the seeded init
    (the families' opened as their serve case opens them)."""
    if path is not None and os.path.exists(path):
        return convert.params_from_numpy(torch.load(path, weights_only=False),
                                         device="cpu")
    params = init_params(ttf.model_template(cfg),
                         torch.Generator().manual_seed(0), device="cpu")
    return _opened(cfg, {"params": params})["params"]


def _engine_both(cfg, params, mesh, **kw) -> dict:
    """:func:`_engine_run` of the rank's blocks of ``params`` on ``mesh``
    under FSDP (every rank's result) and, on rank 0, of ``params`` on one
    device (``one``)."""
    ctx = MeshCtx(mesh=mesh, batch_axes=("data",))
    blocks = shard_params(params, tstep.train_state_specs(cfg, ctx)["params"],
                          mesh)
    with gathered_leaves() as refs:
        got = _engine_run(cfg, blocks, ctx, refs=refs, **kw)
    got["blocks"] = [list(t.shape) for t in tree_leaves(blocks)]
    out = {"ranks": _all_ranks(got)}
    if mesh.rank == 0:
        out["one"] = _engine_run(cfg, params, None, **kw)
    return out


def case_engine_fsdp(rank, meshes, out_dir):
    """The ``ServingEngine`` under FSDP over processes, every config and
    mesh of ``ENGINE_FSDP_RUNS`` reduced with ``fsdp=True``: the rank's
    blocks of one seeded init (tinyllama-1.1b's: the reference's serving
    fixture, ``REFERENCE_ENGINE``, where the caller wrote it), the same
    requests on every rank, against the one-device engine on the whole
    parameters: greedy, and on (4,1) sampled through the degrade ladder's
    ``bf16`` rung; granite-moe-3b-a800m at ``ENGINE_DROP_CF``, and so
    with its prompt prefilled as each rank's row (a planted fault); a
    corrupted length in one rank's row and a NaN slot. What the engine
    refuses is ``case_refusals``' (:func:`engine_refusals`)."""
    out = {}
    for arch, shape in ENGINE_FSDP_RUNS:
        cfg = engine_cfg(arch)
        params = _engine_params(cfg, os.path.join(out_dir, REFERENCE_ENGINE)
                                if arch == "tinyllama-1.1b" else None)
        r = {"greedy": _engine_both(cfg, params, meshes[shape])}
        if shape == (4, 1):
            r["sampled"] = _engine_both(
                cfg, params, meshes[shape], sampled=True,
                degrade=DegradeLadder(bf16_at=ENGINE_SAMPLED["bf16_at"]))
        out[arch, shape] = r
    granite = _with_cf(engine_cfg("granite-moe-3b-a800m"), ENGINE_DROP_CF)
    params = _engine_params(granite)
    tmoe.DISPATCH_LOG = []
    try:
        out["drops"] = _engine_both(granite, params, meshes[4, 1])
        out["drops fault"] = _engine_both(granite, params, meshes[4, 1],
                                          rows_prefill=True)
    finally:
        tmoe.DISPATCH_LOG = None
    cfg = engine_cfg("tinyllama-1.1b")
    params = _engine_params(cfg)
    a = ENGINE_AUDIT
    out["corrupt"] = _engine_both(cfg, params, meshes[4, 1], hooks=(
        corrupt_length(a["slot"], a["tick"], a["by"]),))
    out["nan"] = _engine_both(cfg, params, meshes[4, 1], hooks=(
        inject_nan(a["slot"], a["tick"]),))
    return out


def engine_refusals(meshes) -> dict:
    """What the engine refuses under FSDP over processes, before any
    collective: slots that the data ranks do not divide (``ValueError``),
    and zamba2-7b on (2,2) (``NotImplementedError``, item 2.6). The text
    of each."""
    out = {}
    zamba = engine_cfg("zamba2-7b")
    for name, exc, cfg, shape, slots in (
            ("fsdp_engine_slots", ValueError, engine_cfg("tinyllama-1.1b"),
             (4, 1), 6),
            ("fsdp_hybrid_engine", NotImplementedError, zamba, (2, 2), 4)):
        try:
            ServingEngine(cfg, init_params(ttf.model_template(cfg),
                                           torch.Generator().manual_seed(0),
                                           device="cpu"),
                          slots=slots, ctx=MeshCtx(mesh=meshes[shape]),
                          device="cpu")
        except exc as e:
            out[name] = str(e)
        else:
            out[name] = None
    return out


def case_refusals(rank, meshes, out_dir):
    """The texts of what the process route refuses."""
    out = {}

    def text(name, exc, fn):
        try:
            fn()
        except exc as e:
            out[name] = str(e)
        else:
            out[name] = None
    text("world", ValueError, lambda: make_process_mesh(3, 1, device="cpu"))
    cfg = reduced(get_config("tinyllama-1.1b"))
    # a dense config whose heads the model axis does not divide, an SSM
    # config whose mLSTM heads it does not divide, and a vision config
    # whose heads (those of its self and cross layers) it does not divide
    for name, acfg in (("tp_odd", dataclasses.replace(
            cfg, n_heads=6, n_kv_heads=2)), ("tp_ssm_odd", reduced(
                get_config("xlstm-1.3b"), n_heads=2, n_kv_heads=2)),
            ("tp_cross_odd", reduced(get_config("llama-3.2-vision-11b"),
                                     n_heads=6, n_kv_heads=2))):
        text(name, NotImplementedError,
             lambda acfg=acfg: tstep.make_train_step(
                 acfg, adamw.OptConfig(), MeshCtx(mesh=meshes[1, 4])))
    text("tp_kv_seq", NotImplementedError, lambda: tstep.make_prefill_step(
        dataclasses.replace(cfg, n_kv_heads=2),
        MeshCtx(mesh=meshes[1, 4]), 16))
    # FSDP of the families outside the tensor-parallel route at model > 1
    # (item 2.6), and what the engine refuses under FSDP
    text("fsdp_hybrid_model", NotImplementedError,
         lambda: tstep.make_prefill_step(
             reduced(get_config("zamba2-7b"), fsdp=True),
             MeshCtx(mesh=meshes[2, 2]), 16))
    text("fsdp_vision_model", NotImplementedError,
         lambda: tstep.make_decode_step(
             reduced(get_config("llama-3.2-vision-11b"), fsdp=True),
             MeshCtx(mesh=meshes[2, 2])))
    out.update(engine_refusals(meshes))
    # a MoE step in micro-batches whose rows the data ranks do not split:
    # 4 micro-batches of 2 rows over the 4 data ranks of (4,1), raised by
    # the step on the rank's 2 rows, before any collective
    mcfg = _moe_cfg()
    micro = tstep.make_train_step(mcfg, adamw.OptConfig(),
                                  MeshCtx(mesh=meshes[4, 1]), grad_accum=4)
    toks = torch.zeros(DP["global_batch"] // 4, DP["seq_len"],
                       dtype=torch.long)
    text("accum_rows", ValueError, lambda: micro.step_fn(
        {"params": {}, "opt": {}}, {"tokens": toks, "labels": toks}))
    text("outside", RuntimeError, lambda: compat.psum(torch.ones(2), "data"))
    text("backend", RuntimeError,
         lambda: make_process_mesh(4, 1, device="cuda"))
    return out


# ---------------------------------------------------------------------------
# the SSM and hybrid blocks under the model axis over processes
# ---------------------------------------------------------------------------


def ssm_tp_cfg(arch, dtype="float64", **kw):
    """Reduced ``arch`` (xlstm-1.3b or zamba2-7b, the latter at 4 layers:
    two groups read its shared block) with ``fsdp=False`` in ``dtype``."""
    if arch == "zamba2-7b":
        kw = {"n_layers": 4, **kw}
    return reduced(get_config(arch), fsdp=False, param_dtype=dtype,
                   compute_dtype=dtype, **kw)


def ssm_tp_batch(cfg, batch=DP["global_batch"]) -> dict:
    """The global batch of the SSM cases, from a seed."""
    r = np.random.RandomState(37)
    toks = torch.from_numpy(r.randint(0, cfg.vocab_size,
                                      size=(batch, DP["seq_len"])))
    return {"tokens": toks, "labels": torch.roll(toks, -1, 1)}


def ssm_tp_params(cfg, out_dir):
    """The whole parameters of ``cfg``: the reference's init, converted
    from the numpy tree the caller wrote (``REFERENCE_SSM``), else the
    seeded init."""
    path = os.path.join(out_dir, REFERENCE_SSM)
    if os.path.exists(path):
        tree = torch.load(path, weights_only=False)[cfg.name]
        return tree_map(lambda t: t.to(torch_dtype(cfg.param_dtype)),
                        convert.params_from_numpy(tree, device="cpu"))
    return init_params(ttf.model_template(cfg),
                       torch.Generator().manual_seed(0),
                       dtype=torch_dtype(cfg.param_dtype), device="cpu")


def ssm_tp_opt():
    return adamw.OptConfig(peak_lr=1e-2, warmup_steps=1,
                           decay_steps=DP["steps"])


def _tp_step(cfg, params, mesh, batch, grad_accum=1, steps=1):
    """``steps`` train steps of ``cfg`` from ``params`` on ``batch`` (the
    global batch) on ``mesh`` (the rank's blocks, its rows of the batch),
    or on one device where ``mesh`` is None: the metrics of the last, the
    global parameters after it, and on the ranks the collectives (forward,
    backward) and the blocks' shapes."""
    opt = ssm_tp_opt()
    params = _detach(params)
    ctx, specs, blocks = None, None, params
    if mesh is not None:
        ctx = MeshCtx(mesh=mesh, batch_axes=("data",))
        specs = tstep.sanitize_specs(tstep.train_state_specs(cfg, ctx)[
            "params"], params, mesh)
        blocks = shard_params(params, specs, mesh)
        rows = batch["tokens"].shape[0] // mesh.shape["data"]
        mine = slice(mesh.coord("data") * rows,
                     (mesh.coord("data") + 1) * rows)
        batch = {k: v[mine] for k, v in batch.items()}
    step = tstep.make_train_step(cfg, opt, ctx, grad_accum=grad_accum)
    state = {"params": blocks, "opt": adamw.init(opt, blocks)}
    compat.reset_counts()
    for _ in range(steps):
        state, m = step.step_fn(state, batch)
    out = {"metrics": {k: float(v) for k, v in m.items()}}
    if mesh is None:
        return dict(out, params=state["params"])
    return dict(out, params=gather_params(state["params"], specs, mesh),
                counts=_counts(mesh),
                blocks=[tuple(t.shape) for t in tree_leaves(blocks)])


def _tp_serve(cfg, params, mesh, prompt, seed):
    """``cfg`` served on ``mesh`` (None: one device) from ``params``, every
    rank the whole batch: the prefill of ``TP_SERVE``'s 8 prompts of
    ``prompt`` tokens from ``seed`` (with the frontend's embeddings of
    :func:`cross_tp_batch` where the model takes them) and 2 decode steps
    (the vision model reads the embeddings at each, the audio model its
    encoder's output from the cache), each step's logits and collectives,
    and the cache after the last."""
    ctx = None
    if mesh is not None:
        ctx = MeshCtx(mesh=mesh, batch_axes=("data",))
        params = shard_params(params, tstep.train_state_specs(cfg, ctx)[
            "params"], mesh)
    r = np.random.RandomState(seed)
    b, n = TP_SERVE["batch"], TP_SERVE["steps"]
    toks = torch.from_numpy(r.randint(0, cfg.vocab_size, size=(b, prompt)))
    steps = [torch.from_numpy(r.randint(0, cfg.vocab_size, size=(b, 1)))
             for _ in range(n)]
    fe = {"frontend_emb": cross_tp_batch(cfg, b)["frontend_emb"]} \
        if cfg.frontend_seq else {}
    outs, counts = [], []
    dt = torch_dtype(cfg.compute_dtype)
    with torch.no_grad():
        compat.reset_counts()
        logits, cache = tstep.make_prefill_step(cfg, ctx, prompt + n,
                                                cache_dtype=dt)(
            params, {"tokens": toks, **fe})
        outs.append(logits)
        counts.append(_counts(mesh) if ctx else None)
        dec = tstep.make_decode_step(cfg, ctx)
        for tok in steps:
            compat.reset_counts()
            logits, cache = dec(params, cache, {"tokens": tok, **fe})
            outs.append(logits)
            counts.append(_counts(mesh) if ctx else None)
    return outs, counts, {k: v.clone() for k, v in cache.items()}


def ssm_state_slices(cfg, m: int, r: int) -> dict:
    """Where rank ``r`` of ``m``'s cache lies in the one-device cache: per
    key, the index of the one-device tensor that it holds (its heads of
    ``ssm``, its kv heads of ``attn_k`` / ``attn_v``; of ``conv`` its block
    of ``d_inner`` (ssm) or its heads' x channels, then B and C)."""
    s = cfg.ssm
    di = s.expansion * cfg.d_model
    nh = cfg.n_heads if s.kind != "mamba2" else di // s.head_dim

    def blk(n):
        return slice(r * n // m, (r + 1) * n // m)
    every = slice(None)
    out = {"ssm": (every, every, blk(nh))}
    if s.kind == "mamba2":
        out["conv"] = (every, every, every, torch.cat([
            torch.arange(di)[blk(di)],
            torch.arange(di, di + 2 * s.state_dim)]))
        out["attn_k"] = out["attn_v"] = (every, every, every,
                                         blk(cfg.n_kv_heads))
    else:
        out["conv"] = (every, every, every, blk(di))
    return out


@contextlib.contextmanager
def norm_without_all_reduce():
    """A planted fault: the split norm over the rank's block of d_inner
    alone (its sum of squares not all-reduced)."""
    from repro_torch.models import layers, sharding
    orig = sharding.InnerSplit.norm

    def local(self, x, gamma, eps, width):
        if self.mesh is None:
            return orig(self, x, gamma, eps, width)
        return layers.rms_norm(x, gamma, eps)
    sharding.InnerSplit.norm = local
    try:
        yield
    finally:
        sharding.InnerSplit.norm = orig


@contextlib.contextmanager
def conv_from_the_contiguous_block():
    """A planted fault: Mamba2's conv weights of the rank's x channels read
    from its contiguous block of ``conv_w`` / ``conv_b`` (as if that block
    lined up with its heads), not from the gathered weights."""
    from repro_torch.models import ssm
    orig = ssm._mamba2_split

    def faulty(cfg, p, x, split):
        z, xbc, dt_pre, conv_w, conv_b = orig(cfg, p, x, split)
        dl = z.shape[-1]
        conv_w = torch.cat([p["conv_w"][:, :dl], conv_w[:, dl:]], dim=-1)
        conv_b = torch.cat([p["conv_b"][:dl], conv_b[dl:]], dim=-1)
        return z, xbc, dt_pre, conv_w, conv_b
    ssm._mamba2_split = faulty
    try:
        yield
    finally:
        ssm._mamba2_split = orig


def case_ssm_tp(rank, meshes, out_dir):
    """The SSM and hybrid blocks under the model axis, reduced xlstm-1.3b
    and zamba2-7b in float64 with ``fsdp=False`` (the reference's init
    where the caller wrote it): one train step on each mesh of
    ``SSM_TP["meshes"]`` and one in ``MICRO`` micro-batches on
    ``SSM_TP["accum"]`` (on rank 0 the one-device steps), the prefill and
    decode steps on (1,4) (every rank against the one-device steps, its
    cache against the one-device cache's slices of its heads), the
    ``ServingEngine`` on (1,4), and the two planted faults' steps on
    (1,4)."""
    out = {}
    for arch in SSM_TP["archs"]:
        cfg = ssm_tp_cfg(arch)
        params = ssm_tp_params(cfg, out_dir)
        r = {}
        batch = ssm_tp_batch(cfg)
        for shape in SSM_TP["meshes"]:
            r[shape] = _tp_step(cfg, params, meshes[shape], batch)
        r["accum"] = _tp_step(cfg, params, meshes[SSM_TP["accum"]], batch,
                              grad_accum=MICRO)
        mesh = meshes[SSM_TP["serve"]]
        outs, counts, cache = _tp_serve(cfg, params, mesh, SSM_TP["prompt"],
                                        7)
        one = _tp_serve(cfg, params, None, SSM_TP["prompt"], 7)
        m, k = mesh.shape["model"], mesh.coord("model")
        want = {key: one[2][key][ix] for key, ix in
                ssm_state_slices(cfg, m, k).items()}
        r["serve"] = {"logits": max(_err(a, b) for a, b in zip(outs, one[0])),
                      "max_logit": max(float(b.abs().max()) for b in one[0]),
                      "counts": counts,
                      "states": _all_ranks({key: _err(cache[key], want[key])
                                            for key in want})}
        # in float32: the engine's cache is float32, and so is its state
        eng_cfg = ssm_tp_cfg(arch, "float32")
        eng_params = tree_map(lambda t: t.float(), params)

        def engine(p, c):
            eng = ServingEngine(eng_cfg, p, slots=ENGINE["slots"],
                                max_seq=ENGINE["max_seq"], ctx=c,
                                device="cpu")
            rr = np.random.RandomState(8)
            for uid in range(ENGINE["requests"]):
                eng.submit(Request(uid=uid, prompt=rr.randint(
                    0, cfg.vocab_size, size=4 + uid).astype(np.int32),
                    max_new_tokens=ENGINE["max_new"]))
            return {q.uid: list(q.out_tokens)
                    for q in eng.run_to_completion()}
        ctx = MeshCtx(mesh=mesh, batch_axes=("data",))
        r["engine"] = _all_ranks(engine(shard_params(
            eng_params, tstep.train_state_specs(eng_cfg, ctx)["params"],
            mesh), ctx))
        fault = norm_without_all_reduce() if arch == "xlstm-1.3b" \
            else conv_from_the_contiguous_block()
        with fault:
            r["fault"] = _tp_step(cfg, params, mesh, batch)
        if rank == 0:
            r["one"] = _tp_step(cfg, params, None, batch)
            r["one_accum"] = _tp_step(cfg, params, None, batch,
                                      grad_accum=MICRO)
            r["engine_one"] = engine(eng_params, None)
        out[arch] = r
    return out


# ---------------------------------------------------------------------------
# the vision and encoder-decoder cross layers under the model axis
# ---------------------------------------------------------------------------


def cross_tp_cfg(arch, dtype="float64", **kw):
    """Reduced ``arch`` (llama-3.2-vision-11b, or seamless-m4t-medium with
    ``CROSS_TP["audio_vocab"]``) with ``fsdp=False`` in ``dtype``."""
    if arch == "seamless-m4t-medium":
        kw = {"vocab_size": CROSS_TP["audio_vocab"], **kw}
    return reduced(get_config(arch), fsdp=False, param_dtype=dtype,
                   compute_dtype=dtype, **kw)


def cross_tp_batch(cfg, batch=DP["global_batch"]) -> dict:
    """The global batch of the cross cases, from a seed: tokens, labels
    and the stub frontend's embeddings in the parameters' dtype."""
    r = np.random.RandomState(38)
    toks = torch.from_numpy(r.randint(0, cfg.vocab_size,
                                      size=(batch, DP["seq_len"])))
    fe = torch.from_numpy(r.randn(batch, cfg.frontend_seq,
                                  cfg.frontend_dim or cfg.d_model))
    return {"tokens": toks, "labels": torch.roll(toks, -1, 1),
            "frontend_emb": fe.to(torch_dtype(cfg.param_dtype))}


def cross_tp_params(cfg, out_dir):
    """The whole parameters of ``cfg``: the reference's init, converted
    from the numpy tree the caller wrote (``REFERENCE_CROSS``), else the
    seeded init; the vision gates at ``CROSS_GATE`` either way."""
    path = os.path.join(out_dir, REFERENCE_CROSS)
    if os.path.exists(path):
        tree = torch.load(path, weights_only=False)[cfg.name]
        params = tree_map(lambda t: t.to(torch_dtype(cfg.param_dtype)),
                          convert.params_from_numpy(tree, device="cpu"))
    else:
        params = init_params(ttf.model_template(cfg),
                             torch.Generator().manual_seed(0),
                             dtype=torch_dtype(cfg.param_dtype), device="cpu")
    return _opened(cfg, {"params": params})["params"]


def cross_cache_slices(cfg, m: int, r: int) -> dict:
    """Where rank ``r`` of ``m``'s cache lies in the one-device cache: its
    kv heads of ``k`` / ``v``; the audio model's ``memory`` whole."""
    every = slice(None)
    blk = slice(r * cfg.n_kv_heads // m, (r + 1) * cfg.n_kv_heads // m)
    out = {"k": (every, every, every, blk), "v": (every, every, every, blk)}
    if cfg.family == "audio":
        out["memory"] = (every,)
    return out


class _Proxy:
    """A rank's ``TensorParallel`` with some of its operators replaced (the
    planted faults below)."""

    def __init__(self, tp, **ops):
        self._tp = tp
        self.__dict__.update(ops)

    def __getattr__(self, name):
        return getattr(self._tp, name)


@contextlib.contextmanager
def _cross_fault(make_tp):
    """The cross layers run with ``make_tp(tp, p, memory)`` in place of the
    rank's ``tp``."""
    orig = ttf.cross_attention

    def faulty(cfg, p, x, memory, memory_valid=None, tp=None):
        if tp is not None:
            p, tp = make_tp(tp, p, memory)
        return orig(cfg, p, x, memory, memory_valid, tp)
    ttf.cross_attention = faulty
    try:
        yield
    finally:
        ttf.cross_attention = orig


def gate_before_reduce():
    """A planted fault: the vision cross layer's tanh gate applied to the
    rank's partial output before the all-reduce, so that each rank's gate
    gradient is its own heads' share (the forward is unchanged)."""
    def make(tp, p, memory):
        if "gate" not in p:
            return p, tp
        gate = p["gate"]
        rest = {k: v for k, v in p.items() if k != "gate"}
        return rest, _Proxy(tp, reduce=lambda t: tp.reduce(
            torch.tanh(gate).to(t.dtype) * t))
    return _cross_fault(make)


def memory_without_copy():
    """A planted fault: the audio decoder's cross-attention reads the
    encoder's output without ``copy_to``, so that the encoder's gradient
    is each rank's heads' share, not summed over the model axis."""
    def make(tp, p, memory):
        return p, _Proxy(tp, copy=lambda t: t if t is memory
                         else tp.copy(t))
    return _cross_fault(make)


def case_cross_tp(rank, meshes, out_dir):
    """The vision and encoder-decoder cross layers under the model axis,
    reduced llama-3.2-vision-11b and seamless-m4t-medium in float64 with
    ``fsdp=False`` (the reference's init where the caller wrote it): one
    train step on each mesh of ``CROSS_TP["meshes"]`` and one in ``MICRO``
    micro-batches on ``CROSS_TP["accum"]`` (on rank 0 the one-device
    steps), the prefill and decode steps on each mesh (every rank against
    the one-device steps, its cache against the one-device cache's slices
    of its kv heads), and each model's planted fault's step on (1,4)."""
    out = {}
    for arch in CROSS_TP["archs"]:
        cfg = cross_tp_cfg(arch)
        params = cross_tp_params(cfg, out_dir)
        r = {}
        batch = cross_tp_batch(cfg)
        for shape in CROSS_TP["meshes"]:
            r[shape] = _tp_step(cfg, params, meshes[shape], batch)
        r["accum"] = _tp_step(cfg, params, meshes[CROSS_TP["accum"]], batch,
                              grad_accum=MICRO)
        one = _tp_serve(cfg, params, None, CROSS_TP["prompt"], 9)
        r["serve"] = {}
        for shape in CROSS_TP["meshes"]:
            mesh = meshes[shape]
            outs, counts, cache = _tp_serve(cfg, params, mesh,
                                            CROSS_TP["prompt"], 9)
            m, k = mesh.shape["model"], mesh.coord("model")
            want = {key: one[2][key][ix] for key, ix in
                    cross_cache_slices(cfg, m, k).items()}
            r["serve"][shape] = {
                "logits": max(_err(a, b) for a, b in zip(outs, one[0])),
                "max_logit": max(float(b.abs().max()) for b in one[0]),
                "counts": counts,
                "cache": _all_ranks({key: _err(cache[key], want[key])
                                     for key in want}),
                "keys": sorted(cache)}
        fault = gate_before_reduce() if cfg.family == "vlm" \
            else memory_without_copy()
        with fault:
            r["fault"] = _tp_step(cfg, params, meshes[1, 4], batch,
                                  steps=CROSS_FAULT_STEPS)
        if rank == 0:
            r["one"] = _tp_step(cfg, params, None, batch)
            r["one_accum"] = _tp_step(cfg, params, None, batch,
                                      grad_accum=MICRO)
            r["one_fault"] = _tp_step(cfg, params, None, batch,
                                      steps=CROSS_FAULT_STEPS)
        out[arch] = r
    return out


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------


def refusal_texts() -> dict:
    """What each refusal of ``case_refusals`` says (a part of its text).
    Device "cuda" on the gloo group: with NCCL in this torch the group's
    backend is refused, without it the missing backend."""
    import torch.distributed as dist
    return {
        "world": "a (3, 1) mesh needs 3 processes, the world has 4",
        "tp_odd": "tinyllama-1.1b with model=4 on a process mesh: heads 6 "
                  "do not split over 4 ranks; a rank holding a leaf that "
                  "the model axis should split whole (ROADMAP Queue A, "
                  "A13c item 2.6)",
        "tp_ssm_odd": "xlstm-1.3b with model=4 on a process mesh: heads 2 "
                      "do not split over 4 ranks; a rank holding a leaf "
                      "that the model axis should split whole (ROADMAP "
                      "Queue A, A13c item 2.6)",
        "tp_cross_odd": "llama-3.2-vision-11b with model=4 on a process "
                        "mesh: heads 6 do not split over 4 ranks; a rank "
                        "holding a leaf that the model axis should split "
                        "whole (ROADMAP Queue A, A13c item 2.6)",
        "tp_kv_seq": "a sequence-split cache over processes (ROADMAP Queue "
                     "A, A13c item 2.6)",
        "fsdp_hybrid_model": "zamba2-7b with fsdp=True over data on a "
                             "process mesh with model=2: the hybrid family "
                             "under FSDP and the model axis; the SSM, "
                             "hybrid, vision and encoder-decoder families "
                             "under FSDP with model > 1 (ROADMAP Queue A, "
                             "A13c item 2.6) are not ported",
        "fsdp_vision_model": "llama-3.2-vision-11b with fsdp=True over data "
                             "on a process mesh with model=2: the vlm "
                             "family under FSDP and the model axis; the "
                             "SSM, hybrid, vision and encoder-decoder "
                             "families under FSDP with model > 1 (ROADMAP "
                             "Queue A, A13c item 2.6) are not ported",
        "fsdp_engine_slots": "tinyllama-1.1b under FSDP over 4 data ranks: "
                             "6 slots do not split; the slots must be a "
                             "multiple of the data extent",
        "fsdp_hybrid_engine": "zamba2-7b with fsdp=True over data on a "
                              "process mesh with model=2: the hybrid family "
                              "under FSDP and the model axis; the SSM, "
                              "hybrid, vision and encoder-decoder families "
                              "under FSDP with model > 1 (ROADMAP Queue A, "
                              "A13c item 2.6) are not ported",
        "accum_rows": "granite-moe-3b-a800m on a process mesh: "
                      "grad_accum=4 cuts the global batch's 8 rows into "
                      "micro-batches of 2 rows, which 4 data ranks do not "
                      "split evenly (ROADMAP Queue C)",
        "outside": "a collective runs only inside shard_map's body",
        "backend": "the process group runs gloo, device 'cuda' needs nccl"
        if dist.is_nccl_available() else "needs the nccl backend"}


def _leaves(tree):
    """The tensors of a tree of dicts, tuples and lists, in order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _err(a, b) -> float:
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    if not a.is_floating_point():
        return float((a.long() != b.long()).sum())
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def check_pair(case, tag, pair, tol=None):
    """The process route's outputs against the stacked route's at ``tol``
    (exact for integers), and their counts equal, forward and backward."""
    tol = TOL[case] if tol is None else tol
    (got, gc), (want, wc) = pair["proc"], pair["stacked"]
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want) and got, (case, tag)
    errs = [_err(a, b) for a, b in zip(got, want)]
    assert max(errs) <= tol, (case, tag, errs, tol)
    assert gc == wc, (case, tag, gc, wc)
    return max(errs)


def check(name, res) -> dict:
    """Holds case ``name``'s results (rank 0's) to their tolerances;
    returns the largest error of each comparison. Raises AssertionError on
    the first that fails."""
    if "error" in res:
        raise AssertionError(f"case {name} raised on rank 0:\n{res['error']}")
    if name == "refusals":
        want = refusal_texts()
        assert set(res) == set(want), (res, want)
        for key, text in want.items():
            assert res[key] is not None and text in res[key], (key, res[key])
        return {}
    if name == "dp_train":
        return check_dp(res)
    if name == "tp_train":
        return check_tp_train(res)
    if name == "tp_serve":
        return check_tp_serve(res)
    if name == "fsdp_train":
        return check_fsdp_train(res)
    if name == "fsdp_serve":
        return check_fsdp_serve(res)
    if name == "moe_train":
        return check_moe_train(res)
    if name == "mla_train":
        return check_mla_train(res)
    if name == "mla":
        return check_mla_serve(res)
    if name == "mla_fsdp":
        return check_mla_fsdp(res)
    if name == "mla_fsdp_serve":
        return check_mla_fsdp_serve(res)
    if name == "ep_train":
        return check_ep_train(res)
    if name == "ep_serve":
        return check_ep_serve(res)
    if name == "moe_micro":
        return check_moe_micro(res)
    if name == "families_fsdp":
        return check_families_fsdp(res)
    if name == "ssm_tp":
        return check_ssm_tp(res)
    if name == "cross_tp":
        return check_cross_tp(res)
    if name == "held":
        return {tag: check_held(res, tag) for tag in res}
    if name == "local_axes":
        (y, g), counts = res["local"]
        (yg, gg), gcounts = res["global"]["stacked"]
        rows = slice(2 * res["data"], 2 * res["data"] + 2)
        errs = {"local y": _err(y, yg[rows]), "local grad": _err(g, gg[rows]),
                "global": check_pair(name, "global", res["global"])}
        assert max(errs.values()) <= TOL[name], errs
        assert counts == gcounts, (counts, gcounts)
        return errs
    return {tag: check_pair(name, tag, pair) for tag, pair in res.items()}


def check_dp(res) -> dict:
    """Per step, the float32 loss and grad norm within 1e-5 relative of
    the one-device step's; the float64 parameters within 1e-10; the
    parameters equal on every rank; one pmean a leaf and one for the
    metrics each step, outside any body; rank 0's checkpoint files,
    restored on every rank."""
    errs = {}
    for tag in ("f32", "f64"):
        r = res[tag]
        assert r["same_on_every_rank"], tag
        got, want = r["log"], r["one"]["log"]
        assert [m["step"] for m in got] == [m["step"] for m in want] \
            == list(range(1, DP["steps"] + 1)), (got, want)
        for key in ("loss", "ce", "grad_norm", "lr"):
            rel = max(abs(a[key] - b[key]) / abs(b[key])
                      for a, b in zip(got, want))
            errs[f"{tag} {key}"] = rel
            assert rel <= TOL["dp_f32"], (tag, key, rel)
        if tag == "f64":
            err = max(_err(a, b) for a, b in zip(
                tree_leaves(r["params"]), tree_leaves(r["one"]["params"])))
            errs["f64 params"] = err
            assert err <= TOL["dp_f64"], err
        fwd, bwd = r["counts"]
        assert set(fwd) == {"pmean"} and not bwd, (fwd, bwd)
        assert fwd["pmean"]["calls"] == DP["steps"] * (r["leaves"] + 1), fwd
    assert res["restore"]["written"] == ["step_00000002",
                                         "step_00000003"], res["restore"]
    assert all(s and no_step for s, no_step in res["restore"]["every_rank"]), \
        res["restore"]
    return errs


def _rel(got: dict, want: dict, keys) -> float:
    return max(abs(got[k] - want[k]) / abs(want[k]) for k in keys)


def check_trajectory(tag, got, want, errs):
    """Per-step metrics (relative, ``tp_f32``) and the final parameters
    (``tp_f64``) of two ``Trainer.run`` logs."""
    steps = [[m["step"] for m in r["log"]] for r in (got, want)]
    assert steps[0] == steps[1] == list(range(1, DP["steps"] + 1)), (
        tag, got["log"], want["log"])
    errs[f"{tag} metrics"] = max(_rel(a, b, ("loss", "ce", "grad_norm", "lr"))
                                 for a, b in zip(got["log"], want["log"]))
    errs[f"{tag} params"] = max(_err(a, b) for a, b in zip(
        tree_leaves(got["params"]), tree_leaves(want["params"])))
    assert errs[f"{tag} metrics"] <= TOL["tp_f32"], (tag, errs)
    assert errs[f"{tag} params"] <= TOL["tp_f64"], (tag, errs)


def by_kind(counts) -> dict:
    """Bytes by the dry run's kind (``core.step_analysis``'s names) of a
    ``_counts`` pair, forward and backward summed."""
    from repro_torch.core import step_analysis as sa
    out = {}
    for names, c in zip((sa._KIND, sa._KIND_BWD), counts):
        for k, v in c.items():
            if k in names:
                out[names[k]] = out.get(names[k], 0) + v["bytes"]
    return out


def norm_bytes(d: int, m: int, itemsize: int = 4, group=None) -> int:
    """The bytes summed over the ranks of the grad norm's one all-reduce
    of a scalar over the axes that cut a leaf (of ``group`` ranks: by
    default the model axis's; which the dry run does not count: it
    derives no reduction of a sum over a sharded leaf)."""
    g = m if group is None else group
    return d * m * int(round(2 * (g - 1) / g * itemsize))


def tp_train_shape():
    from repro_torch.configs.base import ShapeConfig
    return ShapeConfig("train", DP["seq_len"], DP["global_batch"], "train")


def _dry_count(cfg, shape, mesh, grad_accum=1):
    from repro_torch.launch import dryrun
    return dryrun.count_step(cfg, shape, mesh, target="cpu",
                             grad_accum=grad_accum)


def check_tp_mesh(res, shape) -> dict:
    """On ``shape``: float32 step by step (each from the same state) within
    ``tp_f32`` of the one-device step, float64 through ``Trainer.run``
    within ``tp_f32`` (metrics) and ``tp_f64`` (parameters) of the
    one-device trainer; the blocks of the reference's shard shapes; the
    replicated leaves equal on every rank, the blocks on the ranks of one
    model coordinate."""
    r = res[shape]
    f32 = r["f32"]
    assert f32["shapes_ok"] and f32["blocks_agree"], (shape, f32)
    errs = {f"{shape} f32": max(
        _rel(row["tp"], row["one"], ("loss", "ce", "grad_norm", "lr"))
        for row in f32["rows"])}
    assert errs[f"{shape} f32"] <= TOL["tp_f32"], (shape, f32["rows"])
    check_trajectory(f"{shape} f64", r["f64"], r["f64_one"], errs)
    return errs


def check_tp_bytes(res, shape, count=_dry_count) -> float:
    """The float32 steps' collectives on ``shape``: one pmean a gradient
    leaf and one for the metrics (over data), and the bytes the ranks
    move, summed, equal to the dry run's all-reduces (``count(cfg, shape,
    mesh)``) times the ranks, less the grad norm's all-reduce and the loss
    metrics' mean. Returns the relative difference."""
    from repro_torch.launch.mesh import make_mesh
    d, m = shape
    f32 = res[shape]["f32"]
    fwd, _ = f32["counts"]
    assert fwd["pmean"]["calls"] == DP["steps"] * (f32["leaves"] + 1), fwd
    cfg = reduced(get_config("tinyllama-1.1b"))
    st = count(cfg, tp_train_shape(), make_mesh(d, m))
    got = by_kind(f32["counts"])
    assert set(got) == {"all-reduce"} == set(st.collective_by_kind), (
        got, st.collective_by_kind)
    # the loss metrics' mean over data: loss, ce and aux in float32
    extra = norm_bytes(d, m) + d * m * int(round(2 * (d - 1) / d * 12))
    per_step = got["all-reduce"] / DP["steps"] - extra
    want = d * m * st.collective_by_kind["all-reduce"]
    assert abs(per_step - want) <= d * m, (shape, per_step, want)
    return per_step / want - 1


def check_tp_config(res, name) -> dict:
    """On (1,4), float64 through ``Trainer.run`` against the one-device
    trainer: ``name`` "kv2" (reduced tinyllama-1.1b with 2 kv heads, which
    the model axis does not divide) or one of ``TP_ARCHS``."""
    errs = {}
    check_trajectory(f"{name} f64", res[name]["f64"], res[name]["f64_one"],
                     errs)
    return errs


def check_tp_reference(res) -> float:
    """The reference's own sharded step on (2,2) (its FSDP step in the FSDP
    case): loss, ce and grad norm within ``tp_reference`` relative."""
    ref = res["reference"]
    err = _rel(ref["got"], ref["want"], ("loss", "ce", "grad_norm"))
    assert err <= TOL["tp_reference"], ref
    return err


def check_tp_ckpt(res, steps=DP["steps"]):
    """A (1,4) checkpoint (the global state, gathered, after ``steps``
    steps) restored by the one-device trainer, and a one-device checkpoint
    restored on (1,4) (each rank its blocks), byte for byte, with no step
    run after."""
    one = res["ckpt_to_one"]
    assert one["no_step"] and one["equal"], one
    tp = res["ckpt_to_tp"]
    assert tp["written"] == [f"step_{steps:08d}"], tp
    assert all(no_step and equal for no_step, equal in tp["every_rank"]), tp


def check_tp_train(res, count=_dry_count) -> dict:
    """Every check of the tensor-parallel train case (the reference's step
    where it ran)."""
    errs = {}
    for shape in TP_MESHES:
        errs.update(check_tp_mesh(res, shape))
        errs[f"{shape} bytes"] = check_tp_bytes(res, shape, count)
    for name in ("kv2",) + TP_ARCHS:
        errs.update(check_tp_config(res, name))
    if res["reference"] is not None:
        errs["reference"] = check_tp_reference(res)
    check_tp_ckpt(res)
    return errs


def check_tp_serve_logits(res) -> dict:
    """The prefill's and 2 decode steps' logits within ``tp_serve`` of the
    one-device steps; the cache's k/v of the rank's kv heads."""
    cfg = reduced(get_config("tinyllama-1.1b"))
    outs, _, kv = res["tp"]
    want_outs, _, want_kv = res["one"]
    errs = {"logits": max(_err(a, b) for a, b in zip(outs, want_outs)),
            "max_logit": max(float(b.abs().max()) for b in want_outs)}
    assert errs["logits"] <= TOL["tp_serve"], errs
    assert [s[3] for s in kv] == [cfg.n_kv_heads // 4] * 2 \
        and [s[3] for s in want_kv] == [cfg.n_kv_heads] * 2, (kv, want_kv)
    return errs


def check_tp_serve_bytes(res, count=_dry_count):
    """Per step the all-reduce bytes summed over the ranks equal to the dry
    run's (``tests/test_torch_dryrun.py``'s cells "tinyllama-1.1b prefill
    1x4" and "decode 1x4") times the ranks, and one all-gather of the last
    position's logits (the step returns them whole on every rank, where
    the dry run's count leaves them split over vocab)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_mesh
    cfg = reduced(get_config("tinyllama-1.1b"))
    m, b, s = 4, TP_SERVE["batch"], TP_SERVE["prompt"]
    gathered = m * (m - 1) * b * (cfg.vocab_size // m) * 4
    for i, c in enumerate(res["tp"][1]):
        kind = "prefill" if i == 0 else "decode"
        st = count(cfg, ShapeConfig(kind, s, b, kind), make_mesh(1, m))
        got = by_kind(c)
        assert got == {"all-reduce": m * st.collective_by_kind["all-reduce"],
                       "all-gather": gathered}, (i, got,
                                                 st.collective_by_kind)


def check_tp_engine(res):
    """The engine's tokens equal on every rank and to the one-device
    engine's, every request finished."""
    eng = res["engine"]
    assert all(e == eng[0] for e in eng) and eng[0] == res["engine_one"] \
        and len(eng[0]) == ENGINE["requests"], (eng, res["engine_one"])


def check_tp_serve(res, count=_dry_count) -> dict:
    errs = check_tp_serve_logits(res)
    check_tp_serve_bytes(res, count)
    check_tp_engine(res)
    return errs


def metric_bytes(n_metrics: int, itemsize: int, n: int) -> int:
    """The bytes summed over ``n`` ranks of one pmean of the stacked loss
    metrics (a ring all-reduce a rank)."""
    return n * int(round(2 * (n - 1) / n * n_metrics * itemsize))


# -- FSDP ---------------------------------------------------------------------


def check_fsdp_mesh(res, shape) -> dict:
    """On ``shape``: float32 step by step (each from the same state) within
    ``tp_f32`` of the one-device step at ``remat="none"`` and ``"full"``,
    float64 through ``Trainer.run`` within ``tp_f32`` (metrics) and
    ``tp_f64`` (parameters) of the one-device trainer; the blocks of the
    reference's FSDP shard shapes, equal on the ranks whose coordinates
    agree along the axes that cut them."""
    r = res[shape]
    errs = {}
    for tag in ("f32", "full"):
        got = r[tag]
        assert got["shapes_ok"] and got["blocks_agree"], (shape, tag, got)
        errs[f"{shape} {tag}"] = max(
            _rel(row["tp"], row["one"], ("loss", "ce", "grad_norm", "lr"))
            for row in got["rows"])
        assert errs[f"{shape} {tag}"] <= TOL["tp_f32"], (shape, got["rows"])
    check_trajectory(f"{shape} f64", r["f64"], r["f64_one"], errs)
    return errs


def fsdp_extra(d: int, m: int, n_metrics: int = 3, itemsize: int = 4) -> int:
    """The all-reduce bytes a step of the FSDP ranks moves beyond the dry
    run's count, summed over the ranks: the loss metrics' mean over data
    (``n_metrics`` of them, by default loss, ce and aux, of ``itemsize``
    bytes) and the grad norm's scalar over every rank (each leaf is cut
    over data, and at m > 1 some over model too)."""
    return norm_bytes(d, m, itemsize, group=d * m) \
        + metric_bytes(n_metrics, itemsize, d) * m


def check_fsdp_step_bytes(got, cfg, shape, count=_dry_count) -> dict:
    """FSDP steps' collectives on ``shape`` (``_tp_step_by_step``'s or
    ``_moe_steps``' results ``got``): one pmean a step for the loss
    metrics and one for each leaf that FSDP leaves whole over data, none
    of a leaf it cuts; the bytes by kind, summed over the
    ranks, equal to ``count``'s for the same cell (``cfg``) times the
    ranks: every leaf gathered in the forward and again for the backward
    that reads it (in a checkpoint's recompute, or from its saved
    handles), of a padded expert table the live experts' rows alone, its
    gradient reduce-scattered on those rows; the per-expert counts'
    all-gather over data; the tensor-parallel all-reduces; the
    all-reduces less :func:`fsdp_extra`. Returns the bytes a step by
    kind."""
    from repro_torch.launch.mesh import make_mesh
    d, m = shape
    steps = len(got["rows"])
    fwd, _ = got["counts"]
    assert fwd["pmean"]["calls"] == steps * (
        got["leaves"] - got["n_data_cut"] + 1), (fwd, got["n_data_cut"])
    st = count(cfg, tp_train_shape(), make_mesh(d, m))
    per_step = {k: v / steps for k, v in by_kind(got["counts"]).items()}
    want = {k: d * m * v for k, v in st.collective_by_kind.items()}
    itemsize = 8 if cfg.param_dtype == "float64" else 4
    want["all-reduce"] = want.get("all-reduce", 0) + fsdp_extra(
        d, m, len(got["rows"][0]["tp"]) - 2, itemsize)
    assert set(per_step) == set(want), (shape, per_step, want)
    for k in per_step:
        assert abs(per_step[k] - want[k]) <= d * m, (shape, k, per_step,
                                                     want)
    return per_step


def check_fsdp_bytes(res, shape, count=_dry_count) -> dict:
    """The steps' collectives on ``shape`` (:func:`check_fsdp_step_bytes`:
    every leaf gathered in the forward and again for the backward that
    reads it, a reduce-scatter of its gradient, no pmean of it; every leaf
    of the dense family is cut over data) at ``remat="none"`` and
    ``"full"``, whose all-reduces are its own count's (the checkpoint's
    recompute runs the tensor-parallel all-reduces again), its gathers
    and reduce-scatters the same. Returns the bytes a step by kind."""
    r = res[shape]
    assert r["f32"]["n_data_cut"] == r["f32"]["leaves"], r["f32"]
    per_step = {tag: check_fsdp_step_bytes(r[key], cfg, shape, count)
                for tag, key, cfg in (("none", "f32", _fsdp_cfg()),
                                      ("full", "full",
                                       _fsdp_cfg(remat="full")))}
    for k in ("all-gather", "reduce-scatter"):
        assert per_step["none"][k] == per_step["full"][k], per_step
    return per_step


def check_fsdp_accum(res, count=_dry_count):
    """One step at ``grad_accum=2`` on (4,1) within ``tp_f32`` of the
    one-device step; its gathers and reduce-scatters equal to the dry
    run's count of the step in 2 micro-batches (each micro-batch's forward
    and backward gathers every leaf and reduce-scatters its gradient;
    the dense family's rows keep their contiguous strips: no re-lay)."""
    from repro_torch.launch.mesh import make_mesh
    r = res["accum"]
    err = max(_rel(row["tp"], row["one"], ("loss", "ce", "grad_norm", "lr"))
              for row in r["rows"])
    assert err <= TOL["tp_f32"], r["rows"]
    st = count(_fsdp_cfg(), tp_train_shape(), make_mesh(4, 1), grad_accum=2)
    got = by_kind(r["counts"])
    for k in ("all-gather", "reduce-scatter"):
        assert got[k] == 4 * st.collective_by_kind[k], (k, got, st)
    return err


def regather_scopes(cfg) -> int:
    """The ``Fsdp.regather`` scopes of one FSDP forward at ``remat="none"``:
    one a block it runs (each layer, each use of the hybrid family's
    shared block, each cross layer, each encoder layer), the audio
    model's ``enc_norm``, the head, and the MTP module."""
    n = cfg.n_layers + 1 + bool(cfg.mtp_depth)
    if cfg.family == "hybrid":
        n += cfg.n_layers // cfg.attn_every
    elif cfg.family == "vlm":
        n += cfg.n_layers // cfg.cross_attn_every
    elif cfg.family == "audio":
        n += cfg.n_encoder_layers + 1
    return n


def check_fsdp_freed(res, cfg=None):
    """The gathered leaves (and their casts) that the blocks' and the
    head's scopes (:func:`regather_scopes`, the MTP module's too) held are
    all freed when the forward returns; the backward gathers each again
    but the embedding (whose lookups' backward does not read the table)
    and the audio model's first encoder norm (its input is the frontend's,
    so its gradient does not read it), once however many products read it
    (the MTP head reads the main head's; the hybrid family's groups read
    its shared block), so its all-gather bytes are the forward's twice
    less those (and less the MoE layers' gathers of their per-expert
    counts, which are not parameters); one reduce-scatter a gathered
    leaf. ``cfg``: the case's config, on (4,1) (reduced tinyllama-1.1b
    with ``fsdp=True`` by default)."""
    cfg = cfg or _fsdp_cfg()
    r = res["freed"]
    assert r["scopes"] == regather_scopes(cfg) and r["held"] > 0 \
        and r["alive"] == 0, r
    before = r["forward"][0]["all_gather"]["bytes"]
    after = r["after"][0]["all_gather"]["bytes"]
    table = WORLD * 3 * cfg.vocab_size * cfg.d_model // 4 * 4
    if cfg.family == "audio":
        table += WORLD * 3 * cfg.d_model // 4 * 4
    counts = 0
    if cfg.is_moe:
        n_moe = cfg.n_layers - cfg.moe.n_dense_layers
        counts = WORLD * 3 * cfg.moe.n_experts * 4 * n_moe
    assert after == 2 * before - table - counts, (before, after, table,
                                                  counts)
    assert r["after"][1]["all_gather"]["bytes"] == before - counts, r


def check_fsdp_train(res, count=_dry_count) -> dict:
    """Every check of the FSDP train case (the reference's step where it
    ran)."""
    errs = {}
    for shape in FSDP_MESHES:
        errs.update(check_fsdp_mesh(res, shape))
        check_fsdp_bytes(res, shape, count)
    errs["accum"] = check_fsdp_accum(res, count)
    check_fsdp_freed(res)
    for arch in TP_ARCHS:
        errs.update(check_tp_config(res, arch))
    if res["reference"] is not None:
        errs["reference"] = check_tp_reference(res)
    check_tp_ckpt(res)
    return errs


def check_fsdp_serve_logits(res) -> dict:
    """The prefill's and 2 decode steps' logits, whole on every rank,
    within ``tp_serve`` of the one-device steps; the cache of the rank's
    rows and kv heads."""
    cfg = _fsdp_cfg()
    d, m = FSDP_SERVE_MESH
    outs, _, kv = res["fsdp"]
    want_outs, _, want_kv = res["one"]
    errs = {"logits": max(_err(a, b) for a, b in zip(outs, want_outs))}
    assert errs["logits"] <= TOL["tp_serve"], errs
    b = TP_SERVE["batch"]
    assert [(s[1], s[3]) for s in kv] == [(b // d, cfg.n_kv_heads // m)] * 2 \
        and [(s[1], s[3]) for s in want_kv] == [(b, cfg.n_kv_heads)] * 2, (
            kv, want_kv)
    return errs


def fsdp_logit_bytes(cfg, mesh=FSDP_SERVE_MESH,
                     batch=TP_SERVE["batch"]) -> int:
    """The serve step's two all-gathers of the last position's logits,
    summed over the ranks of ``mesh`` (a (data, model) shape) serving
    ``batch`` prompts: the vocab blocks over model, then each data rank's
    rows over data (the step returns them whole on every rank, as the
    reference's returns a global array; the dry run's count leaves them
    split)."""
    d, m = mesh
    rows = batch // d
    return d * m * 4 * rows * cfg.vocab_size * ((m - 1) / m + (d - 1))


def check_fsdp_serve_bytes(res, count=_dry_count):
    """Each decode step's bytes summed over the ranks: the dry run's count
    of "tinyllama-1.1b decode 2x2" with FSDP (each leaf gathered once, the
    tensor-parallel all-reduces) times the ranks, and
    :func:`fsdp_logit_bytes`. The prefill is held on its logits only: the
    dry run counts the prefill without FSDP (``dryrun.cell_config``)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_mesh
    cfg = _fsdp_cfg()
    d, m = FSDP_SERVE_MESH
    b, s = TP_SERVE["batch"], TP_SERVE["prompt"]
    st = count(cfg, ShapeConfig("decode", s, b, "decode"), make_mesh(d, m))
    assert set(st.collective_by_kind) == {"all-gather", "all-reduce"}, st
    for c in res["fsdp"][1][1:]:
        got = by_kind(c)
        want = {"all-reduce": d * m * st.collective_by_kind["all-reduce"],
                "all-gather": d * m * st.collective_by_kind["all-gather"]
                + fsdp_logit_bytes(cfg)}
        assert set(got) == set(want) and all(
            abs(got[k] - want[k]) <= d * m for k in got), (got, want)


def check_fsdp_serve(res, count=_dry_count) -> dict:
    errs = check_fsdp_serve_logits(res)
    check_fsdp_serve_bytes(res, count)
    return errs


# -- the SSM, hybrid, vision and encoder-decoder families under FSDP ---------


def _family_rel(arch, got, want) -> float:
    """The largest relative gap of the loss, ce, grad norm and lr, where
    xlstm-1.3b's float32 grad norm counts as a share of
    ``XLSTM_GNORM_RTOL`` (its rule) of ``tp_f32``."""
    out = 0.0
    for k in ("loss", "ce", "grad_norm", "lr"):
        rel = abs(got[k] - want[k]) / abs(want[k])
        if arch == "xlstm-1.3b" and k == "grad_norm":
            rel *= TOL["tp_f32"] / XLSTM_GNORM_RTOL
        out = max(out, rel)
    return out


def check_family_mesh(res, arch) -> dict:
    """``arch`` under FSDP on (4,1): float32 step by step (each from the
    same state) within ``tp_f32`` of the one-device step at
    ``remat="none"`` and, for zamba2-7b, ``"full"`` (xlstm-1.3b's grad
    norm at its rule);
    float64 within ``tp_f32`` (metrics) and ``tp_f64`` (parameters) of the
    one-device run; the blocks of the reference's FSDP shard shapes,
    equal on every rank where no axis cuts them; some leaves of the
    SSM and hybrid families' mix layers whole (no ``embed``)."""
    r = res[arch]
    errs = {}
    for tag in ("f32", "full") if "full" in r else ("f32",):
        got = r[tag]
        assert got["shapes_ok"] and got["blocks_agree"], (arch, tag, got)
        errs[f"{arch} {tag}"] = max(_family_rel(arch, row["tp"], row["one"])
                                    for row in got["rows"])
        assert errs[f"{arch} {tag}"] <= TOL["tp_f32"], (arch, got["rows"])
    whole = r["f32"]["leaves"] - r["f32"]["n_data_cut"]
    assert (whole > 0) == (_family_cfg(arch).family in ("ssm", "hybrid",
                                                        "vlm")), (arch, whole)
    check_trajectory(f"{arch} f64", r["f64"], r["f64_one"], errs)
    return errs


def check_family_bytes(res, arch, count=_dry_count) -> dict:
    """The steps' bytes by kind at ``remat="none"`` and, for zamba2-7b,
    ``"full"`` (:func:`check_fsdp_step_bytes`: every cut leaf gathered in
    the forward and again for the backward that reads it, the shared block
    once each way, a reduce-scatter of its gradient; one pmean a step of
    each leaf FSDP leaves whole) equal to the dry run's count of the same
    cell times the ranks. Returns the bytes a step by kind."""
    cfg = _family_cfg(arch)
    return {tag: check_fsdp_step_bytes(
        res[arch][tag], dataclasses.replace(cfg, remat=remat), FAMILY_MESH,
        count) for tag, remat in (("f32", "none"), ("full", "full"))
        if tag in res[arch]}


def _batch_dim(got, want) -> int:
    """The one dimension where a rank's cache tensor (its rows) and the
    one-device one differ."""
    dims = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    assert len(dims) == 1, (got, want)
    return dims[0]


def check_family_serve(res, arch, count=_dry_count) -> dict:
    """The prefill of ``TP_SERVE``'s 8 x 64 and 2 decode steps under FSDP,
    each data rank its 2 prompts: the logits, whole on every rank, within
    ``tp_serve`` of the one-device steps'; each cache tensor (the SSM
    state, the shared block's KV, the encoder's ``memory``) rank 0's rows
    of the one-device cache within ``tp_serve``; each step's bytes by kind
    the dry run's count of the same step with ``fsdp=True`` times the
    ranks (each leaf gathered once, the shared block once), and the last
    logits' gather over data (:func:`fsdp_logit_bytes`)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_mesh
    cfg = _family_cfg(arch)
    r = res[arch]["serve"]
    (outs, counts, cache), (want_outs, _, want_cache) = r["fsdp"], r["one"]
    errs = {"logits": max(_err(a, b) for a, b in zip(outs, want_outs))}
    assert errs["logits"] <= TOL["tp_serve"], (arch, errs)
    keys = {"lengths", "conv", "ssm", "attn_k", "attn_v", "k", "v", "memory"}
    assert set(cache) == set(want_cache) and set(cache) <= keys, (
        arch, set(cache))
    lo, hi = r["rows"]
    for k, t in cache.items():
        dim = _batch_dim(t.shape, want_cache[k].shape)
        assert t.shape[dim] == hi - lo, (arch, k, t.shape)
        errs[f"cache {k}"] = _err(t, want_cache[k].narrow(dim, lo, hi - lo))
        assert errs[f"cache {k}"] <= TOL["tp_serve"], (arch, k, errs)
    d, m = FAMILY_MESH
    b, s = TP_SERVE["batch"], TP_SERVE["prompt"]
    for i, c in enumerate(counts):
        kind = "prefill" if i == 0 else "decode"
        st = count(cfg, ShapeConfig(kind, s, b, kind), make_mesh(d, m))
        got = by_kind(c)
        want = {k: d * m * v for k, v in st.collective_by_kind.items()}
        want["all-gather"] = want.get("all-gather", 0) + fsdp_logit_bytes(
            cfg, FAMILY_MESH, b)
        assert set(got) == set(want) and all(
            abs(got[k] - want[k]) <= d * m for k in got), (arch, i, got, want)
    return errs


def _cut_leaves(cfg) -> list:
    """(stack key, leaf path, the global leaf on ``meta``, stack depth) of
    each leaf that FSDP cuts over data on (4,1), as ``fsdp_split`` finds
    them (no process group needed)."""
    from repro_torch.core.compat import ProcessMesh
    from repro_torch.models.layers import abstract_params
    from repro_torch.models.sharding import fsdp_split
    mesh = ProcessMesh(("data", "model"), FAMILY_MESH, 0, torch.device("cpu"),
                       {})
    fs = fsdp_split(cfg, MeshCtx(mesh=mesh))
    tree = abstract_params(ttf.model_template(cfg))
    out = []

    def walk(path, spec, leaf):
        if isinstance(spec, dict):
            for k in spec:
                walk(path + (k,), spec[k], leaf[k])
        elif fs.dim(spec) is not None:
            stacked = path[0] in ("layers", "dense_layers", "cross_layers",
                                  "enc_layers")
            out.append((path[0], path, leaf, leaf.shape[0] if stacked else 1))
    walk((), fs.specs, tree)
    return out


def gathers_a_forward(cfg) -> int:
    """The all-gathers of one FSDP forward of the loss on a rank: one a
    layer of each cut leaf, one of each other cut leaf, the hybrid
    family's shared block once whatever the number of its groups; the
    cross layers' ``q_norm``, which nothing reads, none."""
    return sum(n for _, path, _, n in _cut_leaves(cfg)
               if path[-1] != "q_norm")


def check_family_freed(res, arch) -> dict:
    """:func:`check_fsdp_freed` of ``arch``'s forward and backward at
    ``remat="none"`` on (4,1), and its forward's all-gathers a rank those
    of :func:`gathers_a_forward` (the shared block's once)."""
    cfg = _family_cfg(arch)
    r = res["freed"][arch]
    check_fsdp_freed({"freed": r}, cfg)
    calls = r["forward"][0]["all_gather"]["calls"]
    assert calls == gathers_a_forward(cfg), (arch, calls)
    return {"scopes": r["scopes"], "gathers": calls}


def check_family_fault(res, count=_dry_count) -> dict:
    """The planted fault: zamba2-7b's step with its shared block gathered
    at each of the 2 groups' uses keeps the one-device step's metrics
    but moves one more forward gather of the block than the count (the
    backward's saved views share one gather either way), so the bytes
    check fails."""
    from repro_torch.launch.mesh import make_mesh
    cfg = _family_cfg("zamba2-7b")
    got = res["each use"]
    err = max(_family_rel("zamba2-7b", row["tp"], row["one"])
              for row in got["rows"])
    assert err <= TOL["tp_f32"], got["rows"]
    try:
        check_fsdp_step_bytes(got, cfg, FAMILY_MESH, count)
    except AssertionError:
        pass
    else:
        raise AssertionError("a shared block gathered at each use passed "
                             "the bytes check")
    st = count(cfg, tp_train_shape(), make_mesh(*FAMILY_MESH))
    # a rank receives (n - 1) / n of a leaf: (n - 1) leaves over the ranks
    shared = sum((WORLD - 1) * leaf.numel() * leaf.element_size()
                 for key, _, leaf, _ in _cut_leaves(cfg)
                 if key == "shared_attn")
    groups = cfg.n_layers // cfg.attn_every
    extra = by_kind(got["counts"])["all-gather"] \
        - WORLD * st.collective_by_kind["all-gather"]
    assert extra == (groups - 1) * shared, (extra, groups, shared)
    return {"extra all-gather": extra}


def check_family_accum(res, count=_dry_count) -> float:
    """One xlstm-1.3b step at ``grad_accum=2`` on (4,1) within ``tp_f32``
    of the one-device step (its grad norm at its rule); its gathers and
    reduce-scatters the dry run's count of the step in 2 micro-batches
    (each micro-batch gathers every cut leaf and reduce-scatters its
    gradient; the rows are independent: no re-lay)."""
    from repro_torch.launch.mesh import make_mesh
    r = res["accum"]
    err = max(_family_rel("xlstm-1.3b", row["tp"], row["one"])
              for row in r["rows"])
    assert err <= TOL["tp_f32"], r["rows"]
    st = count(_family_cfg("xlstm-1.3b"), tp_train_shape(),
               make_mesh(*FAMILY_MESH), grad_accum=MICRO)
    got = by_kind(r["counts"])
    for k in ("all-gather", "reduce-scatter"):
        assert got[k] == WORLD * st.collective_by_kind[k], (k, got, st)
    return err


def check_family_reference(res, arch) -> dict:
    """The reference's own FSDP step of ``arch`` on (4,1), in float64 (in
    float32 the grad norm carries the stack's rounding: the reference's
    own one-device and FSDP steps disagree by more than ``tp_reference``
    there): loss and ce within ``tp_reference`` relative; the grad norm
    within ``tp_reference``, or within twice the gap of the two packages'
    one-device float64 steps where that is wider (the reference keeps its
    attention scores and logits in float32: that gap is its float32
    rounding, FSDP aside); the port's one-device step the ranks' within
    ``tp_f64``."""
    ref = res["reference"][arch]
    errs = {"metrics": _rel(ref["got"], ref["want"], ("loss", "ce")),
            "grad_norm": _rel(ref["got"], ref["want"], ("grad_norm",)),
            "one gap": _rel(ref["one"], ref["want_one"], ("grad_norm",)),
            "ranks vs one": _rel(ref["got"], ref["one"],
                                 ("loss", "ce", "grad_norm"))}
    assert errs["metrics"] <= TOL["tp_reference"], (arch, ref)
    assert errs["grad_norm"] <= max(TOL["tp_reference"],
                                    2 * errs["one gap"]), (arch, errs, ref)
    assert errs["ranks vs one"] <= TOL["tp_f64"], (arch, errs, ref)
    return errs


def ssm_step_errs(got, want) -> dict:
    """Relative gaps of a step's loss, ce and grad norm, and the largest
    gap of its parameters, against ``want``'s."""
    return {"metrics": _rel(got["metrics"], want["metrics"],
                            ("loss", "ce", "grad_norm", "lr")),
            "params": max(_err(a, b) for a, b in zip(
                tree_leaves(got["params"]), tree_leaves(want["params"])))}


def check_tp_step(r, cfg, tag, accum) -> dict:
    """A model's step on mesh ``tag`` (a shape, or "accum": on ``accum``
    in ``MICRO`` micro-batches; ``r`` its results) within ``tp_f64`` of
    the one-device step (in as many micro-batches): the metrics relative,
    the parameters after it absolute; the rank's blocks of the
    reference's shard shapes."""
    got, want = r[tag], r["one_accum" if tag == "accum" else "one"]
    errs = ssm_step_errs(got, want)
    assert max(errs.values()) <= TOL["tp_f64"], (cfg.name, tag, errs)
    mesh = Mesh(("data", "model"), accum if tag == "accum" else tag)
    tmpl = ttf.model_template(cfg)
    from repro_torch.models.layers import abstract_params, param_specs
    from repro_torch.models.sharding import make_rules, sanitize_specs
    aparams = abstract_params(tmpl)
    specs = sanitize_specs(param_specs(tmpl, make_rules(
        cfg, MeshCtx(mesh=mesh))), aparams, mesh)
    want_shapes = [NamedSharding(mesh, sp).shard_shape(t.shape)
                   for sp, t in zip(tree_leaves(specs),
                                    tree_leaves(aparams))]
    assert got["blocks"] == want_shapes, (cfg.name, tag)
    return errs


def check_ssm_step(res, arch, tag) -> dict:
    """:func:`check_tp_step` of ``arch``'s step on ``tag``."""
    return check_tp_step(res[arch], ssm_tp_cfg(arch), tag, SSM_TP["accum"])


def ssm_extra(d: int, m: int, itemsize: int = 8) -> int:
    """The train step's all-reduce bytes, summed over the ranks, that the
    dry run does not count: the grad norm's scalar over model and the
    loss metrics' mean over data (loss, ce and aux)."""
    return norm_bytes(d, m, itemsize) \
        + d * m * int(round(2 * (d - 1) / d * 3 * itemsize))


def check_tp_bytes_by_kind(r, cfg, tag, accum, count=_dry_count) -> dict:
    """The bytes by kind of a model's step on ``tag`` (as
    :func:`check_tp_step`), summed over the ranks, equal to the dry run's
    count of the cell times the ranks (the all-reduces less
    :func:`ssm_extra`), kind by kind, and the count short of nothing."""
    from repro_torch.launch.mesh import make_mesh
    d, m = accum if tag == "accum" else tag
    st = count(cfg, tp_train_shape(), make_mesh(d, m),
               grad_accum=MICRO if tag == "accum" else 1)
    got = by_kind(r[tag]["counts"])
    got["all-reduce"] -= ssm_extra(d, m)
    want = {k: d * m * v for k, v in st.collective_by_kind.items()}
    assert set(got) == set(want) and all(
        abs(got[k] - want[k]) <= d * m for k in got), (cfg.name, tag, got,
                                                       want)
    assert not st.count_short, st.count_short
    return got


def check_ssm_bytes(res, arch, tag, count=_dry_count) -> dict:
    """:func:`check_tp_bytes_by_kind` of ``arch``'s step on ``tag``: the
    fused activation's all-gather and its reduce-scatter, the conv
    gathers, the norm's and the gates' all-reduces, mLSTM's
    reduce-scatters, the replicated leaves' gradient all-reduces and the
    tensor-parallel and data-parallel all-reduces."""
    return check_tp_bytes_by_kind(res[arch], ssm_tp_cfg(arch), tag,
                                  SSM_TP["accum"], count)


def check_ssm_serve(res, arch, count=_dry_count) -> dict:
    """The prefill's and 2 decode steps' logits, whole on every rank,
    within ``tp_f64`` of the one-device steps' (absolute); every rank's
    cache within it of the one-device cache's slices of its heads
    (:func:`ssm_state_slices`); each step's bytes by kind, summed over the
    ranks, the dry run's count of the serve step times the ranks and the
    last logits' gather over model. The dry run counts the float32 twin
    (its serve step's bfloat16 cache keeps a float32 state, which a
    float64 step cannot read), twice over: every collective of the step
    moves the compute dtype (or the parameters' and the norm's
    statistics', which are that dtype here)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_mesh
    r = res[arch]["serve"]
    cfg = ssm_tp_cfg(arch)
    errs = {"logits": r["logits"],
            "states": max(max(e.values()) for e in r["states"])}
    assert max(errs.values()) <= TOL["tp_f64"], (arch, errs, r["states"])
    d, m = SSM_TP["serve"]
    b, s = TP_SERVE["batch"], SSM_TP["prompt"]
    gathered = m * (m - 1) * b * (cfg.vocab_size // m) * 8
    for i, c in enumerate(r["counts"]):
        kind = "prefill" if i == 0 else "decode"
        st = count(ssm_tp_cfg(arch, "float32"), ShapeConfig(kind, s, b, kind),
                   make_mesh(d, m))
        want = {k: 2 * m * v for k, v in st.collective_by_kind.items()}
        want["all-gather"] = want.get("all-gather", 0) + gathered
        got = by_kind(c)
        assert set(got) == set(want) and all(
            abs(got[k] - want[k]) <= m for k in got), (arch, i, got, want)
    return errs


def check_ssm_engine(res, arch):
    """The engine's tokens equal on every rank and to the one-device
    engine's, every request finished."""
    r = res[arch]
    assert all(e == r["engine"][0] for e in r["engine"]) \
        and r["engine"][0] == r["engine_one"] \
        and len(r["engine_one"]) == ENGINE["requests"], (
            r["engine"], r["engine_one"])


def check_ssm_fault(res, arch) -> dict:
    """The planted fault's step (xlstm-1.3b's norm without its all-reduce,
    zamba2-7b's conv weights from the contiguous block) on (1,4) fails the
    parity that the step holds: its loss or parameters beyond ``tp_f64``
    of the one-device step's."""
    errs = ssm_step_errs(res[arch]["fault"], res[arch]["one"])
    assert max(errs.values()) > 1e3 * TOL["tp_f64"], (arch, errs)
    return errs


def check_ssm_tp(res, count=_dry_count) -> dict:
    errs = {}
    for arch in SSM_TP["archs"]:
        for tag in SSM_TP["meshes"] + ("accum",):
            errs[f"{arch} {tag}"] = check_ssm_step(res, arch, tag)
            check_ssm_bytes(res, arch, tag, count)
        errs[f"{arch} serve"] = check_ssm_serve(res, arch, count)
        check_ssm_engine(res, arch)
        errs[f"{arch} fault"] = check_ssm_fault(res, arch)
    return errs


def check_cross_step(res, arch, tag) -> dict:
    """:func:`check_tp_step` of ``arch``'s step on ``tag``."""
    return check_tp_step(res[arch], cross_tp_cfg(arch), tag,
                         CROSS_TP["accum"])


def check_cross_bytes(res, arch, tag, count=_dry_count) -> dict:
    """:func:`check_tp_bytes_by_kind` of ``arch``'s step on ``tag``: the
    tensor-parallel all-reduces of the self, cross and encoder layers and
    the head, and the data-parallel gradient mean, all-reduces alone."""
    got = check_tp_bytes_by_kind(res[arch], cross_tp_cfg(arch), tag,
                                 CROSS_TP["accum"], count)
    assert set(got) == {"all-reduce"}, (arch, tag, got)
    return got


def cross_logit_bytes(cfg, shape, itemsize: int = 8) -> int:
    """The bytes, summed over the ranks, of a serve step's all-gather of
    the last position's logits over model, where the model axis splits
    the vocab (every rank holds the whole batch: ``TP_SERVE``'s)."""
    d, m = shape
    if cfg.vocab_size % m:
        return 0
    return d * m * (m - 1) * TP_SERVE["batch"] * (cfg.vocab_size // m) \
        * itemsize


def check_cross_serve(res, arch, shape, count=_dry_count) -> dict:
    """The prefill's and 2 decode steps' logits, whole on every rank,
    within ``tp_f64`` of the one-device steps' (absolute); every rank's
    cache within it of the one-device cache's slices of its kv heads (the
    audio model's ``memory`` whole); each step's bytes by kind, summed
    over the ranks, the dry run's count of the serve step times the ranks
    and ``data`` (every rank serves the whole batch, which the count
    splits over data), beside the last logits' gather over model."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_mesh
    r = res[arch]["serve"][shape]
    cfg = cross_tp_cfg(arch)
    errs = {"logits": r["logits"],
            "cache": max(max(e.values()) for e in r["cache"])}
    assert max(errs.values()) <= TOL["tp_f64"], (arch, shape, errs,
                                                 r["cache"])
    assert set(r["cache"][0]) == set(cross_cache_slices(cfg, 1, 0)), r
    d, m = shape
    b, s = TP_SERVE["batch"], CROSS_TP["prompt"]
    gathered = cross_logit_bytes(cfg, shape)
    for i, c in enumerate(r["counts"]):
        kind = "prefill" if i == 0 else "decode"
        st = count(cfg, ShapeConfig(kind, s, b, kind), make_mesh(d, m))
        want = {k: d * d * m * v for k, v in st.collective_by_kind.items()}
        if gathered:
            want["all-gather"] = want.get("all-gather", 0) + gathered
        got = by_kind(c)
        assert set(got) == set(want) and all(
            abs(got[k] - want[k]) <= d * m for k in got), (arch, shape, i,
                                                           got, want)
    return errs


def check_cross_fault(res, arch) -> dict:
    """The planted fault's step (the vision gate before the all-reduce,
    the audio decoder's memory without ``copy_to``) on (1,4) fails the
    parity that the step holds: its grad norm or parameters beyond
    ``1e3 * tp_f64`` of the one-device step's."""
    errs = ssm_step_errs(res[arch]["fault"], res[arch]["one_fault"])
    assert max(errs.values()) > 1e3 * TOL["tp_f64"], (arch, errs)
    return errs


def check_cross_tp(res, count=_dry_count) -> dict:
    errs = {}
    for arch in CROSS_TP["archs"]:
        for tag in CROSS_TP["meshes"] + ("accum",):
            errs[f"{arch} {tag}"] = check_cross_step(res, arch, tag)
            check_cross_bytes(res, arch, tag, count)
        for shape in CROSS_TP["meshes"]:
            errs[f"{arch} serve {shape}"] = check_cross_serve(res, arch,
                                                              shape, count)
        errs[f"{arch} fault"] = check_cross_fault(res, arch)
    return errs


def check_families_fsdp(res, count=_dry_count) -> dict:
    """Every check of the families' FSDP case (the reference's steps where
    they ran)."""
    errs = {}
    for arch in FAMILIES:
        errs.update(check_family_mesh(res, arch))
        errs[f"{arch} bytes"] = check_family_bytes(res, arch, count)
        errs[f"{arch} serve"] = check_family_serve(res, arch, count)
    for arch in res["freed"]:
        errs[f"{arch} freed"] = check_family_freed(res, arch)
    errs.update(check_family_fault(res, count))
    errs["accum"] = check_family_accum(res, count)
    if res["reference"] is not None:
        for arch in REFERENCE_FAMILIES:
            errs[f"{arch} reference"] = check_family_reference(res, arch)
    check_tp_ckpt(res)
    return errs


# -- the MoE family -------------------------------------------------------------


def _hold_metrics(tag, rows, keys, tol, against64=False):
    """Each row's metrics ``keys`` (the ranks', ``tp``) within ``tol``
    relative of the other step's (``one``); where the rows resolve float32
    (``one64``, the other step in float64 from the same state), within
    twice the float32 step's own gap from float64 where that is wider.
    ``against64``: held against the float64 step instead (the ranks'
    float32 metric at most twice as far from float64 as the other
    float32 step, or ``tol``)."""
    for r in rows:
        for k in keys:
            limit = tol if "one64" not in r else max(
                tol, 2 * _rel(r["one"], r["one64"], (k,)))
            want = r["one64"] if against64 and "one64" in r else r["one"]
            assert _rel(r["tp"], want, (k,)) <= limit, (tag, k, limit, rows)


def check_moe_steps(tag, got, tol, params_tol=None, model=1,
                    blocks=True, hold_params=True, against64=False) -> dict:
    """``_moe_steps``' rows: per step the loss, ce, aux (mtp where the
    model has it), grad norm and lr within ``tol`` relative of the
    one-device step's (where the rows resolve float32, ``one64``: within
    twice the float32 one-device step's own gap from float64 where that
    is wider), the parameters after it within ``params_tol``
    (default ``tol``; with ``hold_params`` False the gap is returned, not
    held); no route of a rank that the one-device step did not
    choose for the same tokens; and the pairs the ranks' dispatches
    dropped (each rank's, in rank order) equal on the ranks of a data
    coordinate (``model`` of them: they route the same tokens), each equal
    to the one-device step's drops of that coordinate's block of rows
    (with ``blocks``: each dispatch one group), and summed over the data
    coordinates, equal to the one-device step's. ``against64``: as
    :func:`_hold_metrics`. Returns the largest gaps, the drops and the
    flipped routes."""
    rows = got["rows"]
    keys = ("loss", "ce", "aux", "grad_norm", "lr") \
        + (("mtp",) if "mtp" in rows[0]["one"] else ())
    errs = {f"{tag} metrics": max(_rel(r["tp"], r["one"], keys)
                                  for r in rows),
            f"{tag} params": max(r["params"] for r in rows)}
    _hold_metrics(tag, rows, keys, tol, against64)
    assert not hold_params or errs[f"{tag} params"] <= (params_tol or tol), (
        tag, errs, rows)
    for r in rows:
        by_data = [r["drops"][i:i + model]
                   for i in range(0, len(r["drops"]), model)]
        assert all(len(set(b)) == 1 for b in by_data), (tag, r)
        assert sum(b[0] for b in by_data) == r["drops_one"], (tag, r)
        if blocks:
            assert [b[0] for b in by_data] == r["drops_by_block"], (tag, r)
        assert not any(r["flips"]), (tag, r["flips"])
    errs[f"{tag} drops"] = [r["drops"] for r in rows]
    errs[f"{tag} flips"] = [r["flips"] for r in rows]
    return errs


def check_moe_mesh(res, shape) -> dict:
    """On ``shape``: float32 and float64, 3 steps each from the same state
    as the one-device step, within ``MOE_TOL``."""
    errs = {}
    for tag in ("f32", "f64"):
        errs.update(check_moe_steps(f"{shape} {tag}", res[shape][tag],
                                    MOE_TOL[tag],
                                    MOE_TOL.get(f"{tag} params"), shape[1]))
    return errs


def check_moe_drops(res, shape) -> dict:
    """Capacity factor 0.5 on ``shape`` (float64): as the one-device step,
    which drops pairs every step, and so does a rank whose data coordinate
    is above 0 (its slots come after those of the ranks before it)."""
    got = res[f"drops {shape}"]
    d, m = shape
    errs = check_moe_steps(f"drops {shape}", got, MOE_TOL["f64"], model=m)
    for r in got["rows"]:
        assert r["drops_one"] > 0 and any(r["drops"][i] > 0
                                          for i in range(m, d * m)), r
    return errs


def check_moe_bytes(res, shape, count=_dry_count, cfg=None) -> dict:
    """The float32 steps' collectives on ``shape``: one pmean a gradient
    leaf and one for the metrics (over data), and the bytes by kind the
    ranks move, summed, equal to the dry run's count of the same cell
    (``count(cfg, shape, mesh)``; ``cfg`` reduced granite-moe-3b-a800m by
    default) times the ranks: the counts' all-gather of each MoE layer
    over data, and the all-reduces less the grad norm's scalar and the
    loss metrics' mean. Returns the bytes a step by kind."""
    from repro_torch.launch.mesh import make_mesh
    d, m = shape
    cfg = cfg or _moe_cfg()
    f32 = res[shape]["f32"]
    steps = len(f32["rows"])
    fwd, _ = f32["counts"]
    assert fwd["pmean"]["calls"] == steps * (f32["leaves"] + 1), fwd
    st = count(cfg, tp_train_shape(), make_mesh(d, m))
    got = {k: v / steps for k, v in by_kind(f32["counts"]).items()}
    want = {k: d * m * v for k, v in st.collective_by_kind.items()}
    # the loss metrics: loss, ce, aux (and mtp) in float32
    want["all-reduce"] = want.get("all-reduce", 0) + norm_bytes(d, m) \
        + metric_bytes(len(f32["rows"][0]["tp"]) - 2, 4, d) * m
    assert set(got) == set(want), (shape, got, want)
    for k in got:
        assert abs(got[k] - want[k]) <= d * m, (shape, k, got, want)
    return got


def check_moe_reference(res) -> dict:
    """The reference's own sharded float32 step on (4,1) and (2,2): loss,
    ce, aux and grad norm within ``tp_reference`` relative."""
    errs = {}
    for shape, r in res["reference"].items():
        errs[f"reference {shape}"] = _rel(r["got"], r["want"],
                                          ("loss", "ce", "aux", "grad_norm"))
        assert errs[f"reference {shape}"] <= TOL["tp_reference"], (shape, r)
    return errs


def check_moe_train(res, count=_dry_count) -> dict:
    """Every check of the MoE train case (the reference's step where it
    ran)."""
    errs = {}
    for shape in MOE_MESHES:
        errs.update(check_moe_mesh(res, shape))
        errs[f"{shape} bytes"] = check_moe_bytes(res, shape, count)
    for shape in ((4, 1), (2, 2)):
        errs.update(check_moe_drops(res, shape))
    for name, m in (("groups", 1), ("vocab257", 4), ("deepseek", 1)):
        errs.update(check_moe_steps(name, res[name], MOE_TOL["f64"],
                                    model=m, blocks=name != "groups"))
    if res["reference"] is not None:
        errs.update(check_moe_reference(res))
    return errs


# -- MLA under the model axis -------------------------------------------------
# (and, after it, the MoE family under FSDP)


def check_mla_mesh(res, shape) -> dict:
    """On ``shape``: float32 and float64, 3 steps each from the same state
    as the one-device step, the metrics (the mtp loss too) within
    ``MOE_TOL``, the parameters after each step within ``MOE_TOL["f64"]``
    in float64. Two float32 gaps are read against what float32 resolves:
    after AdamW's first step the one-device float32 step's own grad norm
    is 3.4e-6 from float64's from the same state (measured on the CPU;
    granite-moe-3b-a800m's 2.6e-8), so each float32 metric is held within
    twice that where it is wider than ``MOE_TOL["f32"]`` (the ranks'
    grad norm there: 2.4e-6 on (1,4)); and float32's parameter gap is
    returned, not held: AdamW's first update, lr g / (|g| + eps) element
    by element, turns the rounding of gradient elements near eps (1e-8 of
    a table whose largest gradient is 3e-3) into gaps of a tenth of lr
    (1.48e-3 on (1,4), 8.4e-4 on (2,2), in the first step; 6.7e-6 and
    1.2e-7 in the next two), which float64 holds at 1e-10."""
    errs = {}
    for tag in ("f32", "f64"):
        errs.update(check_moe_steps(f"mla {shape} {tag}", res[shape][tag],
                                    MOE_TOL[tag], model=shape[1],
                                    hold_params=tag == "f64"))
    return errs


def check_mla_bytes(res, shape, count=_dry_count) -> dict:
    """The float32 steps' bytes by kind, summed over the ranks, equal to
    the dry run's count of reduced deepseek-v3-671b's train cell with
    ``fsdp=False`` on ``shape`` times the ranks (:func:`check_moe_bytes`):
    MLA's all-reduce after ``wo`` and of its three latent cotangents, the
    experts' of the tokens, their gates and the combined output, the
    vocab-split lookups and cross-entropies (the MTP module's too)."""
    return check_moe_bytes(res, shape, count, _mla_cfg())


def check_mla_drops(res) -> dict:
    """Capacity factor 0.5 on (2,2) (float64): as the one-device step,
    which drops pairs every step, each rank's drops those of its data
    coordinate's block of rows."""
    got = res["drops"]
    errs = check_moe_steps("mla drops", got, MOE_TOL["f64"], model=2)
    for r in got["rows"]:
        assert r["drops_one"] > 0 and r["drops"][2] > 0, r
    return errs


def check_mla_train(res, count=_dry_count) -> dict:
    """Every check of the MLA train case (the reference's step where it
    ran)."""
    errs = {}
    for shape in MLA_MESHES:
        errs.update(check_mla_mesh(res, shape))
        errs[f"mla {shape} bytes"] = check_mla_bytes(res, shape, count)
    errs.update(check_mla_drops(res))
    if res["reference"] is not None:
        errs.update(check_moe_reference(res))
    check_tp_ckpt(res)
    return errs


def check_mla_serve_logits(res) -> dict:
    """The process route's prefill and 2 decode steps on (1,4), on the
    rank's blocks, within ``TOL["mla"]`` of the one-device steps and of
    the stacked route's (its lane-local prefill, one ``shard_map`` a
    layer; none on the ranks); every rank holds the latent cache whole."""
    cfg = reduced(get_config("deepseek-v3-671b"))
    outs, counts, cache = res["tp"]
    errs = {route: max(_err(a, b) for a, b in zip(outs, res[route][0]))
            for route in ("one", "stacked")}
    assert max(errs.values()) <= TOL["mla"], errs
    assert cache == res["one"][2], (cache, res["one"][2])
    assert all("shard_map" not in c[0] for c in counts), counts
    assert res["stacked"][1][0][0]["shard_map"]["calls"] == cfg.n_layers
    return errs


def check_mla_serve_bytes(res, count=_dry_count):
    """Per serve step of the process route the bytes summed over the ranks
    equal to the dry run's count ("deepseek-v3-671b prefill 1x4" and
    "decode 1x4" of ``tests/test_torch_dryrun.py``, at the case's 2 x 6
    and float32 parameters) times the ranks, and one all-gather of the
    last position's logits."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_mesh
    # the case's parameters are float32 (the config's are bfloat16): the
    # lookup's all-reduce moves the table's dtype
    cfg = reduced(get_config("deepseek-v3-671b"), param_dtype="float32")
    outs, counts, _ = res["tp"]
    m, b, s = 4, outs[0].shape[0], 6
    gathered = m * (m - 1) * b * (cfg.vocab_size // m) * 4
    for i, c in enumerate(counts):
        kind = "prefill" if i == 0 else "decode"
        st = count(cfg, ShapeConfig(kind, s, b, kind), make_mesh(1, m))
        got = by_kind(c)
        assert got == {"all-reduce": m * st.collective_by_kind["all-reduce"],
                       "all-gather": gathered}, (i, got,
                                                 st.collective_by_kind)


def check_mla_ep_serve(res) -> dict:
    """The prefill at or above a lowered ``DENSE_PATH_MAX_TOKENS`` on
    (1,4): each rank runs the expert-parallel route on its block of the
    experts (its ``all_to_all``s counted), within ``TOL["mla"]`` of the
    stacked route's on the global tables."""
    pair = res["ep"]
    err = _err(pair["proc"][0], pair["stacked"][0])
    assert err <= TOL["mla"], err
    for route in ("proc", "stacked"):
        assert pair[route][1][0]["all_to_all"]["calls"] > 0, pair[route][1]
    return {"ep": err}


def check_mla_serve(res, count=_dry_count) -> dict:
    errs = check_mla_serve_logits(res)
    check_mla_serve_bytes(res, count)
    errs.update(check_mla_ep_serve(res))
    return errs


# -- the MoE family under FSDP --------------------------------------------------


def check_mla_fsdp_mesh(res, shape) -> dict:
    """On ``shape``: reduced deepseek-v3-671b as configured under FSDP,
    float32 and float64, 3 steps each from the same state as the
    one-device step, held as :func:`check_mla_mesh` holds the model axis's
    steps: the metrics within ``MOE_TOL`` (float32: or twice what it
    resolves there), the parameters within ``MOE_TOL["f64"]`` in
    float64; no route flipped, the drops equal."""
    errs = {}
    for tag in ("f32", "f64"):
        errs.update(check_moe_steps(f"mla fsdp {shape} {tag}",
                                    res[shape][tag], MOE_TOL[tag],
                                    model=shape[1],
                                    hold_params=tag == "f64"))
    return errs


def check_mla_fsdp_bytes(res, shape, count=_dry_count) -> dict:
    """The float32 steps' bytes on ``shape`` against the dry run's count of
    reduced deepseek-v3-671b's train cell with ``fsdp=True``
    (:func:`check_fsdp_step_bytes`)."""
    return check_fsdp_step_bytes(res[shape]["f32"], _mla_fsdp_cfg(), shape,
                                count)


def check_mla_fsdp_drops(res) -> dict:
    """Capacity factor 0.5 on (2,2) under FSDP (float64): as the one-device
    step, which drops pairs every step, each rank's drops those of its
    data coordinate's block of rows."""
    got = res["drops"]
    errs = check_moe_steps("mla fsdp drops", got, MOE_TOL["f64"], model=2)
    for r in got["rows"]:
        assert r["drops_one"] > 0 and r["drops"][2] > 0, r
    return errs


def check_mla_fsdp_none(res, count=_dry_count) -> dict:
    """One float32 step at ``remat="none"`` on (2,2): every layer under
    ``Fsdp.regather`` (the backward gathers each leaf again from the
    handles the products saved), within ``MOE_TOL["f32"]`` (or twice what
    float32 resolves) of the one-device step; its bytes the count's at
    "none", its reduce-scatters those of the config's "full" and its
    gathers too (the recompute's), but the per-expert counts' all-gather,
    which "full" runs again in the recompute."""
    got = res["none"]
    errs = check_moe_steps("mla fsdp none", got, MOE_TOL["f32"], model=2,
                           hold_params=False)
    cfg = _mla_fsdp_cfg(remat="none")
    per_step = check_fsdp_step_bytes(got, cfg, (2, 2), count)
    full = by_kind(res[2, 2]["f32"]["counts"])
    steps = len(res[2, 2]["f32"]["rows"])
    counts = WORLD * (2 - 1) * cfg.moe.n_experts * 4 * (
        cfg.n_layers - cfg.moe.n_dense_layers)
    assert per_step["reduce-scatter"] == full["reduce-scatter"] / steps \
        and per_step["all-gather"] == full["all-gather"] / steps - counts, (
            per_step, full, counts)
    errs["mla fsdp none bytes"] = per_step
    return errs


def check_granite_fsdp(res, count=_dry_count) -> dict:
    """Reduced granite-moe-3b-a800m with ``fsdp=True`` on (2,2) (4 experts
    padded to 48, the experts' FFN on model, the tied table), float64, 3
    steps within ``MOE_TOL["f64"]`` of the one-device step; its bytes the
    dry run's count's: the padded tables gathered and reduce-scattered on
    their 4 live rows, as the count reads them."""
    got = res["granite"]
    errs = check_moe_steps("granite fsdp", got, MOE_TOL["f64"], model=2)
    errs["granite fsdp bytes"] = check_fsdp_step_bytes(
        got, _moe_cfg(dtype="float64", fsdp=True), (2, 2), count)
    return errs


def check_mla_fsdp(res, count=_dry_count) -> dict:
    """Every check of the MoE-under-FSDP train case (the reference's FSDP
    step where it ran)."""
    errs = {}
    for shape in MLA_FSDP_MESHES:
        errs.update(check_mla_fsdp_mesh(res, shape))
        errs[f"mla fsdp {shape} bytes"] = check_mla_fsdp_bytes(res, shape,
                                                               count)
    errs.update(check_mla_fsdp_drops(res))
    errs.update(check_mla_fsdp_none(res, count))
    check_fsdp_freed(res, _mla_fsdp_cfg(remat="none"))
    errs.update(check_granite_fsdp(res, count))
    if res["reference"] is not None:
        errs.update(check_moe_reference(res))
    check_tp_ckpt(res)
    return errs


def check_mla_fsdp_serve_logits(res) -> dict:
    """The prefill's and 2 absorbed decode steps' logits under FSDP, whole
    on every rank, within ``tp_serve`` of the one-device steps; the
    latent cache of the rank's rows."""
    sv = MLA_FSDP_SERVE
    d = sv["mesh"][0]
    outs, _, cache = res["fsdp"]
    want_outs, _, want_cache = res["one"]
    errs = {"logits": max(_err(a, b) for a, b in zip(outs, want_outs))}
    assert errs["logits"] <= TOL["tp_serve"], errs
    assert [c[1] for c in cache] == [sv["batch"] // d] * 2 and [
        c[1] for c in want_cache] == [sv["batch"]] * 2 and [
            c[2:] for c in cache] == [c[2:] for c in want_cache], (
                cache, want_cache)
    return errs


def check_mla_fsdp_serve_bytes(res, count=_dry_count):
    """Each serve step's bytes by kind summed over the ranks, the prefill's
    and each decode step's: the dry run's count of the same step with
    ``fsdp=True`` (each leaf gathered once, the per-expert counts'
    all-gather, the tensor-parallel all-reduces) times the ranks, and the
    last logits' two all-gathers (:func:`fsdp_logit_bytes`)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_mesh
    cfg = _mla_fsdp_cfg()
    sv = MLA_FSDP_SERVE
    d, m = sv["mesh"]
    b, s = sv["batch"], sv["prompt"]
    for i, c in enumerate(res["fsdp"][1]):
        kind = "prefill" if i == 0 else "decode"
        st = count(cfg, ShapeConfig(kind, s, b, kind), make_mesh(d, m))
        got = by_kind(c)
        want = {k: d * m * v for k, v in st.collective_by_kind.items()}
        want["all-gather"] = want.get("all-gather", 0) + fsdp_logit_bytes(
            cfg, sv["mesh"], b)
        assert set(got) == set(want) and all(
            abs(got[k] - want[k]) <= d * m for k in got), (i, got, want)


def check_mla_fsdp_serve(res, count=_dry_count) -> dict:
    errs = check_mla_fsdp_serve_logits(res)
    check_mla_fsdp_serve_bytes(res, count)
    return errs



# -- the expert-parallel route over processes --------------------------------


def check_held(res, tag) -> float:
    """The held input's output and every rank's gradient of its block
    within ``TOL["local_axes"]`` of the stacked route's (its gradient's
    rows of that block); the counts equal."""
    (y, grads), counts = res[tag]["proc"]
    (y_s, g_s), counts_s = res[tag]["stacked"]
    errs = [_err(y, y_s)] + [_err(g, g_s[2 * m:2 * m + 2]) for m, g in grads]
    assert max(errs) <= TOL["local_axes"], (tag, errs)
    assert counts == counts_s, (tag, counts, counts_s)
    return max(errs)


def check_ep_steps(tag, got, tol, hold_params=True, against64=False) -> dict:
    """``_ep_steps``' rows against the stacked route's step (or, where the
    rows hold ``drops_by_device`` none, the one-device step's): per step
    the loss, ce, aux (mtp where the model has it), grad norm and lr
    within ``tol`` relative (where the rows resolve float32, within twice
    the stacked float32 step's own gap from float64 where that is wider),
    the parameters after it within ``tol`` (with ``hold_params``); no
    route of a rank that the other step did not choose for the same
    tokens; each rank's dropped pairs those of its device there (against
    the one-device step, summed over the ranks, its drops). ``against64``:
    as :func:`_hold_metrics`. Returns the largest gaps and the drops."""
    rows = got["rows"]
    keys = ("loss", "ce", "aux", "grad_norm", "lr") \
        + (("mtp",) if "mtp" in rows[0]["one"] else ())
    errs = {f"{tag} metrics": max(_rel(r["tp"], r["one"], keys)
                                  for r in rows),
            f"{tag} params": max(r["params"] for r in rows)}
    _hold_metrics(tag, rows, keys, tol, against64)
    for r in rows:
        if "drops_by_device" in r:
            assert r["drops"] == r["drops_by_device"], (tag, r)
        assert not any(r["flips"]), (tag, r["flips"])
    assert not hold_params or errs[f"{tag} params"] <= tol, (tag, errs)
    errs[f"{tag} drops"] = [r["drops"] for r in rows]
    return errs


@functools.lru_cache(maxsize=None)
def ep_count(cfg, shape, kind="train", seq=None, batch=None, gate=None,
             grad_accum=1):
    """The dry run's count of ``cfg``'s ``kind`` step (in ``grad_accum``
    micro-batches) on a stacked mesh of ``shape`` at the gate the cases
    lower (``EP_GATE``, or ``gate``); each cell counted once a
    process."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_mesh
    seq, batch = seq or DP["seq_len"], batch or DP["global_batch"]
    with ep_gate(gate or EP_GATE):
        return _dry_count(cfg, ShapeConfig(kind, seq, batch, kind),
                          make_mesh(*shape), grad_accum)


def check_ep_bytes(got, cfg, shape, worlds=1, gate=None, grad_accum=1,
                   ep=True) -> dict:
    """The steps' bytes by kind, summed over the ranks of ``worlds``
    meshes side by side (``pair_mesh``'s two), equal to the dry run's
    count of the same cell times the ranks (:func:`ep_count`, at ``gate``
    and in ``grad_accum`` micro-batches): the body's all-to-alls and each
    re-lay's, forward and backward (and in a checkpoint's recompute); the
    tensor-parallel all-reduces; the gradient means of every padded slot
    (or FSDP's gathers and reduce-scatters); in micro-batches, the batch's
    micro-major all-gathers; beside them the grad norm's scalar and the
    loss metrics' mean. ``ep`` False: a one-hot step's (the count then
    knows its dispatch short). Returns the bytes a step by kind."""
    d, m = shape
    rows = got["rows"]
    steps = len(rows)
    st = ep_count(cfg, shape, gate=gate, grad_accum=grad_accum)
    per_step = {k: v / steps / worlds
                for k, v in by_kind(got["counts"]).items()}
    want = {k: d * m * v for k, v in st.collective_by_kind.items()}
    itemsize = 8 if cfg.param_dtype == "float64" else 4
    n_metrics = len(rows[0]["tp"]) - 2
    extra = fsdp_extra(d, m, n_metrics, itemsize) if cfg.fsdp and d > 1 \
        else norm_bytes(d, m, itemsize) + metric_bytes(n_metrics, itemsize,
                                                       d) * m
    want["all-reduce"] = want.get("all-reduce", 0) + extra
    assert set(per_step) == set(want), (shape, per_step, want)
    for k in per_step:
        assert abs(per_step[k] - want[k]) <= d * m, (shape, k, per_step,
                                                     want)
    assert ("collective: moe one-hot dispatch resharded"
            not in st.count_short) == ep, st.count_short
    return per_step


def ep_cases() -> dict:
    """(config, mesh shape, how many meshes side by side) of each
    ``case_ep_train`` cell."""
    out = {}
    for dt in ("float32", "float64"):
        tag = "f32" if dt == "float32" else "f64"
        out[f"mla (1, 2) {tag}"] = (_mla_cfg(dt), (1, 2), 2)
        out[f"mla (2, 2) {tag}"] = (_mla_fsdp_cfg(dt), (2, 2), 1)
    for shape in EP_GRANITE_MESHES:
        out[f"granite {shape}"] = (_ep_granite_cfg(shape), shape, 1)
    return out


def _ep_rows(res, key):
    name, _, tag = key.rpartition(" ")
    return res[name][tag] if name.startswith("mla") else res[key]


def check_ep_mesh(res, key) -> dict:
    """``ep_cases()``'s cell ``key``: 3 steps against the stacked route's
    step on a mesh of the same shape, float64 within ``MOE_TOL["f64"]``
    (metrics and parameters), float32 by :func:`check_mla_mesh`'s rules
    (metrics within ``MOE_TOL["f32"]`` or twice what float32 resolves;
    parameters not held)."""
    tag = "f32" if key.endswith("f32") else "f64"
    return check_ep_steps(key, _ep_rows(res, key), MOE_TOL[tag],
                          hold_params=tag == "f64")


def check_ep_no_drops(res) -> dict:
    """Capacity factor 16 on (2,2): no pair dropped by either route (the
    capacities asserted: a device sends a lane at most its chunk's pairs,
    an expert receives at most a row a token of each lane's chunk, the
    one group at most a slot a token), so the route's cross-entropy is
    the one-device one-hot step's within ``MOE_TOL["f64"]`` (the aux
    loss, the Switch loss of each device's tokens averaged over the
    devices, is another function of them: not held)."""
    got = res["no drops"]
    cfg = _moe_cfg()
    m, lanes, n = cfg.moe, 2, WORLD
    tokens = DP["seq_len"] * DP["global_batch"]
    chunk = min(tmoe.EP_CHUNK_TOKENS, tokens // n)
    cap_send = max(int(chunk * m.top_k * 16.0 / lanes), m.top_k)
    cap_local = max(int(lanes * cap_send * 2
                        / (m.n_experts_padded // lanes)), 1)
    cap_group = max(int(tokens * m.top_k * 16.0 / m.n_experts), m.top_k)
    assert cap_send >= chunk * m.top_k and cap_local >= lanes * chunk \
        and cap_group >= tokens, (cap_send, cap_local, cap_group)
    errs = {}
    for r in got["rows"]:
        assert r["drops"] == [0] * n and r["drops_one"] == 0, r
        assert not any(r["flips"]), r
        errs["no drops ce"] = _rel(r["tp"], r["one"], ("ce",))
    assert errs["no drops ce"] <= MOE_TOL["f64"], (errs, got["rows"])
    return errs


def check_ep_drops(res) -> dict:
    """Capacity factor 0.5 on (2,2), deepseek-v3-671b as configured,
    float64: every rank drops pairs, each those the stacked route's
    device dropped, within ``MOE_TOL["f64"]``."""
    got = res["drops"]
    errs = check_ep_steps("drops", got, MOE_TOL["f64"])
    for r in got["rows"]:
        assert all(x > 0 for x in r["drops"]), r
    return errs


def check_ep_replicated(res) -> dict:
    """The planted fault (held tables passed as replicated: the other
    lane's experts' gradients summed into each block) is caught: the
    step's gap from the stacked route's exceeds ``MOE_TOL["f64"]``."""
    r = res["replicated"]["rows"][0]
    gap = max(_rel(r["tp"], r["one"], ("grad_norm",)), r["params"])
    assert gap > MOE_TOL["f64"], r
    return {"replicated gap": gap}


def check_ep_reference(res) -> dict:
    """The reference's own sharded float32 step of reduced deepseek-v3-671b
    as configured on its expert-parallel route on (2,2): loss, ce and aux
    within 5e-4 and grad norm within 1e-3 (the reference's own bounds,
    tests/test_torch_mesh.py), three all-to-alls a MoE layer."""
    ref = res["reference"]
    errs = {k: abs(ref["got"][k] - ref["want"][k])
            for k in ("loss", "ce", "aux", "grad_norm")}
    assert max(errs[k] for k in ("loss", "ce", "aux")) < 5e-4, ref
    assert errs["grad_norm"] < 1e-3, ref
    assert ref["all_to_all"] == 3, ref
    return errs


def check_ep_uncounted(res) -> list:
    """The payloads that the counts leave out of one granite (2,2) step,
    on every rank the same: the all-gathers of the EP body's output and
    of its tokens' gradient over model (two a MoE layer) and the
    all-reduce of the router's gradient over model (one a MoE layer)."""
    every = res["uncounted"]
    cfg = _moe_cfg()
    assert all(e == every[0] for e in every), every
    assert every[0]["all_gather"][0] == 2 * cfg.n_layers, every[0]
    assert every[0]["all_reduce"][0] == cfg.n_layers, every[0]
    return every


def check_ep_train(res, count=None) -> dict:
    """Every check of the expert-parallel train case (the reference's step
    where it ran)."""
    errs = {}
    for key, (cfg, shape, worlds) in ep_cases().items():
        errs.update(check_ep_mesh(res, key))
        errs[f"{key} bytes"] = check_ep_bytes(_ep_rows(res, key), cfg, shape,
                                              worlds)
    errs.update(check_ep_no_drops(res))
    errs.update(check_ep_drops(res))
    errs.update(check_ep_replicated(res))
    check_ep_uncounted(res)
    check_tp_ckpt(res)
    if res["reference"] is not None:
        errs.update(check_ep_reference(res))
    return errs


# -- the MoE step in micro-batches over processes -----------------------------


def check_micro_drops(rows, model) -> list:
    """Each rank's dropped pairs in each micro-batch equal to the
    one-device step's drops of its data block of that micro-batch (the
    ranks of a data coordinate route the same tokens). Returns the
    one-device step's drops by micro-batch and block."""
    for r in rows:
        for rank, micro in enumerate(r["drops_micro"]):
            assert micro == [b[rank // model] for b in
                             r["drops_by_block_micro"]], (rank, r)
    return [r["drops_by_block_micro"] for r in rows]


def check_micro_cell(res, key) -> dict:
    """``micro_cells()``'s cell ``key``: 3 steps in ``MICRO``
    micro-batches against the one-device step (one-hot: granite's
    float32 parameters by :func:`check_moe_mesh`'s rule, deepseek's by
    :func:`check_mla_mesh`'s, and the drops of each micro-batch its data
    block's) or the stacked route's step (expert-parallel:
    :func:`check_ep_mesh`'s rules); float64 within ``MOE_TOL["f64"]``. A
    float32 metric is held against the float64 step from the same state
    (``against64``): two micro-batches' sums round more than one step's,
    and the ranks' grad norm of deepseek-v3-671b on the expert-parallel
    route is 8.1e-7 from float64's where the stacked route's is 4.2e-7
    (measured on the CPU), a gap of 1.2e-6 between the two."""
    make, shape, ep = micro_cells()[key]
    mla = make("float32").use_mla
    errs = {}
    for tag in ("f32", "f64"):
        got, tol = res[key][tag], MOE_TOL[tag]
        if ep:
            errs.update(check_ep_steps(f"{key} {tag}", got, tol,
                                       hold_params=tag == "f64",
                                       against64=True))
            continue
        errs.update(check_moe_steps(
            f"{key} {tag}", got, tol, MOE_TOL.get(f"{tag} params"),
            model=shape[1],
            hold_params=tag == "f64" or not mla,
            against64=True))
        errs[f"{key} {tag} micro drops"] = check_micro_drops(got["rows"],
                                                             shape[1])
    return errs


def check_micro_bytes(res, key) -> dict:
    """The float32 steps' bytes by kind of ``micro_cells()``'s cell
    ``key``, summed over the ranks, equal to the dry run's count of the
    same cell in ``MICRO`` micro-batches times the ranks
    (:func:`check_ep_bytes`: each strip's gathers, reduce-scatters,
    dispatch gathers and all-to-alls, the re-lay's all-gathers once, the
    gradient mean once). Returns the bytes a step by kind."""
    make, shape, ep = micro_cells()[key]
    return check_ep_bytes(res[key]["f32"], make("float32"), shape,
                          gate=MICRO_GATE if ep
                          else tmoe.DENSE_PATH_MAX_TOKENS,
                          grad_accum=MICRO, ep=ep)


def check_micro_dropping(res) -> list:
    """Capacity factor 0.5, granite-moe-3b-a800m on (2,2), one float64
    step: within ``MOE_TOL["f64"]`` of the one-device step; each rank's
    drops in each micro-batch those of its data block there, each
    micro-batch dropping pairs."""
    got = res["drops"]
    check_moe_steps("micro drops", got, MOE_TOL["f64"], model=2)
    drops = check_micro_drops(got["rows"], 2)
    assert all(sum(b) > 0 for r in drops for b in r), drops
    return drops


def check_micro_fault(res) -> float:
    """The planted fault (no re-lay: each rank's contiguous strips) is
    caught: its aux or its parameters after the step miss the one-device
    step's by more than ``MOE_TOL["f64"]``."""
    r = res["no relay"]["rows"][0]
    gap = max(_rel(r["tp"], r["one"], ("aux",)), r["params"])
    assert gap > MOE_TOL["f64"], r
    return gap


def check_moe_micro(res, count=None) -> dict:
    """Every check of the micro-batch case."""
    errs = {}
    for key in micro_cells():
        errs.update(check_micro_cell(res, key))
        errs[f"{key} bytes"] = check_micro_bytes(res, key)
    errs["drops"] = check_micro_dropping(res)
    errs["no relay"] = check_micro_fault(res)
    check_tp_ckpt(res, MICRO_CKPT_STEPS)
    return errs


def ep_serve_cfgs() -> dict:
    return {"granite": _moe_cfg(), "mla": _mla_fsdp_cfg()}


def check_ep_serve_logits(res, key) -> float:
    """The process route's prefill (on the expert-parallel route) and
    decode steps' logits, whole on every rank, within ``TOL["tp_serve"]``
    of the stacked route's."""
    outs, _ = res[key]["proc"]
    want, _ = res[key]["stacked"]
    err = max(_err(a, b) for a, b in zip(outs, want))
    assert err <= TOL["tp_serve"], (key, err)
    return err


def check_ep_serve_bytes(res, name, shape):
    """Each serve step's bytes by kind summed over the ranks: the dry
    run's count of the same step at the lowered gate times the ranks (the
    prefill's all-to-alls and re-lay, its tensor-parallel all-reduces and,
    under FSDP, its gathers), beside the last logits' all-gathers. Where
    FSDP is off and ``data > 1`` every rank serves the whole batch (the
    serve steps' batch is global there), so its tensor-parallel
    all-reduces move ``data`` times the count's, which splits the batch
    over data; the expert-parallel body cuts its tokens over every axis,
    so its all-to-alls and its aux loss's mean are the count's. The
    decode steps (the one-hot dispatch, whose group the count splits over
    data too) are held where the ranks' rows are the count's: under FSDP
    or at ``data`` 1."""
    key, (d, m) = f"{name} {shape}", shape
    cfg = ep_serve_cfgs()[name]
    sv = EP_SERVE
    b, s = sv["batch"], sv["prompt"]
    fsdp = cfg.fsdp and d > 1
    logits = fsdp_logit_bytes(cfg, (d, m), b) if fsdp \
        else d * m * 4 * b * cfg.vocab_size * (m - 1) / m
    counts = res[key]["proc"][1]
    for i, c in enumerate(counts if fsdp or d == 1 else counts[:1]):
        kind = "prefill" if i == 0 else "decode"
        st = ep_count(cfg, (d, m), kind, s, b, gate=b * s)
        got = by_kind(c)
        want = {k: d * m * v for k, v in st.collective_by_kind.items()}
        want["all-gather"] = want.get("all-gather", 0) + logits
        if not fsdp and "all-reduce" in want:
            body = d * m * sum(v for k, v in st.top_collectives
                               if k.startswith("all-reduce compat.pmean"))
            want["all-reduce"] = d * (want["all-reduce"] - body) + body
        assert set(got) == set(want) and all(
            abs(got[k] - want[k]) <= d * m for k in got), (key, i, got, want)
        if i == 0:
            assert got["all-to-all"] > 0, (key, got)


def check_ep_serve(res, count=None) -> dict:
    errs = {}
    for shape in EP_GRANITE_MESHES:
        for name in ep_serve_cfgs():
            errs[f"{name} {shape}"] = check_ep_serve_logits(
                res, f"{name} {shape}")
            check_ep_serve_bytes(res, name, shape)
    return errs


# -- the serving engine under FSDP -------------------------------------------


def engine_runs() -> list:
    """The keys of ``case_engine_fsdp``'s engine runs: (arch, mesh, tag)."""
    return [(arch, shape, tag) for arch, shape in ENGINE_FSDP_RUNS
            for tag in (("greedy", "sampled") if shape == (4, 1)
                        else ("greedy",))]


def engine_tokens(run) -> dict:
    """``{uid: tokens}`` of a run on every rank, held equal, every request
    done; their tokens against the one-device engine's on rank 0 (``one``,
    None where there is none) are the caller's."""
    ranks = run["ranks"]
    toks = ranks[0]["tokens"]
    assert all(r["tokens"] == toks for r in ranks), [r["tokens"]
                                                     for r in ranks]
    assert all(set(r["states"].values()) == {"done"} for r in ranks) \
        and len(toks) == ENGINE_FSDP["requests"], [r["states"]
                                                   for r in ranks]
    return toks


def engine_step_bytes(ranks) -> list:
    """Each recorded step of an engine run: ``(kind, shape, mode, bytes by
    kind summed over the ranks)``."""
    out = []
    for i, rec in enumerate(ranks[0]["record"]):
        total = {}
        for r in ranks:
            assert r["record"][i]["kind"] == rec["kind"], i
            for k, v in by_kind((r["record"][i]["counts"], {})).items():
                total[k] = total.get(k, 0) + v
        out.append((rec["kind"], tuple(rec["shape"]), rec["mode"], total))
    return out


def engine_bytes_want(cfg, mesh_shape, kind, shape, count) -> dict:
    """The bytes by kind, summed over the ranks of ``mesh_shape``, that
    an engine step of ``kind`` at ``shape`` moves, from ``count(cfg,
    ShapeConfig)`` (``launch.dryrun.count_step`` on the stacked mesh of
    that shape, a StepStats) of the serve step of the same shape times the
    ranks, where the ranks' step differs from it (ROADMAP Queue C):

    - ``decode`` at (slots, 1): the last logits' all-gathers over model
      and over data (:func:`fsdp_logit_bytes`; the count leaves them
      split);
    - ``prefill`` at (1, prompt): the one prompt replicated over the data
      ranks, so each rank reduces the whole prompt: its tensor-parallel
      all-reduces are the count's at a batch of d prompts (one a data
      rank; the count at batch 1 splits the replicated prompt's
      reductions over the data ranks), and its logits' all-gather over
      model (none over data: every rank holds the prompt's);
    - ``audit`` at (slots,): the lengths' all-gather over data, which no
      serve step has: each rank's ``slots / d`` int32.

    ``cfg``'s stored dtype is the step's compute dtype (the engine's
    gathers move the rung's dtype: its parameters are cast before them),
    the logits' all-gathers in that dtype too."""
    from repro_torch.configs.base import ShapeConfig
    d, m = mesh_shape
    n = d * m
    item = torch_dtype(cfg.compute_dtype).itemsize
    if kind == "audit":
        return {"all-gather": n * (d - 1) * shape[0] // d * 4}
    b, s = shape
    if kind == "decode":
        st = count(cfg, ShapeConfig(kind, ENGINE_FSDP["max_seq"], b, kind))
        want = {k: n * v for k, v in st.collective_by_kind.items()}
        want["all-gather"] = want.get("all-gather", 0) + fsdp_logit_bytes(
            cfg, mesh_shape, b) * item / 4
        return want
    st = count(cfg, ShapeConfig(kind, s, b, kind))
    want = {k: n * v for k, v in st.collective_by_kind.items()}
    want["all-gather"] += n * item * cfg.vocab_size * (m - 1) / m
    if "all-reduce" in want:
        wide = count(cfg, ShapeConfig(kind, s, d, kind))
        want["all-reduce"] = n * wide.collective_by_kind["all-reduce"]
    return want


def _engine_count(cfg, mesh_shape):
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(*mesh_shape)

    @functools.lru_cache(maxsize=None)
    def count(c, shape):
        return _dry_count(c, shape, mesh)
    return count


def check_engine_bytes(run, cfg, mesh_shape, count=None) -> dict:
    """Every recorded step of a run, bytes by kind summed over the ranks,
    equal to :func:`engine_bytes_want` (``count``: the dry run's on the
    host by default); a ``bf16`` rung's decode steps against the count of
    ``cfg`` stored in bfloat16. Returns the bytes of each kind of step
    (the first of each)."""
    count = count or _engine_count(cfg, mesh_shape)
    n = mesh_shape[0] * mesh_shape[1]
    seen = {}
    for kind, shape, mode, got in engine_step_bytes(run["ranks"]):
        c = cfg if mode == "fp32" else dataclasses.replace(
            cfg, param_dtype="bfloat16", compute_dtype="bfloat16")
        want = engine_bytes_want(c, mesh_shape, kind, shape, count)
        assert set(got) == set(want) and all(
            abs(got[k] - want[k]) <= n for k in got), (kind, shape, mode,
                                                        got, want)
        seen.setdefault(f"{kind} {mode} {shape}", got)
    return seen


def check_engine_blocks(run) -> dict:
    """Each rank holds only its blocks: every parameter tree the engine
    keeps (one a compute dtype) of its blocks' shapes, no gathered leaf
    alive before any step nor after the run, and leaves gathered."""
    for r in run["ranks"]:
        assert r["trees"] and all(t == r["blocks"]
                                  for t in r["trees"].values()), r["trees"]
        alive = [s["alive_before"] for s in r["record"]] + [r["alive_end"]]
        assert r["gathered"] > 0 and not any(alive), (r["gathered"], alive)
    return {"gathered": [r["gathered"] for r in run["ranks"]]}


def engine_dispatch_faults(run) -> list:
    """Where a MoE run's dispatches differ from the one-device engine's:
    each prefill's (pairs, kept) on every rank against the one-device
    prefill's (the prompt its own group), each decode's summed over the
    ranks (one group over their rows) against the one-device decode's."""
    one = [rec for rec in run["one"]["record"] if rec["kind"] != "audit"]
    faults = []
    for i, rec in enumerate(one):
        steps = [[x for x in r["record"] if x["kind"] != "audit"][i]
                 for r in run["ranks"]]
        if rec["kind"] == "prefill":
            bad = [s["dispatch"] for s in steps
                   if s["dispatch"] != rec["dispatch"]]
        else:
            summed = [tuple(map(sum, zip(*pairs))) for pairs in zip(
                *[s["dispatch"] for s in steps])]
            bad = [] if summed == rec["dispatch"] else [summed]
        faults += [(i, rec["kind"], rec["dispatch"], b) for b in bad]
    return faults


def engine_drops(run) -> int:
    """The pairs that the one-device engine's prefills dropped."""
    return sum(p - k for rec in run["one"]["record"]
               if rec["kind"] == "prefill" for p, k in rec["dispatch"])


def engine_events(run) -> list:
    """The events of a run, ``(tick, code, slot)``, held equal on every
    rank and to the one-device engine's."""
    ev = [[(e["tick"], e["code"], e.get("slot")) for e in r["events"]]
          for r in run["ranks"] + [run["one"]]]
    assert all(e == ev[0] for e in ev), ev
    return ev[0]
