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

import dataclasses
import os
import time

import numpy as np
import torch
import torch.multiprocessing as mp

from repro_torch.configs import get_config, reduced
from repro_torch.core import chaining, compat
from repro_torch.core.compat import PartitionSpec as PS
from repro_torch.core.staging import Mesh
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.mesh import make_process_mesh
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.models.layers import init_params, tree_leaves, tree_map
from repro_torch.models.sharding import MeshCtx
from repro_torch.optim import adamw
from repro_torch.optim.compression import compressed_psum
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
       "dp_f32": 1e-5, "dp_f64": 1e-10}
CASES = ("collectives", "chaining", "compression", "pipeline", "moe_ep",
         "mla", "local_axes", "dp_train", "refusals")


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
          timeout_s: float = 300.0) -> dict:
    """Run ``cases`` in ``world`` spawned gloo ranks; rank 0's results."""
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
    """Reduced deepseek-v3-671b's serve steps on (1,4): the prefill's
    lane-local MLA route and two absorbed decode steps."""
    cfg = reduced(get_config("deepseek-v3-671b"))
    params = init_params(ttf.model_template(cfg),
                         torch.Generator().manual_seed(0), device="cpu")
    r = np.random.RandomState(3)
    toks = torch.from_numpy(r.randint(0, cfg.vocab_size, size=(2, 6)))
    steps = [torch.from_numpy(r.randint(0, cfg.vocab_size, size=(2, 1)))
             for _ in range(2)]

    def run(mesh):
        ctx = MeshCtx(mesh=mesh, batch_axes=("data",))
        with torch.no_grad():
            logits, cache = tstep.make_prefill_step(cfg, ctx, 16)(
                params, {"tokens": toks})
            outs = [logits]
            dec = tstep.make_decode_step(cfg, ctx)
            for tok in steps:
                logits, cache = dec(params, cache, {"tokens": tok})
                outs.append(logits)
        ttf.forward(cfg, params, toks[:, :1])     # resets the mesh context
        return tuple(outs)
    return {"mla": _both(rank, meshes[1, 4], run)}


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


def _dp_run(cfg, mesh, tmp, ckpt_every=0, steps=DP["steps"]):
    data = DataConfig(seq_len=DP["seq_len"], global_batch=DP["global_batch"],
                      vocab_size=cfg.vocab_size)
    opt = adamw.OptConfig(peak_lr=1e-2, warmup_steps=1, decay_steps=steps)
    tcfg = TrainerConfig(steps=steps, log_every=1, ckpt_dir=tmp,
                         ckpt_every=ckpt_every or 50)
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
    text("model", NotImplementedError, lambda: tstep.make_train_step(
        cfg, adamw.OptConfig(), MeshCtx(mesh=meshes[2, 2])))
    text("fsdp", NotImplementedError, lambda: tstep.make_train_step(
        dataclasses.replace(cfg, fsdp=True), adamw.OptConfig(),
        MeshCtx(mesh=meshes[4, 1])))
    text("moe", NotImplementedError, lambda: tstep.make_train_step(
        reduced(get_config("granite-moe-3b-a800m")), adamw.OptConfig(),
        MeshCtx(mesh=meshes[4, 1])))
    text("outside", RuntimeError, lambda: compat.psum(torch.ones(2), "data"))
    text("backend", RuntimeError,
         lambda: make_process_mesh(4, 1, device="cuda"))
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
        "model": "tensor parallelism over processes",
        "fsdp": "FSDP over processes",
        "moe": "the MoE train step over processes",
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


def metric_bytes(n_metrics: int, itemsize: int, n: int) -> int:
    """The bytes summed over ``n`` ranks of one pmean of the stacked loss
    metrics (a ring all-reduce a rank)."""
    return n * int(round(2 * (n - 1) / n * n_metrics * itemsize))
