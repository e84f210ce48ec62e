"""PyTorch port, the training slice: ``lm_loss``, AdamW, strip-mining, the
train step, the data pipeline and the trainer against the reference on the
same numpy inputs and the same converted state.

The reference's state is built by its own ``init_params`` / ``adamw.init``
and converted through numpy (``repro_torch.convert``); batches come from
the data pipeline, which both packages compute with numpy alone. Flash
routes forced on run the reference's kernel in interpret mode, so those
cases stay at S <= 64 and 2 layers.
"""
import dataclasses
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduced as jreduced
from repro.core import stripmine as jstrip
from repro.data import pipeline as jdata
from repro.ft.elastic import StragglerMonitor as JMonitor
from repro.models import transformer as jtf
from repro.models.layers import init_params as jinit
from repro.models.sharding import MeshCtx
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.configs import get_config as tget, reduced as treduced
from repro_torch.core import stripmine as tstrip
from repro_torch.data import pipeline as tdata
from repro_torch.launch.mesh import make_mesh
from repro_torch.ft.elastic import StragglerMonitor as TMonitor
from repro_torch.models import transformer as ttf
from repro_torch.models.layers import tree_leaves, value_and_grad
from repro_torch.models.sharding import MeshCtx as MeshCtx_t
from repro_torch.optim import adamw as tadamw
from repro_torch.train import step as tstep
from repro_torch.train.trainer import Trainer, TrainerConfig

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

ARCH = "tinyllama-1.1b"


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _flat_pairs(ttree, jtree, path=""):
    if isinstance(ttree, dict):
        for k in ttree:
            yield from _flat_pairs(ttree[k], jtree[k], f"{path}/{k}")
    else:
        yield path, ttree.detach().float().numpy(), np.asarray(jtree,
                                                                np.float32)


def _assert_trees(ttree, jtree, rtol, atol):
    for path, a, b in _flat_pairs(ttree, jtree):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=path)


def _configs(**over):
    cj = dataclasses.replace(jreduced(jget(ARCH)), **over)
    ct = dataclasses.replace(treduced(tget(ARCH)), **over)
    return cj, ct


def _params(cj):
    pj = jinit(jtf.model_template(cj), jax.random.PRNGKey(0))
    pt = convert.params_from_numpy(_np_tree(pj), device="cpu")
    return pj, pt


def _batch(cfg, b, s, step=0):
    src = jdata.SyntheticLM(jdata.DataConfig(seq_len=s, global_batch=b,
                                             vocab_size=cfg.vocab_size))
    return src.batch(step)


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


def test_schedule_matches_reference():
    cfg_j = jadamw.OptConfig(peak_lr=1e-3, warmup_steps=10, decay_steps=100)
    cfg_t = tadamw.OptConfig(peak_lr=1e-3, warmup_steps=10, decay_steps=100)
    assert dataclasses.asdict(cfg_j) == dataclasses.asdict(cfg_t)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        want = float(jadamw.schedule(cfg_j, jnp.int32(step)))
        got = tadamw.schedule(cfg_t, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6,
                                   err_msg=f"step {step}")
        assert float(tadamw.schedule(cfg_t, step)) == float(got)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(moment_dtype):
    """Three updates from the same state with the same grads, clipping
    active on the first (global norm > clip_norm); a 1-D leaf takes no
    weight decay. fp32 within rtol 1e-6; bf16 moments within one bf16 step
    (both sides round the same fp32 value, which may differ in its last
    bit)."""
    r = np.random.RandomState(1)
    params = {"w": r.randn(6, 5).astype(np.float32),
              "blk": {"g": r.randn(5).astype(np.float32),
                      "u": r.randn(2, 3, 4).astype(np.float32)}}
    cfg_j = jadamw.OptConfig(warmup_steps=2, decay_steps=10, peak_lr=1e-2,
                             moment_dtype=moment_dtype)
    cfg_t = tadamw.OptConfig(**dataclasses.asdict(cfg_j))
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    oj = jadamw.init(cfg_j, pj)
    pt = convert.params_from_numpy(params, device="cpu")
    ot = convert.opt_state_from_numpy(jax.tree_util.tree_map(np.asarray, oj),
                                      device="cpu")
    assert ot["m"]["w"].dtype == (torch.bfloat16 if moment_dtype == "bfloat16"
                                  else torch.float32)
    mom_tol = 2.0 ** -7 if moment_dtype == "bfloat16" else 1e-6
    for i in range(3):
        scale = 3.0 if i == 0 else 0.05
        grads = jax.tree_util.tree_map(
            lambda a: (r.randn(*a.shape) * scale).astype(np.float32), params)
        pj, oj, mj = jadamw.update(cfg_j, jax.tree_util.tree_map(
            jnp.asarray, grads), oj, pj)
        pt, ot, mt = tadamw.update(cfg_t, convert.params_from_numpy(
            grads, device="cpu"), ot, pt)
        assert int(ot["step"]) == int(oj["step"]) == i + 1
        np.testing.assert_allclose(float(mt["lr"]), float(mj["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(mt["grad_norm"]),
                                   float(mj["grad_norm"]), rtol=1e-6)
        _assert_trees(pt, pj, rtol=1e-6, atol=1e-6)
        _assert_trees(ot["m"], oj["m"], rtol=mom_tol, atol=1e-7)
        _assert_trees(ot["v"], oj["v"], rtol=mom_tol, atol=1e-7)
    # the update is in place: the tree that came in is the tree that left
    assert float(torch.abs(pt["w"] - torch.from_numpy(params["w"])).max()) > 0


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_in_slices_is_bit_equal(moment_dtype, monkeypatch):
    """A leaf larger than ``UPDATE_SLICE`` elements is updated in slices
    along its first axis: three updates give the same parameters and
    moments, bit for bit, as whole-leaf updates, for a scalar, a vector
    (no weight decay) and 2-D and 3-D leaves."""
    r = np.random.RandomState(3)
    params = {"s": np.float32(0.7), "b": r.randn(29).astype(np.float32),
              "w": r.randn(13, 5).astype(np.float32),
              "u": r.randn(3, 4, 6).astype(np.float32)}
    grads = [{k: (np.asarray(r.randn(*np.shape(a))) * 0.3).astype(np.float32)
              for k, a in params.items()} for _ in range(3)]
    cfg = tadamw.OptConfig(warmup_steps=1, decay_steps=10, peak_lr=1e-2,
                           moment_dtype=moment_dtype)
    runs = []
    for size in (1 << 25, 7):
        monkeypatch.setattr(tadamw, "UPDATE_SLICE", size)
        pt = convert.params_from_numpy(params, device="cpu")
        ot = tadamw.init(cfg, pt)
        for g in grads:
            pt, ot, _ = tadamw.update(
                cfg, convert.params_from_numpy(g, device="cpu"), ot, pt)
        runs.append((pt, ot["m"], ot["v"]))
    for whole, sliced in zip(*runs):
        for a, b in zip(tree_leaves(whole), tree_leaves(sliced)):
            assert torch.equal(a, b)


def test_global_norm_matches_reference():
    r = np.random.RandomState(2)
    tree = {"a": r.randn(4, 3).astype(np.float32),
            "b": {"c": r.randn(7).astype(np.float32)}}
    want = float(jadamw.global_norm(jax.tree_util.tree_map(jnp.asarray, tree)))
    got = tadamw.global_norm(convert.params_from_numpy(tree, device="cpu"))
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


# ---------------------------------------------------------------------------
# Data, strip-mining, fault tolerance
# ---------------------------------------------------------------------------


def test_synthetic_and_file_batches_identical(tmp_path):
    kw = dict(seq_len=16, global_batch=3, vocab_size=256, seed=5)
    for step in range(3):
        a = jdata.SyntheticLM(jdata.DataConfig(**kw)).batch(step)
        b = tdata.SyntheticLM(tdata.DataConfig(**kw)).batch(step)
        for key in ("tokens", "labels"):
            assert a[key].dtype == b[key].dtype == np.int32
            np.testing.assert_array_equal(a[key], b[key])
    path = tmp_path / "tokens.npy"
    np.save(path, np.random.RandomState(0).randint(0, 256, size=1000))
    a = jdata.make_source(jdata.DataConfig(**kw, path=str(path))).batch(4)
    b = tdata.make_source(tdata.DataConfig(**kw, path=str(path))).batch(4)
    for key in ("tokens", "labels"):
        np.testing.assert_array_equal(a[key], b[key])
    t = tdata.to_device(b, "cpu")
    assert t["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(t["labels"].numpy(), a["labels"])


def test_prefetcher_moves_batches_to_the_device():
    src = tdata.SyntheticLM(tdata.DataConfig(seq_len=8, global_batch=2,
                                             vocab_size=64))
    pf = tdata.Prefetcher(src, start_step=3, depth=2, device="cpu")
    try:
        step, batch = next(iter(pf))
    finally:
        pf.close()
    assert not pf.thread.is_alive()
    assert step == 3 and isinstance(batch["tokens"], torch.Tensor)
    np.testing.assert_array_equal(batch["tokens"].numpy(),
                                  src.batch(3)["tokens"])


def test_stripmine_map_and_fuse_steps():
    x = np.arange(24, dtype=np.float32).reshape(12, 2)
    want = jstrip.stripmine_map(lambda a: a * 2 + a.sum(), jnp.asarray(x), 4)
    got = tstrip.stripmine_map(lambda a: a * 2 + a.sum(), torch.from_numpy(x),
                               4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="strip"):
        tstrip.stripmine_map(lambda a: a, torch.from_numpy(x), 5)

    def step_fn(state, b):
        state = state + b["x"].sum()
        return state, {"s": state, "n": b["x"][0]}
    fused = tstrip.fuse_steps(step_fn, 3)
    state, metrics = fused(torch.tensor(1.0),
                           {"x": torch.arange(6.0).reshape(3, 2)})
    assert float(state) == 1 + 15
    assert metrics["s"].tolist() == [2.0, 7.0, 16.0]
    assert metrics["n"].tolist() == [0.0, 2.0, 4.0]


def test_straggler_monitor_is_a_copy():
    times = [0.1, 0.11, 0.09, 0.1, 0.1, 0.12, 0.1, 0.1, 0.09, 0.1, 0.1, 0.5,
             0.1, 0.1, 2.0]
    mj, mt = JMonitor(min_steps=5), TMonitor(min_steps=5)
    assert [mj.observe(t) for t in times] == [mt.observe(t) for t in times]
    assert mj.flagged == mt.flagged and mt.flagged
    assert mj.median == mt.median


# ---------------------------------------------------------------------------
# Loss, gradients, remat
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flash", ["on", "off"])
def test_lm_loss_and_grads_match_reference(flash):
    cj, ct = _configs(attn_flash=flash)
    pj, pt = _params(cj)
    nb = _batch(cj, 2, 32)
    (lj, mj), gj = jax.value_and_grad(
        lambda p: jtf.lm_loss(cj, p, jax.tree_util.tree_map(jnp.asarray, nb)),
        has_aux=True)(pj)
    (lt, mt), gt = value_and_grad(
        lambda p, b: ttf.lm_loss(ct, p, b))(pt, tdata.to_device(nb, "cpu"))
    np.testing.assert_allclose(float(lt), float(lj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(mt["ce"]), float(mj["ce"]), rtol=0,
                               atol=1e-5)
    assert float(mt["aux"]) == float(mj["aux"]) == 0.0
    _assert_trees(gt, gj, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("remat,block_remat", [
    ("full", "none"), ("dots", "none"), ("dots_no_batch", "none"),
    ("nothing", "none"), ("everything", "none"), ("none", "dots"),
    ("full", "nothing")])
def test_remat_changes_no_value_or_grad(remat, block_remat):
    """Layer-level remat and the per-q-block policy (with a chunk and
    threshold small enough that the model's attention takes the per-q-block
    branch) change memory, never math."""
    base = dict(attn_flash="off", attn_chunk=8, attn_threshold=8)
    cj, ct0 = _configs(**base)
    ct = dataclasses.replace(ct0, remat=remat, attn_block_remat=block_remat)
    _, pt = _params(cj)
    b = tdata.to_device(_batch(cj, 2, 32), "cpu")
    (l0, _), g0 = value_and_grad(lambda p, x: ttf.lm_loss(ct0, p, x))(pt, b)
    (l1, _), g1 = value_and_grad(lambda p, x: ttf.lm_loss(ct, p, x))(pt, b)
    np.testing.assert_allclose(float(l1), float(l0), rtol=0, atol=1e-5)
    for a, b_ in zip(tree_leaves(g1), tree_leaves(g0)):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_bogus_remat_raises():
    _, ct = _configs(remat="bogus")
    _, pt = _params(jreduced(jget(ARCH)))
    b = tdata.to_device(_batch(ct, 1, 8), "cpu")
    with pytest.raises(ValueError, match="checkpoint policy"):
        value_and_grad(lambda p, x: ttf.lm_loss(ct, p, x))(pt, b)


# ---------------------------------------------------------------------------
# Train step, trainer, launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_matches_reference(grad_accum):
    """Three steps of both packages' train steps from the same state on the
    same batches: loss, grad_norm and lr per step, and the final params.

    Adam's first steps move each parameter by about lr * sign(g): with the
    default eps (1e-8) a gradient at rounding-noise level (|g| ~ 1e-7)
    whose sign differs between the two stacks moves a parameter by ~lr in
    opposite directions (seen: 3 of 8192 ``wk`` entries 1.6e-4 apart). An
    eps of 1e-3 keeps such gradients from deciding a step, so the
    comparison sees the port's arithmetic, not that amplified noise."""
    cj, ct = _configs()
    opt_j = jadamw.OptConfig(warmup_steps=2, decay_steps=6, peak_lr=1e-3,
                             eps=1e-3)
    opt_t = tadamw.OptConfig(**dataclasses.asdict(opt_j))
    pj, _ = _params(cj)
    sj = {"params": pj, "opt": jadamw.init(opt_j, pj)}
    st = convert.train_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, sj), device="cpu")
    fj = jax.jit(jstep.make_train_step(cj, opt_j, MeshCtx(mesh=None),
                                       grad_accum=grad_accum).step_fn)
    ft = tstep.make_train_step(ct, opt_t, grad_accum=grad_accum).step_fn
    for i in range(3):
        nb = _batch(cj, 4, 16, step=i)
        sj, mj = fj(sj, jax.tree_util.tree_map(jnp.asarray, nb))
        st, mt = ft(st, tdata.to_device(nb, "cpu"))
        assert set(mt) == set(mj) == {"loss", "ce", "aux", "lr", "grad_norm"}
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                                   rtol=0, atol=1e-5, err_msg=f"step {i}")
        np.testing.assert_allclose(float(mt["grad_norm"]),
                                   float(mj["grad_norm"]), rtol=1e-4,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(float(mt["lr"]), float(mj["lr"]),
                                   rtol=1e-6, err_msg=f"step {i}")
    assert int(st["opt"]["step"]) == 3
    _assert_trees(st["params"], sj["params"], rtol=1e-4, atol=1e-5)


def test_attn_overrides_and_one_device_contract():
    cfg = treduced(tget(ARCH))
    ov = tstep.AttnOverrides(flash="off", chunk=256, block_remat="dots")
    out = tstep.apply_attn_overrides(cfg, ov)
    want = jstep.apply_attn_overrides(jreduced(jget(ARCH)),
                                      jstep.AttnOverrides(**dataclasses.asdict(
                                          ov)))
    assert dataclasses.asdict(out) == dataclasses.asdict(want)
    assert tstep.apply_attn_overrides(cfg, None) is cfg
    bundle = tstep.make_train_step(cfg, tadamw.OptConfig(), attn=ov)
    assert bundle.cfg.attn_block_remat == "dots"
    # no mesh is one device: every spec replicated, as the reference's
    jbundle = jstep.make_train_step(jreduced(jget(ARCH)), jadamw.OptConfig(),
                                    MeshCtx(mesh=None))
    assert _spec_tuples(bundle.state_specs) == _spec_tuples(
        jbundle.state_specs)
    assert _spec_tuples(bundle.batch_specs) == _spec_tuples(
        jbundle.batch_specs)
    # a mesh (held as tensor dimensions) gives the reference's specs, and
    # the trainer its sanitized shardings
    mesh = make_mesh(1, 2)
    tb = tstep.make_train_step(cfg, tadamw.OptConfig(), MeshCtx_t(mesh=mesh))
    jb = jstep.make_train_step(
        jreduced(jget(ARCH)), jadamw.OptConfig(),
        MeshCtx(mesh=SimpleNamespace(axis_names=("data", "model"),
                                     devices=np.empty((1, 2)))))
    assert _spec_tuples(tb.state_specs) == _spec_tuples(jb.state_specs)
    data = tdata.DataConfig(seq_len=8, global_batch=2, vocab_size=256)
    tr = Trainer(cfg, tadamw.OptConfig(), data, TrainerConfig(), mesh=mesh,
                 device="cpu")
    assert tr.ctx.mesh is mesh and tr.ctx.n_lanes == 2
    emb = tr.state_sharding["params"]["embed"]
    assert emb.shard_shape((cfg.vocab_size, cfg.d_model)) == (
        cfg.vocab_size // 2, cfg.d_model)
    assert Trainer(cfg, tadamw.OptConfig(), data, TrainerConfig(),
                   device="cpu").state_sharding is None


def _spec_tuples(tree):
    if isinstance(tree, dict):
        return {k: _spec_tuples(v) for k, v in tree.items()}
    return tuple(tree)


def test_trainer_fuse_steps_equal_single_steps():
    cfg = treduced(tget(ARCH))
    data = tdata.DataConfig(seq_len=16, global_batch=4,
                            vocab_size=cfg.vocab_size)
    opt = tadamw.OptConfig(warmup_steps=1, decay_steps=4, peak_lr=1e-3)
    runs = {}
    for fuse in (1, 2):
        tr = Trainer(cfg, opt, data, TrainerConfig(steps=4, log_every=2,
                                                   fuse_steps=fuse,
                                                   grad_accum=2),
                     device="cpu")
        step, state = tr.run()
        runs[fuse] = (step, state, tr.metrics_log)
    (s1, st1, log1), (s2, st2, log2) = runs[1], runs[2]
    assert s1 == s2 == 4 and [m["step"] for m in log1] == [2, 4]
    assert [m["step"] for m in log2] == [2, 4]
    for m1, m2 in zip(log1, log2):
        for key in ("loss", "ce", "lr", "grad_norm"):
            np.testing.assert_allclose(m2[key], m1[key], rtol=1e-6)
    for a, b in zip(tree_leaves(st1["params"]), tree_leaves(st2["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)
    assert log1[-1]["loss"] < log1[0]["loss"] + 1.0


def _launch_train(arch):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--device", "cpu", "--steps", "3", "--seq-len", "16", "--batch",
         "2", "--arch", arch], capture_output=True, text=True, timeout=300,
        env={**__import__("os").environ,
             "PYTHONPATH": str(__import__("pathlib").Path(__file__)
                               .resolve().parents[1] / "src")})


# one config of each family whose batches are tokens only
@pytest.mark.parametrize("arch", [ARCH, "granite-moe-3b-a800m", "xlstm-1.3b",
                                  "zamba2-7b"])
def test_launch_train_reduced_on_the_cpu_exits_zero(arch):
    res = _launch_train(arch)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "done at step 3" in res.stdout


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b",
                                  "seamless-m4t-medium"])
def test_launch_train_refuses_frontend_families(arch):
    """The launcher's trainer makes tokens only (as the reference's), so
    the vision and encoder-decoder models, which need the frontend's
    embeddings in every batch, stop at the first step with the port's
    ``ValueError`` naming ``frontend_emb``; the reference's launcher
    crashes there with an ``AttributeError`` (``None.astype``)."""
    res = _launch_train(arch)
    assert res.returncode != 0, res.stdout
    assert "ValueError" in res.stderr and "frontend_emb" in res.stderr, \
        res.stderr
    assert "done at step" not in res.stdout


def test_train_state_from_numpy_keeps_moment_dtypes():
    cj, _ = _configs()
    pj, _ = _params(cj)
    opt = jadamw.OptConfig(moment_dtype="bfloat16")
    oj = jadamw.init(opt, pj)
    oj["m"] = jax.tree_util.tree_map(lambda a: a + jnp.bfloat16(0.3), oj["m"])
    st = convert.train_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, {"params": pj, "opt": oj}),
        device="cpu")
    assert st["opt"]["m"]["embed"].dtype == torch.bfloat16
    assert st["params"]["embed"].dtype == torch.float32
    assert st["opt"]["step"].dtype == torch.int32
    _assert_trees(st["opt"]["m"], oj["m"], rtol=0, atol=0)
