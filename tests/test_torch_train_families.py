"""PyTorch port: the train step of every config against the reference.

Three steps of both packages' ``make_train_step`` on every config of
``ARCH_NAMES`` (reduced, fp32, CPU), from one state converted through
numpy, with stub ``frontend_emb`` made by numpy for the vision and
encoder-decoder families (the vision cross gate set to 0.5 in both trees,
``tests/torch_family_parity.py``); the same with ``grad_accum=2`` for the
mixture-of-experts, vision and encoder-decoder families (``aux`` and
``mtp`` under strip-mining, ``frontend_emb`` split along the batch); and
``value_and_grad(lm_loss)`` at init against ``jax.value_and_grad`` for
the four families the serving slice added.

The optimizer is ``tests/test_torch_train.py``'s: AdamW with eps 1e-3, so
that gradient-sign noise at rounding level does not decide a step. Two
configs need more, each measured (``LOOSER``, and the test of each).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES
from repro.data import pipeline as jdata
from repro.models import transformer as jtf
from repro.models.sharding import MeshCtx
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.data import pipeline as tdata
from repro_torch.models import transformer as ttf
from repro_torch.models.layers import tree_leaves, tree_map, value_and_grad
from repro_torch.optim import adamw as tadamw
from repro_torch.train import step as tstep

import torch_family_parity as fp

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

STEPS, B, S = 3, 4, 16
LOSS_ATOL, GNORM_RTOL, LR_RTOL = 1e-5, 1e-4, 1e-6
P_RTOL, P_ATOL = 1e-4, 1e-5
# Per-config figures, from these measurements (CPU, one thread; the
# reference's gap from the port, each step, eps 1e-3 unless noted):
#
# seamless-m4t-medium: grad_norm 2.8e-5, 5.0e-6, 2.6e-4 relative (step 3),
#   parameters 8.9e-5 of their leaf's max. At identical parameters the two
#   gradients are equally far from the port's float64 gradient (step 1,
#   ``enc_layers/ln1``: 2.8e-5 and 4.5e-5 of 0.63), so the step-3 gap is
#   the trajectory's, and it follows Adam's eps: 3.6e-3 at eps 1e-8,
#   2.6e-4 at 1e-3, 6.2e-5 at 1e-1. Adam amplifying noise, not a gradient
#   fault: grad_norm is held to 1e-3 here, the rest as every config.
# xlstm-1.3b: the reference's mLSTM output num / max(|den|, 1e-6) meets a
#   normaliser of 6e-5 .. 3e-4 on these batches, so its gradient (~ 1/den^2)
#   turns float32 rounding into percent-level noise: at the reference's
#   step-2 parameters both float32 grad norms are off the float64 one
#   (89.66 and 89.81 against 90.77; the test below). With eps 1e-3 the
#   step-2 gaps then move the step-3 grad_norm by 4.8e-2; with eps 0.1,
#   which keeps Adam's first steps from amplifying that noise, by 5.3e-6
#   (1.6e-4 at step 2, the float32 noise itself). So this config runs at
#   eps 0.1, grad_norm held to 1e-3.
LOOSER = {"seamless-m4t-medium": {"gnorm_rtol": 1e-3},
          "xlstm-1.3b": {"eps": 0.1, "gnorm_rtol": 1e-3}}
# Gradients at init, of each leaf's largest entry. The vision and
# encoder-decoder stacks' float32 gradients carry ~1e-4 of rounding on both
# sides, measured (CPU, one thread; the port from the reference, then the
# reference and the port from the port's float64 gradient): vision
# ``embed`` 1.3e-4 (1.8e-4 in an earlier reading), 8.3e-5, 2.1e-4;
# seamless ``enc_layers/ln1`` 1.2e-4, 1.5e-4, 4.4e-5. granite-moe and
# deepseek-v3 stay under 2.2e-5. So a leaf may take three times the
# reference's own distance from float64 where that passes GRAD_TOL, but
# never more than GRAD_CEIL, 2.8 times the largest reading: a fault that
# shows alike in both of the port's precisions moves that distance with
# it, and the ceiling is what then fails it.
GRAD_TOL, GRAD_CEIL = 1e-4, 5e-4
FRONTEND = ("llama-3.2-vision-11b", "seamless-m4t-medium")
SERVING_SLICE = ("granite-moe-3b-a800m", "deepseek-v3-671b") + FRONTEND


def _batch(cfg, step, fe):
    """The data pipeline's batch ``step`` (numpy) for both packages, with
    the stub frontend embeddings ``fe`` where the family takes them."""
    nb = jdata.SyntheticLM(jdata.DataConfig(
        seq_len=S, global_batch=B, vocab_size=cfg.vocab_size)).batch(step)
    bj = {k: jnp.asarray(v) for k, v in nb.items()}
    bt = tdata.to_device(nb, "cpu")
    if fe is not None:
        bj["frontend_emb"], bt["frontend_emb"] = fp.j(fe), fp.t(fe)
    return bj, bt


def _pairs(ttree, jtree, path=""):
    if isinstance(ttree, dict):
        assert set(ttree) == set(jtree), path
        for k in sorted(ttree):      # tree_leaves' order
            yield from _pairs(ttree[k], jtree[k], f"{path}/{k}")
    else:
        yield path, ttree.detach().double().numpy(), np.asarray(jtree,
                                                                np.float64)


def _run_both(arch, grad_accum, eps):
    """STEPS train steps of both packages from one converted state; the
    metrics of each step (port, reference) and both final states."""
    cj, ct, pj, _ = fp.pair(arch)
    opt_j = jadamw.OptConfig(warmup_steps=2, decay_steps=6, peak_lr=1e-3,
                             eps=eps)
    opt_t = tadamw.OptConfig(**dataclasses.asdict(opt_j))
    sj = {"params": pj, "opt": jadamw.init(opt_j, pj)}
    st = convert.train_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, sj), device="cpu")
    fj = jax.jit(jstep.make_train_step(cj, opt_j, MeshCtx(mesh=None),
                                       grad_accum=grad_accum).step_fn)
    ft = tstep.make_train_step(ct, opt_t, grad_accum=grad_accum).step_fn
    fe = fp.frontend(cj, b=B)
    metrics = []
    for i in range(STEPS):
        bj, bt = _batch(cj, i, fe)
        sj, mj = fj(sj, bj)
        st, mt = ft(st, bt)
        metrics.append((mt, mj))
    return metrics, st, sj


def _check_run(arch, grad_accum):
    over = LOOSER.get(arch, {})
    metrics, st, sj = _run_both(arch, grad_accum, over.get("eps", 1e-3))
    keys = {"loss", "ce", "aux", "lr", "grad_norm"}
    if arch == "deepseek-v3-671b":
        keys.add("mtp")
    for i, (mt, mj) in enumerate(metrics):
        assert set(mt) == set(mj) == keys, (set(mt), set(mj))
        for k in keys - {"lr", "grad_norm"}:
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=0,
                                       atol=LOSS_ATOL,
                                       err_msg=f"{k} step {i + 1}")
        np.testing.assert_allclose(
            float(mt["grad_norm"]), float(mj["grad_norm"]),
            rtol=over.get("gnorm_rtol", GNORM_RTOL),
            err_msg=f"grad_norm step {i + 1}")
        assert float(mt["grad_norm"]) > 0
        np.testing.assert_allclose(float(mt["lr"]), float(mj["lr"]),
                                   rtol=LR_RTOL, err_msg=f"lr step {i + 1}")
    assert int(st["opt"]["step"]) == int(sj["opt"]["step"]) == STEPS
    for path, a, b in _pairs(st["params"], sj["params"]):
        np.testing.assert_allclose(a, b, rtol=P_RTOL, atol=P_ATOL,
                                   err_msg=path)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_train_step_matches_reference(arch):
    """Every config: loss, ce, aux (and mtp) within 1e-5, grad_norm within
    1e-4 relative (``LOOSER`` where measured), lr, the final parameters."""
    _check_run(arch, grad_accum=1)


@pytest.mark.parametrize("arch", SERVING_SLICE)
def test_grad_accum_matches_reference(arch):
    """``grad_accum=2``: two micro-batches of 2, the frontend embeddings
    split along the batch with the tokens, aux and mtp averaged over the
    strips as the reference's scan averages them."""
    _check_run(arch, grad_accum=2)


@pytest.mark.parametrize("arch", SERVING_SLICE)
def test_grads_at_init_match_reference(arch):
    """``value_and_grad(lm_loss)`` against ``jax.value_and_grad`` on one
    batch at init: the gradient through ``_route``'s stable sort and the
    capacity dispatch, the MTP term, the tanh gate (0.5 in both trees),
    the encoder and the tied embedding. Loss and metrics within 1e-5.
    Each gradient leaf within GRAD_TOL of its largest entry, or within
    three times the reference's own float32 distance from the port's
    float64 gradient where that is larger, but never beyond GRAD_CEIL.
    A leaf that is zero in the reference (the vision ``q_norm``, which
    nothing reads) is zero in the port."""
    cj, ct, pj, pt = fp.pair(arch)
    fe = fp.frontend(cj, b=B)
    bj, bt = _batch(cj, 0, fe)
    (lj, mj), gj = jax.jit(jax.value_and_grad(
        lambda p: jtf.lm_loss(cj, p, bj), has_aux=True))(pj)
    (lt, mt), gt = value_and_grad(
        lambda p, b: ttf.lm_loss(ct, p, b))(pt, bt)
    c64 = dataclasses.replace(ct, compute_dtype="float64")
    b64 = {k: v.double() if v.is_floating_point() else v
           for k, v in bt.items()}
    _, g64 = value_and_grad(lambda p, b: ttf.lm_loss(c64, p, b))(
        tree_map(lambda a: a.double(), pt), b64)
    np.testing.assert_allclose(float(lt), float(lj), rtol=0, atol=LOSS_ATOL)
    assert set(mt) == set(mj)
    for k in mt:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=0,
                                   atol=LOSS_ATOL, err_msg=k)
    leaves = list(zip(_pairs(gt, gj), tree_leaves(g64)))
    assert len(leaves) == len(list(tree_leaves(pt)))
    for (path, a, b), g in leaves:
        assert np.isfinite(a).all(), path
        scale = np.abs(b).max()
        if scale == 0:
            assert not a.any(), path
            continue
        ref_noise = np.abs(b - g.numpy()).max() / scale
        gap = np.abs(a - b).max() / scale
        limit = min(max(GRAD_TOL, 3 * ref_noise), GRAD_CEIL)
        assert gap <= limit, (path, gap, ref_noise)
    if "cross_layers" in gt:
        assert float(gt["cross_layers"]["attn"]["gate"].abs().max()) > 0
    if "mtp" in gt:
        assert float(gt["mtp"]["proj"].abs().max()) > 0


def test_xlstm_float32_gradient_is_as_close_to_float64_as_the_reference():
    """At the reference's own parameters after two steps (eps 1e-3), the
    port's float32 gradient is no further from the port's float64 gradient
    than the reference's float32 gradient is, leaf by leaf (within 2x), and
    the two float32 grad norms lie about equally far from the float64 one:
    the gap that ``LOOSER`` allows for xlstm-1.3b is float32 rounding
    through the normaliser, not the port. Measured: grad norms 89.66
    (port), 89.81 (reference), 90.77 (float64); ``layers/mix/up_proj``
    2.1e-2 and 1.8e-2 off float64 (of 1.44)."""
    arch = "xlstm-1.3b"
    cj, ct, pj, _ = fp.pair(arch)
    opt = jadamw.OptConfig(warmup_steps=2, decay_steps=6, peak_lr=1e-3,
                           eps=1e-3)
    sj = {"params": pj, "opt": jadamw.init(opt, pj)}
    fj = jax.jit(jstep.make_train_step(cj, opt, MeshCtx(mesh=None)).step_fn)
    for i in range(2):
        sj, _ = fj(sj, _batch(cj, i, None)[0])
    bj, bt = _batch(cj, 2, None)
    _, gj = jax.jit(jax.value_and_grad(lambda p: jtf.lm_loss(cj, p, bj),
                                       has_aux=True))(sj["params"])
    pt = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, sj["params"]), device="cpu")
    _, g32 = value_and_grad(lambda p, b: ttf.lm_loss(ct, p, b))(pt, bt)
    c64 = dataclasses.replace(ct, compute_dtype="float64")
    _, g64 = value_and_grad(lambda p, b: ttf.lm_loss(c64, p, b))(
        tree_map(lambda a: a.double(), pt), bt)

    def norm(tree):
        return float(np.sqrt(sum((np.asarray(x, np.float64) ** 2).sum()
                                 for x in tree)))
    n64 = norm(g.numpy() for g in tree_leaves(g64))
    n32 = norm(g.double().numpy() for g in tree_leaves(g32))
    nj = norm(jax.tree_util.tree_leaves(gj))
    assert abs(n32 - n64) <= 2 * abs(nj - n64), (n32, nj, n64)
    assert abs(n32 - nj) <= 2 * abs(nj - n64), (n32, nj, n64)
    for (path, a, b), g in zip(_pairs(g32, gj), tree_leaves(g64)):
        want = g.numpy()
        ref_gap = np.abs(b - want).max()
        assert np.abs(a - want).max() <= 2 * ref_gap + 1e-7, (
            path, np.abs(a - want).max(), ref_gap)
