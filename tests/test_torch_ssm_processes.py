"""PyTorch port, the SSM and hybrid blocks under the model axis over
processes: reduced xlstm-1.3b (mLSTM) and zamba2-7b (Mamba2 with its shared
attention block) tensor-parallel on 4 gloo ranks on the CPU, in float64.

One module fixture spawns 4 gloo ranks for this file's case alone
(``tests/torch_process_cases.py::case_ssm_tp``; the spawns of
``tests/test_torch_processes.py`` and ``tests/test_torch_engine_processes.py``
are others, so that ``--dist loadfile`` runs them on different workers).
Both models start from the reference's init (``repro.models.layers.
init_params``), converted through ``repro_torch.convert``. Held: one train
step on (1,4) and (2,2) and one in 2 micro-batches on (2,2) against the
port's one-device step (loss, ce, grad norm and lr relative, the
parameters after the step absolute, each to 1e-10; every rank's blocks of
the reference's shard shapes) and against the reference's one-device step
in the same process; the prefill of 8 prompts of 16 tokens and 2 decode
steps on (1,4), logits and every rank's cache of its heads against the
one-device steps to 1e-10; the ``ServingEngine`` on (1,4) emitting the
one-device engine's tokens on every rank; the bytes by kind of each
step, summed over the ranks, equal to the dry run's count
(``launch/dryrun.py::count_step``); and two planted faults (the split norm
without its all-reduce, Mamba2's conv weights read from the contiguous
block) failing the parity.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_process_cases as pc
from repro.configs import get_config as jget, reduced as jreduced
from repro.models import transformer as jtf
from repro.models.layers import init_params as jinit
from repro.models.sharding import MeshCtx as JMeshCtx
from repro.optim import adamw as jadamw
from repro.train import step as jstep

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

# the guard of this file's spawn (it takes ~10 s alone)
SPAWN_TIMEOUT_S = 400.0
ARCHS = pc.SSM_TP["archs"]
STEPS = [(a, t) for a in ARCHS for t in pc.SSM_TP["meshes"] + ("accum",)]


def _jcfg(arch, dtype):
    kw = {"n_layers": 4} if arch == "zamba2-7b" else {}
    return jreduced(jget(arch), fsdp=False, param_dtype=dtype,
                    compute_dtype=dtype, **kw)


def _reference(arrays):
    """The reference's one-device float64 step of each arch from its init
    (``arrays``) on the cases' batch, x64 on in this block alone: the
    metrics and the parameters after it."""
    out = {}
    with jax.enable_x64(True):
        for arch in ARCHS:
            cfg = _jcfg(arch, "float64")
            params = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), arrays[arch])
            batch = {k: jnp.asarray(v.numpy().astype(np.int32))
                     for k, v in pc.ssm_tp_batch(pc.ssm_tp_cfg(arch)).items()}
            o = pc.ssm_tp_opt()
            opt = jadamw.OptConfig(peak_lr=o.peak_lr,
                                   warmup_steps=o.warmup_steps,
                                   decay_steps=o.decay_steps)
            step = jstep.make_train_step(cfg, opt, JMeshCtx(mesh=None))
            state, m = jax.jit(step.step_fn)(
                {"params": params, "opt": jadamw.init(opt, params)}, batch)
            out[arch] = {
                "metrics": {k: float(v) for k, v in m.items()},
                "params": jax.tree_util.tree_map(
                    lambda a: torch.from_numpy(np.array(a)),
                    state["params"])}
    return out


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ssm_processes"))
    arrays = {arch: jax.tree_util.tree_map(
        np.asarray, jinit(jtf.model_template(_jcfg(arch, "float32")),
                          jax.random.PRNGKey(0))) for arch in ARCHS}
    torch.save(arrays, os.path.join(out, pc.REFERENCE_SSM))
    res = pc.spawn(out, cases=pc.SSM_TP_CASES,
                   timeout_s=SPAWN_TIMEOUT_S)["ssm_tp"]
    return res, _reference(arrays)


@pytest.fixture(scope="module")
def res(spawned):
    return spawned[0]


def _step_id(key):
    arch, tag = key
    return f"{arch}-{tag if isinstance(tag, str) else '%dx%d' % tag}"


@pytest.mark.parametrize("key", STEPS, ids=_step_id)
def test_ssm_step_matches_the_one_device_step(res, key):
    """One step from the reference's init: loss, ce, grad norm and lr
    within 1e-10 relative, the parameters after it within 1e-10, of the
    one-device step (in as many micro-batches); each rank's blocks of the
    reference's shard shapes."""
    pc.check_ssm_step(res, *key)


@pytest.mark.parametrize("key", STEPS, ids=_step_id)
def test_ssm_step_bytes_equal_the_dry_runs_count(res, key):
    """The bytes by kind, summed over the ranks, equal to ``count_step``'s
    for the cell times the ranks (the all-reduces less the grad norm's
    scalar and the loss metrics' mean), and the count short of nothing."""
    got = pc.check_ssm_bytes(res, *key)
    assert set(got) == {"all-gather", "reduce-scatter", "all-reduce"}


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_step_matches_the_references_one_device_step(spawned, arch):
    """The ranks' step on (1,4) against the reference's one-device step on
    the same init and batch in float64: loss, ce, grad norm and lr within
    1e-10 relative, or within twice the gap of the port's own one-device
    step to the reference's where that is wider (the reference runs its
    SSM chunk loop's states and products, and the shared block's attention
    scores, in float32 whatever its compute dtype: that gap is its float32
    rounding, the model axis aside); the parameters likewise, absolute."""
    res, ref = spawned
    r = res[arch]
    gap = pc.ssm_step_errs(r["one"], ref[arch])
    got = pc.ssm_step_errs(r[1, 4], ref[arch])
    for k in got:
        assert got[k] <= max(pc.TOL["tp_f64"], 2 * gap[k]), (arch, k, got,
                                                              gap)


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_serve_steps_match_the_one_device_steps(res, arch):
    """The prefill and 2 decode steps on (1,4): logits, whole on every
    rank, and every rank's cache of its heads (``conv``, ``ssm`` and
    zamba2-7b's ``attn_k`` / ``attn_v``) within 1e-10 of the one-device
    steps'; each step's bytes the dry run's count beside the logits'
    gather."""
    pc.check_ssm_serve(res, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_engine_emits_the_one_device_engines_tokens(res, arch):
    pc.check_ssm_engine(res, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_planted_fault_fails_the_parity(res, arch):
    """xlstm-1.3b's norm over the rank's block alone (its sum of squares
    not all-reduced) and zamba2-7b's conv weights of the rank's x channels
    read from its contiguous block of the reference's layout: each step
    lies far outside the parity the ranks hold."""
    pc.check_ssm_fault(res, arch)
