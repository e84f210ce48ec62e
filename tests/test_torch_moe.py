"""PyTorch port, the mixture-of-experts family: ``repro_torch.models.moe``
function by function and granite-moe-3b-a800m as a whole against the
reference (``repro.models.moe``, ``repro.models.transformer``), on the same
numpy inputs and converted parameters, fp32 on the CPU.

Routing is held exactly (ids equal, the order of tied probabilities
pinned), dispatch and combine exactly on the same ids and gates, outputs
and losses at atol 1e-4, as the dense family's (``test_torch_model.py``).
Parity with the reference keeps the default capacity factor, drops
included; only the port's cached-versus-full check raises it to 8.0, as
the reference's own equivalence test does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduced as jreduced
from repro.models import moe as jmoe
from repro.models.layers import init_params as jinit
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import convert
from repro_torch.configs import get_config as tget, reduced as treduced
from repro_torch.core import compat
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe as tmoe
from repro_torch.models import sharding as tsh
from repro_torch.models import transformer as ttf
from repro_torch.serving import Request, ServingEngine, State

import torch_family_parity as fp

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

ARCH = "granite-moe-3b-a800m"


def _tokens(t_len, d, seed):
    return np.random.RandomState(seed).randn(t_len, d).astype(np.float32)


def test_template_pads_the_expert_table_and_keeps_the_router():
    cj, ct, pj, pt = fp.pair(ARCH)
    m = ct.moe
    assert m.n_experts_padded == 48 and m.n_experts == 4
    tree = pt["layers"]["moe"]
    assert tuple(tree["router"].shape) == (ct.n_layers, ct.d_model, 4)
    assert tuple(tree["w_gate"].shape) == (ct.n_layers, 48, ct.d_model,
                                           m.expert_d_ff)
    assert fp.shapes(tmoe.moe_template(ct)) == fp.shapes(
        jmoe.moe_template(cj))


@pytest.mark.parametrize("seed", [0, 1])
def test_route_matches_reference(seed):
    cj, ct, pj, pt = fp.pair(ARCH)
    x = _tokens(32, ct.d_model, seed)
    w = np.asarray(pj["layers"]["moe"]["router"][0])
    gj, ij, aj = jmoe._route(jnp.asarray(x), jnp.asarray(w), 2, 4)
    gt, it, at = tmoe._route(fp.t(x), fp.t(w), 2, 4)
    assert it.dtype == torch.int32
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    fp.close(gt, gj, atol=1e-6)
    fp.close(at, aj, atol=1e-6)


def test_route_ties_keep_index_order():
    """Integer-valued logits that tie: the top k come in index order, as
    ``jax.lax.top_k`` gives them."""
    x = np.eye(4, dtype=np.float32)
    # token i's logits are row i: ties among experts 1, 3, 4 and 0, 2, ...
    w = np.array([[0, 2, 1, 2, 2, 0],
                  [1, 1, 1, 1, 0, 0],
                  [3, 0, 3, 0, 3, 3],
                  [0, 0, 0, 0, 0, 0]], np.float32)
    gj, ij, aj = jmoe._route(jnp.asarray(x), jnp.asarray(w), 3, 6)
    gt, it, at = tmoe._route(fp.t(x), fp.t(w), 3, 6)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(it.numpy(), [[1, 3, 4], [0, 1, 2],
                                               [0, 2, 4], [0, 1, 2]])
    fp.close(gt, gj, atol=1e-7)
    fp.close(at, aj, atol=1e-6)


@pytest.mark.parametrize("capacity", [2, 3, 16])
def test_dispatch_combine_is_exact(capacity):
    """Equal dispatch and combine on the same ids and gates; capacities 2
    and 3 drop pairs, 16 drops none."""
    r = np.random.RandomState(3)
    sg, k, e = 12, 2, 4
    ids = np.stack([r.choice(e, k, replace=False) for _ in range(sg)]) \
        .astype(np.int32)
    gates = r.rand(sg, k).astype(np.float32)
    dj, cj_ = jmoe._dispatch_combine(jnp.asarray(ids), jnp.asarray(gates),
                                     sg, k, e, capacity)
    dt, ct_ = tmoe._dispatch_combine(fp.t(ids), fp.t(gates), sg, k, e,
                                     capacity)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(ct_.numpy(), np.asarray(cj_))
    kept = float(dt.sum())
    assert (kept < sg * k) == (capacity * e < sg * k), kept


@pytest.mark.parametrize("group_size", [None, 4])
def test_moe_dense_dispatch_matches_reference(group_size):
    """One group of 16 tokens, and four groups of 4 (capacity
    max(int(4*2*1.25/4), 2) = 2 slots an expert a group): drops are
    present in the grouped case, and both stacks drop the same pairs."""
    cj, ct, pj, pt = fp.pair(ARCH)
    x = _tokens(16, ct.d_model, 4)
    p_j = {k: v[0] for k, v in pj["layers"]["moe"].items()}
    p_t = {k: v[0] for k, v in pt["layers"]["moe"].items()}
    yj, aj = jmoe.moe_dense_dispatch(cj, p_j, jnp.asarray(x),
                                     group_size=group_size)
    yt, at = tmoe.moe_dense_dispatch(ct, p_t, fp.t(x), group_size=group_size)
    fp.close(yt, yj)
    fp.close(at, aj, atol=1e-6)
    if group_size == 4:
        _, ids, _ = tmoe._route(fp.t(x), p_t["router"], 2, 4)
        per_group = [np.bincount(g.ravel(), minlength=4)
                     for g in ids.numpy().reshape(4, 8)]
        assert max(c.max() for c in per_group) > 2, per_group   # drops
    with pytest.raises(ValueError, match="whole groups"):
        tmoe.moe_dense_dispatch(ct, p_t, fp.t(x), group_size=5)


def test_moe_block_refuses_a_mesh(monkeypatch):
    """moe_block under a mesh (it refused one before the mesh machinery was
    ported). tests/test_moe.py's EP config (8 experts, top 2, capacity
    factor 16: no token drops on either route) with
    ``DENSE_PATH_MAX_TOKENS`` lowered to its 64 tokens: on a 2 x 4 mesh
    the port takes the expert-parallel route (three all_to_all, one chunk)
    and its output equals the reference's ``moe_block`` on one device (the
    one-hot dispatch) at 1e-5; its aux is the mean of the reference's
    router loss over each device's tokens. A mesh whose lanes do not divide
    granite's 48 padded experts (5 lanes) stays on the dense dispatch,
    bit-equal to no mesh, and ``moe_ep_shard_map`` raises on it."""
    cj = dataclasses.replace(jreduced(jget("deepseek-v3-671b"), mtp_depth=0),
                             d_model=32)
    cj = dataclasses.replace(cj, moe=dataclasses.replace(
        cj.moe, n_experts=8, top_k=2, expert_d_ff=16, capacity_factor=16.0,
        n_shared_experts=0, n_dense_layers=0))
    ct = treduced(tget("deepseek-v3-671b"), mtp_depth=0)
    ct = dataclasses.replace(ct, d_model=32, moe=dataclasses.replace(
        ct.moe, **dataclasses.asdict(cj.moe)))
    p_j = jinit(jmoe.moe_template(cj), jax.random.PRNGKey(0))
    p_t = convert.params_from_numpy(
        {k: np.asarray(v) for k, v in p_j.items()}, device="cpu")
    x = _tokens(64, 32, 7).reshape(1, 64, 32)
    yj, aj = jmoe.moe_block(cj, p_j, jnp.asarray(x))
    monkeypatch.setattr(tmoe, "DENSE_PATH_MAX_TOKENS", 64)
    compat.reset_counts()
    yt, at = tmoe.moe_block(ct, p_t, fp.t(x),
                            tsh.MeshCtx(mesh=make_mesh(2, 4)))
    assert compat.CALLS["all_to_all"] == 3
    fp.close(yt, yj, atol=1e-5)
    # aux is the mean of each device's Switch loss over its 8 tokens
    xs = jnp.asarray(x[0]).reshape(8, 8, 32)
    want = np.mean([float(jmoe._route(xd, p_j["router"], 2, 8)[2])
                    for xd in xs])
    fp.close(at, want, atol=1e-5)
    assert abs(float(at) - float(aj)) < 0.3      # tests/test_moe.py's bound

    _, cg, _, pg = fp.pair(ARCH)
    p_g = {k: v[0] for k, v in pg["layers"]["moe"].items()}
    xg = fp.t(_tokens(60, cg.d_model, 8).reshape(1, 60, cg.d_model))
    ragged = tsh.MeshCtx(mesh=make_mesh(1, 5))
    y5, a5 = tmoe.moe_block(cg, p_g, xg, ragged)
    y0, a0 = tmoe.moe_block(cg, p_g, xg)
    assert torch.equal(y5, y0) and torch.equal(a5, a0)
    with pytest.raises(ValueError, match="does not evenly divide 48"):
        tmoe.moe_ep_shard_map(cg, p_g, xg[0], ragged)


def test_forward_prefill_and_decode_match_reference():
    fp.check_forward_prefill_decode(ARCH)


def test_lm_loss_matches_reference():
    m = fp.check_lm_loss(ARCH)
    assert float(m["aux"]) > 0 and "mtp" not in m


def test_cached_path_equals_the_full_forward():
    fp.check_cached_equals_full(ARCH)


def _requests(cfg, n):
    r = np.random.RandomState(23)
    return [Request(uid=i, prompt=r.randint(0, cfg.vocab_size,
                                            size=4 + 4 * (i % 2))
                    .astype(np.int32), max_new_tokens=3 + (i % 3))
            for i in range(n)]


@pytest.mark.parametrize("arch", [ARCH, "deepseek-v3-671b"])
def test_engine_tokens_equal_the_reference_engine(arch):
    """5 requests through 2 slots on both engines: equal greedy tokens and
    ticks. Every decode step routes both slots, an idle one too, so idle
    slots take expert capacity in both."""
    cj, ct, pj, pt = fp.pair(arch)
    mine = _requests(ct, 5)
    eng = ServingEngine(ct, pt, slots=2, max_seq=32, device="cpu")
    for r in mine:
        assert eng.submit(r) is None
    eng.run_to_completion(100)
    ref = JEngine(cj, pj, slots=2, max_seq=32)
    theirs = _requests(cj, 5)
    for r in theirs:
        assert ref.submit(r) is None
    ref.run_to_completion(100)
    for r, rr in zip(mine, theirs):
        assert r.state == State.DONE, (r.uid, r.state)
        assert r.out_tokens == rr.out_tokens, r.uid
        assert (r.first_token_tick, r.finish_tick) \
            == (rr.first_token_tick, rr.finish_tick)
    assert eng.tick == ref.tick and not eng.events
    assert set(eng.cache) == set(ref.cache)
    # every cache tensor but lengths holds the slots on axis 1
    for key, v in eng.cache.items():
        assert ServingEngine._batch_dim(key) == (0 if key == "lengths"
                                                 else 1)
        assert v.shape[ServingEngine._batch_dim(key)] == 2, key


def test_cache_tensors_are_written_in_place():
    cj, ct, pj, pt = fp.pair(ARCH)
    cache = ttf.init_cache(ct, 2, 8, cache_dtype=torch.float32, device="cpu")
    toks = torch.ones((2, 3), dtype=torch.int32)
    _, aux, new = ttf.forward(ct, pt, toks, cache=cache)
    for key in ("k", "v"):
        assert new[key] is cache[key] and float(new[key].abs().sum()) > 0
    assert new["lengths"].tolist() == [3, 3]
    assert cache["lengths"].tolist() == [0, 0] and float(aux) > 0
