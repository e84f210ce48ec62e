"""PyTorch port, Multi-head Latent Attention and deepseek-v3-671b as a
whole: ``repro_torch.models.attention``'s MLA functions against the
reference's (``repro.models.attention``), and the model's forward, prefill,
absorbed decode and ``lm_loss`` (with its MTP term), on the same numpy
inputs and converted parameters, fp32 on the CPU, at atol 1e-4.

The port walks a ragged last chunk of keys as a shorter chunk where the
reference pads it with invalid keys; both add nothing for those keys. The
absorbed decode sums in another order than the expanded form: it is held
to the reference's absorbed decode at 1e-4, and to the port's own
no-cache forward at 1e-3, the reference's tolerance for that check.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models.sharding import MeshCtx
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.train import step as jstep
from repro_torch.core import compat
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention as tattn
from repro_torch.models import sharding as tsh
from repro_torch.serving import Request, ServingEngine
from repro_torch.models import transformer as ttf
from repro_torch.train import step as tstep

import torch_family_parity as fp

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

ARCH = "deepseek-v3-671b"


def _mla_inputs(ct, b, s, t_len, seed):
    m = ct.mla
    r = np.random.RandomState(seed)

    def f(*shape):
        return r.randn(*shape).astype(np.float32)
    return (f(b, s, ct.n_heads, m.qk_nope_head_dim),
            f(b, s, ct.n_heads, m.qk_rope_head_dim),
            f(b, t_len, m.kv_lora_rank), f(b, t_len, m.qk_rope_head_dim),
            0.3 * f(m.kv_lora_rank, ct.n_heads,
                    m.qk_nope_head_dim + m.v_head_dim))


def test_template_matches_reference():
    cj, ct, pj, pt = fp.pair(ARCH)
    assert fp.shapes(tattn.mla_template(ct)) == fp.shapes(
        jattn.mla_template(cj))
    assert set(pt) == {"embed", "unembed", "final_norm", "dense_layers",
                       "layers", "mtp"}
    assert "wkv_b" in pt["layers"]["attn"] and "shared" in \
        pt["layers"]["moe"]


@pytest.mark.parametrize("t_len,chunk", [(7, 3), (9, 4), (5, 8)])
def test_mla_chunked_with_a_ragged_last_chunk(t_len, chunk):
    """Keys in chunks of ``chunk`` with a shorter last one (and one chunk
    larger than the keys), causal by position and partly invalid: batch
    row 1 has no valid key at all, so its rows are dead and output 0."""
    cj, ct, pj, pt = fp.pair(ARCH)
    qn, qr, ckv, ckr, wkv = _mla_inputs(ct, 2, 4, t_len, 0)
    q_pos = np.array([[0, 2, 4, 6], [1, 3, 5, 6]], np.int32)
    valid = np.ones((2, t_len), bool)
    valid[0, 1] = False
    valid[1] = False
    args = (qn, qr, ckv, ckr, wkv, q_pos, valid)
    want = jattn._mla_chunked(cj, *map(jnp.asarray, args), chunk=chunk)
    got = tattn._mla_chunked(ct, *map(fp.t, args), chunk=chunk)
    fp.close(got, want)
    assert float(got[1].abs().max()) == 0.0
    # the dispatcher takes the same path with no mesh
    fp.close(tattn.mla_chunked(ct, *map(fp.t, args), chunk=chunk,
                               lane_local=True), want)


def test_mla_triangular_runs_the_q_block_loop():
    """S = 16 in chunks of 4: four q blocks, each against its causal prefix
    of keys; the same as one mla_chunked call over all keys."""
    cj, ct, pj, pt = fp.pair(ARCH)
    qn, qr, ckv, ckr, wkv = _mla_inputs(ct, 2, 16, 16, 1)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    args = (qn, qr, ckv, ckr, wkv, pos)
    want = jattn._mla_triangular(cj, *map(jnp.asarray, args), chunk=4)
    got = tattn._mla_triangular(ct, *map(fp.t, args), chunk=4)
    fp.close(got, want)
    whole = tattn.mla_chunked(ct, *map(fp.t, args),
                              torch.ones((2, 16), dtype=torch.bool), chunk=4)
    fp.close(got, whole, atol=1e-5)


def _layer0(tree):
    return {k: v[0] for k, v in tree.items()}


def test_absorbed_decode_matches_reference_and_the_expanded_form():
    """One attention layer: a prefill of 5 tokens, then one token through
    the absorbed form, against the reference's absorbed decode and against
    the expanded no-cache form over all 6 tokens."""
    cj, ct, pj, pt = fp.pair(ARCH)
    pa_j, pa_t = _layer0(pj["layers"]["attn"]), _layer0(pt["layers"]["attn"])
    x = np.random.RandomState(2).randn(2, 6, ct.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6))
    m = ct.mla
    cache_np = {"c_kv": np.zeros((2, 8, m.kv_lora_rank), np.float32),
                "k_rope": np.zeros((2, 8, m.qk_rope_head_dim), np.float32),
                "lengths": np.zeros(2, np.int32)}
    cache_j = {k: jnp.asarray(v) for k, v in cache_np.items()}
    cache_t = {k: fp.t(v) for k, v in cache_np.items()}
    _, cj_ = jattn.mla_attention(cj, pa_j, jnp.asarray(x[:, :5]),
                                 jnp.asarray(pos[:, :5]), cache=cache_j)
    _, ct_ = tattn.mla_attention(ct, pa_t, fp.t(x[:, :5]), fp.t(pos[:, :5]),
                                 cache=cache_t)
    assert ct_["c_kv"] is cache_t["c_kv"]           # written in place
    for key in ("c_kv", "k_rope"):
        fp.close(ct_[key], cj_[key])
    lengths = np.full(2, 5, np.int32)
    oj, _ = jattn.mla_attention(
        cj, pa_j, jnp.asarray(x[:, 5:]), jnp.asarray(pos[:, 5:]),
        cache=dict(cj_, lengths=jnp.asarray(lengths)))
    ot, _ = tattn.mla_attention(
        ct, pa_t, fp.t(x[:, 5:]), fp.t(pos[:, 5:]),
        cache=dict(ct_, lengths=fp.t(lengths)))
    fp.close(ot, oj)
    full, _ = tattn.mla_attention(ct, pa_t, fp.t(x), fp.t(pos))
    fp.close(ot[:, 0], full[:, 5], atol=1e-3)


@pytest.mark.parametrize("hint", [False, True])
def test_prefill_step_matches_reference(hint, monkeypatch):
    """The serve steps, bfloat16 caches as the reference's defaults: a
    prompt of 16 tokens into a cache of 18 rows and two decode steps; and
    into a cache of 16 rows, which the prompt fills, so that the from-zero
    hint takes the triangular form in every MLA layer."""
    cj, ct, pj, pt = fp.pair(ARCH)
    calls = []
    tri = tattn._mla_triangular
    monkeypatch.setattr(tattn, "_mla_triangular",
                        lambda *a, **k: calls.append(1) or tri(*a, **k))
    r = np.random.RandomState(4)
    toks = r.randint(0, cj.vocab_size, size=(2, 16)).astype(np.int32)
    jpre = jstep.make_prefill_step(cj, MeshCtx(mesh=None), 18)
    tpre = tstep.make_prefill_step(ct, None, 18)
    if hint:                  # the prompt fills the cache: triangular walk
        jpre = jstep.make_prefill_step(cj, MeshCtx(mesh=None), 16)
        tpre = tstep.make_prefill_step(ct, None, 16)
    lj, cache_j = jpre(pj, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        lt, cache_t = tpre(pt, {"tokens": fp.t(toks)})
    assert cache_t["c_kv"].dtype == torch.bfloat16
    assert not ttf._PREFILL_FROM_ZERO          # cleared after the step
    assert len(calls) == (ct.n_layers if hint else 0)
    fp.close(lt, lj)
    if hint:
        return
    jdec = jstep.make_decode_step(cj, MeshCtx(mesh=None))
    tdec = tstep.make_decode_step(ct)
    for _ in range(2):
        tok = r.randint(0, cj.vocab_size, size=(2, 1)).astype(np.int32)
        lj, cache_j = jdec(pj, cache_j, {"tokens": jnp.asarray(tok)})
        with torch.no_grad():
            lt, cache_t = tdec(pt, cache_t, {"tokens": fp.t(tok)})
        fp.close(lt, lj)


def test_serve_steps_refuse_a_mesh():
    """The serve steps under a mesh (they refused one before the mesh
    machinery was ported): on a 1 x 2 mesh held as tensor dimensions the
    port's prefill runs MLA's lane-local route, one ``shard_map`` a layer,
    and its logits and two decode steps' equal the reference's serve steps
    on its one-device mesh, where the same route runs on one lane.
    ``max_seq < 1`` still raises."""
    cj, ct, pj, pt = fp.pair(ARCH)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                              ("data", "model"))
    jctx = MeshCtx(mesh=jmesh)
    tctx = tsh.MeshCtx(mesh=make_mesh(1, 2))
    r = np.random.RandomState(13)
    toks = r.randint(0, cj.vocab_size, size=(2, 6)).astype(np.int32)
    try:
        lj, cache_j = jstep.make_prefill_step(cj, jctx, fp.SMAX)(
            pj, {"tokens": jnp.asarray(toks)})
        compat.reset_counts()
        with torch.no_grad():
            lt, cache_t = tstep.make_prefill_step(ct, tctx, fp.SMAX)(
                pt, {"tokens": fp.t(toks)})
        assert compat.CALLS["shard_map"] == ct.n_layers
        fp.close(lt, lj)
        jdec, tdec = jstep.make_decode_step(cj, jctx), \
            tstep.make_decode_step(ct, tctx)
        for _ in range(2):
            tok = r.randint(0, cj.vocab_size, size=(2, 1)).astype(np.int32)
            lj, cache_j = jdec(pj, cache_j, {"tokens": jnp.asarray(tok)})
            with torch.no_grad():
                lt, cache_t = tdec(pt, cache_t, {"tokens": fp.t(tok)})
            fp.close(lt, lj)
    finally:
        jattn.set_mesh_ctx(None)
        tattn.set_mesh_ctx(None)
    with pytest.raises(ValueError, match="max_seq"):
        tstep.make_prefill_step(ct, None, 0)


def test_engine_with_a_mesh_equals_the_reference_engine_with_one():
    """``ServingEngine(ctx=)``: the port's engine on a 1 x 2 mesh (each
    prefill's MLA lane-local, one ``shard_map`` a layer) and the
    reference's on its one-device mesh (its mesh prefill and decode)
    give 4 requests through 2 slots the same greedy tokens and ticks."""
    cj, ct, pj, pt = fp.pair(ARCH)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                              ("data", "model"))
    r = np.random.RandomState(29)
    prompts = [r.randint(0, cj.vocab_size, size=4 + 2 * i).astype(np.int32)
               for i in range(4)]
    runs = []
    try:
        for make, req in (
                (lambda: JEngine(cj, pj, slots=2, max_seq=32,
                                 ctx=MeshCtx(mesh=jmesh)), JRequest),
                (lambda: ServingEngine(ct, pt, slots=2, max_seq=32,
                                       ctx=tsh.MeshCtx(mesh=make_mesh(1, 2)),
                                       device="cpu"), Request)):
            eng = make()
            reqs = [req(uid=i, prompt=p, max_new_tokens=3 + i % 2)
                    for i, p in enumerate(prompts)]
            for q in reqs:
                assert eng.submit(q) is None
            compat.reset_counts()
            eng.run_to_completion(100)
            runs.append([(q.out_tokens, q.first_token_tick, q.finish_tick)
                         for q in reqs])
        assert compat.CALLS["shard_map"] == ct.n_layers * len(prompts)
        assert runs[0] == runs[1]
    finally:
        jattn.set_mesh_ctx(None)
        tattn.set_mesh_ctx(None)


def test_forward_prefill_and_decode_match_reference():
    fp.check_forward_prefill_decode(ARCH)


def test_lm_loss_and_mtp_match_reference():
    m = fp.check_lm_loss(ARCH)
    assert float(m["mtp"]) > 0 and float(m["aux"]) > 0


def test_cached_path_equals_the_full_forward():
    fp.check_cached_equals_full(ARCH)
