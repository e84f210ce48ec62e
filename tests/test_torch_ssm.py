"""PyTorch port, the SSM and hybrid model families: ``repro_torch.models.
ssm`` and the ``ssm`` / ``hybrid`` branches of ``repro_torch.models.
transformer`` against the reference's, on converted parameters, and the
serving engine on both families against the reference's engine.

Inputs are made with numpy from a seed and go through both stacks in fp32
on the CPU. Functions of ``models/ssm.py`` agree to 1e-4; the model's
logits to atol 1e-4, as the dense family's (``test_torch_model.py``);
recurrent states and caches to 1e-4 of their largest entry.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduced as jreduced
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro.models.layers import init_params as jinit
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import convert
from repro_torch.configs import get_config as tget, reduced as treduced
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf
from repro_torch.models.layers import value_and_grad
from repro_torch.serving import Request, ServingEngine, State

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

ATOL = 1e-4
# the families and their reduced configs: zamba2-7b at 5 layers has two
# groups of attn_every = 2 Mamba2 layers and one tail layer
FAMILIES = {"xlstm-1.3b": {}, "zamba2-7b": {"n_layers": 5}}


@functools.lru_cache(maxsize=None)
def _pair(arch):
    kw = FAMILIES[arch]
    cj, ct = jreduced(jget(arch), **kw), treduced(tget(arch), **kw)
    pj = jinit(jtf.model_template(cj), jax.random.PRNGKey(0))
    arrays = jax.tree_util.tree_map(np.asarray, pj)
    return cj, ct, pj, arrays


def _params(arch):
    cj, ct, pj, arrays = _pair(arch)
    return cj, ct, pj, convert.params_from_numpy(arrays, device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL, rel_to_max=False, msg=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    tol = atol * max(1.0, float(np.abs(want).max())) if rel_to_max else atol
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=msg)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def _layer(tree, i):
    return jax.tree_util.tree_map(lambda a: a[i], tree)


# ---------------------------------------------------------------------------
# models/ssm.py, function by function
# ---------------------------------------------------------------------------


def _core_inputs(b, s, h, n, p, seed):
    r = np.random.RandomState(seed)
    return (r.randn(b, s, h, n).astype(np.float32),
            (r.randn(b, s, h, n) * 0.3).astype(np.float32),
            r.randn(b, s, h, p).astype(np.float32),
            (-r.rand(b, s, h) * 0.5).astype(np.float32),
            r.rand(b, s, h).astype(np.float32))


@pytest.mark.parametrize("s,chunk", [(64, 16), (37, 16), (16, 64), (40, 8)])
@pytest.mark.parametrize("with_state", [False, True])
def test_chunked_linear_attention_matches_reference(s, chunk, with_state):
    b, h, n, p = 2, 3, 8, 5
    arrays = _core_inputs(b, s, h, n, p, s + chunk)
    init = None
    if with_state:
        init = np.random.RandomState(1).randn(b, h, n, p).astype(np.float32)
    yj, stj = jssm.chunked_linear_attention(
        *map(jnp.asarray, arrays), chunk=chunk,
        initial_state=None if init is None else jnp.asarray(init))
    yt, stt = tssm.chunked_linear_attention(
        *map(_t, arrays), chunk=chunk,
        initial_state=None if init is None else _t(init))
    assert yt.shape == (b, s, h, p) and stt.shape == (b, h, n, p)
    assert yt.dtype == torch.float32 and stt.dtype == torch.float32
    _close(yt, yj)
    _close(stt, stj, rel_to_max=True)


def _core_grads_jax(arrays, gout, chunk):
    def f(*xs):
        y, st = jssm.chunked_linear_attention(*xs, chunk=chunk)
        return jnp.sum(y * gout) + jnp.sum(st)
    return jax.grad(f, argnums=tuple(range(5)))(*map(jnp.asarray, arrays))


def _core_grads_torch(arrays, gout, chunk, dtype=torch.float32):
    xs = [_t(a).to(dtype).requires_grad_(True) for a in arrays]
    y, st = tssm.chunked_linear_attention(*xs, chunk=chunk)
    (torch.sum(y * _t(gout).to(dtype)) + torch.sum(st)).backward()
    return [x.grad for x in xs]


@pytest.mark.parametrize("decay", [0.5, 1.0])
def test_chunked_linear_attention_grads_where_the_reference_overflows(decay):
    """A chunk of 128 steps whose log decay is -``decay`` a step: above the
    diagonal exp(cd_t - cd_s) reaches exp(127 * decay). At 0.5 (exp(63.5)
    is finite) the port's gradients are the reference's. At 1.0 it
    overflows float32: the reference masks after exp, and its backward
    then multiplies inf by zero, so its gradients are NaN (what training
    zamba2-7b and xlstm-1.3b at full width meets in their first step); the
    port masks the exponent first, so the forward is the reference's and
    the gradients are finite, and equal to the port's float64 ones."""
    b, s, h, n, p, chunk = 1, 128, 2, 4, 3, 128
    q, k, v, _, scale = _core_inputs(b, s, h, n, p, 7)
    log_decay = np.full((b, s, h), -decay, np.float32)
    arrays = (q, k, v, log_decay, scale)
    gout = np.random.RandomState(8).randn(b, s, h, p).astype(np.float32)
    yj, _ = jssm.chunked_linear_attention(*map(jnp.asarray, arrays),
                                          chunk=chunk)
    yt, _ = tssm.chunked_linear_attention(*map(_t, arrays), chunk=chunk)
    _close(yt, yj)
    gj = _core_grads_jax(arrays, gout, chunk)
    gt = _core_grads_torch(arrays, gout, chunk)
    g64 = _core_grads_torch(arrays, gout, chunk, torch.float64)
    for name, a, want, exact in zip("q k v log_decay scale".split(), gt, gj,
                                    g64):
        assert bool(torch.isfinite(a).all()), name
        _close(a, exact.numpy(), atol=1e-4, rel_to_max=True,
               msg=f"{name} against float64")
        if decay == 0.5:
            _close(a, want, atol=1e-4, rel_to_max=True, msg=name)
    if decay == 1.0:
        assert any(bool(np.isnan(np.asarray(g)).any()) for g in gj)


def test_chunked_linear_attention_bf16_inputs_keep_a_float32_state():
    arrays = _core_inputs(1, 24, 2, 4, 6, 3)
    q, k, v = (_t(a).to(torch.bfloat16) for a in arrays[:3])
    yt, stt = tssm.chunked_linear_attention(q, k, v, _t(arrays[3]),
                                            _t(arrays[4]), chunk=8)
    assert yt.dtype == torch.bfloat16 and stt.dtype == torch.float32
    j = [jnp.asarray(a, jnp.bfloat16) for a in arrays[:3]] \
        + [jnp.asarray(a) for a in arrays[3:]]
    yj, stj = jssm.chunked_linear_attention(*j, chunk=8)
    _close(yt.float(), np.asarray(yj, np.float32), atol=2e-2,
           rel_to_max=True)
    _close(stt, stj, atol=1e-3, rel_to_max=True)


def test_linear_attention_step_matches_reference():
    r = np.random.RandomState(4)
    b, h, n, p = 2, 3, 4, 5
    q, k = r.randn(b, h, n).astype(np.float32), r.randn(b, h, n).astype(
        np.float32)
    v = r.randn(b, h, p).astype(np.float32)
    ld, sc = (-r.rand(b, h)).astype(np.float32), r.rand(b, h).astype(
        np.float32)
    st = r.randn(b, h, n, p).astype(np.float32)
    yj, sj = jssm.linear_attention_step(*map(jnp.asarray,
                                             (q, k, v, ld, sc, st)))
    yt, stt = tssm.linear_attention_step(*map(_t, (q, k, v, ld, sc, st)))
    _close(yt, yj)
    _close(stt, sj)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("width", [1, 4])
def test_causal_conv1d_matches_reference(with_state, width):
    r = np.random.RandomState(width)
    x = r.randn(2, 7, 6).astype(np.float32)
    w, bias = r.randn(width, 6).astype(np.float32), r.randn(6).astype(
        np.float32)
    st = r.randn(2, width - 1, 6).astype(np.float32) if with_state else None
    yj, nj = jssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(bias),
                                None if st is None else jnp.asarray(st))
    yt, nt = tssm.causal_conv1d(_t(x), _t(w), _t(bias),
                                None if st is None else _t(st))
    _close(yt, yj)
    assert tuple(nt.shape) == tuple(nj.shape)
    _close(nt, nj)


@pytest.mark.parametrize("arch", list(FAMILIES))
@pytest.mark.parametrize("mode", ["none", "step", "chunk"])
def test_mixing_block_matches_reference(arch, mode):
    """mamba2_block (zamba2-7b) and mlstm_block (xlstm-1.3b) without a
    state, one decode step with a state, and a 21-token chunk with a
    state."""
    cj, ct, pj, pt = _params(arch)
    block_j = jssm.mamba2_block if arch == "zamba2-7b" else jssm.mlstm_block
    block_t = tssm.mamba2_block if arch == "zamba2-7b" else tssm.mlstm_block
    init_j = jssm.mamba2_init_state if arch == "zamba2-7b" \
        else jssm.mlstm_init_state
    init_t = tssm.mamba2_init_state if arch == "zamba2-7b" \
        else tssm.mlstm_init_state
    pj1 = _layer(pj["layers"]["mix"], 1)
    pt1 = {k: v[1] for k, v in pt["layers"]["mix"].items()}
    r = np.random.RandomState(5)
    seq = 1 if mode == "step" else 21
    x = r.randn(2, seq, cj.d_model).astype(np.float32)
    sj = st = None
    if mode != "none":
        sj = init_j(cj, 2)
        st = init_t(ct, 2, device="cpu")
        assert _shapes(st) == _shapes(sj)
        assert st["ssm"].dtype == torch.float32
        # a state that is not zero: random entries of the same shapes
        sj = {k: jnp.asarray(r.randn(*v.shape).astype(np.float32) * 0.5)
              for k, v in sj.items()}
        st = {k: _t(np.asarray(v)) for k, v in sj.items()}
    yj, nj = block_j(cj, pj1, jnp.asarray(x), sj)
    yt, nt = block_t(ct, pt1, _t(x), st)
    _close(yt, yj)
    if mode == "none":
        assert nj is None and nt is None
    else:
        for key in ("conv", "ssm"):
            _close(nt[key], nj[key], rel_to_max=True, msg=key)


# ---------------------------------------------------------------------------
# transformer: templates, conversion, forward with and without a cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_template_and_params_from_numpy_take_the_tree_unchanged(arch):
    cj, ct, pj, pt = _params(arch)
    assert _shapes(pt) == _shapes(pj)
    tmpl = ttf.model_template(ct)
    assert _shapes(jax.tree_util.tree_map(
        lambda p: np.empty(p.shape), tmpl,
        is_leaf=lambda x: not isinstance(x, dict))) == _shapes(pj)
    assert ("shared_attn" in pt) == (arch == "zamba2-7b")
    leaf = pt["layers"]["mix"]["conv_w"]
    np.testing.assert_array_equal(
        leaf.numpy(), np.asarray(pj["layers"]["mix"]["conv_w"]))


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_forward_prefill_and_decode_match_reference(arch):
    cj, ct, pj, pt = _params(arch)
    r = np.random.RandomState(11)
    b, s, smax = 2, 19, 40
    toks = r.randint(0, cj.vocab_size, size=(b, s)).astype(np.int32)

    # full causal forward, no cache
    lj, _, ej = jtf.forward(cj, pj, jnp.asarray(toks))
    lt, aux, et = ttf.forward(ct, pt, torch.from_numpy(toks))
    assert lt.shape == (b, s, cj.vocab_size) and float(aux) == 0.0
    _close(lt, lj)
    _close(et["final_hidden"], ej["final_hidden"])

    # prefill into a fresh cache
    cache_j = jtf.init_cache(cj, b, smax, cache_dtype=jnp.float32)
    cache_t = ttf.init_cache(ct, b, smax, cache_dtype=torch.float32,
                             device="cpu")
    assert _shapes(cache_t) == _shapes(cache_j)
    assert {k: str(v.dtype).replace("torch.", "") for k, v in
            cache_t.items()} == {k: str(v.dtype) for k, v in cache_j.items()}
    lj, _, cache_j = jtf.forward(cj, pj, jnp.asarray(toks), cache=cache_j)
    lt, _, cache_t = ttf.forward(ct, pt, torch.from_numpy(toks),
                                 cache=cache_t)
    _close(lt, lj)

    # three decode steps with per-slot lengths (slot 1 rewound, as a
    # freshly prefilled shorter prompt would leave its KV rows)
    new_len = np.asarray([s, 7], np.int32)
    cache_j = dict(cache_j, lengths=jnp.asarray(new_len))
    cache_t = dict(cache_t, lengths=torch.from_numpy(new_len))
    for step in range(3):
        tok = r.randint(0, cj.vocab_size, size=(b, 1)).astype(np.int32)
        lj, _, cache_j = jtf.forward(cj, pj, jnp.asarray(tok), cache=cache_j)
        lt, _, cache_t = ttf.forward(ct, pt, torch.from_numpy(tok),
                                     cache=cache_t)
        _close(lt, lj, msg=f"decode step {step}")
        assert set(cache_t) == set(cache_j)
        np.testing.assert_array_equal(cache_t["lengths"].numpy(),
                                      np.asarray(cache_j["lengths"]))
        for key in cache_t:
            _close(cache_t[key], cache_j[key], rel_to_max=True,
                   msg=f"{key} step {step}")
    np.testing.assert_array_equal(cache_t["lengths"].numpy(), new_len + 3)


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_cached_forward_writes_the_states_in_place(arch):
    cj, ct, pj, pt = _params(arch)
    cache = ttf.init_cache(ct, 2, 8, cache_dtype=torch.float32, device="cpu")
    before = {k: v for k, v in cache.items()}
    _, _, new = ttf.forward(ct, pt, torch.zeros((2, 3), dtype=torch.int32),
                            cache=cache)
    for key in cache:
        if key == "lengths":
            assert new[key] is not before[key]
            assert before[key].tolist() == [0, 0]
            assert new[key].tolist() == [3, 3]
        else:
            assert new[key] is before[key], key
            assert float(new[key].abs().sum()) > 0, key


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_cached_path_equals_the_full_forward(arch):
    """Prefill then two decode steps give the logits of the full forward
    over the same tokens (the serving oracle's contract), in float64."""
    cj, ct, pj, pt = _params(arch)
    c64 = dataclasses.replace(ct, compute_dtype="float64")
    p64 = convert.params_from_numpy(_pair(arch)[3], device="cpu",
                                    dtype="float64")
    r = np.random.RandomState(13)
    toks = torch.from_numpy(r.randint(0, ct.vocab_size, size=(1, 21))
                            .astype(np.int32))
    cache = ttf.init_cache(c64, 1, 32, cache_dtype=torch.float64,
                           device="cpu")
    assert cache["ssm"].dtype == torch.float64
    lg, _, cache = ttf.forward(c64, p64, toks[:, :19], cache=cache)
    got = [lg[0, -1]]
    for i in (19, 20):
        lg, _, cache = ttf.forward(c64, p64, toks[:, i:i + 1], cache=cache)
        got.append(lg[0, -1])
    full, _, _ = ttf.forward(c64, p64, toks)
    for g, pos in zip(got, (18, 19, 20)):
        torch.testing.assert_close(g, full[0, pos], rtol=0, atol=1e-10)


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_lm_loss_and_grads_match_reference(arch):
    cj, ct, pj, pt = _params(arch)
    r = np.random.RandomState(17)
    toks = r.randint(0, cj.vocab_size, size=(2, 12)).astype(np.int32)
    labels = r.randint(0, cj.vocab_size, size=(2, 12)).astype(np.int32)
    (lj, _), gj = jax.value_and_grad(
        lambda p: jtf.lm_loss(cj, p, {"tokens": jnp.asarray(toks),
                                      "labels": jnp.asarray(labels)}),
        has_aux=True)(pj)
    (lt, _), gt = value_and_grad(lambda p, bt: ttf.lm_loss(ct, p, bt))(
        pt, {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(lt), float(lj), rtol=0, atol=1e-5)
    flat_j = jax.tree_util.tree_leaves_with_path(gj)
    for path, gjl in flat_j:
        node = gt
        for key in path:
            node = node[key.key]
        _close(node, gjl, atol=1e-4, rel_to_max=True, msg=str(path))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _requests(cfg, n):
    r = np.random.RandomState(23)
    return [Request(uid=i, prompt=r.randint(0, cfg.vocab_size,
                                            size=5 + 3 * (i % 2))
                    .astype(np.int32), max_new_tokens=3 + (i % 3))
            for i in range(n)]


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_engine_tokens_equal_the_reference_engine(arch):
    """5 requests through 2 slots on both engines: equal greedy tokens and
    ticks — slot reuse overwrites a slot's conv/ssm state (and the hybrid's
    shared-block KV rows) whole, so nothing of an earlier request leaks."""
    cj, ct, pj, pt = _params(arch)
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
        assert len(r.out_tokens) == r.max_new_tokens
        assert r.out_tokens == rr.out_tokens, r.uid
        assert (r.first_token_tick, r.finish_tick) \
            == (rr.first_token_tick, rr.finish_tick)
    assert eng.tick == ref.tick and not eng.events
    assert set(eng.cache) == set(ref.cache)


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_engine_scatters_every_state_layer_major(arch):
    """Every cache key but ``lengths``/``memory`` holds the batch on axis 1
    (layer-major): a prefilled single-sequence cache lands whole in its
    slot and leaves the other slots as they were."""
    cj, ct, pj, pt = _params(arch)
    eng = ServingEngine(ct, pt, slots=3, max_seq=16, device="cpu")
    for key in eng.cache:
        assert ServingEngine._batch_dim(key) == (0 if key == "lengths"
                                                 else 1)
    single = ttf.init_cache(ct, 1, 16, cache_dtype=torch.float32,
                            device="cpu")
    for key, v in single.items():
        v.copy_(torch.full_like(v, 2 if key == "lengths" else 1.5))
    pool = eng._scatter_slot(eng.cache, single, 1)
    for key, v in pool.items():
        if key == "lengths":
            assert v.tolist() == [0, 2, 0]
            continue
        assert v.shape[1] == 3, key
        assert bool((v[:, 1] == 1.5).all()) and float(v[:, 0].abs().sum()) \
            == 0 and float(v[:, 2].abs().sum()) == 0, key


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_launch_serve_reduced_on_the_cpu(arch):
    """``python -m repro_torch.launch.serve --arch <arch> --reduced
    --device cpu`` serves its requests and exits 0."""
    import os
    import pathlib
    import subprocess
    import sys
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--reduced", "--device", "cpu", "--requests", "3", "--slots", "2",
         "--max-new", "4"], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(src)))
    assert res.returncode == 0, res.stdout + res.stderr
    assert "served 3 requests, 12 tokens" in res.stdout, res.stdout
