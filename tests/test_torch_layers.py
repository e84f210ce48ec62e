"""PyTorch port, layer functions: ``repro_torch.models.{layers,mlp,
attention}`` against their ``repro.models`` counterparts on the same numpy
inputs, in fp32 on the CPU.

Tolerance 1e-5 throughout unless said otherwise: both sides do the same
fp32 arithmetic, and differ only in summation order inside matrix products
and in the last ulp of exp / cos / sin / tanh.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduced as jreduced
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import mlp as jmlp
from repro_torch.configs import get_config as tget, reduced as treduced
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import mlp as tmlp

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def close(got, want, **kw):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(kw or TOL))


def test_rms_norm():
    r = np.random.RandomState(0)
    x = r.randn(2, 5, 64).astype(np.float32) * 3
    g = r.randn(64).astype(np.float32)
    close(tlayers.rms_norm(T(x), T(g), 1e-5),
          jlayers.rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-5))
    # narrow input: cast back BEFORE the gamma multiply, on both sides
    # (one bf16 ulp, 2^-8 relative, where a last-bit fp32 difference flips
    # a rounding)
    got = tlayers.rms_norm(T(x).bfloat16(), T(g), 1e-5)
    want = jlayers.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(g), 1e-5)
    assert got.dtype == torch.bfloat16
    close(got, want, rtol=2 ** -7, atol=1e-6)


def test_rotary_embedding_and_apply_rope():
    r = np.random.RandomState(1)
    pos = r.randint(0, 60, size=(2, 7)).astype(np.int32)
    tc, ts = tlayers.rotary_embedding(T(pos), 16, 10000.0)
    jc, js = jlayers.rotary_embedding(jnp.asarray(pos), 16, 10000.0)
    assert tc.shape == (2, 7, 8)
    close(tc, jc)
    close(ts, js)
    x = r.randn(2, 7, 4, 16).astype(np.float32)
    close(tlayers.apply_rope(T(x), tc, ts),
          jlayers.apply_rope(jnp.asarray(x), jc, js))
    # half-split layout: with cos=0, sin=1 the halves swap (first negated)
    one, zero = torch.ones(2, 7, 8), torch.zeros(2, 7, 8)
    rot = tlayers.apply_rope(T(x), zero, one)
    close(rot[..., :8], -x[..., 8:])
    close(rot[..., 8:], x[..., :8])


def test_repeat_kv():
    x = np.arange(2 * 3 * 2 * 4, dtype=np.float32).reshape(2, 3, 2, 4)
    got = tlayers.repeat_kv(T(x), 3)
    want = jlayers.repeat_kv(jnp.asarray(x), 3)
    assert got.shape == (2, 3, 6, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tlayers.repeat_kv(T(x), 1).shape == (2, 3, 2, 4)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp(act):
    r = np.random.RandomState(2)
    x = r.randn(2, 5, 32).astype(np.float32)
    p = {"w_up": r.randn(32, 64).astype(np.float32) / 6,
         "w_down": r.randn(64, 32).astype(np.float32) / 8}
    if act == "silu":
        p["w_gate"] = r.randn(32, 64).astype(np.float32) / 6
    assert set(tmlp.mlp_template(32, 64, act)) == set(p) \
        == set(jmlp.mlp_template(32, 64, act))
    got = tmlp.mlp({k: T(v) for k, v in p.items()}, T(x), act)
    want = jmlp.mlp({k: jnp.asarray(v) for k, v in p.items()},
                    jnp.asarray(x), act)
    close(got, want)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    close(tlayers.activation_fn("gelu")(T(x)), jax.nn.gelu(jnp.asarray(x)),
          rtol=1e-5, atol=1e-6)
    exact = torch.nn.functional.gelu(T(x))
    assert (tlayers.activation_fn("gelu")(T(x)) - exact).abs().max() > 1e-4


def test_init_params_laws_and_device_default():
    tmpl = {"a": tlayers.P((4, 300, 200), ("l", "i", "o"), "fan_in"),
            "b": {"n": tlayers.P((500, 40), ("v", "e"), "normal", 0.02),
                  "z": tlayers.P((7,), ("e",), "zeros"),
                  "o": tlayers.P((7,), ("e",), "ones")}}
    gen = torch.Generator(device="cpu").manual_seed(0)
    p = tlayers.init_params(tmpl, gen, device="cpu")
    assert p["a"].shape == (4, 300, 200) and p["a"].dtype == torch.float32
    assert abs(float(p["a"].std()) - 1 / np.sqrt(300)) < 2e-3
    assert abs(float(p["b"]["n"].std()) - 0.02) < 1e-3
    assert (p["b"]["z"] == 0).all() and (p["b"]["o"] == 1).all()
    again = tlayers.init_params(
        tmpl, torch.Generator(device="cpu").manual_seed(0), device="cpu")
    assert torch.equal(p["a"], again["a"])
    assert tlayers.tree_size_bytes(p) == 4 * (4 * 300 * 200 + 500 * 40 + 14)
    # the default device is the card: without one this raises, it does not
    # run on the CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tlayers.init_params(tmpl, gen)


def _kv(seed, b=2, smax=8, hkv=2, d=4, s_new=3):
    r = np.random.RandomState(seed)
    return (r.randn(b, smax, hkv, d).astype(np.float32),
            r.randn(b, smax, hkv, d).astype(np.float32),
            r.randn(b, s_new, hkv, d).astype(np.float32),
            r.randn(b, s_new, hkv, d).astype(np.float32))


@pytest.mark.parametrize("lengths", [[0, 2], [5, 1], [7, 8], [6, 100]])
def test_update_cache_with_clamp(lengths):
    """Including starts past the end of the buffer: the reference clamps
    the slice so it fits (start = min(len, Smax - S_new)); the port must
    compute the same thing, not fault."""
    ck, cv, kn, vn = _kv(3)
    ln = np.asarray(lengths, np.int32)
    wk, wv = jattn.update_cache(jnp.asarray(ck), jnp.asarray(cv),
                                jnp.asarray(kn), jnp.asarray(vn),
                                jnp.asarray(ln))
    tk, tv = T(ck).clone(), T(cv).clone()
    gk, gv = tattn.update_cache(tk, tv, T(kn), T(vn), T(ln))
    assert gk is tk and gv is tv            # in place, and says so
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_update_cache_rejects_too_many_rows():
    ck, cv, _, _ = _kv(3)
    big = torch.zeros(2, 9, 2, 4)
    with pytest.raises(ValueError):
        tattn.update_cache(T(ck), T(cv), big, big, torch.zeros(2, dtype=torch.int32))


def _qkv(seed, b, s, t, h, d):
    r = np.random.RandomState(seed)
    return (r.randn(b, s, h, d).astype(np.float32),
            r.randn(b, t, h, d).astype(np.float32),
            r.randn(b, t, h, d).astype(np.float32))


def test_masked_softmax_attn_with_dead_row():
    q, k, v = _qkv(4, 2, 5, 6, 3, 8)
    mask = np.random.RandomState(5).rand(2, 1, 5, 6) > 0.4
    mask[0, 0, 2, :] = False                       # a dead row
    got = tattn._masked_softmax_attn(T(q), T(k), T(v), T(mask))
    want = jattn._masked_softmax_attn(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(mask))
    close(got, want)
    assert (got[0, 2] == 0).all()


@pytest.mark.parametrize("t_len,chunk,threshold", [
    (37, 8, 8),      # rectangular loop, ragged last chunk
    (32, 8, 4),      # rectangular loop, exact chunks
    (12, 16, 16),    # quadratic fast path
])
def test_chunked_attention_rectangular(t_len, chunk, threshold):
    b, s, h, d = 2, 5, 3, 8
    q, k, v = _qkv(6, b, s, t_len, h, d)
    r = np.random.RandomState(7)
    q_pos = np.sort(r.randint(0, t_len, size=(b, s)), axis=1).astype(np.int32)
    kv_valid = r.rand(b, t_len) > 0.2
    kv_valid[1, :] = False                          # dead rows: all of batch 1
    kv_valid[0, 0] = True
    got = tattn.chunked_attention(T(q), T(k), T(v), T(q_pos), T(kv_valid),
                                  chunk=chunk, threshold=threshold)
    want = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(q_pos),
                                   jnp.asarray(kv_valid), chunk=chunk,
                                   threshold=threshold, use_flash="off")
    close(got, want)
    assert (got[1] == 0).all()


def test_chunked_attention_triangular_blocks_and_forced_flash():
    b, s, h, d = 1, 32, 2, 8
    q, k, v = _qkv(8, b, s, s, h, d)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    valid = np.ones((b, s), bool)
    args_t = (T(q), T(k), T(v), T(pos), T(valid))
    args_j = tuple(jnp.asarray(a) for a in (q, k, v, pos, valid))
    got = tattn.chunked_attention(*args_t, chunk=8, threshold=8,
                                  triangular=True)
    want = jattn.chunked_attention(*args_j, chunk=8, threshold=8,
                                   triangular=True, use_flash="off")
    close(got, want)
    # "auto" means the kernel on a CUDA device, so it is off for CPU
    # tensors; forcing it on takes the kernel's route (its plain version on
    # the CPU) and computes the same function
    assert tattn.flash_route_enabled("auto") is False
    assert tattn.flash_route_enabled("auto", device="cpu") is False
    assert tattn.flash_route_enabled("off") is False
    assert tattn.flash_route_enabled("on") is True
    forced = tattn.chunked_attention(*args_t, chunk=8, threshold=8,
                                     triangular=True, use_flash="on")
    close(forced, want)


def test_flash_env_override(monkeypatch):
    monkeypatch.setenv("REPRO_FLASH_ATTENTION", "1")
    assert tattn.flash_route_enabled("off") is True
    monkeypatch.setenv("REPRO_FLASH_ATTENTION", "0")
    assert tattn.flash_route_enabled("on") is False


def _attn_params(cfg_j, seed):
    tmpl = jattn.gqa_template(cfg_j)
    r = np.random.RandomState(seed)
    return {k: (r.randn(*p.shape) / np.sqrt(p.shape[0])).astype(np.float32)
            for k, p in tmpl.items()}


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "starcoder2-3b"])
def test_gqa_attention_without_and_with_cache(arch):
    """starcoder2's reduced config keeps ``pad_heads_to=32``: padded,
    output-masked heads are covered too."""
    cj, ct = jreduced(jget(arch)), treduced(tget(arch))
    assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
    p = _attn_params(cj, 9)
    assert {k: v.shape for k, v in tattn.gqa_template(ct).items()} \
        == {k: v.shape for k, v in jattn.gqa_template(cj).items()}
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = {k: T(v) for k, v in p.items()}
    r = np.random.RandomState(10)
    b, s, smax = 2, 6, 16
    x = r.randn(b, s, cj.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()

    want, none_j = jattn.gqa_attention(cj, pj, jnp.asarray(x), jnp.asarray(pos))
    got, none_t = tattn.gqa_attention(ct, pt, T(x), T(pos))
    assert none_j is None and none_t is None
    close(got, want, rtol=1e-5, atol=2e-5)

    # with a cache: per-sequence lengths, one validity row per sequence
    hkv, hd = cj.n_kv_heads, cj.resolved_head_dim
    ck = r.randn(b, smax, hkv, hd).astype(np.float32)
    cv = r.randn(b, smax, hkv, hd).astype(np.float32)
    lengths = np.asarray([3, 7], np.int32)
    pos = lengths[:, None] + np.arange(s, dtype=np.int32)[None]
    want, wc = jattn.gqa_attention(
        cj, pj, jnp.asarray(x), jnp.asarray(pos),
        cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv),
               "lengths": jnp.asarray(lengths)})
    got, gc = tattn.gqa_attention(
        ct, pt, T(x), T(pos),
        cache={"k": T(ck).clone(), "v": T(cv).clone(), "lengths": T(lengths)})
    close(got, want, rtol=1e-5, atol=2e-5)
    close(gc["k"], wc["k"])
    close(gc["v"], wc["v"])


def test_value_and_grad_frees_its_gradients_without_the_cycle_collector():
    """Dropping the result of ``value_and_grad`` frees the gradients at
    once: nothing in it forms a reference cycle that would keep them (on
    the card, gigabytes of them) alive until the cycle collector runs."""
    import gc
    import weakref
    params = {"a": torch.randn(3, 4), "b": {"c": torch.randn(4)}}
    fn = tlayers.value_and_grad(
        lambda p, x: (((x @ p["a"]) * p["b"]["c"]).sum(), {}))
    gc.disable()
    try:
        (_, _), grads = fn(params, torch.randn(2, 3))
        assert set(grads) == {"a", "b"} and grads["b"]["c"].shape == (4,)
        ref = weakref.ref(grads["a"])
        del grads
        assert ref() is None
    finally:
        gc.enable()
