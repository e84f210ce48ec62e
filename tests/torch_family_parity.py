"""Shared model-level parity checks for the PyTorch port's mixture-of-
experts, MLA, vision and encoder-decoder families (``test_torch_moe.py``,
``test_torch_mla.py``, ``test_torch_cross.py``).

The reference's parameters are built once per reduced config by its own
``init_params``, converted leaf by leaf through numpy
(``repro_torch.convert``), and both stacks run on that one tree in fp32 on
the CPU. The vision model's cross-attention gate is initialised to zero by
the reference (a cross layer then adds exactly nothing), so every check
here sets it to ``CROSS_GATE`` in both trees first.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget, reduced as jreduced
from repro.models import transformer as jtf
from repro.models.layers import init_params as jinit
from repro_torch import convert
from repro_torch.configs import get_config as tget, reduced as treduced
from repro_torch.models import transformer as ttf

ATOL = 1e-4            # as tests/test_torch_model.py: fp32, two layers
CROSS_GATE = 0.5
B, S, SMAX = 2, 6, 16


def with_capacity(cfg, factor):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=factor))


@functools.lru_cache(maxsize=None)
def _reference(arch, over):
    kw = dict(over)
    cj, ct = jreduced(jget(arch), **kw), treduced(tget(arch), **kw)
    pj = jinit(jtf.model_template(cj), jax.random.PRNGKey(0))
    if "cross_layers" in pj:
        xa = pj["cross_layers"]["attn"]
        pj["cross_layers"]["attn"] = dict(
            xa, gate=jnp.full_like(xa["gate"], CROSS_GATE))
    return cj, ct, pj, jax.tree_util.tree_map(np.asarray, pj)


def pair(arch, **over):
    """(reference cfg, port cfg, reference params, port params) of the
    reduced config, ``over`` applied to both."""
    cj, ct, pj, arrays = _reference(arch, tuple(sorted(over.items())))
    return cj, ct, pj, convert.params_from_numpy(arrays, device="cpu")


def frontend(cfg, b=B, seed=5):
    """Stub frontend embeddings (numpy), or None for a family without."""
    if not cfg.frontend_seq:
        return None
    return np.random.RandomState(seed).randn(
        b, cfg.frontend_seq, cfg.frontend_dim or cfg.d_model) \
        .astype(np.float32)


def t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def j(a):
    return None if a is None else jnp.asarray(a)


def close(got, want, atol=ATOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=atol, err_msg=msg)


def shapes(tree):
    if isinstance(tree, dict):
        return {k: shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def check_forward_prefill_decode(arch, **over):
    """The full forward, a prefill into a fresh cache and three decode
    steps with per-slot lengths (slot 1 rewound to 3, as a freshly
    prefilled shorter prompt would leave it), both stacks on the same
    tokens: logits, aux, caches and lengths."""
    cj, ct, pj, pt = pair(arch, **over)
    r = np.random.RandomState(11)
    toks = r.randint(0, cj.vocab_size, size=(B, S)).astype(np.int32)
    fe = frontend(cj)

    lj, aj, ej = jtf.forward(cj, pj, jnp.asarray(toks), frontend_emb=j(fe))
    lt, at, et = ttf.forward(ct, pt, t(toks), frontend_emb=t(fe))
    assert lt.shape == (B, S, cj.vocab_size)
    close(lt, lj, msg="full forward")
    close(at, aj, msg="aux")
    close(et["final_hidden"], ej["final_hidden"], msg="final_hidden")

    cache_j = jtf.init_cache(cj, B, SMAX, cache_dtype=jnp.float32)
    cache_t = ttf.init_cache(ct, B, SMAX, cache_dtype=torch.float32,
                             device="cpu")
    assert shapes(cache_t) == shapes(cache_j)
    assert all(cache_t[k].dtype == (torch.int32 if k == "lengths"
                                    else torch.float32) for k in cache_t)
    lj, aj, cache_j = jtf.forward(cj, pj, jnp.asarray(toks), cache=cache_j,
                                  frontend_emb=j(fe))
    lt, at, cache_t = ttf.forward(ct, pt, t(toks), cache=cache_t,
                                  frontend_emb=t(fe))
    close(lt, lj, msg="prefill")
    close(at, aj, msg="prefill aux")
    assert set(cache_t) == set(cache_j)

    new_len = np.asarray([S, 3], np.int32)
    cache_j = dict(cache_j, lengths=jnp.asarray(new_len))
    cache_t = dict(cache_t, lengths=torch.from_numpy(new_len))
    for step in range(3):
        tok = r.randint(0, cj.vocab_size, size=(B, 1)).astype(np.int32)
        lj, aj, cache_j = jtf.forward(cj, pj, jnp.asarray(tok),
                                      cache=cache_j, frontend_emb=j(fe))
        lt, at, cache_t = ttf.forward(ct, pt, t(tok), cache=cache_t,
                                      frontend_emb=t(fe))
        close(lt, lj, msg=f"decode step {step}")
        close(at, aj, msg=f"decode aux {step}")
        for key in cache_t:
            close(cache_t[key], cache_j[key], msg=f"cache {key}")
    np.testing.assert_array_equal(cache_t["lengths"].numpy(), new_len + 3)


def check_lm_loss(arch, **over):
    """``lm_loss``: the total and every metric (ce, aux, and mtp where the
    model has an MTP module)."""
    cj, ct, pj, pt = pair(arch, **over)
    r = np.random.RandomState(12)
    toks = r.randint(0, cj.vocab_size, size=(B, 8)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    fe = frontend(cj)
    bj = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    bt = {"tokens": t(toks), "labels": t(labels)}
    if fe is not None:
        bj["frontend_emb"], bt["frontend_emb"] = j(fe), t(fe)
    total_j, mj = jtf.lm_loss(cj, pj, bj)
    with torch.no_grad():
        total_t, mt = ttf.lm_loss(ct, pt, bt)
    assert set(mt) == set(mj)
    close(total_t, total_j, msg="total")
    for key in mt:
        close(mt[key], mj[key], msg=key)
    return mt


def check_cached_equals_full(arch, **over):
    """The port against itself: a prefill of 8 tokens and 8 one-token
    steps give the full forward's logits (1e-4 / 1e-3, the reference's own
    tests/test_models_smoke.py check). For the mixture-of-experts families
    the capacity factor is 8.0, as there: capacity depends on the group,
    so a prefix and the whole sequence would drop different tokens."""
    cj, ct, pj, pt = pair(arch, **over)
    if ct.is_moe:
        ct = with_capacity(ct, 8.0)
    r = np.random.RandomState(13)
    toks = t(r.randint(0, ct.vocab_size, size=(B, 16)).astype(np.int32))
    fe = t(frontend(ct))
    with torch.no_grad():
        full, _, _ = ttf.forward(ct, pt, toks, frontend_emb=fe)
        cache = ttf.init_cache(ct, B, 16, cache_dtype=torch.float32,
                               device="cpu")
        pre, _, cache = ttf.forward(ct, pt, toks[:, :8], cache=cache,
                                    frontend_emb=fe)
        close(pre, full[:, :8], msg="prefill")
        for i in range(8, 16):
            lg, _, cache = ttf.forward(ct, pt, toks[:, i:i + 1], cache=cache,
                                       frontend_emb=fe)
            close(lg[:, 0], full[:, i], atol=1e-3, msg=f"step {i}")
