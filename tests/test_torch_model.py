"""PyTorch port, the dense model as a whole: ``repro_torch.models.
transformer`` against ``repro.models.transformer`` on converted parameters.

The reference's parameters are built once by its own ``init_params``,
converted leaf by leaf through numpy (``repro_torch.convert``), and both
stacks then run on that one tree, in fp32 on the CPU. Logits agree to
atol 1e-4: two layers of fp32 products whose summation order differs, on
logits of order one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduced as jreduced
from repro.models import transformer as jtf
from repro.models.layers import init_params as jinit
from repro_torch import convert
from repro_torch.configs import ARCH_NAMES, get_config as tget, \
    reduced as treduced
from repro_torch.models import transformer as ttf

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

DENSE = ["tinyllama-1.1b", "llama3-8b", "starcoder2-3b", "stablelm-1.6b"]
ATOL = 1e-4


def _pair(arch):
    cj, ct = jreduced(jget(arch)), treduced(tget(arch))
    pj = jinit(jtf.model_template(cj), jax.random.PRNGKey(0))
    pt = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, pj),
                                   device="cpu")
    return cj, ct, pj, pt


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_configs_are_identical_copies(arch):
    assert dataclasses.asdict(jget(arch)) == dataclasses.asdict(tget(arch))
    assert dataclasses.asdict(jreduced(jget(arch))) \
        == dataclasses.asdict(treduced(tget(arch)))


@pytest.mark.parametrize("arch", DENSE)
def test_params_from_numpy_round_trips(arch):
    cj, ct, pj, pt = _pair(arch)
    assert _shapes(pt) == _shapes(pj)
    # the port's own template describes exactly this tree
    tmpl = ttf.model_template(ct)
    assert _shapes(jax.tree_util.tree_map(
        lambda p: np.empty(p.shape), tmpl,
        is_leaf=lambda x: not isinstance(x, dict))) == _shapes(pj)
    leaf_j = np.asarray(pj["layers"]["attn"]["wq"])
    assert pt["layers"]["attn"]["wq"].dtype == torch.float32
    np.testing.assert_array_equal(pt["layers"]["attn"]["wq"].numpy(), leaf_j)
    # owned copy, optional recast
    half = convert.params_from_numpy({"w": leaf_j}, device="cpu",
                                     dtype="bfloat16")
    assert half["w"].dtype == torch.bfloat16
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            convert.params_from_numpy({"w": leaf_j})


@pytest.mark.parametrize("arch", DENSE)
def test_forward_prefill_and_decode_match_reference(arch):
    """gelu (starcoder2), tied embeddings + padded heads (starcoder2) and
    ``parallel_block`` (stablelm) are covered by the config sweep."""
    cj, ct, pj, pt = _pair(arch)
    r = np.random.RandomState(11)
    b, s, smax = 2, 6, 16
    toks = r.randint(0, cj.vocab_size, size=(b, s)).astype(np.int32)

    # full causal forward, no cache
    lj, _, ej = jtf.forward(cj, pj, jnp.asarray(toks))
    lt, aux, et = ttf.forward(ct, pt, torch.from_numpy(toks))
    assert lt.shape == (b, s, cj.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=ATOL)
    np.testing.assert_allclose(et["final_hidden"].numpy(),
                               np.asarray(ej["final_hidden"]), rtol=0,
                               atol=ATOL)

    # prefill into a fresh cache
    cache_j = jtf.init_cache(cj, b, smax, cache_dtype=jnp.float32)
    cache_t = ttf.init_cache(ct, b, smax, cache_dtype=torch.float32,
                             device="cpu")
    assert _shapes(cache_t) == _shapes(cache_j)
    assert cache_t["lengths"].dtype == torch.int32
    lj, _, cache_j = jtf.forward(cj, pj, jnp.asarray(toks), cache=cache_j)
    lt, _, cache_t = ttf.forward(ct, pt, torch.from_numpy(toks), cache=cache_t)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=ATOL)

    # three decode steps with per-slot lengths: slot 1 is rewound to 3, as
    # a freshly prefilled shorter prompt would leave it
    new_len = np.asarray([s, 3], np.int32)
    cache_j = dict(cache_j, lengths=jnp.asarray(new_len))
    cache_t = dict(cache_t, lengths=torch.from_numpy(new_len))
    for step in range(3):
        tok = r.randint(0, cj.vocab_size, size=(b, 1)).astype(np.int32)
        lj, _, cache_j = jtf.forward(cj, pj, jnp.asarray(tok), cache=cache_j)
        lt, _, cache_t = ttf.forward(ct, pt, torch.from_numpy(tok),
                                     cache=cache_t)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                                   atol=ATOL, err_msg=f"decode step {step}")
        np.testing.assert_array_equal(cache_t["lengths"].numpy(),
                                      np.asarray(cache_j["lengths"]))
        for key in ("k", "v"):
            np.testing.assert_allclose(cache_t[key].numpy(),
                                       np.asarray(cache_j[key]), rtol=0,
                                       atol=ATOL)
    np.testing.assert_array_equal(cache_t["lengths"].numpy(), new_len + 3)


def test_cache_from_numpy_and_in_place_contract():
    cj, ct, pj, pt = _pair("tinyllama-1.1b")
    cache_j = jtf.init_cache(cj, 2, 8, cache_dtype=jnp.float32)
    arrays = jax.tree_util.tree_map(np.asarray, cache_j)
    cache_t = convert.cache_from_numpy(arrays, device="cpu")
    assert _shapes(cache_t) == _shapes(cache_j)
    assert cache_t["lengths"].dtype == torch.int32
    toks = torch.zeros((2, 3), dtype=torch.int32)
    old_len = cache_t["lengths"]
    _, _, new = ttf.forward(ct, pt, toks, cache=cache_t)
    # k/v are the same tensors, written in place; lengths is a new tensor
    assert new["k"] is cache_t["k"] and new["v"] is cache_t["v"]
    assert float(new["k"].abs().sum()) > 0
    assert old_len.tolist() == [0, 0] and new["lengths"].tolist() == [3, 3]
    # and the caller's numpy arrays were not aliased
    assert float(np.abs(arrays["k"]).sum()) == 0.0


def test_head_fn_replaces_the_final_product():
    cj, ct, pj, pt = _pair("tinyllama-1.1b")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    seen = {}

    def head(x, unembed):
        seen["shapes"] = (tuple(x.shape), tuple(unembed.shape))
        return x @ unembed + 1.0
    base, _, _ = ttf.forward(ct, pt, toks)
    plus, _, _ = ttf.forward(ct, pt, toks, head_fn=head)
    assert seen["shapes"] == ((1, 4, ct.d_model), (ct.d_model, ct.vocab_size))
    torch.testing.assert_close(plus, base + 1.0)


@pytest.mark.parametrize("arch", [a for a in ARCH_NAMES if a not in DENSE])
def test_other_families_raise_not_implemented(arch):
    cfg = treduced(tget(arch))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttf.model_template(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttf.init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttf.forward(cfg, {}, torch.zeros((1, 2), dtype=torch.int32))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    cfg = treduced(tget("tinyllama-1.1b"))
    with pytest.raises(RuntimeError, match="cuda"):
        ttf.init_cache(cfg, 1, 8)
