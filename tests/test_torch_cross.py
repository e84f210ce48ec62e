"""PyTorch port, cross-attention and the two families that use it:
``repro_torch.models.attention.cross_attention`` against the reference's,
and llama-3.2-vision-11b (a gated cross block after every group of self
layers) and seamless-m4t-medium (a non-causal encoder, decoder layers that
cross-attend to its output) as wholes: forward, prefill and decode through
the serve steps, and ``lm_loss``, on the same numpy inputs and converted
parameters, fp32 on the CPU, at atol 1e-4.

The reference initialises the vision model's tanh gate to zero, so a cross
layer adds exactly nothing at init: every check here sets the gate to 0.5
in both trees (``torch_family_parity.CROSS_GATE``). With the flash route
forced on, both stacks take the blockwise-attention kernel's non-causal
mode: the reference's Pallas kernel in interpret mode, the port's plain
version of its CUDA kernel (CPU tensors).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models.sharding import MeshCtx
from repro.train import step as jstep
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.train import step as tstep

import torch_family_parity as fp

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

VISION, AUDIO = "llama-3.2-vision-11b", "seamless-m4t-medium"


def test_cross_template_adds_q_norm_and_a_zero_gate():
    cj, ct, pj, pt = fp.pair(VISION)
    t = tattn.gqa_template(ct, cross=True)
    assert fp.shapes(t) == fp.shapes(jattn.gqa_template(cj, cross=True))
    assert t["gate"].init == "zeros" and t["gate"].shape == ()
    assert set(tattn.gqa_template(ct)) == {"wq", "wk", "wv", "wo"}
    # the tree under test carries the nonzero gate
    assert pt["cross_layers"]["attn"]["gate"].tolist() == [fp.CROSS_GATE]
    assert "gate" not in pt["layers"]["attn"]


@pytest.mark.parametrize("flash", ["off", "on"])
@pytest.mark.parametrize("arch,sq", [(VISION, 5), (VISION, 1), (AUDIO, 3)])
def test_cross_attention_matches_reference(arch, sq, flash):
    """A query block of ``sq`` rows (1: a decode step) against the memory,
    partly invalid in batch row 0 and wholly invalid in row 1, whose rows
    then output zeros; the vision model's gate at 0.5, the audio model's
    ``xattn`` ungated."""
    cj, ct, pj, pt = fp.pair(arch, attn_flash=flash)
    tree_j, tree_t = (pj["cross_layers"], pt["cross_layers"]) \
        if arch == VISION else (pj["layers"], pt["layers"])
    key = "attn" if arch == VISION else "xattn"
    p_j = {k: v[0] for k, v in tree_j[key].items()}
    p_t = {k: v[0] for k, v in tree_t[key].items()}
    assert ("gate" in p_t) == (arch == VISION)
    r = np.random.RandomState(6)
    x = r.randn(2, sq, ct.d_model).astype(np.float32)
    mem = fp.frontend(ct, seed=7)
    valid = np.ones((2, ct.frontend_seq), bool)
    valid[0, ::3] = False
    valid[1] = False
    want = jattn.cross_attention(cj, p_j, jnp.asarray(x), jnp.asarray(mem),
                                 jnp.asarray(valid))
    got = tattn.cross_attention(ct, p_t, fp.t(x), fp.t(mem), fp.t(valid))
    fp.close(got, want)
    assert float(got[1].abs().max()) == 0.0 and float(got[0].abs().max()) > 0
    # no validity mask: every memory row counts
    fp.close(tattn.cross_attention(ct, p_t, fp.t(x), fp.t(mem)),
             jattn.cross_attention(cj, p_j, jnp.asarray(x),
                                   jnp.asarray(mem)))


def test_cross_attention_takes_the_kernel_route_when_on(monkeypatch):
    """With the route on, the port calls the kernel wrapper's public entry
    non-causally with ``memory_valid`` as ``kv_valid``."""
    from repro_torch.kernels import ops as kops
    cj, ct, pj, pt = fp.pair(VISION, attn_flash="on")
    seen = []
    real = kops.flash_attention

    def spy(q, k, v, **kw):
        seen.append((tuple(q.shape), tuple(k.shape), kw["causal"],
                     kw["kv_valid"].dtype))
        return real(q, k, v, **kw)
    monkeypatch.setattr(kops, "flash_attention", spy)
    p_t = {k: v[0] for k, v in pt["cross_layers"]["attn"].items()}
    x = torch.randn(2, 1, ct.d_model)
    tattn.cross_attention(ct, p_t, x, fp.t(fp.frontend(ct)))
    h, hd, t_len = ct.n_heads_padded, ct.resolved_head_dim, ct.frontend_seq
    assert seen == [((2, h, 1, hd), (2, h, t_len, hd), False, torch.bool)]


@pytest.mark.parametrize("arch", [VISION, AUDIO])
def test_forward_prefill_and_decode_match_reference(arch):
    fp.check_forward_prefill_decode(arch)


@pytest.mark.parametrize("arch", [VISION, AUDIO])
def test_lm_loss_matches_reference(arch):
    m = fp.check_lm_loss(arch)
    assert set(m) == {"ce", "aux"} and float(m["aux"]) == 0.0


@pytest.mark.parametrize("arch", [VISION, AUDIO])
def test_cached_path_equals_the_full_forward(arch):
    fp.check_cached_equals_full(arch)


@pytest.mark.parametrize("arch", [VISION, AUDIO])
def test_serve_steps_match_reference(arch):
    """``make_prefill_step`` (bfloat16 cache, as the reference's default)
    and three ``make_decode_step`` calls with the frontend in the batch:
    the audio model's decode reads the encoder's output from the cache."""
    cj, ct, pj, pt = fp.pair(arch)
    r = np.random.RandomState(8)
    toks = r.randint(0, cj.vocab_size, size=(2, 5)).astype(np.int32)
    fe = fp.frontend(cj)
    bj = {"tokens": jnp.asarray(toks), "frontend_emb": jnp.asarray(fe)}
    bt = {"tokens": fp.t(toks), "frontend_emb": fp.t(fe)}
    lj, cache_j = jstep.make_prefill_step(cj, MeshCtx(mesh=None), 12)(pj, bj)
    with torch.no_grad():
        lt, cache_t = tstep.make_prefill_step(ct, None, 12)(pt, bt)
    fp.close(lt, lj)
    assert set(cache_t) == set(cache_j)
    if arch == AUDIO:
        fp.close(cache_t["memory"], cache_j["memory"])
    jdec = jstep.make_decode_step(cj, MeshCtx(mesh=None))
    tdec = tstep.make_decode_step(ct)
    for _ in range(3):
        tok = r.randint(0, cj.vocab_size, size=(2, 1)).astype(np.int32)
        lj, cache_j = jdec(pj, cache_j, {"tokens": jnp.asarray(tok),
                                         "frontend_emb": jnp.asarray(fe)})
        bt = {"tokens": fp.t(tok)}
        if arch == VISION:                # audio: memory from the cache
            bt["frontend_emb"] = fp.t(fe)
        with torch.no_grad():
            lt, cache_t = tdec(pt, cache_t, bt)
        fp.close(lt, lj)


@pytest.mark.parametrize("arch", [VISION, AUDIO])
def test_forward_without_frontend_raises(arch):
    cfg, params = fp.pair(arch)[1], fp.pair(arch)[3]
    toks = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="frontend_emb"):
        ttf.forward(cfg, params, toks)
    if arch == AUDIO:             # a one-token step reads the cached memory
        cache = ttf.init_cache(cfg, 1, 4, device="cpu")
        ttf.forward(cfg, params, toks[:, :1], cache=cache)
