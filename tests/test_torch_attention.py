"""PyTorch port, blockwise attention: ``repro_torch.kernels.attention`` and
the flash route of ``repro_torch.models.attention`` against the reference
on the same numpy inputs.

The reference's Pallas kernels run in interpret mode (every JAX flash call
here is at S <= 64); the port's wrappers get CPU tensors and take their
plain versions, which is also where its custom backward (``_FlashCore``)
runs. Tolerances are the reference tests' own (tests/test_attention.py):
outputs 1e-5 fp32; grads GRAD_TOL (1e-5 fp32, 2e-2 bf16) with atol 4x.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.precision import Policy as JPolicy
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.attention import flash_attention_probe as jprobe
from repro.models import attention as jattn
from repro_torch.core.precision import Policy as TPolicy
from repro_torch.kernels import attention as tka
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as tattn

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

GRAD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(t):
    return t.detach().float().numpy()


def _inputs(seed, b, h, sq, sk, d, p_valid=0.9):
    r = np.random.RandomState(seed)
    return (r.randn(b, h, sq, d).astype(np.float32),
            r.randn(b, h, sk, d).astype(np.float32),
            r.randn(b, h, sk, d).astype(np.float32),
            r.rand(b, sk) < p_valid)


def _port_grads(q, k, v, dtype, loss):
    qt, kt, vt = (torch.from_numpy(a).to(TDT[dtype]).requires_grad_(True)
                  for a in (q, k, v))
    out = loss(qt, kt, vt)
    return out, torch.autograd.grad(out[1], (qt, kt, vt))


# ---------------------------------------------------------------------------
# Kernel module: forward and backward against the reference
# ---------------------------------------------------------------------------


CASES = [(sq, sk, bq, bk, causal)
         for sq, sk, bq, bk in [(64, 64, 16, 16), (48, 80, 16, 16),
                                (33, 33, 16, 8)]
         for causal in (True, False) if not (causal and sq != sk)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk,bq,bk,causal", CASES)
def test_flash_matches_reference_fwd_and_grads(dtype, sq, sk, bq, bk,
                                               causal):
    b, h, d = 2, 2, 16
    q, k, v, kv_valid = _inputs(sq * 100 + sk, b, h, sq, sk, d)
    jq, jk, jv = (jnp.asarray(a, JDT[dtype]) for a in (q, k, v))
    jkv = jnp.asarray(kv_valid)

    def l_kernel(q_, k_, v_):
        o = jops.flash_attention(q_, k_, v_, kv_valid=jkv, causal=causal,
                                 bq=bq, bk=bk, interpret=True)
        return jnp.sum(jnp.sin(o.astype(jnp.float32)))

    want = jops.flash_attention(jq, jk, jv, kv_valid=jkv, causal=causal,
                                bq=bq, bk=bk, interpret=True)
    want_ref = jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                        kv_valid=jkv)
    gj = jax.grad(l_kernel, argnums=(0, 1, 2))(jq, jk, jv)

    tkv = torch.from_numpy(kv_valid)

    def l_port(q_, k_, v_):
        o = tops.flash_attention(q_, k_, v_, kv_valid=tkv, causal=causal,
                                 bq=bq, bk=bk)
        return o, torch.sum(torch.sin(o.float()))

    (got, _), gt = _port_grads(q, k, v, dtype, l_port)
    tol = GRAD_TOL[dtype]
    assert got.dtype == TDT[dtype] and got.shape == (b, h, sq, d)
    out_tol = 1e-5 if dtype == "float32" else tol
    for w in (want, want_ref):
        np.testing.assert_allclose(_np(got), np.asarray(w, np.float32),
                                   rtol=out_tol, atol=out_tol * 4)
    for name, a, b_ in zip("qkv", gt, gj):
        assert a.dtype == TDT[dtype]
        np.testing.assert_allclose(_np(a), np.asarray(b_, np.float32),
                                   rtol=tol, atol=tol * 4, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk,bq,bk", [(40, 40, 16, 8), (24, 56, 8, 16)])
def test_custom_backward_matches_autograd_in_float64(causal, sq, sk, bq, bk):
    """The Function's backward (delta, then the dQ and dK/dV plain
    versions) against torch autograd through a plain softmax attention, in
    float64: they agree to rounding (1e-10), dead rows included."""
    if causal and sq != sk:
        sq = sk
    b, h, d = 2, 3, 8
    q, k, v, kv_valid = _inputs(7, b, h, sq, sk, d, p_valid=0.7)
    kv_valid[1] = False                         # batch 1: every row dead
    tkv = torch.from_numpy(kv_valid)
    args = [torch.from_numpy(a).double().requires_grad_(True)
            for a in (q, k, v)]
    w = torch.from_numpy(np.random.RandomState(3).randn(b, h, sq, d))

    def softmax_attn(q_, k_, v_):
        s = torch.einsum("bhqd,bhkd->bhqk", q_, k_) / np.sqrt(d)
        mask = tkv[:, None, None, :].expand(b, 1, sq, sk)
        if causal:
            mask = mask & torch.ones(sq, sk, dtype=torch.bool).tril()
        s = s.masked_fill(~mask, -1e30)
        p = torch.softmax(s, dim=-1) * mask.any(dim=-1, keepdim=True)
        return torch.einsum("bhqk,bhkd->bhqd", p, v_)

    got = tka.flash_attention(*args, kv_valid=tkv, causal=causal, bq=bq,
                              bk=bk)
    want = softmax_attn(*args)
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, want, rtol=0, atol=1e-10)
    g_got = torch.autograd.grad((got * w).sum(), args)
    g_want = torch.autograd.grad((want * w).sum(), args)
    for name, a, b_ in zip("qkv", g_got, g_want):
        torch.testing.assert_close(a, b_, rtol=0, atol=1e-10,
                                   msg=f"d{name}")
        assert float(a[1].abs().max()) == 0.0, f"d{name} of dead rows"


@pytest.mark.parametrize("s,bq,bk", [(64, 16, 16), (64, 16, 8), (48, 8, 16)])
def test_probe_matches_reference(s, bq, bk):
    """Causal: q-block i walks min(n_k, (i*bq + bq - 1)//bk + 1) KV blocks
    (i + 1 on square blocks) — the same counts as the reference's in-kernel
    probe, summing to G*n(n+1)/2 on square blocks."""
    b, h, d = 2, 3, 16
    q, _, _, _ = _inputs(5, b, h, s, s, d)
    out, probe = tka.flash_attention_probe(*(torch.from_numpy(q),) * 3,
                                           causal=True, bq=bq, bk=bk)
    jout, jp = jprobe(*(jnp.asarray(q),) * 3, causal=True, bq=bq, bk=bk,
                      interpret=True)
    assert probe.dtype == torch.int32
    np.testing.assert_array_equal(probe.numpy(), np.asarray(jp))
    np.testing.assert_allclose(_np(out), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    n_q, n_k = s // bq, s // bk
    want = np.minimum(n_k, (np.arange(n_q) * bq + bq - 1) // bk + 1)
    assert (probe.numpy() == want[None, :]).all()
    if bq == bk:
        assert int(probe.sum()) == b * h * n_q * (n_q + 1) // 2
    _, full = tka.flash_attention_probe(*(torch.from_numpy(q),) * 3,
                                        causal=False, bq=bq, bk=bk)
    assert int(full.sum()) == b * h * n_q * n_k


def test_dead_rows_zero_output_and_grads():
    b, h, s, d = 2, 2, 32, 8
    q, k, v, _ = _inputs(9, b, h, s, s, d)
    kv_valid = np.ones((b, s), bool)
    kv_valid[0] = False                          # seq 0: all padding
    tkv = torch.from_numpy(kv_valid)

    def l_port(q_, k_, v_):
        o = tops.flash_attention(q_, k_, v_, kv_valid=tkv, causal=False,
                                 bq=8, bk=8)
        return o, o.sum()
    (out, _), (gq, gk, gv) = _port_grads(q, k, v, "float32", l_port)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), kv_valid=jnp.asarray(kv_valid),
                                causal=False, bq=8, bk=8, interpret=True)
    np.testing.assert_allclose(_np(out), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert float(out[0].abs().max()) == 0.0
    assert float(out[1].abs().max()) > 0.0
    for g in (gq, gk, gv):
        assert float(g[0].abs().max()) == 0.0


@pytest.mark.parametrize("sq,sk", [(20, 20), (130, 70), (7, 128)])
def test_non_multiple_shapes_pad_internally(sq, sk):
    causal = sq == sk
    q, k, v, _ = _inputs(sq + sk, 1, 2, sq, sk, 16)
    got = tops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal, bq=32,
                               bk=32)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal)
    assert got.shape == q.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-5,
                               atol=1e-4)


def test_bad_shapes_raise_valueerror_naming_shapes():
    q3 = torch.zeros((2, 16, 8))
    with pytest.raises(ValueError, match="rank-4"):
        tops.flash_attention(q3, q3, q3)
    q = torch.zeros((1, 2, 16, 8))
    v = torch.zeros((1, 2, 24, 8))
    with pytest.raises(ValueError, match=r"24"):
        tops.flash_attention(q, q, v)
    with pytest.raises(ValueError, match=r"incompatible"):
        tops.flash_attention(q, torch.zeros((1, 3, 16, 8)),
                             torch.zeros((1, 3, 16, 8)))
    with pytest.raises(ValueError, match="kv_valid"):
        tops.flash_attention(q, q, q, kv_valid=torch.zeros((1, 7),
                                                           dtype=torch.bool))


def test_kernel_wrappers_refuse_what_the_kernel_cannot_take():
    """What the CUDA kernel does not take raises ValueError before any
    launch (checked here on meta tensors: no card is needed to refuse)."""
    meta = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt,
                                                    device="meta")
    kvm = meta(2, 16, dt=torch.int32)
    with pytest.raises(ValueError, match="unsupported device"):
        tka.flash_fwd(meta(2, 16, 8), meta(2, 16, 8), meta(2, 16, 8), kvm,
                      causal=True, bq=8, bk=8)
    bad = [(meta(2, 16, 8, dt=torch.int32),) * 3 + (kvm,),
           (meta(2, 16, 8), meta(2, 16, 8, dt=torch.float16),
            meta(2, 16, 8), kvm),
           (meta(2, 16, 256),) * 3 + (kvm,),
           (meta(2, 16, 8),) * 3 + (meta(2, 16),)]
    for args in bad:
        with pytest.raises(ValueError):
            tka._check_launchable("flash_fwd", *args)
    tka._check_launchable("flash_fwd", *(meta(2, 16, 128),) * 3, kvm)


def test_policy_block_knobs_flow_through():
    pol_j = JPolicy(compute_dtype="float32", attn_bq=32, attn_bk=32)
    pol_t = TPolicy(compute_dtype="float32", attn_bq=32, attn_bk=32)
    q, _, _, _ = _inputs(4, 1, 1, 64, 64, 8)
    got = tops.flash_attention(*(torch.from_numpy(q),) * 3, policy=pol_t)
    want = jops.flash_attention(*(jnp.asarray(q),) * 3, policy=pol_j,
                                interpret=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    _, probe = tka.flash_attention_probe(*(torch.from_numpy(q),) * 3,
                                         causal=True, bq=pol_t.attn_bq,
                                         bk=pol_t.attn_bk)
    assert tuple(probe.shape) == (1, 2) and int(probe.sum()) == 3
    # a bf16 policy casts the operands first
    out = tops.flash_attention(*(torch.from_numpy(q),) * 3,
                               policy=TPolicy(compute_dtype="bfloat16"))
    assert out.dtype == torch.bfloat16


def test_plain_versions_count_no_launch():
    tka.reset_launches()
    q, _, _, _ = _inputs(2, 1, 2, 16, 16, 8)
    qt = torch.from_numpy(q).requires_grad_(True)
    tops.flash_attention(qt, qt, qt, bq=8, bk=8).sum().backward()
    assert tka.LAUNCHES == {"flash_fwd": 0, "flash_bwd_dq": 0,
                            "flash_bwd_dkv": 0}


# ---------------------------------------------------------------------------
# Model layer: route and rematerialization
# ---------------------------------------------------------------------------


def test_forced_flash_route_matches_reference(monkeypatch):
    """chunked_attention with the route forced on and off, forward and
    grads, against the reference's own forced on / off run (its
    tolerances: 2e-5/1e-4 forward, 1e-4 grads)."""
    monkeypatch.delenv("REPRO_FLASH_ATTENTION", raising=False)
    b, s, h, d = 2, 48, 4, 16
    r = np.random.RandomState(21)
    q, k, v = (r.randn(b, s, h, d).astype(np.float32) for _ in range(3))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    kv_valid = r.rand(b, s) < 0.9

    def run_j(flag):
        def loss(q_, k_, v_):
            o = jattn.chunked_attention(q_, k_, v_, jnp.asarray(pos),
                                        jnp.asarray(kv_valid),
                                        triangular=True, use_flash=flag)
            return jnp.sum(o * jnp.cos(o))
        args = tuple(jnp.asarray(a) for a in (q, k, v))
        return (jattn.chunked_attention(*args, jnp.asarray(pos),
                                        jnp.asarray(kv_valid),
                                        triangular=True, use_flash=flag),
                jax.grad(loss, argnums=(0, 1, 2))(*args))

    def run_t(flag):
        args = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        o = tattn.chunked_attention(*args, torch.from_numpy(pos),
                                    torch.from_numpy(kv_valid),
                                    triangular=True, use_flash=flag)
        return o, torch.autograd.grad((o * torch.cos(o)).sum(), args)

    for flag in ("on", "off"):
        oj, gj = run_j(flag)
        ot, gt = run_t(flag)
        np.testing.assert_allclose(_np(ot), np.asarray(oj), rtol=2e-5,
                                   atol=1e-4, err_msg=flag)
        for a, b_ in zip(gt, gj):
            np.testing.assert_allclose(_np(a), np.asarray(b_), rtol=1e-4,
                                       atol=1e-4, err_msg=flag)
    o_on, g_on = run_t("on")
    o_off, g_off = run_t("off")
    np.testing.assert_allclose(_np(o_on), _np(o_off), rtol=2e-5, atol=1e-4)
    for a, b_ in zip(g_on, g_off):
        np.testing.assert_allclose(_np(a), _np(b_), rtol=1e-4, atol=1e-4)


def test_flash_route_enabled_env_and_auto(monkeypatch):
    monkeypatch.delenv("REPRO_FLASH_ATTENTION", raising=False)
    assert tattn.flash_route_enabled("on") is True
    assert tattn.flash_route_enabled("off") is False
    # "auto" = the kernel where the operands lie on a CUDA device
    assert tattn.flash_route_enabled("auto") is False
    assert tattn.flash_route_enabled("auto", device="cpu") is False
    assert tattn.flash_route_enabled("auto", device="cuda") is True
    assert tattn.flash_route_enabled("auto",
                                     device=torch.device("cuda", 0)) is True
    monkeypatch.setenv("REPRO_FLASH_ATTENTION", "0")
    assert tattn.flash_route_enabled("on", device="cuda") is False
    assert tattn.flash_route_enabled("auto", device="cuda") is False
    monkeypatch.setenv("REPRO_FLASH_ATTENTION", "1")
    assert tattn.flash_route_enabled("off") is True
    assert tattn.flash_route_enabled("auto", device="cpu") is True
    # the same overrides as the reference's
    for val, want in (("true", True), ("false", False), ("", True)):
        monkeypatch.setenv("REPRO_FLASH_ATTENTION", val)
        assert tattn.flash_route_enabled("on") == want
        assert jattn.flash_route_enabled("on") == want


@pytest.mark.parametrize("policy", ["everything", "nothing", "dots",
                                    "dots_no_batch"])
def test_block_remat_preserves_values_and_grads(policy):
    """Per-q-block checkpointing changes memory, never math."""
    b, s, h, d = 1, 64, 2, 8
    q = np.random.RandomState(17).randn(b, s, h, d).astype(np.float32)
    pos = torch.arange(s, dtype=torch.int32)[None].expand(b, s)
    valid = torch.ones((b, s), dtype=torch.bool)

    def grad(remat):
        qt = torch.from_numpy(q).requires_grad_(True)
        o = tattn.chunked_attention(qt, qt, qt, pos, valid, triangular=True,
                                    use_flash="off", threshold=8, chunk=16,
                                    block_remat=remat)
        return o, torch.autograd.grad((o ** 2).sum(), qt)[0]

    o, g = grad(policy)
    o0, g0 = grad("none")
    np.testing.assert_allclose(_np(o), _np(o0), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(g), _np(g0), rtol=1e-5, atol=1e-5)


def test_checkpoint_policy_vocabulary():
    assert tattn.checkpoint_policy("none") is None
    assert tattn.checkpoint_policy("everything") is None
    for name in ("nothing", "dots", "dots_no_batch"):
        assert callable(tattn.checkpoint_policy(name))
    for bogus in ("bogus", "full", "dots_saveable"):
        with pytest.raises(ValueError, match="checkpoint policy"):
            tattn.checkpoint_policy(bogus)
        with pytest.raises(ValueError, match="checkpoint policy"):
            jattn.checkpoint_policy(bogus)
