"""PyTorch port, the paper's kernels and the scan kernel: ``repro_torch.
kernels.{axpy,conv,ssm_scan}`` and their ``ops`` wrappers against the
reference's ``repro.kernels`` (Pallas in interpret mode, and its pure-jnp
oracles in ``ref.py``).

On the CPU every wrapper takes its plain version, because its tensors lie
on the CPU; the CUDA kernels are held to those plain versions on the card
by ``chip_smoke.py``. Tolerances are the reference tests' own
(``tests/test_kernels.py``: ``_tol``, 2e-4 for conv, 3e-4 for the scan).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import precision as jprecision
from repro.kernels import ops as jops, ref as jref
from repro.models.ssm import chunked_linear_attention as j_chunked
from repro_torch.core.precision import Policy
from repro_torch.kernels import axpy as tax, conv as tconv, ops as tops, \
    ssm_scan as tssm
from repro_torch.models.ssm import chunked_linear_attention as t_chunked

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _t(a, dtype=None):
    """numpy -> CPU tensor (bfloat16 through float32, exactly)."""
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))
    return t if dtype is None else t.to(dtype)


def _np(t):
    return t.detach().to(torch.float32).numpy() if t.dtype == torch.bfloat16 \
        else t.detach().numpy()


def _jnp(t):
    return np.asarray(t, np.float32)


# ---------------------------------------------------------------------------
# axpy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,block", [(64, 64), (1024, 128), (4096, 1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_axpy_sweep_matches_reference(n, block, dtype):
    jd, td = DTYPES[dtype]
    r = np.random.RandomState(n + block)
    x, y = r.randn(n).astype(np.float32), r.randn(n).astype(np.float32)
    got = tops.axpy(2.5, _t(x, td), _t(y, td), block=block)
    want = jops.axpy(2.5, jnp.asarray(x, jd), jnp.asarray(y, jd),
                     block=block, interpret=True)
    assert got.dtype == td and got.shape == (n,)
    np.testing.assert_allclose(_np(got), _jnp(want), rtol=TOL[dtype],
                               atol=TOL[dtype])
    np.testing.assert_allclose(
        _np(got), _jnp(jref.axpy_ref(2.5, jnp.asarray(x, jd),
                                     jnp.asarray(y, jd))),
        rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("seed,nb,alpha", [(0, 1, -3.7), (1, 3, 0.0),
                                           (2, 8, 1.1), (3, 5, 3.999)])
def test_axpy_property_cases(seed, nb, alpha):
    r = np.random.RandomState(seed)
    n = 32 * nb
    x, y = r.randn(n).astype(np.float32), r.randn(n).astype(np.float32)
    got = tax.axpy(alpha, _t(x), _t(y), block=32)
    want = jref.axpy_ref(alpha, jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(_np(got), _jnp(want), rtol=1e-5, atol=1e-5)


def test_axpy_lmul_blocks_match():
    """``tests/test_lmul.py::test_pallas_axpy_lmul_blocks_match``."""
    r = np.random.RandomState(4)
    x, y = _t(r.randn(4096)), _t(r.randn(4096))
    want = tops.axpy(0.5, x, y, block=512)
    got = tops.axpy(0.5, x, y, block=512, lmul=8)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    got = tops.axpy(0.5, x, y, block=512, policy=Policy(
        compute_dtype="float32", lmul=4))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_axpy_rounds_alpha_and_each_operation_to_x_dtype():
    """``alpha`` is rounded to x's dtype first; in bfloat16 the product
    and the sum are each rounded to bfloat16."""
    x = torch.tensor([1.0, 3.0, -2.0], dtype=torch.bfloat16)
    y = torch.tensor([1e-3, 0.5, 7.0], dtype=torch.bfloat16)
    alpha = 1.0 + 2.0 ** -9                # rounds to 1.0 in bfloat16
    got = tax.axpy(alpha, x, y, block=3)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, x + y, rtol=0, atol=0)
    want = jref.axpy_ref(alpha, jnp.asarray([1.0, 3.0, -2.0], jnp.bfloat16),
                         jnp.asarray([1e-3, 0.5, 7.0], jnp.bfloat16))
    np.testing.assert_allclose(_np(got), _jnp(want), rtol=2 ** -7, atol=0)


@pytest.mark.parametrize("alpha", [2.5, -1.75, 0.3])
def test_axpy_bf16_is_bit_equal_to_the_reference(alpha):
    """The reference rounds the bfloat16 product and then the sum (two
    roundings, not one fused): the port's result is the same bits."""
    r = np.random.RandomState(12)
    x, y = r.randn(4096).astype(np.float32), r.randn(4096).astype(np.float32)
    got = tax.axpy(alpha, _t(x, torch.bfloat16), _t(y, torch.bfloat16),
                   block=1024)
    want = jops.axpy(alpha, jnp.asarray(x, jnp.bfloat16),
                     jnp.asarray(y, jnp.bfloat16), block=1024, interpret=True)
    np.testing.assert_array_equal(_np(got), _jnp(want))


def test_axpy_float64_stays_float64():
    """The paper's DAXPY is double precision: float64 in, float64 out."""
    r = np.random.RandomState(5)
    x, y = r.randn(256), r.randn(256)
    got = tax.axpy(1.0 / 3.0, torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), x / 3.0 + y, rtol=1e-15,
                               atol=1e-15)


@pytest.mark.parametrize("x,y,block,match", [
    (torch.zeros(100), torch.zeros(100), 64, "multiple of its block"),
    (torch.zeros(0), torch.zeros(0), 64, "positive"),
    (torch.zeros(64), torch.zeros(64), 0, "positive"),
    (torch.zeros(8, 8), torch.zeros(8, 8), 64, "one shape"),
    (torch.zeros(64), torch.zeros(32), 64, "one shape"),
    (torch.zeros(64), torch.zeros(64, dtype=torch.float64), 64, "dtype"),
    (torch.zeros(64, dtype=torch.int32), torch.zeros(64, dtype=torch.int32),
     64, "dtype"),
])
def test_axpy_contract_raises_value_error(x, y, block, match):
    with pytest.raises(ValueError, match=match):
        tax.axpy(1.0, x, y, block=block)


@pytest.mark.parametrize("x,y,block,outcome", [
    (torch.zeros(100, device="meta"), torch.zeros(100, device="meta"), 64,
     "raises"),
    (torch.zeros(64, device="meta"), torch.zeros(32, device="meta"), 64,
     "raises"),
    (torch.zeros(64, device="meta"),
     torch.zeros(64, dtype=torch.float64, device="meta"), 64, "raises"),
    (torch.zeros(64, dtype=torch.int8, device="meta"),
     torch.zeros(64, dtype=torch.int8, device="meta"), 64, "raises"),
    (torch.zeros(64, device="meta"), torch.zeros(64, device="meta"), 64,
     "meta output"),
])
def test_axpy_contract_raises_before_any_launch(monkeypatch, x, y, block,
                                                outcome):
    """Off the CPU, the contract raises ValueError before the library is
    loaded, and so before any launch; on ``meta`` a call that meets it (the
    last case) returns an output of its shape and dtype, again without
    loading the library or launching."""
    def no_load(name):
        raise AssertionError("the library was loaded")
    monkeypatch.setattr(tax.build, "load", no_load)
    tax.reset_launches()
    if outcome == "meta output":
        out = tax.axpy(1.0, x, y, block=block)
        assert (out.device.type, out.shape, out.dtype) == (
            "meta", x.shape, x.dtype)
    else:
        with pytest.raises(ValueError):
            tax.axpy(1.0, x, y, block=block)
    assert tax.LAUNCHES["axpy"] == 0


# ---------------------------------------------------------------------------
# conv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c,h,w,oc,kh,kw", [
    (1, 8, 16, 2, 3, 3),
    (3, 12, 20, 4, 7, 7),
    (3, 10, 118, 8, 7, 7),   # GoogLeNet layer-1 row geometry (oc reduced)
])
def test_conv_sweep_matches_reference(c, h, w, oc, kh, kw):
    r = np.random.RandomState(c * h + w)
    x = r.randn(c, h, w).astype(np.float32)
    wgt = (r.randn(oc, c, kh, kw) * 0.2).astype(np.float32)
    got = tops.conv2d(_t(x), _t(wgt))
    want = jops.conv2d(jnp.asarray(x), jnp.asarray(wgt), interpret=True)
    assert got.shape == tuple(want.shape) == (oc, h - kh + 1, w - kw + 1)
    np.testing.assert_allclose(_np(got), _jnp(want), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        _np(got), _jnp(jref.conv2d_ref(jnp.asarray(x), jnp.asarray(wgt))),
        rtol=2e-4, atol=2e-4)


def test_conv_bf16_policy_matches_reference():
    """``tests/test_multiprecision.py::test_pallas_conv_bf16_matches_fp32``
    on both stacks: bfloat16 operands, float32 accumulation and output."""
    r = np.random.RandomState(6)
    x = r.randn(3, 12, 20).astype(np.float32)
    wgt = (r.randn(4, 3, 5, 5) * 0.2).astype(np.float32)
    want32 = tops.conv2d(_t(x), _t(wgt))
    got = tops.conv2d(_t(x), _t(wgt), policy=Policy(compute_dtype="bfloat16"),
                      out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want32), rtol=5e-2, atol=0.5)
    ref = jops.conv2d(jnp.asarray(x), jnp.asarray(wgt),
                      policy=jprecision.Policy(compute_dtype="bfloat16"),
                      out_dtype=jnp.float32, interpret=True)
    # the same bf16 operands, fp32 sums in two orders
    np.testing.assert_allclose(_np(got), _jnp(ref), rtol=1e-5, atol=1e-5)


def test_conv_narrow_output_and_float64():
    r = np.random.RandomState(7)
    x = r.randn(2, 9, 11)
    wgt = r.randn(3, 2, 3, 4) * 0.2
    got = tconv.conv2d_direct(_t(x, torch.bfloat16), _t(wgt, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = jops.conv2d(jnp.asarray(x, jnp.bfloat16),
                       jnp.asarray(wgt, jnp.bfloat16), interpret=True)
    np.testing.assert_allclose(_np(got), _jnp(want), rtol=2e-2, atol=2e-2)
    got64 = tconv.conv2d_direct(torch.from_numpy(x), torch.from_numpy(wgt))
    assert got64.dtype == torch.float64
    ref64 = torch.nn.functional.conv2d(torch.from_numpy(x)[None],
                                       torch.from_numpy(wgt))[0]
    torch.testing.assert_close(got64, ref64, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("x,w,kw,match", [
    (torch.zeros(3, 8, 8), torch.zeros(2, 4, 3, 3), {}, "channels"),
    (torch.zeros(3, 8), torch.zeros(2, 3, 3, 3), {}, "expected"),
    (torch.zeros(3, 8, 8), torch.zeros(2, 3, 9, 3), {}, "does not fit"),
    (torch.zeros(3, 8, 8), torch.zeros(2, 3, 3, 3, dtype=torch.float64), {},
     "dtype"),
    (torch.zeros(3, 8, 8), torch.zeros(2, 3, 3, 3),
     {"out_dtype": torch.float64}, "out_dtype"),
])
def test_conv_contract_raises_value_error(x, w, kw, match):
    with pytest.raises(ValueError, match=match):
        tops.conv2d(x, w, **kw)


def test_conv_shared_memory_limit_is_the_kernels_only():
    """256 channels of 3 rows of width 512 do not fit the CUDA kernel's
    shared memory (the card raises ``ValueError``, ``chip_smoke.py``
    ``paper_kernels``); the plain version has no such limit."""
    x = torch.from_numpy(np.random.RandomState(12).randn(256, 3, 512)
                         .astype(np.float32))
    w = torch.full((1, 256, 3, 3), 1.0 / 256)
    got = tconv.conv2d_direct(x, w)
    assert got.shape == (1, 1, 510)
    torch.testing.assert_close(got[0], torch.nn.functional.conv2d(
        x[None], w)[0, 0], rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# ssm scan
# ---------------------------------------------------------------------------


def _ssm_inputs(bh, s, n, p, seed):
    """The reference tests' statistics: k * 0.3, log_decay in (-0.5, 0],
    scale in [0, 1)."""
    r = np.random.RandomState(seed)
    q = r.randn(bh, s, n).astype(np.float32)
    k = (r.randn(bh, s, n) * 0.3).astype(np.float32)
    v = r.randn(bh, s, p).astype(np.float32)
    ld = (-r.rand(bh, s) * 0.5).astype(np.float32)
    sc = r.rand(bh, s).astype(np.float32)
    return q, k, v, ld, sc


@pytest.mark.parametrize("bh,s,n,p,chunk", [
    (2, 32, 8, 8, 8),
    (4, 64, 16, 32, 16),
    (1, 128, 32, 16, 64),
    (2, 48, 5, 7, 48),
    (3, 20, 6, 9, 128),          # S below the chunk: chunk = S
])
def test_ssm_scan_matches_reference_kernel_and_recurrence(bh, s, n, p, chunk):
    arrays = _ssm_inputs(bh, s, n, p, bh * s + n)
    got = tops.ssm_scan(*map(_t, arrays), chunk=chunk)
    assert got.shape == (bh, s, p) and got.dtype == torch.float32
    j = [jnp.asarray(a) for a in arrays]
    np.testing.assert_allclose(
        _np(got), _jnp(jops.ssm_scan(*j, chunk=chunk, interpret=True)),
        rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(_np(got), _jnp(jref.ssm_scan_ref(*j)),
                               rtol=3e-4, atol=3e-4)


def test_ssm_scan_bf16_keeps_v_dtype():
    arrays = _ssm_inputs(2, 32, 8, 8, 9)
    q, k, v = (_t(a, torch.bfloat16) for a in arrays[:3])
    got = tssm.ssm_scan(q, k, v, _t(arrays[3]), _t(arrays[4]), chunk=16)
    assert got.dtype == torch.bfloat16
    j = [jnp.asarray(a, jnp.bfloat16) for a in arrays[:3]] \
        + [jnp.asarray(a) for a in arrays[3:]]
    want = jops.ssm_scan(*j, chunk=16, interpret=True)
    assert want.dtype == jnp.bfloat16
    scale = float(np.abs(_jnp(want)).max())
    np.testing.assert_allclose(_np(got), _jnp(want), rtol=2e-2,
                               atol=2e-2 * scale)


def test_ssm_scan_float64_stays_float64():
    arrays = _ssm_inputs(2, 32, 8, 8, 10)
    t64 = [torch.from_numpy(a.astype(np.float64)) for a in arrays]
    got = tssm.ssm_scan(*t64, chunk=8)
    assert got.dtype == torch.float64
    j = [jnp.asarray(a) for a in arrays]
    np.testing.assert_allclose(got.numpy(), _jnp(jref.ssm_scan_ref(*j)),
                               rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("chunk", [16, 64])
def test_ssm_scan_matches_the_model_core(chunk):
    """``tests/test_kernels.py::test_ssm_scan_matches_model_core`` on the
    port: the kernel's (BH,S,·) form against the port's
    ``chunked_linear_attention`` in its (B,S,H,·) form, and against the
    reference's."""
    b, s, h, n, p = 2, 64, 2, 8, 16
    r = np.random.RandomState(11)
    q = r.randn(b, s, h, n).astype(np.float32)
    k = (r.randn(b, s, h, n) * 0.3).astype(np.float32)
    v = r.randn(b, s, h, p).astype(np.float32)
    ld = (-r.rand(b, s, h) * 0.5).astype(np.float32)
    sc = r.rand(b, s, h).astype(np.float32)
    y_model, _ = t_chunked(_t(q), _t(k), _t(v), _t(ld), _t(sc), chunk=chunk)

    def flat(t):
        return t.transpose(1, 2).reshape((b * h, s) + t.shape[3:])
    y_kern = tops.ssm_scan(flat(_t(q)), flat(_t(k)), flat(_t(v)),
                           flat(_t(ld)), flat(_t(sc)), chunk=chunk)
    y_kern = y_kern.reshape(b, h, s, p).transpose(1, 2)
    torch.testing.assert_close(y_kern, y_model, rtol=3e-4, atol=3e-4)
    y_ref, _ = j_chunked(*(jnp.asarray(a) for a in (q, k, v, ld, sc)),
                         chunk=chunk)
    np.testing.assert_allclose(_np(y_kern), _jnp(y_ref), rtol=3e-4,
                               atol=3e-4)


@pytest.mark.parametrize("shapes,chunk,match", [
    (((2, 30, 4), (2, 30, 4), (2, 30, 3), (2, 30), (2, 30)), 8, "multiple"),
    (((2, 30, 4), (2, 30, 5), (2, 30, 3), (2, 30), (2, 30)), 10, "expected"),
    (((2, 30, 4), (2, 30, 4), (2, 29, 3), (2, 30), (2, 30)), 10, "expected"),
    (((2, 30, 4), (2, 30, 4), (2, 30, 3), (2, 31), (2, 30)), 10, "expected"),
    (((2, 30, 4), (2, 30, 4), (2, 30, 3), (2, 30), (2, 30)), 0, "chunk"),
])
def test_ssm_scan_contract_raises_value_error(shapes, chunk, match):
    tensors = [torch.zeros(sh) for sh in shapes]
    with pytest.raises(ValueError, match=match):
        tops.ssm_scan(*tensors, chunk=chunk)
    with pytest.raises(ValueError, match=match):
        tssm.ssm_scan_plain(*tensors, chunk=chunk)


def test_ssm_scan_dtype_contract():
    z = torch.zeros(2, 8, 4)
    with pytest.raises(ValueError, match="dtype"):
        tssm.ssm_scan(z, z.double(), torch.zeros(2, 8, 3), torch.zeros(2, 8),
                      torch.zeros(2, 8))
    with pytest.raises(ValueError, match="floating"):
        tssm.ssm_scan(z, z, torch.zeros(2, 8, 3), torch.zeros(2, 8),
                      torch.zeros(2, 8, dtype=torch.int32))


def test_ssm_scan_shared_memory_limit_is_the_kernels_only():
    """A chunk of 1024 with P past one column tile does not fit the CUDA
    kernel's block, whose scores tile holds the chunk's keys (the card
    raises ``ValueError``, ``chip_smoke.py`` ``ssm_kernel``; N 2048 at chunk
    256 runs there); the plain version has no such limit and meets the
    reference's recurrence at both shapes."""
    for (bh, s, n, p, chunk, seed) in ((1, 1024, 8, 72, 1024, 13),
                                       (1, 256, 2048, 3, 256, 14)):
        arrays = _ssm_inputs(bh, s, n, p, seed)
        got = tssm.ssm_scan(*map(_t, arrays), chunk=chunk)
        assert got.shape == (bh, s, p)
        np.testing.assert_allclose(
            _np(got),
            _jnp(jref.ssm_scan_ref(*(jnp.asarray(a) for a in arrays))),
            rtol=3e-4, atol=3e-4)


# the kernel's three passes, mirrored in plain PyTorch (ssm_scan_passes):
# S equal to one chunk (no state is passed), several chunks, N and P that
# tile nothing, a chunk that tiles no row block, and float64
PASS_CASES = [
    (2, 32, 8, 8, 32, "float32"),
    (2, 64, 8, 8, 16, "float32"),
    (3, 96, 33, 65, 32, "float32"),
    (2, 48, 5, 7, 12, "float32"),
    (4, 64, 16, 32, 16, "float64"),
    (2, 40, 6, 9, 8, "float64"),
]


@pytest.mark.parametrize("bh,s,n,p,chunk,dtype", PASS_CASES)
def test_ssm_scan_passes_match_reference_kernel_and_plain(bh, s, n, p, chunk,
                                                         dtype):
    arrays = _ssm_inputs(bh, s, n, p, bh * s + n + p)
    td = torch.float64 if dtype == "float64" else torch.float32
    tens = [torch.from_numpy(a.astype(np.float64)).to(td) for a in arrays]
    got = tssm.ssm_scan_passes(*tens, chunk=chunk)
    assert got.shape == (bh, s, p) and got.dtype == td
    plain = tssm.ssm_scan_plain(*tens, chunk=chunk)
    torch.testing.assert_close(got, plain, rtol=3e-4, atol=3e-4)
    j = [jnp.asarray(a) for a in arrays]
    want = jops.ssm_scan(*j, chunk=chunk, interpret=True)
    np.testing.assert_allclose(got.numpy().astype(np.float32), _jnp(want),
                               rtol=3e-4, atol=3e-4)


def test_ssm_scan_passes_narrow_operands_keep_v_dtype():
    """bfloat16 operands are widened as in the plain version and y comes
    back in bfloat16, within one step of the Pallas kernel's result."""
    arrays = _ssm_inputs(2, 64, 8, 8, 21)
    q, k, v = (_t(a, torch.bfloat16) for a in arrays[:3])
    got = tssm.ssm_scan_passes(q, k, v, _t(arrays[3]), _t(arrays[4]),
                               chunk=16)
    assert got.dtype == torch.bfloat16
    j = [jnp.asarray(a, jnp.bfloat16) for a in arrays[:3]] \
        + [jnp.asarray(a) for a in arrays[3:]]
    want = jops.ssm_scan(*j, chunk=16, interpret=True)
    scale = float(np.abs(_jnp(want)).max())
    np.testing.assert_allclose(_np(got), _jnp(want), rtol=2e-2,
                               atol=2e-2 * scale)


def test_ssm_scan_passes_masks_by_select():
    """A decay steep enough that exp(cd_i - cd_j) overflows above the
    diagonal leaves y finite in the mirror, as in the plain version: the
    mask is a select, never a multiply by 0/1 (inf * 0 would be NaN)."""
    arrays = list(_ssm_inputs(1, 32, 4, 4, 22))
    arrays[3] = np.full((1, 32), -40.0, np.float32)   # exp(40 * 31) = inf
    tens = [_t(a) for a in arrays]
    got = tssm.ssm_scan_passes(*tens, chunk=32)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, tssm.ssm_scan_plain(*tens, chunk=32),
                               rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("shapes,chunk,match", [
    (((2, 30, 4), (2, 30, 4), (2, 30, 3), (2, 30), (2, 30)), 8, "multiple"),
    (((2, 30, 4), (2, 30, 5), (2, 30, 3), (2, 30), (2, 30)), 10, "expected"),
])
def test_ssm_scan_passes_keep_the_contract(shapes, chunk, match):
    with pytest.raises(ValueError, match=match):
        tssm.ssm_scan_passes(*[torch.zeros(sh) for sh in shapes],
                             chunk=chunk)


# ---------------------------------------------------------------------------
# launches
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    before = (dict(tax.LAUNCHES), dict(tconv.LAUNCHES), dict(tssm.LAUNCHES))
    x = torch.randn(64)
    torch.testing.assert_close(tax.axpy(1.5, x, x, block=64),
                               tax.axpy_plain(1.5, x, x), rtol=0, atol=0)
    xi, wi = torch.randn(2, 6, 6), torch.randn(3, 2, 3, 3)
    torch.testing.assert_close(tconv.conv2d_direct(xi, wi),
                               tconv.conv2d_plain(xi, wi), rtol=0, atol=0)
    q = torch.randn(2, 16, 4)
    args = (q, q, torch.randn(2, 16, 3), -torch.rand(2, 16), torch.rand(2, 16))
    torch.testing.assert_close(tssm.ssm_scan(*args, chunk=8),
                               tssm.ssm_scan_plain(*args, chunk=8), rtol=0,
                               atol=0)
    assert (tax.LAUNCHES, tconv.LAUNCHES, tssm.LAUNCHES) == before
    for mod, name in ((tax, "axpy"), (tconv, "conv2d_direct"),
                      (tssm, "ssm_scan")):
        mod.LAUNCHES[name] += 3
        mod.reset_launches()
        assert mod.LAUNCHES == {name: 0}
