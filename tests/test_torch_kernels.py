"""PyTorch port, kernel modules: ``repro_torch.kernels`` against
``repro.kernels`` on the same numpy inputs.

The reference's Pallas kernels run in interpret mode; the port's wrappers
get CPU tensors and therefore take their plain versions — the arithmetic
the CUDA kernels repeat and are held against on the card. So these
tests pin the wrappers' contract (shapes, dtypes, block arithmetic,
epilogue, routing) and the plain versions' agreement with the reference.
"""
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core import precision as tprecision
from repro_torch.core import stripmine as tstrip
from repro_torch.kernels import attention as tka, axpy as tax, \
    conv as tconv, ssm_scan as tssm
from repro_torch.kernels import matmul as tmm
from repro_torch.kernels import ops as tops

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
       "float16": jnp.float16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
       "float16": torch.float16}
# fp32: both sides accumulate in fp32, only the summation order differs.
# bf16/f16: both cast the SAME numpy inputs to the narrow type (exact same
# operand bits), accumulate in fp32 and round once to the narrow output —
# one output ulp (2^-8 for bf16) is the most they can differ by.
TOL = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 2e-2}

SWEEP = [(8, 8, 8, 8, 8, 8), (32, 16, 24, 8, 8, 8),
         (64, 128, 32, 16, 16, 32), (128, 64, 128, 128, 128, 64)]


def _np32(t):
    return t.float().numpy()


@pytest.mark.parametrize("m,k,n,bm,bn,bk", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_matmul_sweep_matches_reference(m, k, n, bm, bn, bk, dtype):
    r = np.random.RandomState(m * 1000 + n)
    a, b = r.randn(m, k).astype(np.float32), r.randn(k, n).astype(np.float32)
    want = jops.matmul(jnp.asarray(a, JDT[dtype]), jnp.asarray(b, JDT[dtype]),
                       bm=bm, bn=bn, bk=bk, interpret=True)
    got = tops.matmul(torch.from_numpy(a).to(TDT[dtype]),
                      torch.from_numpy(b).to(TDT[dtype]),
                      bm=bm, bn=bn, bk=bk)
    assert got.dtype == TDT[dtype] and got.shape == (m, n)
    np.testing.assert_allclose(_np32(got), np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype] * 4)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_matmul_narrow_in_fp32_out(dtype):
    """The logits-head use: narrow operands, fp32 result (no final
    narrowing), so only the fp32 summation order differs: 1e-5."""
    r = np.random.RandomState(1)
    a, b = r.randn(8, 64).astype(np.float32), r.randn(64, 256).astype(np.float32)
    want = jops.matmul(jnp.asarray(a, JDT[dtype]), jnp.asarray(b, JDT[dtype]),
                       out_dtype=jnp.float32, interpret=True)
    got = tops.matmul(torch.from_numpy(a).to(TDT[dtype]),
                      torch.from_numpy(b).to(TDT[dtype]),
                      out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


def test_matmul_policy_casts_and_lmul_flows():
    r = np.random.RandomState(2)
    a, b = r.randn(16, 32).astype(np.float32), r.randn(32, 64).astype(np.float32)
    pol = tprecision.Policy(compute_dtype="bfloat16", lmul=2)
    got = tops.matmul(torch.from_numpy(a), torch.from_numpy(b), policy=pol,
                      bm=16, bn=16, bk=16)
    assert got.dtype == torch.bfloat16
    want = tmm.matmul_plain(torch.from_numpy(a).bfloat16(),
                            torch.from_numpy(b).bfloat16())
    assert torch.equal(got, want)


@pytest.mark.parametrize("lmul", [1, 2, 4, Fraction(1, 2), Fraction(1, 4)])
def test_matmul_lmul_variants_agree(lmul):
    r = np.random.RandomState(3)
    a, b = r.randn(32, 32).astype(np.float32), r.randn(32, 64).astype(np.float32)
    base = tops.matmul(torch.from_numpy(a), torch.from_numpy(b),
                       bm=16, bn=16, bk=16)
    got = tops.matmul(torch.from_numpy(a), torch.from_numpy(b),
                      bm=16, bn=16, bk=16, lmul=lmul)
    want = jops.matmul(jnp.asarray(a), jnp.asarray(b), bm=16, bn=16, bk=16,
                       lmul=lmul, interpret=True)
    assert torch.equal(got, base)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


def test_matmul_int8_exact_and_requantized():
    """The case of the reference's int8 kernel test (16-wide blocks)."""
    r = np.random.RandomState(0)
    a = r.randint(-64, 64, (32, 48)).astype(np.int8)
    b = r.randint(-64, 64, (48, 64)).astype(np.int8)
    want = a.astype(np.int32) @ b.astype(np.int32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = tops.matmul_int8(ta, tb, bm=16, bn=16, bk=16)
    ref = jops.matmul_int8(jnp.asarray(a), jnp.asarray(b), bm=16, bn=16,
                           bk=16, interpret=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

    got8 = tops.matmul_int8(ta, tb, bm=16, bn=16, bk=16,
                            out_dtype=torch.int8, shift=7)
    ref8 = jops.matmul_int8(jnp.asarray(a), jnp.asarray(b), bm=16, bn=16,
                            bk=16, interpret=True, out_dtype=jnp.int8,
                            shift=7)
    assert got8.dtype == torch.int8
    np.testing.assert_array_equal(
        got8.numpy(), np.clip((want + 64) >> 7, -128, 127).astype(np.int8))
    np.testing.assert_array_equal(got8.numpy(), np.asarray(ref8))

    # int32 output with a shift: shifted, NOT clamped
    got32s = tops.matmul_int8(ta, tb, bm=16, bn=16, bk=16, shift=3)
    ref32s = jops.matmul_int8(jnp.asarray(a), jnp.asarray(b), bm=16, bn=16,
                              bk=16, interpret=True, shift=3)
    np.testing.assert_array_equal(got32s.numpy(), (want + 4) >> 3)
    np.testing.assert_array_equal(got32s.numpy(), np.asarray(ref32s))
    assert np.abs(got32s.numpy()).max() > 127


def test_matmul_int8_saturates_at_both_ends():
    a = np.full((8, 16), 127, np.int8)
    b = np.concatenate([np.full((16, 8), 127, np.int8),
                        np.full((16, 8), -128, np.int8)], axis=1)
    got = tops.matmul_int8(torch.from_numpy(a), torch.from_numpy(b),
                           out_dtype=torch.int8, shift=4)
    ref = jops.matmul_int8(jnp.asarray(a), jnp.asarray(b), interpret=True,
                           out_dtype=jnp.int8, shift=4)
    assert (got[:, :8] == 127).all() and (got[:, 8:] == -128).all()
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_matmul_int8_requantize_wraps_like_int32():
    """The add-half step wraps around as int32 does (the plain epilogue
    spells that out in int64; the CUDA kernel adds in unsigned)."""
    acc = torch.tensor([2**31 - 1, -2**31, 5, -5], dtype=torch.int64)
    got = tmm._requantize(acc, 1, torch.int32)
    want = ((acc.numpy().astype(np.int32) + np.int32(1)) >> 1)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("lmul", [1, 2, Fraction(1, 2)])
def test_matmul_int8_lmul_blocks_match(lmul):
    r = np.random.RandomState(5)
    a = r.randint(-32, 32, (32, 32)).astype(np.int8)
    b = r.randint(-32, 32, (32, 32)).astype(np.int8)
    want = jops.matmul_int8(jnp.asarray(a), jnp.asarray(b), bm=16, bn=16,
                            bk=16, lmul=lmul, interpret=True)
    got = tops.matmul_int8(torch.from_numpy(a), torch.from_numpy(b), bm=16,
                           bn=16, bk=16, lmul=lmul)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fn,dt", [(tmm.matmul, torch.float32),
                                   (tmm.matmul_int8, torch.int8)])
def test_shape_contract_raises_value_error(fn, dt):
    """Where the reference asserts, the port raises ValueError."""
    def z(*shape):
        return torch.zeros(shape, dtype=dt)
    with pytest.raises(ValueError):        # contraction mismatch
        fn(z(8, 16), z(8, 8))
    with pytest.raises(ValueError):        # n not a multiple of its block
        fn(z(8, 8), z(8, 24), bn=16)
    with pytest.raises(ValueError):        # m not tiled
        fn(z(12, 8), z(8, 8), bm=8)
    with pytest.raises(ValueError):        # k not tiled
        fn(z(8, 12), z(12, 8), bk=8)
    with pytest.raises(ValueError):        # wrong rank
        fn(z(2, 8, 8), z(8, 8))
    # blocks clamp to the dims, so an odd shape that its own size tiles is fine
    assert fn(z(5, 7), z(7, 9)).shape == (5, 9)


def test_dtype_contract_raises_value_error():
    f32, i8 = torch.zeros(8, 8), torch.zeros(8, 8, dtype=torch.int8)
    with pytest.raises(ValueError):
        tmm.matmul(i8, i8)
    with pytest.raises(ValueError):
        tmm.matmul(f32, f32.bfloat16())
    with pytest.raises(ValueError):
        tmm.matmul(f32, f32, out_dtype=torch.int32)
    with pytest.raises(ValueError):
        tmm.matmul_int8(f32, f32)
    with pytest.raises(ValueError):
        tmm.matmul_int8(i8, i8, out_dtype=torch.float32)
    with pytest.raises(ValueError):
        tmm.matmul_int8(i8, i8, shift=32)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    tmm.reset_launches()
    a = torch.ones(8, 8)
    assert torch.equal(tmm.matmul(a, a), tmm.matmul_plain(a, a))
    i = torch.ones(8, 8, dtype=torch.int8)
    assert torch.equal(tmm.matmul_int8(i, i), tmm.matmul_int8_plain(i, i))
    assert tmm.LAUNCHES == {"matmul": 0, "matmul_int8": 0}


class _FakeMatmulLib:
    """Stands in for the built ``csrc/matmul.cu`` where no card is: its
    row limit and route answers, as the source gives them
    (``test_fake_matmul_library_is_the_source`` holds the two together)."""
    ROW_LIMIT = {0: 65535 * 128, 1: 65535 * 128, 2: 65535 * 128,
                 3: 65535 * 128}

    def repro_matmul_max_rows(self, code):
        return self.ROW_LIMIT[code]

    def repro_matmul_route(self, m, k, n, code):
        return (2 if m <= 16 else 3) if code == 0 else (0 if m <= 16 else 1)

    def repro_matmul_int8_route(self, m, k, n):
        return -1 if m < 1 else (0 if m <= 16 else 1)


def _source_constants():
    """The integer constants of ``csrc/matmul.cu`` that the row limit and
    the route boundaries are made of."""
    import re
    from repro_torch.kernels import build
    text = (build.CSRC / "matmul.cu").read_text()
    return {name: int(value) for name, value in
            re.findall(r"\b(k\w+) = (\d+)[,;]", text)}, text


def test_fake_matmul_library_is_the_source():
    """The fake's answers are the source's: the row limit is grid.y's
    65535 row tiles of the tiled routes' large tiles (128 rows for matmul,
    ``kI8BM`` for matmul_int8, whose small tiles only run shapes with fewer
    tiles than SMs), and both types switch route above 16 rows."""
    consts, text = _source_constants()
    assert consts["kGridY"] == 65535
    assert consts["kTBM"] == 128 and consts["kSkM"] == 16
    assert consts["kI8BM"] == 128 and consts["kI8SkM"] == 16
    assert "if (in_dtype == 3) return kGridY * kI8BM;" in text
    assert "return M <= kI8SkM ? 0 : 1;" in text
    lib = _FakeMatmulLib()
    assert lib.ROW_LIMIT[3] == consts["kGridY"] * consts["kI8BM"]
    assert lib.ROW_LIMIT[0] == consts["kGridY"] * consts["kTBM"]
    for m in (1, 16, 17):
        assert lib.repro_matmul_int8_route(m, 8, 8) == (m > consts["kI8SkM"])


def test_matmul_row_limit_is_the_sources():
    """The wrapper holds a launch to the rows the source says its grid
    takes (``repro_matmul_max_rows``): 128-row tiles for matmul and for
    matmul_int8, each up to 65535 grid rows; non-contiguous operands raise
    first."""
    lib = _FakeMatmulLib()
    b = torch.empty((1, 0))
    for code, rows in lib.ROW_LIMIT.items():
        tmm._check_launchable(lib, torch.empty((rows, 0)), b, code, "x")
        with pytest.raises(ValueError, match=f"grid \\({rows} rows\\)"):
            tmm._check_launchable(lib, torch.empty((rows + 1, 0)), b, code,
                                  "x")
        with pytest.raises(ValueError, match="contiguous"):
            tmm._check_launchable(lib, torch.empty((4, 2)).t(), b, code, "x")
    assert lib.ROW_LIMIT[1] > 65535 * 8      # the old 8-row grid's limit


@pytest.mark.parametrize("m,dtype,want", [
    (1, "bfloat16", "skinny_mma"), (16, "float16", "skinny_mma"),
    (17, "bfloat16", "tiled_mma"), (8192, "float16", "tiled_mma"),
    (16, "float32", "skinny_fma"), (17, "float32", "tiled_fma")])
def test_matmul_kernel_route_names(monkeypatch, m, dtype, want):
    """``kernel_route`` reports the source's route code by name; the
    boundary is M = 16 / 17 for every operand type."""
    monkeypatch.setattr(tmm.build, "load", lambda name: _FakeMatmulLib())
    assert tmm.kernel_route(m, 2048, 32000, dtype) == want
    assert set(tmm.ROUTES) == {"skinny_mma", "tiled_mma", "skinny_fma",
                               "tiled_fma"}


def test_matmul_kernel_route_refuses_int8(monkeypatch):
    monkeypatch.setattr(tmm.build, "load", lambda name: _FakeMatmulLib())
    with pytest.raises(ValueError):
        tmm.kernel_route(8, 64, 64, torch.int8)


@pytest.mark.parametrize("m,want", [
    (1, "skinny_imma"), (16, "skinny_imma"), (17, "tiled_imma"),
    (8192, "tiled_imma")])
def test_matmul_int8_kernel_route_names(monkeypatch, m, want):
    """``kernel_route_int8`` reports the source's int8 route code by name,
    with the boundary at M = 16 / 17; a code below 0 raises."""
    monkeypatch.setattr(tmm.build, "load", lambda name: _FakeMatmulLib())
    assert tmm.kernel_route_int8(m, 2048, 32000) == want
    assert tmm.ROUTES_INT8 == ("skinny_imma", "tiled_imma")
    with pytest.raises(ValueError):
        tmm.kernel_route_int8(0, 2048, 32000)


def _meta(*shape, dtype=torch.int8):
    return torch.zeros(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("a,b,kw,outcome", [
    (_meta(8, 16, dtype=torch.float32), _meta(16, 8), {}, "raises"),
    (_meta(8, 16), _meta(16, 8, dtype=torch.uint8), {}, "raises"),
    (_meta(8, 16), _meta(16, 8), {"out_dtype": torch.float32}, "raises"),
    (_meta(8, 16), _meta(16, 8), {"out_dtype": torch.int16}, "raises"),
    (_meta(8, 16), _meta(16, 8), {"shift": 32}, "raises"),
    (_meta(8, 16), _meta(16, 8), {"shift": -1}, "raises"),
    (_meta(8, 16), _meta(12, 8), {}, "raises"),
    (_meta(2, 8, 16), _meta(16, 8), {}, "raises"),
    (_meta(8, 16), _meta(16, 24), {"bn": 16}, "raises"),
    (_meta(8, 16), _meta(16, 8), {}, "meta output"),
])
def test_matmul_int8_contract_raises_before_any_launch(monkeypatch, a, b, kw,
                                                       outcome):
    """Wrong dtypes, shapes and shifts raise ValueError before the library
    is loaded, and so before any launch; on ``meta`` a call that meets the
    contract returns an output of its shape and dtype, again without
    loading the library or launching."""
    def no_load(name):
        raise AssertionError("the library was loaded")
    monkeypatch.setattr(tmm.build, "load", no_load)
    tmm.reset_launches()
    if outcome == "meta output":
        out = tmm.matmul_int8(a, b, **kw)
        assert (out.device.type, tuple(out.shape), out.dtype) == (
            "meta", (8, 8), torch.int32)
    else:
        with pytest.raises(ValueError):
            tmm.matmul_int8(a, b, **kw)
    assert tmm.LAUNCHES["matmul_int8"] == 0


class _Elsewhere(torch.Tensor):
    """A CPU tensor that reports a device no wrapper takes."""

    @property
    def device(self):
        return torch.device("xpu")


def _elsewhere(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype).as_subclass(_Elsewhere)


_F = _elsewhere
_ATT = (_F(2, 16, 8), _F(2, 16, 8), _F(2, 16, 8),
        _F(2, 16, dtype=torch.int32))
_ATT_BWD = _ATT + (_F(2, 16, 8), _F(2, 16), _F(2, 16))


@pytest.mark.parametrize("module,name,args,kw", [
    (tmm, "matmul", (_F(8, 16), _F(16, 8)), {}),
    (tmm, "matmul_int8", (_F(8, 16, dtype=torch.int8),
                          _F(16, 8, dtype=torch.int8)), {}),
    (tax, "axpy", (1.0, _F(64), _F(64)), {"block": 64}),
    (tconv, "conv2d_direct", (_F(3, 8, 8), _F(4, 3, 3, 3)), {}),
    (tssm, "ssm_scan", (_F(2, 128, 16), _F(2, 128, 16), _F(2, 128, 8),
                        _F(2, 128), _F(2, 128)), {"chunk": 128}),
    (tka, "flash_fwd", _ATT, {"causal": True, "bq": 8, "bk": 8}),
    (tka, "flash_bwd_dq", _ATT_BWD, {"causal": True, "bq": 8, "bk": 8}),
    (tka, "flash_bwd_dkv", _ATT_BWD, {"causal": True, "bq": 8, "bk": 8}),
])
def test_each_wrapper_refuses_an_unsupported_device(monkeypatch, module,
                                                    name, args, kw):
    """A device that is neither the CPU, CUDA nor meta raises ValueError
    through the wrapper itself, before the library is loaded, and nothing
    is launched."""
    def no_load(lib):
        raise AssertionError("the library was loaded")
    monkeypatch.setattr(module.build, "load", no_load)
    module.reset_launches()
    with pytest.raises(ValueError, match=f"{name}: unsupported device xpu"):
        getattr(module, name)(*args, **kw)
    assert not any(module.LAUNCHES.values())


@pytest.mark.parametrize("m,k,n,bm,bn,bk", [
    (16, 256, 200, 16, 200, 128), (17, 256, 200, 17, 200, 128),
    (129, 77, 93, 129, 93, 77), (256, 256, 256, 128, 128, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_matmul_route_shapes_match_reference(m, k, n, bm, bn, bk, dtype):
    """Both sides of the skinny / tiled boundary, a ragged tiled shape and
    the paper's 256^3: the wrapper keeps the reference's numbers and output
    type at each (on the card these are chip_smoke.py's new checks)."""
    r = np.random.RandomState(m + n)
    a, b = r.randn(m, k).astype(np.float32), r.randn(k, n).astype(np.float32)
    want = jops.matmul(jnp.asarray(a, JDT[dtype]), jnp.asarray(b, JDT[dtype]),
                       bm=bm, bn=bn, bk=bk, interpret=True)
    got = tops.matmul(torch.from_numpy(a).to(TDT[dtype]),
                      torch.from_numpy(b).to(TDT[dtype]), bm=bm, bn=bn, bk=bk)
    assert got.dtype == TDT[dtype] and got.shape == (m, n)
    np.testing.assert_allclose(_np32(got), np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype] * 4)


def test_lm_head_routes():
    cases = [((8, 64, 256, "float32"), "einsum-fp32"),
             ((8, 64, 256, "bfloat16"), "bfloat16"),
             ((8, 64, 256, "float16"), "float16"),
             ((8, 64, 256, "int8"), "int8"),
             ((8, 64, 200, "int8"), "einsum-fallback"),
             ((8, 2048, 32000, "int8"), "int8"),
             ((8, 2048, 32000, "bfloat16"), "bfloat16")]
    for args, want in cases:
        ref = jops.lm_head_route(*args)
        got = tops.lm_head_route(*args)
        if want.startswith("einsum"):
            assert got == ref == want
        else:   # the reference's pallas-* with the prefix changed
            assert ref == f"pallas-{want}" and got == f"cuda-{want}"


def test_lm_head_route_on_the_card_is_always_a_kernel():
    """On a CUDA device no narrow head gives way to an einsum: a shape the
    default blocks do not tile goes through the kernels with
    whole-dimension blocks, which always meet the block contract."""
    for dt in ("int8", "bfloat16", "float16"):
        want = "cuda-int8" if dt == "int8" else f"cuda-{dt}"
        assert tops.lm_head_route(200, 64, 200, dt, device="cuda") == want
        assert tops.lm_head_route(200, 64, 200, dt, device="cuda:1") == want
        assert tops.lm_head_route(200, 64, 200, dt,
                                  device="cpu") == "einsum-fallback"
    assert tops.lm_head_route(200, 64, 200, "float32",
                              device="cuda") == "einsum-fp32"
    r = np.random.RandomState(11)
    a = r.randint(-128, 128, (200, 136)).astype(np.int8)
    b = r.randint(-128, 128, (136, 200)).astype(np.int8)
    with pytest.raises(ValueError):
        tmm.matmul_int8(torch.from_numpy(a), torch.from_numpy(b))
    got = tmm.matmul_int8(torch.from_numpy(a), torch.from_numpy(b), bm=200,
                          bn=200, bk=136)
    np.testing.assert_array_equal(
        got.numpy(), a.astype(np.int32) @ b.astype(np.int32))
    af = torch.from_numpy(a).float()
    got = tmm.matmul(af, torch.from_numpy(b).float(), bm=200, bn=200, bk=136)
    assert got.shape == (200, 200)


def test_lm_head_numerics_match_reference():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 4, 64).astype(np.float32)
    w = rng.randn(64, 256).astype(np.float32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    ref = np.einsum("bsd,dv->bsv", x, w)

    # fp32 route: the same fp32 product, summation order aside: 1e-6 of scale
    out = tops.lm_head(tx, tw, compute_dtype="float32")
    want = jops.lm_head(jnp.asarray(x), jnp.asarray(w),
                        compute_dtype="float32")
    assert out.dtype == torch.float32 and out.shape == (2, 4, 256)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6 * np.abs(ref).max())

    out16 = tops.lm_head(tx, tw, compute_dtype="bfloat16")
    want16 = jops.lm_head(jnp.asarray(x), jnp.asarray(w),
                          compute_dtype="bfloat16")
    np.testing.assert_allclose(out16.numpy(), np.asarray(want16), rtol=1e-5,
                               atol=1e-4)
    assert np.abs(out16.numpy() - ref).max() / np.abs(ref).max() < 0.05

    out8 = tops.lm_head(tx, tw, compute_dtype="int8")
    want8 = jops.lm_head(jnp.asarray(x), jnp.asarray(w), compute_dtype="int8")
    assert out8.dtype == torch.float32
    assert np.abs(out8.numpy() - ref).max() / np.abs(ref).max() < 0.1
    # the int32 product is exact on both sides and the two fp32 scales are
    # computed by the same correctly-rounded operations: 1e-6
    np.testing.assert_allclose(out8.numpy(), np.asarray(want8), rtol=1e-6,
                               atol=1e-6 * np.abs(ref).max())

    w_odd = rng.randn(64, 200).astype(np.float32)
    out_f = tops.lm_head(tx, torch.from_numpy(w_odd), compute_dtype="int8")
    want_f = jops.lm_head(jnp.asarray(x), jnp.asarray(w_odd),
                          compute_dtype="int8")
    assert out_f.shape == (2, 4, 200) and out_f.dtype == torch.float32
    np.testing.assert_allclose(out_f.numpy(), np.asarray(want_f), rtol=1e-5,
                               atol=1e-4)


def test_lm_head_int8_quantization_equals_reference():
    """The int8 route's quantized operands and int32 product are EQUAL to
    the reference's (same fp32 scale arithmetic, round-half-to-even, clip)."""
    rng = np.random.RandomState(7)
    x = rng.randn(8, 64).astype(np.float32)
    w = rng.randn(64, 256).astype(np.float32)

    def jq(v):
        v = jnp.asarray(v)
        s = jnp.max(jnp.abs(v)) / 127.0 + 1e-8
        return jnp.clip(jnp.round(v / s), -127, 127).astype(jnp.int8), s

    def tq(v):
        v = torch.from_numpy(v)
        s = v.abs().max() / 127.0 + 1e-8
        return torch.round(v / s).clamp(-127, 127).to(torch.int8), s

    (jqx, jsx), (jqw, jsw) = jq(x), jq(w)
    (tqx, tsx), (tqw, tsw) = tq(x), tq(w)
    assert float(jsx) == float(tsx) and float(jsw) == float(tsw)
    np.testing.assert_array_equal(tqx.numpy(), np.asarray(jqx))
    np.testing.assert_array_equal(tqw.numpy(), np.asarray(jqw))
    acc_j = jops.matmul_int8(jqx, jqw, interpret=True)
    acc_t = tops.matmul_int8(tqx, tqw)
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
    # and lm_head is exactly that pipeline
    out = tops.lm_head(torch.from_numpy(x)[None], torch.from_numpy(w),
                       compute_dtype="int8")
    assert torch.equal(out[0], acc_t.float() * (tsx * tsw))


def test_precision_and_stripmine_copies_match_reference():
    from repro.core import precision as jprec
    from repro.core import stripmine as jstrip
    for n, base, lmul in [(32000, 128, 1), (32000, 128, 2), (96, 16, 4),
                          (100, 16, Fraction(1, 2)), (7, 128, 1)]:
        assert tstrip.lmul_tile(n, base, lmul) == jstrip.lmul_tile(n, base,
                                                                   lmul)
    assert tstrip.strip_lengths(100, 16, 2) == jstrip.strip_lengths(100, 16, 2)
    assert tstrip.mixed_width_lmul(1, 32, 8) == jstrip.mixed_width_lmul(1, 32, 8)
    assert tprecision.DTYPE_TO_SEW == jprec.DTYPE_TO_SEW
    assert tprecision.SEW_TO_DTYPE == jprec.SEW_TO_DTYPE
    jp, tp = jprec.Policy(), tprecision.Policy()
    assert [f.name for f in jp.__dataclass_fields__.values()] \
        == [f.name for f in tp.__dataclass_fields__.values()]
    assert tp.sew == jp.sew == 16
    # the port's peaks are the H100's own: int8 twice bf16, bf16 twice TF32
    assert tp.peak_flops() == tprecision.PEAKS_FLOPS["bfloat16"] == 989e12
    assert tprecision.PEAKS_FLOPS["int8"] == 1979e12
    assert tprecision.PEAKS_FLOPS["tf32"] == 495e12
    assert tprecision.sew_for_dtype(torch.bfloat16) == 16
    assert tprecision.dtype_for_sew(8) == torch.int8
