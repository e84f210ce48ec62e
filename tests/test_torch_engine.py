"""PyTorch port, the Ara vector engine: ``repro_torch.core`` (isa, analysis,
staging, vector_engine, perfmodel), ``repro_torch.configs.ara`` and
``repro_torch.testing.differential`` against the reference package.

On the CPU (``device="cpu"``):

- the pure-host modules are copies, pinned to their originals' source;
- the port's encoder builds the reference's instruction tables;
- the port's ``ReferenceEngine`` meets the numpy oracle over the 21-cell
  SEW x LMUL grid at ``diff.TOL`` (the reference test's gate), and equals
  the JAX ``ReferenceEngine`` bit for bit: float32 and int32 in this
  process, float64 in a subprocess with x64 enabled (in-process JAX runs
  float64 as float32);
- the scoreboard's cycles and unit occupancy equal the reference's;
- the runner cache follows the reference's single-device trace-cache
  cases, with the port's contract: one build per signature, then hits.

The same engine on the card is held to the CPU run, bit for bit, by
``chip_smoke.py`` phase ``vector_engine``.
"""
import collections
import json
import os
import pathlib
import re
import subprocess
import sys
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from conftest import run_devices
from repro.configs import ara as jara
from repro.core import isa as jisa
from repro.core import precision as jprecision
from repro.core import staging as jstaging
from repro.core.vector_engine import ReferenceEngine as JEngine
from repro.core.vector_engine import simulate_timing as jsimulate
from repro.testing import differential as jdiff
from repro_torch.configs import ara
from repro_torch.core import analysis, isa, precision, staging
from repro_torch.core import perfmodel as pm
from repro_torch.core.vector_engine import ReferenceEngine, simulate_timing
from repro_torch.testing import differential as diff

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
V = diff.VLMAX64
WIN = diff.grid_window(V)
TORCH = {"float32": torch.float32, "float64": torch.float64,
         "int32": torch.int32}


def _engine(dtype="float32", cache=None, vlmax=V, lanes=2):
    if cache is None:               # an empty cache is falsy: len()
        cache = staging.TraceCache()
    return ReferenceEngine(ara.AraConfig(lanes=lanes), vlmax=vlmax,
                           dtype=TORCH[dtype], cache=cache, device="cpu")


def _same_bits(a, b) -> bool:
    """Equal dtype, shape and bit patterns (any NaN matches any NaN)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    ua, ub = a.view(f"u{a.itemsize}"), b.view(f"u{b.itemsize}")
    same = ua == ub
    if a.dtype.kind == "f":
        same |= np.isnan(a) & np.isnan(b)
    return bool(np.all(same))


def _sregs(s):
    return np.array([s[k] for k in range(32)])


def _assert_runs_equal(got, want, what):
    (gm, gs), (wm, ws) = got, want
    assert len(gm) == len(wm)
    for i in range(len(gm)):
        assert _same_bits(gm[i], wm[i]), (what, i, "memory")
        assert _same_bits(_sregs(gs[i]), _sregs(ws[i])), (what, i, "sregs")


def _cell_batch(d, sew, lmul, seeds):
    """One grid cell's (programs, memories, sregs) from a package's own
    generator (each engine dispatches on its own package's ISA classes)."""
    out = [d.random_program(np.random.RandomState(s), sew, lmul)
           for s in seeds]
    return [o[0] for o in out], [o[1] for o in out], [o[2] for o in out]


# ---------------------------------------------------------------------------
# copies of the pure-host modules
# ---------------------------------------------------------------------------

COPIES = ("configs/ara.py", "core/isa.py", "core/analysis.py",
          "core/perfmodel.py", "testing/differential.py",
          "testing/faults.py")


def _as_port(text):
    return re.sub(r"^(\s*)(from|import) repro\.", r"\1\2 repro_torch.",
                  text, flags=re.M)


@pytest.mark.parametrize("rel", COPIES)
def test_copied_modules_equal_the_reference(rel):
    ref = (REPO / "src" / "repro" / rel).read_text()
    port = (REPO / "src" / "repro_torch" / rel).read_text()
    assert _as_port(ref) == port


def test_scoreboard_is_a_copy():
    """``simulate_timing`` and its tables, from the section header on."""
    def section(pkg):
        text = (REPO / "src" / pkg / "core" / "vector_engine.py").read_text()
        return text[text.index("# Scoreboard timing simulation"):]
    assert section("repro") == section("repro_torch")


def test_staging_host_half_is_the_reference():
    import inspect
    for name in ("bucket", "bucket_pow2", "encode_program", "pack_tables"):
        assert inspect.getsource(getattr(staging, name)) \
            == inspect.getsource(getattr(jstaging, name)), name
    assert staging.OPS == jstaging.OPS and staging.FIELDS == jstaging.FIELDS
    assert staging.OP_ID == jstaging.OP_ID
    assert staging.INT_OPS == jstaging.INT_OPS
    assert precision.ARA_FLOP_PER_CYCLE_PER_LANE \
        == jprecision.ARA_FLOP_PER_CYCLE_PER_LANE
    assert ara.PAPER_TABLE3 == jara.PAPER_TABLE3
    assert ara.NOMINAL_CLOCK_GHZ == jara.NOMINAL_CLOCK_GHZ


def test_perfmodel_reproduces_the_golden_table(monkeypatch):
    """The reference's golden-table builder, run on the port's modules."""
    import test_perfmodel_golden as golden
    monkeypatch.setattr(golden, "pm", pm)
    monkeypatch.setattr(golden, "AraConfig", ara.AraConfig)
    monkeypatch.setattr(golden, "isa", isa)
    table = golden.compute_table()
    with open(golden.GOLDEN) as f:
        want = json.load(f)
    assert set(table) == set(want)
    assert all(table[k] == pytest.approx(want[k], rel=1e-12) for k in want)


def test_encoding_equals_the_reference():
    """Every grid program encodes and packs into the reference's table."""
    for sew, lmul, seeds in diff.cells(5):
        progs, _, _ = _cell_batch(diff, sew, lmul, seeds)
        jprogs, _, _ = _cell_batch(jdiff, sew, lmul, seeds)
        rows = [staging.encode_program(p, V) for p in progs]
        assert rows == [jstaging.encode_program(p, V) for p in jprogs]
        got, want = staging.pack_tables(rows), jstaging.pack_tables(rows)
        assert got.keys() == want.keys()
        assert all(np.array_equal(got[k], want[k]) for k in want)
        assert [(vl, s, lm) for _, vl, s, lm in
                staging.resolve_vtype(progs[0], V)] \
            == [(vl, s, lm) for _, vl, s, lm in
                jstaging.resolve_vtype(jprogs[0], V)]


# ---------------------------------------------------------------------------
# the engine against the oracle and against the JAX engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_reference_vs_oracle_grid(dtype):
    """420 random SEW x LMUL programs, the reference test's gate
    (``test_reference_vs_oracle_grid``), on the port's engine."""
    storage = np.float64 if dtype == "float64" else np.float32
    checked = diff.run_cells(
        diff.engine_batch(_engine(dtype)),
        diff.oracle_batch(V, storage=storage), diff.cells(20),
        label=f"port-{dtype}-vs-oracle")
    assert checked == 20 * len(diff.vtype_combos()) == 420


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_bit_exact_against_the_jax_engine(dtype):
    """tol=0, bit patterns: 5 programs per cell (int32 storage: the
    integer cells), one batch per cell through both engines."""
    eng = _engine(dtype)
    jeng = JEngine(jara.AraConfig(lanes=2), vlmax=V,
                   dtype=getattr(jnp, dtype))
    n = 0
    for sew, lmul, seeds in diff.cells(5):
        if dtype == "int32" and sew not in isa.INT_SEWS:
            continue
        progs, mems, srs = _cell_batch(diff, sew, lmul, seeds)
        jprogs, _, _ = _cell_batch(jdiff, sew, lmul, seeds)
        got = eng.run_many(progs, mems, [dict(s) for s in srs], window=WIN)
        want = jeng.run_many(jprogs, mems, [dict(s) for s in srs],
                             window=WIN)
        _assert_runs_equal(got, want, (sew, lmul))
        n += len(seeds)
    assert n == 5 * sum(1 for s, _ in diff.vtype_combos()
                        if dtype == "float32" or s in isa.INT_SEWS)


X64_PER_CELL = 3
X64_CODE = """
import numpy as np, jax.numpy as jnp
from repro.configs.ara import AraConfig
from repro.core import isa
from repro.core.vector_engine import ReferenceEngine
from repro.testing import differential as diff
eng = ReferenceEngine(AraConfig(lanes=2), vlmax=diff.VLMAX64,
                      dtype=jnp.float64)
out = {}
for sew, lmul, seeds in diff.cells(%(per_cell)d):
    batch = [diff.random_program(np.random.RandomState(s), sew, lmul)
             for s in seeds]
    mems, srs = eng.run_many([b[0] for b in batch], [b[1] for b in batch],
                             [dict(b[2]) for b in batch],
                             window=diff.grid_window(diff.VLMAX64))
    for s, m, r in zip(seeds, mems, srs):
        out["m%%d" %% s] = m
        out["s%%d" %% s] = np.array([r[k] for k in range(32)])
cfg = AraConfig(lanes=4)
n = 16
rng = np.random.RandomState(3)
mem = rng.randn(3 * n * n)
prog = isa.matmul_program(n, 0, n * n, 2 * n * n, t=4, vlmax=cfg.vlmax_dp)
out["listing1"] = ReferenceEngine(cfg, dtype=jnp.float64).run(prog, mem)[0]
x = np.array([1 + 2.0 ** -11 + 2.0 ** -40, 0.0])
one = ReferenceEngine(cfg, dtype=jnp.float64).run(
    [isa.VSETVL(1, 16, 1), isa.VLD(1, 0), isa.VST(1, 1)], x)[0]
out["f16_once"] = one
import jax
fma_in = np.load(%(fma_in)r)
out["fma"] = np.asarray(jax.jit(lambda a, b, c: a * b + c)(
    *(jnp.asarray(fma_in[k]) for k in "abc")))
np.savez(%(path)r, **out)
print("X64_OK", out["listing1"].dtype)
"""


def _fma_normal_range_cases():
    """The float64 FMA regimes' cases whose operands and exact result are
    zero, normal or past the largest float64: XLA:CPU flushes subnormal
    operands and results to zero, the port keeps IEEE's gradual underflow
    (as the numpy oracle does), so subnormals are held to exact rationals
    alone (``test_fma_rounds_once``)."""
    tiny = Fraction(2) ** -1022
    keep = []
    for regime in FMA_REGIMES:
        a, b, c = _fma_inputs(regime, np.float64, seed=2, n=300)
        _, exact = _fma_exact(a, b, c, np.float64)
        ok = [all(x == 0 or abs(x) >= 2.0 ** -1022 for x in abc)
              and (f == 0 or abs(f) >= tiny)
              for abc, f in zip(zip(a, b, c), exact)]
        keep.append(np.stack([a, b, c])[:, np.array(ok)])
    return np.concatenate(keep, axis=1)


def test_bit_exact_against_the_jax_engine_float64(tmp_path):
    """float64 storage against the JAX engine with x64 enabled: 3 grid
    programs per cell (SEW-16 cells round float64 to float16 once, as
    JAX does), Listing-1 at n = 16, the double-rounding witness, and
    ``staging.fma`` against XLA's fused ``a*b + c`` on the FMA regimes'
    normal-range cases."""
    path = tmp_path / "x64.npz"
    fma_in = tmp_path / "fma_in.npz"
    abc = _fma_normal_range_cases()
    np.savez(fma_in, a=abc[0], b=abc[1], c=abc[2])
    out = run_devices(X64_CODE % {"per_cell": X64_PER_CELL,
                                  "path": str(path),
                                  "fma_in": str(fma_in)},
                      n_devices=1, x64=True)
    assert "X64_OK float64" in out
    want = np.load(path)
    eng = _engine("float64")
    for sew, lmul, seeds in diff.cells(X64_PER_CELL):
        progs, mems, srs = _cell_batch(diff, sew, lmul, seeds)
        got_m, got_s = eng.run_many(progs, mems, [dict(s) for s in srs],
                                    window=WIN)
        for i, s in enumerate(seeds):
            assert _same_bits(got_m[i], want[f"m{s}"]), (sew, lmul, s)
            assert _same_bits(_sregs(got_s[i]), want[f"s{s}"]), (sew, s)
    cfg = ara.AraConfig(lanes=4)
    n = 16
    mem = np.random.RandomState(3).randn(3 * n * n)
    prog = isa.matmul_program(n, 0, n * n, 2 * n * n, t=4,
                              vlmax=cfg.vlmax_dp)
    got = ReferenceEngine(cfg, device="cpu").run(prog, mem)[0]
    assert _same_bits(got, want["listing1"])
    assert float(want["f16_once"][1]) == float(np.float16(1.0009765625))
    assert abc.shape[1] > 1500
    got = staging.fma(*(torch.from_numpy(x) for x in abc)).numpy()
    assert _same_bits(got, want["fma"])


def test_float16_rounds_once_from_float64():
    """torch converts float64 -> float16 through float32 on the CPU (two
    roundings); the engine's SEW-16 rounding of float64 storage is one,
    like numpy's and the reference's: pinned at 1 + 2^-11 + 2^-40, then
    swept over float64 values around every float16 binade."""
    x = 1 + 2.0 ** -11 + 2.0 ** -40
    assert torch.tensor(x, dtype=torch.float64).half().item() == 1.0
    assert float(np.float16(x)) == 1.0009765625
    got = staging.round_f64_to_f16(torch.tensor([x], dtype=torch.float64))
    assert got.item() == 1.0009765625
    mem, _ = _engine("float64").run(
        [isa.VSETVL(1, 16, 1), isa.VLD(1, 0), isa.VST(1, 1)],
        np.array([x, 0.0]))
    assert mem[1] == 1.0009765625
    r = np.random.RandomState(0)
    base = np.ldexp(r.uniform(1, 2, 200_000), r.randint(-30, 18, 200_000))
    # push values onto and beside float16 midpoints (the hard cases)
    mid = (np.float16(base).astype(np.float64)
           + np.spacing(np.float16(base)).astype(np.float64) / 2)
    vals = np.concatenate([base, -base, mid, np.nextafter(mid, 0),
                           np.nextafter(mid, np.inf), -mid,
                           [0.0, -0.0, np.inf, -np.inf, 65504.0, 65520.0,
                            65519.99, 2.0 ** -25, 2.0 ** -25 * 1.0000001,
                            1e300, -1e-300]])
    want = vals.astype(np.float16)
    got = staging.round_f64_to_f16(torch.from_numpy(vals)).numpy()
    assert _same_bits(got, want)


F32_HUGE = Fraction(2) ** 128 - Fraction(2) ** 103     # max + half an ulp


def _round_fraction_f32(f: Fraction) -> np.float32:
    """A rational rounded to nearest float32, ties to even (reference)."""
    if abs(f) >= F32_HUGE:
        return np.float32(np.inf if f > 0 else -np.inf)
    x = np.float32(float(f))
    cands = [c for c in (np.nextafter(x, np.float32(-np.inf)), x,
                         np.nextafter(x, np.float32(np.inf)))
             if np.isfinite(c)]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - f),
                                     int(c.view(np.uint32)) & 1))


def _round_fraction_f64(f: Fraction) -> np.float64:
    """A rational rounded to nearest float64, ties to even, subnormals and
    overflow included (Python's int / int division is correctly rounded)."""
    try:
        return np.float64(float(f))
    except OverflowError:
        return np.float64(np.inf if f > 0 else -np.inf)


def _fma_exact(a, b, c, npt):
    """IEEE fusedMultiplyAdd of finite arrays: one rounding of the exact
    rational ``a*b + c`` to ``npt``, and the exact values."""
    exact = [Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
             for x, y, z in zip(a, b, c)]
    rnd = _round_fraction_f32 if npt == np.float32 else _round_fraction_f64
    return np.array([rnd(f) for f in exact], npt), exact


def _mant(r, n, lo, hi):
    """n random values of either sign with binary exponents in [lo, hi)."""
    return (r.uniform(0.5, 1, n) * r.choice([-1.0, 1.0], n)
            * np.exp2(r.randint(lo, hi, n).astype(float)))


def _near_minus(r, p):
    """``-p`` nudged by a random relative amount of 2^-60..2^-2: ``c``
    cancelling most of the product's bits."""
    return -p * (1 + r.randn(len(p)) * np.exp2(r.randint(-60, -2, len(p))))


def _subnormal_ties(r, n):
    """Products on a midpoint of the subnormal grid (2^(q-1075) + 2^-1075,
    times 1 + 2^-p where that bit is set: a sticky bit below the
    midpoint), c a few grid steps either side."""
    q = r.randint(2, 53, n)
    p = r.randint(1, 53, n)
    sticky = r.rand(n) < 0.75
    a = np.where(sticky, 1 + np.exp2(-p.astype(float)), 1.0) \
        * np.exp2(-600.0) * r.choice([-1.0, 1.0], n)
    b = (1 + np.exp2(-q.astype(float))) * np.exp2(q - 475.0) \
        * r.choice([-1.0, 1.0], n)
    return a, b, r.randint(-4, 5, n) * 2.0 ** -1074


FMA_N = 2000
# regime -> (dtype, a, b, c): hard cases of one rounding, every range edge
FMA_REGIMES = {
    # cancellation: c takes off most of the product's leading bits
    "cancel": lambda r, n: (_mant(r, n, -20, 20), _mant(r, n, -20, 20),
                            None),
    # every exponent of the format, subnormals included
    "wide": lambda r, n: (_mant(r, n, -1074, 1024), _mant(r, n, -1074, 1024),
                          _mant(r, n, -1074, 1024)),
    # |b| >= 2^990: Veltkamp's split of b itself would overflow
    "large_b": lambda r, n: (_mant(r, n, -60, 30), _mant(r, n, 990, 1024),
                             None),
    # products near 2^-1000: their low halves are subnormal unscaled
    "tiny_product": lambda r, n: (_mant(r, n, -520, -480),
                                  _mant(r, n, -520, -480),
                                  _mant(r, n, -1074, -950)),
    # results below 2^-1022, the top subnormal binade included
    "subnormal_result": lambda r, n: (_mant(r, n, -515, -505),
                                      _mant(r, n, -515, -505), None),
    # on a subnormal midpoint, with and without a sticky bit below it
    "subnormal_ties": _subnormal_ties,
    # products past the largest float64, c pulling some back
    "overflow": lambda r, n: (_mant(r, n, 500, 525), _mant(r, n, 495, 525),
                              None),
    # short mantissas: a*b lands on midpoints, c a sticky bit either side
    "ties": lambda r, n: (1 + r.randint(0, 1 << 26, n) * 2.0 ** -26,
                          (1 + r.randint(0, 1 << 27, n) * 2.0 ** -27)
                          * np.exp2(r.randint(-1040, 1000, n)), "sticky"),
}
FMA32_REGIMES = {
    "cancel": FMA_REGIMES["cancel"],
    "wide": lambda r, n: (_mant(r, n, -149, 128), _mant(r, n, -149, 128),
                          _mant(r, n, -149, 128)),
    "subnormal_result": lambda r, n: (_mant(r, n, -72, -66),
                                      _mant(r, n, -72, -66), None),
    "overflow": lambda r, n: (_mant(r, n, 60, 66), _mant(r, n, 60, 66), None),
}


def _fma_inputs(regime, npt, seed=1, n=FMA_N):
    r = np.random.RandomState(seed)
    table = FMA32_REGIMES if npt == np.float32 else FMA_REGIMES
    a, b, c = table[regime](r, n)
    if c is None:
        big = float(np.finfo(npt).max)
        with np.errstate(over="ignore"):
            c = _near_minus(r, a * b)
            c = np.where(np.isfinite(c), c, np.copysign(big, -a * b))
        c = np.clip(c, -big, big)              # in range of the format
    elif isinstance(c, str):                            # "sticky"
        p = a * b
        c = np.copysign(np.abs(p) * np.exp2(r.randint(-90, -54, n)),
                        r.choice([-1.0, 1.0], n))
    with np.errstate(over="ignore", under="ignore"):
        return a.astype(npt), b.astype(npt), c.astype(npt)


@pytest.mark.parametrize("dtype,regime",
                         [("float64", k) for k in FMA_REGIMES]
                         + [("float32", k) for k in FMA32_REGIMES])
def test_fma_rounds_once(dtype, regime):
    """``staging.fma`` is IEEE 754's fusedMultiplyAdd (one rounding of the
    exact ``a*b + c``, subnormal results and overflow included), built
    from separately rounded operations: held to exact rationals in every
    regime where an unscaled emulation breaks down."""
    npt = np.float32 if dtype == "float32" else np.float64
    a, b, c = _fma_inputs(regime, npt)
    want, _ = _fma_exact(a, b, c, npt)
    got = staging.fma(*(torch.from_numpy(t) for t in (a, b, c))).numpy()
    assert _same_bits(got, want), regime
    if regime == "cancel":
        assert not _same_bits((a * b) + c, want)    # the cases are hard


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fma_special_values(dtype):
    """Infinities, NaNs and zero signs as the fused operation gives them:
    an overflowing product beside an infinite ``c`` is still finite
    exactly (a plain ``a*b + c`` gives NaN there)."""
    big = 1e30 if dtype == "float32" else 1e300
    tiny = 1e-30 if dtype == "float32" else 1e-300
    cases = [  # a, b, c, expected
        (np.inf, 1.0, 1.0, np.inf), (0.0, np.inf, 1.0, np.nan),
        (np.inf, 1.0, -np.inf, np.nan), (big, big, -np.inf, -np.inf),
        (np.nan, 1.0, 1.0, np.nan), (2.0, 3.0, np.inf, np.inf),
        (-0.0, 5.0, -0.0, -0.0), (3.0, 0.0, -0.0, 0.0),
        (1.5, 2.0, -3.0, 0.0), (-tiny, tiny, 0.0, -0.0),
        (tiny, tiny, -0.0, 0.0), (-0.0, -0.0, -0.0, 0.0)]
    t = TORCH[dtype]
    a, b, c, want = (torch.tensor([x[i] for x in cases], dtype=t)
                     for i in range(4))
    got = staging.fma(a, b, c)
    assert _same_bits(got.numpy(), want.numpy())


def test_ieee_max_min_match_xla():
    pairs = [(-0.0, 0.0), (0.0, -0.0), (-0.0, -0.0), (1.0, np.nan),
             (np.nan, -1.0), (2.0, 2.0), (-3.0, 1.0)]
    a = np.array([p[0] for p in pairs], np.float32)
    b = np.array([p[1] for p in pairs], np.float32)
    for mine, theirs in ((staging._ieee_max, jnp.maximum),
                         (staging._ieee_min, jnp.minimum)):
        for dt in (np.float32, np.float64):
            got = mine(torch.from_numpy(a.astype(dt)),
                       torch.from_numpy(b.astype(dt))).numpy()
            want = np.asarray(theirs(a, b)).astype(dt)
            assert _same_bits(got, want), (mine, dt, got, want)


def test_run_many_matches_run_bitwise():
    """Batching groups programs by opcode per row; the results are those
    of one-at-a-time execution."""
    eng = _engine()
    progs, mems, srs = [], [], []
    for seed, (sew, lmul) in enumerate([(64, 1), (32, 2), (16, 4), (8, 1),
                                        (16, isa.parse_lmul("mf4"))]):
        p, m, s = diff.random_program(np.random.RandomState(seed), sew,
                                      lmul, n_ops=10)
        progs.append(p)
        mems.append(m)
        srs.append(s)
    batch = eng.run_many(progs, mems, [dict(s) for s in srs], window=WIN)
    for i in range(len(progs)):
        one = eng.run_many([progs[i]], [mems[i]], [dict(srs[i])],
                           window=WIN)
        _assert_runs_equal(one, ([batch[0][i]], [batch[1][i]]), i)


def test_graph_replay_matches_eager(monkeypatch):
    """On the card a group shape that recurs replays a CUDA graph of its
    branch, fed a static copy of the row's table columns. The bookkeeping
    runs here with a stand-in capture whose replay reruns the branch:
    with every shape that recurs twice replayed, a mixed batch (Listing-1
    programs beside grid programs, groups of 1-6 programs) gives the
    eager run's bits."""
    class Replay:
        captured = 0

        def __init__(self, fn):
            self.replay = fn
            Replay.captured += 1

    n, rng = 6, np.random.RandomState(0)
    progs, mems = [], []
    for _ in range(3):
        progs.append(isa.matmul_program(n, 0, n * n, 2 * n * n, t=4,
                                        vlmax=V))
        mems.append(rng.randn(3 * n * n))
    for seed, (sew, lmul) in enumerate([(32, 2), (16, 1), (64, 4)]):
        p, m, _ = diff.random_program(np.random.RandomState(seed), sew, lmul)
        progs.append(p)
        mems.append(m)
    srs = [{0: 0.5}] * len(progs)
    eng = _engine("float64")
    eager = eng.run_many(progs, mems, srs, window=WIN)
    runner, = eng.cache._fns.values()
    assert runner.graphs is False          # the CPU runs every row eagerly
    monkeypatch.setattr(staging, "_capture", Replay)
    monkeypatch.setattr(staging, "_drain", lambda device: None)
    monkeypatch.setattr(staging, "GRAPH_MIN_REPEATS", 2)
    runner.graphs = True
    _assert_runs_equal(eng.run_many(progs, mems, srs, window=WIN), eager,
                       "replayed")
    assert Replay.captured >= 10


# aten operations that wait for the device to hand a value to the host
HOST_SYNC_OPS = {"aten._local_scalar_dense", "aten.item", "aten.nonzero",
                 "aten.masked_select", "aten.is_nonzero", "aten.equal",
                 "aten.unique", "aten._unique2", "aten.unique_consecutive"}
DISPATCH_ROWS = 20
DISPATCH_HEAD = [isa.VSETVL(256), isa.VLD(0, 0), isa.VLD(2, 0),
                 isa.VLD(4, 0), isa.LDSCALAR(1, 0)]
DISPATCH_ROW = {"VLD": isa.VLD(2, 0), "LDSCALAR": isa.LDSCALAR(1, 0),
                "VINS": isa.VINS(2, 1), "VFMA_VS": isa.VFMA_VS(2, 1, 0),
                "VST": isa.VST(2, 0), "VFMA": isa.VFMA(2, 0, 4)}


class _Dispatches(TorchDispatchMode):
    """Counts the aten operations torch dispatches (views included)."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def _dispatched(fn):
    with _Dispatches() as d:
        fn()
    return d.ops


@pytest.mark.parametrize("opcode", list(DISPATCH_ROW))
def test_rows_dispatch_no_host_sync(opcode, capsys):
    """A row of Listing-1's opcodes (and the grid's VFMA) in float64 on 16
    lanes' VLMAX dispatches no operation that waits on the device, so the
    card's row loop never stalls the host. Prints the operations a row
    dispatches (each a kernel launch on the card when it runs eagerly)
    and, for the FMA rows, the float64 ``staging.fma``'s share (run with
    ``-s`` to read them)."""
    cfg = ara.AraConfig(lanes=16)
    eng = ReferenceEngine(cfg, cache=staging.TraceCache(), device="cpu")
    mem = np.random.RandomState(0).randn(4096)
    prog = DISPATCH_HEAD + [DISPATCH_ROW[opcode]] * DISPATCH_ROWS
    eng.run(prog, mem)                                  # build the runner
    base = _dispatched(lambda: eng.run(DISPATCH_HEAD, mem))
    more = _dispatched(lambda: eng.run(prog, mem))
    assert not HOST_SYNC_OPS & (set(base) | set(more))
    per_row = (sum(more.values()) - sum(base.values())) / DISPATCH_ROWS
    a, b, c = (torch.from_numpy(np.random.RandomState(i).randn(256))
               for i in range(3))
    fma_ops = sum(_dispatched(lambda: staging.fma(a, b, c)).values())
    with capsys.disabled():
        print(json.dumps({"opcode": opcode, "torch_ops_per_row": per_row,
                          "float64_fma_ops": fma_ops}))
    assert per_row > (fma_ops if opcode.startswith("VFMA") else 0)


BOUNDARY = sorted({-(1 << 31), -(1 << 30), -1, 0, 1, 1 << 30,
                   (1 << 31) - 1})


@pytest.mark.parametrize("bits", [8, 16, 32, 64])
@pytest.mark.parametrize("kind", list(staging.INT_OPS))
def test_int_arith_boundaries(kind, bits):
    """int64 arithmetic equals the reference's 32-bit trace on the
    boundary values: lo, hi, -1, 0, 1, 2^30 and the int32 extremes, every
    pair (lo·lo at SEW=32 is the one product that overflows)."""
    s = min(bits, 32)
    vals = sorted(set(BOUNDARY) | {-(1 << (s - 1)), (1 << (s - 1)) - 1})
    a, b = (x.ravel() for x in np.meshgrid(vals, vals))
    jr, js = jstaging.int_arith(kind, jnp.asarray(a, jnp.int32),
                                jnp.asarray(b, jnp.int32), bits)
    tr, ts = staging.int_arith(kind, torch.from_numpy(a.astype(np.int64)),
                               torch.from_numpy(b.astype(np.int64)), bits)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr, np.int64))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# ---------------------------------------------------------------------------
# the paper's programs
# ---------------------------------------------------------------------------


def test_matmul_program_semantics():
    cfg = ara.AraConfig(lanes=4)
    n = 16
    r = np.random.RandomState(0)
    A, B, C = r.randn(n, n), r.randn(n, n), r.randn(n, n)
    mem = np.concatenate([A.ravel(), B.ravel(), C.ravel()])
    prog = isa.matmul_program(n, 0, n * n, 2 * n * n, t=4,
                              vlmax=cfg.vlmax_dp)
    out, _ = ReferenceEngine(cfg, device="cpu").run(prog, mem)
    assert out.dtype == np.float64
    np.testing.assert_allclose(out[2 * n * n:].reshape(n, n), A @ B + C,
                               rtol=1e-12, atol=1e-12)


def test_daxpy_and_masked_argmax():
    cfg = ara.AraConfig(lanes=4)
    eng = ReferenceEngine(cfg, device="cpu")
    r = np.random.RandomState(1)
    x, y = r.randn(200), r.randn(200)
    out, _ = eng.run(isa.daxpy_program(200, 0, 200, alpha_sreg=0,
                                       vlmax=cfg.vlmax_dp),
                     np.concatenate([x, y]), sregs={0: -1.7})
    np.testing.assert_allclose(out[200:], -1.7 * x + y, rtol=1e-12,
                               atol=1e-15)
    vl = 32
    vals = r.randn(vl)
    vals[vl // 3] = vals[2 * vl // 3] = vals.max() + 1.0     # a tie
    mem = np.zeros(4 * vl + 64)
    mem[:vl], mem[vl:2 * vl] = vals, np.arange(vl)
    prog = [isa.VSETVL(vl, 32, 1), isa.VLD(4, 0)] \
        + isa.argmax_program(4, vl, sd=0, huge_sreg=1)
    _, s = eng.run(prog, mem, sregs={1: float(vl + 9)})
    assert int(s[0]) == int(np.argmax(vals)) == vl // 3


# ---------------------------------------------------------------------------
# the scoreboard against the reference's
# ---------------------------------------------------------------------------


def _same_report(got, want):
    return (got.cycles == want.cycles and got.unit_busy == want.unit_busy
            and got.n_insns == want.n_insns)


@pytest.mark.parametrize("clusters", [1, 2])
@pytest.mark.parametrize("lanes", [2, 4, 16])
@pytest.mark.parametrize("n", [8, 16, 32])
def test_scoreboard_equals_the_reference_on_listing1(n, lanes, clusters):
    cfg, jcfg = ara.AraConfig(lanes=lanes), jara.AraConfig(lanes=lanes)
    got = simulate_timing(isa.matmul_program(
        n, 0, n * n, 2 * n * n, t=4, vlmax=cfg.vlmax_dp), cfg,
        clusters=clusters)
    want = jsimulate(jisa.matmul_program(
        n, 0, n * n, 2 * n * n, t=4, vlmax=jcfg.vlmax_dp), jcfg,
        clusters=clusters)
    assert _same_report(got, want)


@pytest.mark.parametrize("spelling", ["native", "slides"])
def test_scoreboard_equals_the_reference_on_the_reductions(spelling):
    """The demo's two sum-reductions: native VREDSUM and slides + adds."""
    def prog(i, vl=32):
        if spelling == "native":
            return [i.VSETVL(vl, 64, 1), i.VLD(5, 0), i.VREDSUM(8, 5),
                    i.VEXT(1, 8, 0)]
        return [i.VSETVL(vl, 64, 1), i.VLD(5, 0)] \
            + i.slide_reduce_program(5, vl, sd=1)
    got = simulate_timing(prog(isa), ara.AraConfig(lanes=4))
    want = jsimulate(prog(jisa), jara.AraConfig(lanes=4))
    assert _same_report(got, want)


# ---------------------------------------------------------------------------
# the runner cache (the single-device cases of tests/test_trace_cache.py)
# ---------------------------------------------------------------------------


def _prog(op, sew=32, lmul=2):
    # vl=8 is reachable at every vtype here, so the element window —
    # signature material — is identical across the variants below
    return [isa.VSETVL(8, sew, lmul), isa.VLD(0, 0), op, isa.VST(0, 40)]


def test_same_signature_reuses_the_runner():
    """Five programs with different opcodes, operands and vtype — same
    shapes — run through one build; opcodes are data."""
    eng = _engine()
    mem = np.arange(64, dtype=float)
    outs = [eng.run(_prog(op, sew, lmul), mem)[0]
            for op, sew, lmul in [(isa.VFMUL(0, 0, 0), 32, 2),
                                  (isa.VFADD(0, 0, 0), 32, 2),
                                  (isa.VADD(0, 0, 0), 32, 1),
                                  (isa.VSMUL(0, 0, 0), 8, 1),
                                  (isa.VSLIDE(4, 0, 3), 16, 4)]]
    st = eng.cache.stats
    assert st.compiles == 1 and st.misses == 1 and st.hits == 4, st
    assert not np.array_equal(outs[0], outs[1])
    assert len(eng.cache) == 1
    assert next(iter(eng.cache._fns)).device == "cpu"


def test_signature_changes_miss():
    """Program-length bucket, batch size and register-file size are all
    signature material: changing any of them builds afresh."""
    eng = _engine()
    mem = np.arange(64, dtype=float)
    eng.run(_prog(isa.VFMUL(2, 0, 0)), mem)
    long_prog = [isa.VSETVL(8, 32, 2)] + \
        [isa.VFADD(0, 0, 0)] * 12 + [isa.VST(0, 40)]
    eng.run(long_prog, mem)
    eng.run_many([_prog(isa.VFMUL(2, 0, 0))] * 2, [mem, mem])
    _engine(vlmax=16, cache=eng.cache).run(_prog(isa.VFMUL(2, 0, 0)), mem)
    assert eng.cache.stats.misses == eng.cache.stats.compiles == 4
    assert eng.cache.stats.hits == 0


def test_cached_equals_fresh_bit_identical():
    """The whole grid in one batch (one signature): a hit, and a rebuild
    after ``clear``, both reproduce the first run bit for bit."""
    eng = _engine()
    batch = [diff.random_program(np.random.RandomState(7 + i), s, lm,
                                 n_ops=10)
             for i, (s, lm) in enumerate(diff.vtype_combos())]

    def go():
        return eng.run_many([b[0] for b in batch], [b[1] for b in batch],
                            [dict(b[2]) for b in batch], window=WIN)

    first = go()
    second = go()
    eng.cache.clear()
    third = go()
    assert eng.cache.stats.compiles == 2 and eng.cache.stats.hits == 1
    _assert_runs_equal(second, first, "hit")
    _assert_runs_equal(third, first, "rebuild")


def test_lru_evicts_oldest():
    cache = staging.TraceCache(maxsize=2)
    eng = _engine(cache=cache)
    mem = np.arange(64, dtype=float)
    p_short = _prog(isa.VFMUL(2, 0, 0))
    p_long = [isa.VSETVL(8, 32, 2)] + \
        [isa.VFADD(0, 0, 0)] * 12 + [isa.VST(0, 40)]
    eng.run(p_short, mem)                         # sig A
    eng.run(p_long, mem)                          # sig B
    eng.run_many([p_short] * 2, [mem, mem])       # sig C -> evicts A
    assert len(cache) == 2
    eng.run(p_short, mem)                         # A again: rebuilt
    assert cache.stats.misses == cache.stats.compiles == 4
    assert cache.stats.hits == 0


def test_illegal_program_raises_on_host_before_building():
    eng = _engine()
    with pytest.raises(ValueError):
        eng.run([isa.VSETVL(8, 64, 2), isa.VFADD(1, 2, 4)], np.zeros(64))
    with pytest.raises(ValueError):
        eng.run([isa.VSETVL(8, 64), isa.VFWMUL(4, 1, 2)], np.zeros(64))
    assert len(eng.cache) == 0 and eng.cache.stats.compiles == 0


def test_vxsat_does_not_leak_across_batched_programs():
    """Sticky vxsat is per program, and a cache hit starts from the
    batch's zeroed flags; a masked-off saturating lane sets nothing."""
    eng = _engine()
    mem = np.zeros(64)
    mem[0:8] = 100.0                 # 100 + 100 saturates int8
    mem[8:16] = 1.0
    sat = [isa.VSETVL(8, 8, 1), isa.VLD(4, 0), isa.VSADD(4, 4, 4),
           isa.VST(4, 32)]
    clean = [isa.VSETVL(8, 8, 1), isa.VLD(4, 8), isa.VSADD(4, 4, 4),
             isa.VST(4, 32)]
    _, srs = eng.run_many([sat, clean, sat], [mem, mem, mem])
    assert [float(s[isa.VXSAT_SREG]) for s in srs] == [1.0, 0.0, 1.0]
    _, srs = eng.run_many([clean] * 3, [mem] * 3)
    assert eng.cache.stats.hits == 1
    assert all(float(s[isa.VXSAT_SREG]) == 0.0 for s in srs)
    m2 = mem.copy()
    m2[16:24] = 0.0                  # v0 pattern: all inactive
    masked = [isa.VSETVL(8, 8, 1), isa.VLD(isa.MASK_REG, 16),
              isa.VLD(4, 0), isa.VSADD(4, 4, 4, vm=0), isa.VST(4, 32)]
    _, srs = eng.run_many([masked], [m2])
    assert float(srs[0][isa.VXSAT_SREG]) == 0.0


# ---------------------------------------------------------------------------
# contracts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", ["mesh", "axis", "axes"])
def test_mesh_arguments_build_lane_and_cluster_runners(kw):
    """``mesh``/``axis``/``axes`` name the lane topology of a "lane" or
    "cluster" signature and build its runner (``tests/test_torch_lanes.py``
    holds those runners to this engine bit for bit); an axis the mesh
    lacks raises ``ValueError``, and so does a lane mesh for the one-lane
    signature."""
    from repro_torch.core.cluster import CLUSTER_AXES, make_cluster_mesh
    from repro_torch.core.vector_engine import make_lane_mesh
    flat = staging.Signature(kind="lane", lanes=4, slots=16, window=8,
                             mem_words=64, prog_len=8, batch=1,
                             storage="float32", mesh_key=(("lanes", 4),))
    grid = staging.Signature(kind="cluster", lanes=4, slots=16, window=8,
                             mem_words=64, prog_len=8, batch=1,
                             storage="float32", clusters=2,
                             mesh_key=(("clusters", 2), ("lanes", 2)))
    sig, given, missing = {
        "mesh": (flat, {"mesh": make_lane_mesh(4)},
                 {"mesh": make_lane_mesh(4), "axis": "x"}),
        "axis": (flat, {"axis": "lanes"},
                 {"mesh": make_lane_mesh(4, axis="x"), "axis": "lanes"}),
        "axes": (grid, {"axes": CLUSTER_AXES},
                 {"mesh": make_cluster_mesh(2, 2), "axes": ("c", "lanes")}),
    }[kw]
    stats = staging.CacheStats()
    runner = staging.build_runner(sig, stats, **given)
    assert (runner.lanes, runner.clusters, stats.compiles) \
        == (4, sig.clusters, 1)
    assert runner.staged == (kw == "axes")
    with pytest.raises(ValueError, match="not in the mesh"):
        staging.build_runner(sig, stats, **missing)
    ref = _engine().signature(window=8, mem_words=64, prog_len=8, batch=1)
    with pytest.raises(ValueError):
        staging.build_runner(ref, stats, **given)
    assert stats.compiles == 1


def test_the_default_device_is_the_card():
    cfg = ara.AraConfig(lanes=2)
    if torch.cuda.is_available():
        assert ReferenceEngine(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ReferenceEngine(cfg)
    eng = ReferenceEngine(cfg, device="cpu")
    assert eng.dtype == torch.float64 and eng.device.type == "cpu"
    with pytest.raises(ValueError, match="dtype"):
        ReferenceEngine(cfg, dtype=torch.float16, device="cpu")


def test_lint_gate_rejects_before_the_device():
    cache = staging.TraceCache()
    gated = ReferenceEngine(ara.AraConfig(lanes=2), vlmax=V, cache=cache,
                            lint=True, device="cpu")
    bad = [isa.VSETVL(4, 32, 1), isa.VST(9, 0)]
    with pytest.raises(analysis.LintError):
        gated.run_many([bad], [np.zeros(64)])
    assert cache.stats.compiles == 0
    _engine(cache=cache).run_many([bad], [np.zeros(64)])   # unlinted: runs


# ---------------------------------------------------------------------------
# the demo's twin
# ---------------------------------------------------------------------------


def _demo(script, *extra):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, str(REPO / "examples" / script),
                          "--lanes", "4", "--n", "16", *extra],
                         capture_output=True, text=True, env=env,
                         timeout=600, cwd=REPO)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout.splitlines()


def test_demo_twin_prints_the_reference_lines():
    """Scoreboard cycles, closed form, argmax and reduction cycles equal
    the JAX demo's line for line; the error line by size only (the JAX
    demo runs float32 in-process, the port float64)."""
    ref = _demo("vector_engine_demo.py")
    port = _demo("torch_vector_engine_demo.py", "--device", "cpu")
    assert port[-1] == "engine device: cpu"
    port = port[:-1]
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        if a.startswith("semantics vs numpy"):
            err = [float(x.split("max err ")[1]) for x in (a, b)]
            assert err[0] < 1e-12 and err[1] < 1e-4
        else:
            assert a == b
