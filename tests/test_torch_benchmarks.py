"""PyTorch port, the main path's measurement surface against the
reference's, on the CPU:

- ``repro_torch.core.precision``'s Ara-side functions and ``Policy``
  methods equal the reference's exactly; ``speedup_vs_fp32`` reads the
  port's own H100 table (a deliberate difference);
- ``repro_torch.core.roofline.model_flops`` equals the reference's;
- ``examples/torch_quickstart.py``'s counts and shapes equal
  ``examples/quickstart.py``'s;
- the twins of ``benchmarks/multiprecision.py``, ``kernel_bench.py``,
  ``attention_long.py``, ``engine_throughput.py`` and ``run.py``: host rows
  equal to the reference's, the same inputs, the gates on the CPU, the
  engine's build counters, and no CPU row labelled as a card kernel.
"""
import importlib.util
import json
import math
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as J_ARCH_NAMES
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core import precision as jprec
from repro.core import roofline as jroof
from repro.kernels import ref as jref
from repro.models import transformer as jtf
from repro.models.layers import init_params as j_init_params
from repro.models.layers import tree_size_bytes as j_tree_size_bytes
from repro_torch.configs import ARCH_NAMES, SHAPES, get_config
from repro_torch.core import precision as prec
from repro_torch.core import roofline

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _load(rel):
    path = REPO / rel
    spec = importlib.util.spec_from_file_location(
        f"_bench_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *map(str, args)],
                          capture_output=True, text=True, env=env,
                          timeout=600, cwd=REPO)


# ---------------------------------------------------------------------------
# core/precision.py and core/roofline.py
# ---------------------------------------------------------------------------

# the SEWs, LMULs, lane counts and vector lengths of tests/test_lmul.py's
# issue-amortization test and tests/test_multiprecision.py's peaks test
SEWS = (64, 32, 16, 8)
LANES = (2, 4, 16)


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("sew", SEWS)
def test_ara_precision_functions_equal_the_reference(sew, lanes):
    """Exact equality: the Ara side is a copy."""
    assert prec.ara_speedup_vs_dp(sew) == jprec.ara_speedup_vs_dp(sew)
    for vl in (16, 64, 256):
        for lmul in (1, 2, 4, 8):
            assert prec.issue_amortization(vl, lanes, sew, lmul) \
                == jprec.issue_amortization(vl, lanes, sew, lmul)
            assert prec.issue_amortization(vl, lanes, sew, lmul, 3.0) \
                == jprec.issue_amortization(vl, lanes, sew, lmul, 3.0)
    name = prec.SEW_TO_DTYPE[sew]
    for lmul in (1, 4, 8):
        pol = prec.Policy(compute_dtype=name, lmul=lmul)
        jpol = jprec.Policy(compute_dtype=name, lmul=lmul)
        assert pol.sew == jpol.sew == sew
        assert pol.ara_peak_flop_per_cycle(lanes) \
            == jpol.ara_peak_flop_per_cycle(lanes)
        assert pol.ara_speedup() == jpol.ara_speedup()
        for vl in (16, 64):
            assert pol.issue_amortization(vl, lanes) \
                == jpol.issue_amortization(vl, lanes)
            assert pol.issue_amortization(vl, lanes, 2.5) \
                == jpol.issue_amortization(vl, lanes, 2.5)


def test_bytes_per_element_takes_the_port_dtype_names():
    for name in ("float64", "float32", "bfloat16", "float16", "int8",
                 "int32"):
        assert prec.bytes_per_element(name) == jprec.bytes_per_element(name)
        assert prec.bytes_per_element(prec.torch_dtype(name)) \
            == jprec.bytes_per_element(name)


def test_speedup_vs_fp32_reads_the_h100_table():
    """A deliberate difference: the port's peaks are the H100's (bf16 and
    f16 on the tensor cores, f32 on the CUDA cores), the reference's a
    TPU's (2.0 for bf16)."""
    assert prec.speedup_vs_fp32("float32") == 1.0
    for name in ("bfloat16", "float16"):
        assert prec.speedup_vs_fp32(name) == pytest.approx(989 / 67,
                                                           rel=1e-12)
        assert jprec.speedup_vs_fp32(name) == 2.0
    assert prec.speedup_vs_fp32("int8") == pytest.approx(1979 / 67,
                                                         rel=1e-12)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_flops_equals_the_reference(arch):
    assert tuple(ARCH_NAMES) == tuple(J_ARCH_NAMES)
    assert set(SHAPES) == set(J_SHAPES)
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for name in SHAPES:
        assert roofline.model_flops(cfg, SHAPES[name]) \
            == jroof.model_flops(jcfg, J_SHAPES[name]), (arch, name)


# ---------------------------------------------------------------------------
# examples/torch_quickstart.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_quickstart_twin_counts_equal_the_reference(arch):
    """The quickstart's deterministic lines (parameter counts and family,
    model FLOPs, the reduced tree's MB, the logits' shape) equal the
    reference's, whose tree and forward are evaluated abstractly
    (``jax.eval_shape``); loss, grad norm and aux are finite."""
    qs = _load("examples/torch_quickstart.py")
    lines = []
    res = qs.run(arch, "cpu", emit=lines.append)
    full = j_get_config(arch)
    cfg = j_reduced(full)
    tree = jax.eval_shape(lambda: j_init_params(jtf.model_template(cfg),
                                                jax.random.PRNGKey(0)))
    tokens = jax.ShapeDtypeStruct((2, 32), jnp.int32)
    kw = {}
    if cfg.frontend_seq:
        kw["frontend_emb"] = jax.ShapeDtypeStruct(
            (2, cfg.frontend_seq, cfg.frontend_dim or cfg.d_model),
            jnp.float32)
    logits = jax.eval_shape(lambda p, t, **k: jtf.forward(cfg, p, t,
                                                          **k)[0],
                            tree, tokens, **kw)
    want = [
        f"{full.name}: {full.param_count()/1e9:.2f}B params "
        f"({full.active_param_count()/1e9:.2f}B active), "
        f"family={full.family}",
        f"train_4k model FLOPs: "
        f"{jroof.model_flops(full, J_SHAPES['train_4k']):.3e}",
        f"reduced config params: {j_tree_size_bytes(tree)/1e6:.1f} MB",
    ]
    assert lines[:3] == want
    assert lines[3].startswith(f"forward: logits {logits.shape}, aux=")
    assert lines[4].startswith("train step: loss=")
    assert len(lines) == 5
    assert res["params"] == full.param_count()
    assert res["active_params"] == full.active_param_count()
    assert res["reduced_params_mb"] == pytest.approx(
        j_tree_size_bytes(tree) / 1e6, rel=1e-12)
    assert res["logits_shape"] == tuple(logits.shape)
    assert all(math.isfinite(res[k]) for k in ("loss", "grad_norm", "aux"))


def test_quickstart_script_runs_on_the_cpu():
    res = _run(REPO / "examples" / "torch_quickstart.py", "--arch",
               "tinyllama-1.1b", "--device", "cpu")
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.splitlines()
    assert len(lines) == 5
    assert lines[0].startswith("tinyllama-1.1b: 1.10B params")
    assert lines[3] == "forward: logits (2, 32, 256), aux=0.000"


def test_quickstart_defaults_to_the_card():
    qs = _load("examples/torch_quickstart.py")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        qs.main(["--arch", "tinyllama-1.1b"])


# ---------------------------------------------------------------------------
# benchmarks/torch_multiprecision.py
# ---------------------------------------------------------------------------


def test_multiprecision_model_rows_equal_the_reference():
    ref, port = _load("benchmarks/multiprecision.py"), \
        _load("benchmarks/torch_multiprecision.py")
    assert port.model_rows() == ref.model_rows()
    assert port.model_rows(lanes=(4, 8), sizes=(32, 128)) \
        == ref.model_rows(lanes=(4, 8), sizes=(32, 128))


@pytest.mark.parametrize("lanes", (2, 4))
def test_multiprecision_scoreboard_rows_equal_the_reference(lanes):
    """At n = 64, not the default 256 (the scoreboard takes ~20 s a run
    there on this CPU): every SEW, the integer spelling included."""
    ref, port = _load("benchmarks/multiprecision.py"), \
        _load("benchmarks/torch_multiprecision.py")
    rows = port.scoreboard_rows(lanes=lanes, n=64)
    assert rows == ref.scoreboard_rows(lanes=lanes, n=64)
    assert [r["sew"] for r in rows] == list(SEWS)


def test_multiprecision_kernel_rows_on_the_cpu():
    """On the CPU the rows say ``plain_cpu``; the predicted speedups are
    the reference's formula; the products are held as
    ``tests/test_multiprecision.py`` holds the low-precision kernels
    against fp32 (3e-2 / 0.5) and int8 exactly."""
    port = _load("benchmarks/torch_multiprecision.py")
    rows = port.kernel_rows(sizes=(64,), device="cpu")
    assert [r["dtype"] for r in rows] == ["float32", "bfloat16", "float16",
                                          "int8"]
    assert {r["source"] for r in rows} == {"plain_cpu"}
    assert [r["predicted_speedup"] for r in rows] == [1.0, 2.0, 2.0, 4.0]
    a32, b32, a8, b8 = port.kernel_operands(64, np.random.RandomState(0),
                                            "cpu")
    calls = port.kernel_calls(a32, b32, a8, b8)
    want = np.random.RandomState(0)
    ja, jb = want.randn(64, 64), want.randn(64, 64)
    np.testing.assert_array_equal(a32.numpy(), ja.astype(np.float32))
    np.testing.assert_array_equal(b32.numpy(), jb.astype(np.float32))
    f32 = calls["float32"]()
    for name in ("bfloat16", "float16"):
        np.testing.assert_allclose(calls[name]().float().numpy(),
                                   f32.numpy(), rtol=3e-2, atol=0.5)
    np.testing.assert_array_equal(
        calls["int8"]().numpy(),
        a8.numpy().astype(np.int32) @ b8.numpy().astype(np.int32))


# ---------------------------------------------------------------------------
# benchmarks/torch_kernel_bench.py and benchmarks/torch_run.py
# ---------------------------------------------------------------------------


# the reference's jnp oracle for each row on the reference's own inputs,
# and the tolerance of the port's plain version against it (fp32
# summation order; the bf16 output's step; the scan's chunked order
# against the sequential recurrence)
BENCH_REF = {
    "matmul256_f32": (lambda a, b: jref.matmul_ref(a, b), 1e-4, 1e-4),
    "axpy_1M_f32": (lambda x, y: jref.axpy_ref(2.0, x, y), 1e-6, 1e-6),
    "conv_googlenet1_f32": (lambda x, w: jref.conv2d_ref(x, w), 2e-4, 2e-4),
    "attention_1k_bf16": (lambda q: jref.flash_attention_ref(q, q, q),
                          2e-2, 2e-2),
    "ssm_scan_4k_f32": (lambda q, ld: jref.ssm_scan_ref(q, q, q, ld, -ld),
                        3e-4, 3e-4),
}


def test_kernel_bench_rows_on_the_cpu():
    """The reference's rows at its shapes; on the CPU no row is labelled
    ``cuda`` (the kernel rows run the wrappers' plain versions and say
    ``plain_cpu``) and none carries a launch count."""
    kb = _load("benchmarks/torch_kernel_bench.py")
    rows = kb.rows("cpu")
    names = [r["kernel"] for r in rows]
    assert not any("cuda" in n or r["source"] == "cuda"
                   for n, r in zip(names, rows))
    assert not any("launches" in r for r in rows)
    want = []
    for base in BENCH_REF:
        want += [f"{base}_plain_cpu", f"{base}_plain"]
        if base != "ssm_scan_4k_f32":          # no library call
            want.append(f"{base}_library")
    assert names == want
    assert all(r["us_per_call"] > 0 for r in rows)


@pytest.mark.parametrize("iters", [1, 2, 3])
def test_timing_makes_one_warm_call_then_times_iters_calls(iters):
    """``benchmarks.torch_timing.seconds_per_call`` on the CPU: the warm
    call, then ``iters`` calls on the host clock, reported per call."""
    timing = _load("benchmarks/torch_timing.py")
    calls = []
    secs = timing.seconds_per_call(lambda: calls.append(1), "cpu", iters)
    assert len(calls) == iters + 1
    assert 0 < secs < 1


@pytest.mark.parametrize("name", list(BENCH_REF))
def test_kernel_bench_inputs_and_plain_versions_match_the_reference(name):
    """Each case's operands are the reference's (numpy ``RandomState(0)``
    in its order), and the port's plain version agrees with the
    reference's jnp oracle on them; the wrapper on CPU tensors is that
    plain version."""
    kb = _load("benchmarks/torch_kernel_bench.py")
    case = {c.name: c for c in kb.cases("cpu")}[name]
    fn, rtol, atol = BENCH_REF[name]
    jargs = [jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)
        for t in case.operands]
    want = np.asarray(fn(*jargs)).astype(np.float32)
    with torch.no_grad():
        plain, wrapped = case.plain(), case.kernel()
    torch.testing.assert_close(wrapped, plain, rtol=0, atol=0)
    np.testing.assert_allclose(plain.float().numpy(), want, rtol=rtol,
                               atol=atol)


def test_kernel_bench_operands_are_the_reference_draws():
    kb = _load("benchmarks/torch_kernel_bench.py")
    rng = np.random.RandomState(0)
    ops_ = [t for c in kb.cases("cpu") for t in c.operands]
    draws = [rng.randn(256, 256), rng.randn(256, 256), rng.randn(1 << 20),
             rng.randn(1 << 20), rng.randn(3, 118, 118),
             rng.randn(64, 3, 7, 7), rng.randn(1, 8, 1024, 64),
             rng.randn(8, 4096, 64), -rng.rand(8, 4096)]
    assert len(ops_) == len(draws)
    for t, d in zip(ops_, draws):
        want = torch.from_numpy(np.asarray(d)).to(t.dtype)
        assert torch.equal(t, want)


def test_run_harness_fig6_and_the_a13_skip_line(tmp_path):
    """The harness's figure rows, then one ``dryrun_roofline`` row per
    report of the port's dry run, as the reference prints its dry-run
    farm's."""
    assert _run("-m", "repro_torch.launch.dryrun", "--arch",
                "tinyllama-1.1b", "--shape", "decode_32k", "--out",
                tmp_path).returncode == 0
    res = _run("-m", "benchmarks.torch_run", "--only", "fig6_kernels",
               "--device", "cpu", "--dryrun-dir", tmp_path)
    assert res.returncode == 0, res.stderr[-2000:]
    out = res.stdout.splitlines()
    assert sum(ln.startswith("fig6_kernels,") for ln in out) == 12
    assert any(ln.startswith("# fig6_kernels done in") for ln in out)
    rows = [ln for ln in out if ln.startswith("dryrun_roofline,")]
    assert len(rows) == 1 and rows[0].startswith(
        "dryrun_roofline,arch=tinyllama-1.1b,shape=decode_32k,"
        "mesh=pod16x16,compute_s=")
    assert "bottleneck=memory" in rows[0]
    assert out[-1] == "# dryrun_roofline done"


def test_run_harness_exits_1_when_a_module_fails():
    """Without a card, ``kernel_bench`` at the default device raises; the
    harness reports it and exits 1, as the reference's does."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = _run("-m", "benchmarks.torch_run", "--only", "kernel_bench")
    assert res.returncode == 1
    assert "# kernel_bench FAILED:" in res.stdout


# ---------------------------------------------------------------------------
# benchmarks/torch_attention_long.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("budget_mb", (0.5, 4, 64, 1024))
def test_attention_long_ceiling_equals_the_reference(budget_mb):
    ref, port = _load("benchmarks/attention_long.py"), \
        _load("benchmarks/torch_attention_long.py")
    assert port.FULL_SEQS == ref.FULL_SEQS
    assert port.SMOKE_SEQS == ref.SMOKE_SEQS
    for b, h in ((1, 4), (2, 8)):
        assert port.quadratic_ceiling(budget_mb, b, h) \
            == ref.quadratic_ceiling(budget_mb, b, h)
        for s in (256, 1024, 32768):
            assert port.quadratic_score_bytes(b, h, s) \
                == ref.quadratic_score_bytes(b, h, s)


@pytest.mark.parametrize("causal", (True, False))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_attention_long_oracle_equals_the_reference(dtype, causal):
    port = _load("benchmarks/torch_attention_long.py")
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 2, 40, 16)) for _ in range(3))
    valid = rng.random((2, 40)) < 0.8
    valid[1] = False                             # a dead batch row
    jt = getattr(jnp, dtype)
    want = jref.flash_attention_ref(
        *(jnp.asarray(x, jt) for x in (q, k, v)), causal=causal,
        kv_valid=jnp.asarray(valid))
    tt = prec.torch_dtype(dtype)
    got = port.attention_ref(*(torch.from_numpy(x).to(tt)
                               for x in (q, k, v)), causal=causal,
                             kv_valid=torch.from_numpy(valid))
    tol = 1e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               rtol=tol, atol=tol)
    assert float(got[1].abs().max()) == 0.0


def test_attention_long_gates_pass_on_the_cpu():
    """Gates 1 and 2 at the reference's sizes, gate 3 in its CPU form and
    gate 4 at 4x a 1 MB ceiling (1024 tokens: the blockwise loop over
    chunks of 512), the kernel route's plain versions throughout."""
    port = _load("benchmarks/torch_attention_long.py")
    lines = []
    assert port.gate_backward_matches_ref(lines.append, "cpu")
    assert port.gate_causal_skip(lines.append, "cpu")
    ceiling = port.quadratic_ceiling(1, 1, 4)
    assert ceiling == 256
    assert port.gate_long_train_step(4 * ceiling, lines.append, "cpu")
    assert len(lines) == 6 and all(ln.endswith("ok=True") for ln in lines)
    assert "issued=40,triangular=40,full_grid=64" in lines[4]


def test_attention_long_rows_skip_the_kernel_on_the_cpu():
    port = _load("benchmarks/torch_attention_long.py")
    lines = []
    rows, ceiling = port.bench_rows([256, 512], b=1, h=2, d=16, chunk=64,
                                    budget_mb=0.5, emit=lines.append,
                                    device="cpu")
    assert ceiling == 256
    assert [(r["path"], r["seq"]) for r in rows] == [
        (p, s) for s in (256, 512)
        for p in ("quadratic", "blockwise", "kernel")]
    for r in rows:
        if r["path"] == "kernel":
            assert "skipped" in r and "CPU" in r["skipped"]
        elif r["path"] == "quadratic" and r["seq"] == 512:
            assert r["skipped"].startswith("score tensor")
        else:
            assert r["fwd_bwd_tokens_per_s"] > 0 and "skipped" not in r
    assert port.gate_blockwise_beats_quadratic(rows, 512, lines.append,
                                               "cpu")
    assert "reason=quadratic skipped at seq 512" in lines[-1]
    assert len(lines) == len(rows) + 1


# ---------------------------------------------------------------------------
# benchmarks/torch_engine_throughput.py
# ---------------------------------------------------------------------------


def test_engine_throughput_counters_on_the_cpu(tmp_path):
    """Uncached builds one runner a program, cached and batched one, the
    lint pass none (asserted inside ``bench`` too), every SEW=8 and mask
    sweep one."""
    et = _load("benchmarks/torch_engine_throughput.py")
    res = et.bench(n=4, reps=1, device="cpu")
    assert res["uncached"]["compiles"] == res["config"]["uncached_n"] == 3
    assert res["cached"]["compiles"] == 1
    assert res["cached_batched"]["compiles"] == 1
    assert res["lint_overhead"]["compiles"] == 1
    assert len(res["int8_cells"]) == 6 and len(res["mask_cells"]) == 4
    for sweep in ("int8_cells", "mask_cells"):
        assert all(r["compiles"] == 1 for r in res[sweep].values())
    assert res["config"]["backend"] == "cpu"
    ref = _load("benchmarks/engine_throughput.py")
    assert et.MASK_OPS == ref.MASK_OPS
    json.dumps(res)                 # what main writes to the JSON file
