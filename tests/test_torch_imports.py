"""PyTorch port, import hygiene: the port imports ``torch`` and never
``jax`` nor anything of the ``repro`` package, and every module imports on
a machine with no ``nvcc`` and no CUDA device."""
import ast
import importlib
import pathlib
import sys

import pytest
import torch

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "src" / "repro_torch"
# the port's scripts beside the reference's: benchmarks, tools, examples,
# experiments
SCRIPTS = sorted(p for d in ("benchmarks", "tools", "examples", "experiments")
                 for p in (REPO / d).glob("torch_*.py"))
# the process route's cases, which chip_smoke.py runs on the chip machine
FILES = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"] + SCRIPTS \
    + [REPO / "tests" / "torch_process_cases.py"]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "repro"}


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module.split(".")[0], node.lineno
        elif isinstance(node, ast.Call):
            # importlib.import_module("...") / __import__("...")
            fn = node.func
            name = getattr(fn, "attr", getattr(fn, "id", ""))
            if name in ("import_module", "__import__") and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                yield node.args[0].value.split(".")[0], node.lineno


def test_the_walk_sees_the_whole_port():
    names = {p.relative_to(REPO).as_posix() for p in FILES}
    assert "chip_smoke.py" in names and (REPO / "chip_smoke.py").exists()
    for must in ("src/repro_torch/kernels/matmul.py",
                 "src/repro_torch/kernels/attention.py",
                 "src/repro_torch/kernels/axpy.py",
                 "src/repro_torch/kernels/conv.py",
                 "src/repro_torch/kernels/ssm_scan.py",
                 "src/repro_torch/models/ssm.py",
                 "src/repro_torch/serving/engine.py",
                 "src/repro_torch/models/transformer.py",
                 "src/repro_torch/launch/serve.py",
                 "src/repro_torch/launch/train.py",
                 "src/repro_torch/optim/adamw.py",
                 "src/repro_torch/train/step.py",
                 "src/repro_torch/train/trainer.py",
                 "src/repro_torch/data/pipeline.py",
                 "src/repro_torch/ft/elastic.py",
                 "src/repro_torch/core/stripmine.py",
                 "src/repro_torch/configs/ara.py",
                 "src/repro_torch/core/isa.py",
                 "src/repro_torch/core/analysis.py",
                 "src/repro_torch/core/perfmodel.py",
                 "src/repro_torch/core/staging.py",
                 "src/repro_torch/core/vector_engine.py",
                 "src/repro_torch/testing/differential.py",
                 "src/repro_torch/testing/faults.py",
                 "src/repro_torch/core/cluster.py",
                 "tools/torch_vlint.py",
                 "benchmarks/torch_scaleout.py",
                 "benchmarks/torch_fig5_matmul.py",
                 "benchmarks/torch_fig6_kernels.py",
                 "benchmarks/torch_table1_hwacha.py",
                 "benchmarks/torch_table3_efficiency.py",
                 "examples/torch_vector_engine_demo.py",
                 "src/repro_torch/serving/faults.py",
                 "src/repro_torch/checkpoint/ckpt.py",
                 "benchmarks/torch_serving_load.py",
                 "examples/torch_serve_lm.py",
                 "examples/torch_train_lm.py",
                 "src/repro_torch/core/roofline.py",
                 "examples/torch_quickstart.py",
                 "benchmarks/torch_kernel_bench.py",
                 "benchmarks/torch_multiprecision.py",
                 "benchmarks/torch_attention_long.py",
                 "benchmarks/torch_engine_throughput.py",
                 "benchmarks/torch_run.py",
                 "benchmarks/torch_timing.py",
                 "src/repro_torch/core/compat.py",
                 "src/repro_torch/core/chaining.py",
                 "src/repro_torch/launch/mesh.py",
                 "src/repro_torch/models/sharding.py",
                 "src/repro_torch/optim/compression.py",
                 "src/repro_torch/train/pipeline.py",
                 "src/repro_torch/core/step_analysis.py",
                 "src/repro_torch/core/partition.py",
                 "src/repro_torch/launch/dryrun.py",
                 "src/repro_torch/launch/report.py",
                 "experiments/torch_hillclimb.py",
                 "tests/torch_process_cases.py",
                 "tools/torch_gloo_cuda_probe.py"):
        assert must in names


@pytest.mark.parametrize(
    "path", FILES, ids=[p.relative_to(REPO).as_posix() for p in FILES])
def test_no_import_of_jax_or_of_the_jax_package(path):
    bad = [(root, line) for root, line in _imported_roots(path)
           if root in FORBIDDEN]
    assert not bad, f"{path}: forbidden imports {bad}"


def _module_names():
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


@pytest.mark.parametrize("name", list(_module_names()))
def test_every_module_imports_without_nvcc_or_a_card(name):
    mod = importlib.import_module(name)
    assert mod.__name__ == name


def test_importing_the_port_does_not_import_jax():
    """In a fresh interpreter: the test process itself has JAX loaded."""
    import subprocess
    code = ("import sys; sys.path.insert(0, %r); "
            "import repro_torch.serving, repro_torch.launch.serve, "
            "repro_torch.convert, repro_torch.kernels.ops, "
            "repro_torch.kernels.attention, repro_torch.kernels.axpy, "
            "repro_torch.kernels.conv, repro_torch.kernels.ssm_scan, "
            "repro_torch.models.ssm, repro_torch.launch.train, "
            "repro_torch.train.trainer, repro_torch.train.step, "
            "repro_torch.optim.adamw, repro_torch.data.pipeline, "
            "repro_torch.ft.elastic, repro_torch.core.vector_engine, "
            "repro_torch.core.cluster, repro_torch.testing.faults, "
            "repro_torch.testing.differential, repro_torch.serving.faults, "
            "repro_torch.checkpoint.ckpt; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); sys.exit(bool(bad))"
            % str(PKG.parent))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_the_kernel_library_is_only_needed_at_launch():
    """Without nvcc a build raises, naming nvcc; importing and calling the
    wrappers on CPU tensors never gets there."""
    from repro_torch.kernels import build
    for name in ("matmul", "attention", "axpy", "conv", "ssm_scan"):
        assert (build.CSRC / f"{name}.cu").exists()
    assert set(build.SIGNATURES) == {p.stem for p in build.CSRC.glob("*.cu")}
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)
    assert build.library_path("matmul").parent == REPO / "build" / "repro_torch"
    import shutil
    if shutil.which("nvcc") is None and not pathlib.Path(
            "/usr/local/cuda/bin/nvcc").exists():
        with pytest.raises(RuntimeError, match="nvcc"):
            build.find_nvcc()


def test_source_hash_covers_the_headers(tmp_path, monkeypatch):
    """A library is keyed by its source, the headers beside it and the
    flags: editing or adding a ``csrc/*.cuh`` changes the hash (and the
    library path) of every source, so no stale library is loaded; undoing
    the edit gives the first hash back, and other files do not count."""
    from repro_torch.kernels import build
    for f in build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    names = sorted(build.SIGNATURES)

    def hashes():
        return {n: build.source_hash(n) for n in names}

    first = hashes()
    header = tmp_path / "mma_sm90.cuh"
    text = header.read_text()
    header.write_text(text + "\n// edited\n")
    edited = hashes()
    assert all(edited[n] != first[n] for n in names)
    assert build.library_path("attention").name \
        == f"attention-{edited['attention']}.so"
    header.write_text(text)
    assert hashes() == first
    (tmp_path / "notes.txt").write_text("not a header")
    assert hashes() == first
    (tmp_path / "extra.cuh").write_text("#pragma once\n")
    assert all(h != first[n] for n, h in hashes().items())
