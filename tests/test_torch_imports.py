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
FILES = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
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
                 "src/repro_torch/serving/engine.py",
                 "src/repro_torch/models/transformer.py",
                 "src/repro_torch/launch/serve.py",
                 "src/repro_torch/launch/train.py",
                 "src/repro_torch/optim/adamw.py",
                 "src/repro_torch/train/step.py",
                 "src/repro_torch/train/trainer.py",
                 "src/repro_torch/data/pipeline.py",
                 "src/repro_torch/ft/elastic.py",
                 "src/repro_torch/core/stripmine.py"):
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
            "repro_torch.kernels.attention, repro_torch.launch.train, "
            "repro_torch.train.trainer, repro_torch.train.step, "
            "repro_torch.optim.adamw, repro_torch.data.pipeline, "
            "repro_torch.ft.elastic; "
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
    assert (build.CSRC / "matmul.cu").exists()
    assert (build.CSRC / "attention.cu").exists()
    assert set(build.SIGNATURES) == {p.stem for p in build.CSRC.glob("*.cu")}
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)
    assert build.library_path("matmul").parent == REPO / "build" / "repro_torch"
    import shutil
    if shutil.which("nvcc") is None and not pathlib.Path(
            "/usr/local/cuda/bin/nvcc").exists():
        with pytest.raises(RuntimeError, match="nvcc"):
            build.find_nvcc()
