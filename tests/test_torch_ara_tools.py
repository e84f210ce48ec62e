"""PyTorch port, the Ara side's host tools against the reference's:

- ``repro_torch.testing.faults`` (a copy, pinned to its original's source
  in ``test_torch_engine.py``'s ``COPIES``) audits the port's linter and
  oracle with the reference's verdicts;
- ``tools/torch_vlint.py`` prints what ``tools/vlint.py`` prints;
- the figure and table twins (``benchmarks/torch_fig5_matmul.py``,
  ``torch_fig6_kernels.py``, ``torch_table1_hwacha.py``,
  ``torch_table3_efficiency.py``) are the reference scripts on the port's
  modules, and their rows equal the reference's;
- ``benchmarks/torch_scaleout.py``'s sweep equals ``benchmarks/
  scaleout.py``'s, and its ``--verify`` holds the port's ClusterEngine to
  the ReferenceEngine bit for bit (on the CPU here).
"""
import importlib.util
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from repro.testing import faults as jfaults
from repro_torch.testing import faults

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
TWINS = ("fig5_matmul", "fig6_kernels", "table1_hwacha", "table3_efficiency")


def _load(path):
    spec = importlib.util.spec_from_file_location(
        f"_bench_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _as_port(text):
    return re.sub(r"^(\s*)(from|import) repro\.", r"\1\2 repro_torch.",
                  text, flags=re.M)


def _run(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, *map(str, args)],
                         capture_output=True, text=True, env=env,
                         timeout=600, cwd=REPO)
    return res


def test_fault_audit_gives_the_reference_verdicts():
    """Every fault class is flagged by the port's linter and confirmed by
    its oracle, with the reference's names, codes, rules and findings."""
    assert [f.name for f in faults.REGISTRY] \
        == [f.name for f in jfaults.REGISTRY]
    assert faults.verify_all() == jfaults.verify_all()


def test_fault_audit_fails_a_missed_fault():
    """The audit is two-sided: a W-class mutation that changes behaviour
    fails it."""
    wrong = faults.Fault("noop-that-diverges", faults.analysis.W_DEAD_WRITE,
                         faults.NOOP, faults._def_before_use)
    with pytest.raises(AssertionError):
        faults.verify(wrong)


def test_vlint_twin_prints_the_reference_lines():
    ref = _run(REPO / "tools" / "vlint.py", "--demo", "--grid", "2",
               "--selftest")
    port = _run(REPO / "tools" / "torch_vlint.py", "--demo", "--grid", "2",
                "--selftest")
    assert ref.returncode == port.returncode == 0, port.stderr
    assert port.stdout == ref.stdout
    assert "vlint: clean" in port.stdout
    assert len(port.stdout.splitlines()) > 1000


@pytest.mark.parametrize("name", TWINS)
def test_figure_twins_give_the_reference_rows(name):
    """The twin is the reference script on the port's modules (plus a
    ``__main__`` that prints its rows), and its rows equal the
    reference's."""
    ref_path = REPO / "benchmarks" / f"{name}.py"
    port_path = REPO / "benchmarks" / f"torch_{name}.py"
    ref_text, port_text = ref_path.read_text(), port_path.read_text()
    body = port_text[port_text.index('"""', 3) + 3:
                     port_text.index('\n\nif __name__ == "__main__":')]
    assert body.strip("\n") == _as_port(
        ref_text[ref_text.index('"""', 3) + 3:]).strip("\n")
    ref, port = _load(ref_path), _load(port_path)
    assert port.rows() == ref.rows()
    emitted = []
    port.main(lambda table, row: emitted.append((table, row)))
    assert emitted == [(name, r) for r in ref.rows()]
    res = _run(port_path)
    assert res.returncode == 0, res.stderr
    assert len(res.stdout.splitlines()) == len(emitted)
    assert res.stdout.startswith(f"{name},")


def test_scaleout_twin_sweep_equals_the_reference():
    ref = _load(REPO / "benchmarks" / "scaleout.py")
    port = _load(REPO / "benchmarks" / "torch_scaleout.py")
    rows = port.sweep()
    assert rows == ref.sweep()
    assert port.check_rows(rows, 2.6) == ref.check_rows(rows, 2.6) == []
    assert {r["lanes"] for r in rows} == {4, 8, 16, 32, 64}


def test_scaleout_twin_verifies_the_cluster_engine(tmp_path):
    """``--verify --device cpu``: the port's ClusterEngine at 2x2 and 4x2
    against its ReferenceEngine, bit for bit, in process."""
    out = tmp_path / "scaleout.json"
    res = _run(REPO / "benchmarks" / "torch_scaleout.py", "--verify",
               "--device", "cpu", "--out", out)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert "SCALEOUT_VERIFY_OK 2x2 12" in res.stdout
    assert "SCALEOUT_VERIFY_OK 4x2 12" in res.stdout
    verify = json.loads(out.read_text())["verify"]
    assert verify["bit_exact"] and verify["device"] == "cpu"
    assert verify["checked"] == {"2x2": 12, "4x2": 12}
