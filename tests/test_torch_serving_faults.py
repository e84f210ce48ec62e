"""PyTorch port, the serving fault registry and its load gate:
``repro_torch.serving.faults`` against ``repro.serving.faults``, and
``benchmarks/torch_serving_load.py`` against ``benchmarks/serving_load.py``.

Each fault class must be detected by its named code, recovered from with
the survivors equal to the port's full-forward oracle, and do damage to
the legacy engine (``verify``), on the port's own fixture (its
``init_params``, ``torch.Generator`` seeded 0) and, report for report, as
the reference does on the reference's parameters converted through numpy.
Everything runs on the CPU in float32; greedy tokens compare exactly.
"""
import functools
import importlib.util
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.serving import faults as jfaults
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.serving import faults

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
NAMES = [f.name for f in faults.REGISTRY]
# fields of a phase row that read the host clock
WALL = {"goodput_tok_per_s", "p50_latency_s", "p99_latency_s",
        "wall_seconds"}


def _load(name):
    path = REPO / "benchmarks" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_bench_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def own_fixture():
    return faults.default_fixture("cpu")


@functools.lru_cache(maxsize=1)
def converted_fixture():
    """The reference's fixture (reduced tinyllama, its own random
    parameters), converted for the port."""
    _, params_j = jfaults.fixture()
    cfg = reduced(get_config("tinyllama-1.1b"))
    return cfg, convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params_j), device="cpu")


def test_registry_equals_the_reference():
    def rows(reg):
        return [(f.name, f.detect_code, f.policy, f.damage,
                 f.scenario.__name__) for f in reg]
    assert rows(faults.REGISTRY) == rows(jfaults.REGISTRY)
    assert len(faults.REGISTRY) == 10
    assert faults.MAX_SEQ == jfaults.MAX_SEQ


@pytest.mark.parametrize("name", NAMES)
def test_every_class_verifies_on_the_ports_own_fixture(name):
    """Detected, recovered (survivors equal to the oracle) and
    non-vacuous (damage on the legacy engine)."""
    faults.use_fixture(*own_fixture())
    fault = faults.REGISTRY[NAMES.index(name)]
    report = faults.verify(fault)
    assert report["name"] == name and report["detect"] == fault.detect_code


@pytest.mark.parametrize("name", NAMES)
def test_verify_report_equals_the_reference(name):
    faults.use_fixture(*converted_fixture())
    i = NAMES.index(name)
    assert faults.verify(faults.REGISTRY[i]) \
        == jfaults.verify(jfaults.REGISTRY[i])


def test_use_fixture_clears_the_oracle_cache():
    """The oracle's cache is keyed by the prompt: after a swap it must
    answer for the new model, never with the old model's tokens."""
    own, conv = own_fixture(), converted_fixture()
    p = faults.prompt(0, 5)
    faults.use_fixture(*own)
    first = faults.oracle(p, 6)
    assert faults._oracle_cached.cache_info().currsize == 1
    faults.use_fixture(*conv)
    assert faults._oracle_cached.cache_info().currsize == 0
    second = faults.oracle(p, 6)
    assert second == jfaults.oracle(p, 6)
    assert first != second
    faults.use_fixture(*own)
    assert faults.oracle(p, 6) == first
    assert faults.fixture() == own and faults._device().type == "cpu"


def test_default_fixture_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        faults.default_fixture()
    cfg, params = own_fixture()
    assert cfg.name == reduced(get_config("tinyllama-1.1b")).name
    gen = torch.Generator().manual_seed(0)
    from repro_torch.models.layers import init_params, tree_leaves
    from repro_torch.models.transformer import model_template
    again = init_params(model_template(cfg), gen, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                 tree_leaves(again)))


def test_kv_bounds_audit_reads_a_snapshot_as_the_reference():
    """A corrupted KV length: the audit evicts the slot (I_KV_BOUNDS) and,
    reading the lengths it took before the eviction, flags the freed slot
    (I_SLOT_LEAK), event for event as the reference's engine does."""
    faults.use_fixture(*converted_fixture())
    logs = []
    for mod in (faults, jfaults):
        eng = mod.make_engine()
        eng.submit(mod.Request(uid=0, prompt=mod.prompt(11, 4),
                               max_new_tokens=6))
        eng.fault_hooks.append(mod.corrupt_length_once(
            uid=0, at_tick=3, value=mod.MAX_SEQ + 3))
        eng.run_to_completion(60)
        logs.append(eng.events)
    assert logs[0] == logs[1]
    assert [e["code"] for e in logs[0]][:2] == ["I_KV_BOUNDS", "I_SLOT_LEAK"]


def test_load_twin_smoke_equals_the_reference():
    """The reference's ``--smoke`` settings on the reference's parameters:
    zero escapes, and every field of both phases that does not read the
    host clock equal to the reference's."""
    ref = _load("serving_load").bench(duration=60, rate=0.4, slots=2)
    got = _load("torch_serving_load").bench(duration=60, rate=0.4, slots=2,
                                            fixture=converted_fixture())
    assert got["faulted"]["undetected_escapes"] == 0
    assert got["faulted"]["injections"] > 0
    for phase in ("clean", "faulted"):
        want = {k: v for k, v in ref[phase].items() if k not in WALL}
        assert {k: got[phase][k] for k in want} == want, phase
        extra = set(got[phase]) - set(ref[phase])
        assert extra == {"degraded_steps_bf16", "degraded_steps_int8"}
        assert got[phase]["degraded_steps_bf16"] \
            + got[phase]["degraded_steps_int8"] \
            == got[phase]["degraded_steps"]
    assert got["faulted"]["degraded_steps_int8"] > 0
    assert got["faulted"]["degraded_steps_bf16"] > 0
    cfg_ref = {k: v for k, v in ref["config"].items() if k != "backend"}
    assert {k: got["config"][k] for k in cfg_ref} == cfg_ref
    assert got["config"]["backend"] == "cpu"


def test_load_twin_cli_writes_its_own_file(tmp_path, monkeypatch, capsys):
    """``--smoke --device cpu`` on the port's own fixture: the rows, the
    gate passes, and the default output is ``torch_BENCH_serving.json``,
    never the reference's ``BENCH_serving.json``."""
    monkeypatch.chdir(tmp_path)
    _load("torch_serving_load").main(["--smoke", "--device", "cpu",
                                      "--min-goodput", "0.5"])
    out = capsys.readouterr().out
    assert "serving_load,phase=clean," in out
    assert "serving_load,phase=faulted," in out
    assert sorted(p.name for p in tmp_path.iterdir()) \
        == ["torch_BENCH_serving.json"]
    res = json.loads((tmp_path / "torch_BENCH_serving.json").read_text())
    assert res["faulted"]["undetected_escapes"] == 0
    assert res["config"]["backend"] == "cpu"
