"""PyTorch port, fault tolerance in training: ``repro_torch.checkpoint.ckpt``
against ``repro.checkpoint.ckpt``, the trainer's checkpoint/restart against
the reference's, and the copies in ``repro_torch.ft.elastic``.

The checkpoint layout, file bytes and manifest are the reference's, so a
checkpoint crosses between the two packages in both directions (bf16 leaves
into the port only: the reference's own restore cannot load them, a
deliberate difference pinned here). The port's AdamW writes its state in
place, so ``save`` must snapshot every leaf before it returns.
"""
import dataclasses
import filecmp
import os
import pathlib
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config as jget, reduced as jreduced
from repro.data import pipeline as jdata
from repro.ft import elastic as jelastic
from repro.optim import adamw as jadamw
from repro.train.trainer import (Trainer as JTrainer,
                                 TrainerConfig as JTrainerConfig)
from jax.sharding import NamedSharding, PartitionSpec as JPS
from repro_torch.checkpoint import ckpt
from repro_torch.core.compat import PartitionSpec as PS
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import sharding
from repro_torch.configs import get_config, reduced
from repro_torch.data import pipeline as tdata
from repro_torch.ft import elastic
from repro_torch.models.layers import tree_leaves
from repro_torch.optim import adamw
from repro_torch.train.trainer import Trainer, TrainerConfig

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
ARCH = "tinyllama-1.1b"


def _arrays(seed=0):
    r = np.random.RandomState(seed)
    return r.randn(4, 4).astype(np.float32), r.randn(4).astype(np.float32)


def _tree(seed=0):
    w, b = _arrays(seed)
    return {"params": {"w": torch.tensor(w), "b": torch.tensor(b)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def _jax_leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _jax_leaves(tree[k])
    else:
        yield tree


def _mixed_trees(seed=0):
    """The same leaves in both packages: float32, int32 and bfloat16."""
    w, b = _arrays(seed)
    j = {"params": {"w": jnp.asarray(w), "h": jnp.asarray(w, jnp.bfloat16),
                    "b": jnp.asarray(b)},
         "opt": {"step": jnp.asarray(7, jnp.int32),
                 "m": jnp.asarray(b, jnp.bfloat16)}}
    t = {"params": {"w": torch.tensor(w),
                    "h": torch.tensor(w).to(torch.bfloat16),
                    "b": torch.tensor(b)},
         "opt": {"step": torch.tensor(7, dtype=torch.int32),
                 "m": torch.tensor(b).to(torch.bfloat16)}}
    return j, t


def _bits(x):
    """A leaf's bytes, whichever package holds it."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16
                else t).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _assert_same_leaves(a, b):
    fa, fb = list(ckpt._flatten(a)), list(ckpt._flatten(b))
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        assert _bits(x) == _bits(y), path
        if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, path


# ---------------------------------------------------------------------------
# the reference's checkpoint tests (tests/test_substrate.py), on the port
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 10, t)
    step, got = ckpt.restore(str(tmp_path), device="cpu")
    assert step == 10
    assert torch.equal(got["params"]["w"], t["params"]["w"])
    assert int(got["opt"]["step"]) == 7
    assert got["opt"]["step"].dtype == torch.int32
    _assert_same_leaves(got, t)


def test_checkpoint_keep_gc(tmp_path):
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, _tree(), keep=2)
    assert ckpt.latest_steps(str(tmp_path)) == [4, 5]


def test_checkpoint_corruption_detected(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree())
    d = os.path.join(tmp_path, "step_00000001")
    fn = [f for f in os.listdir(d) if f.endswith(".npy")][0]
    arr = np.load(os.path.join(d, fn))
    np.save(os.path.join(d, fn), arr + 1)
    with pytest.raises(IOError, match="corruption"):
        ckpt.restore(str(tmp_path), device="cpu")


def test_incomplete_checkpoint_ignored(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree())
    # a crashed save: tmp dir without manifest
    os.makedirs(os.path.join(tmp_path, "step_00000002.tmp"))
    assert ckpt.latest_steps(str(tmp_path)) == [1]
    assert ckpt.restore(str(tmp_path), device="cpu")[0] == 1
    assert ckpt.restore(str(tmp_path / "none"), device="cpu") == (None, None)


@settings(max_examples=5, deadline=None)
@given(seed=st.integers(0, 99))
def test_checkpoint_property_roundtrip(tmp_path_factory, seed):
    d = tmp_path_factory.mktemp("ck")
    t = _tree(seed)
    ckpt.save(str(d), seed, t)
    _, got = ckpt.restore(str(d), device="cpu")
    for p, leaf in [(("params", "w"), t["params"]["w"]),
                    (("params", "b"), t["params"]["b"])]:
        node = got
        for k in p:
            node = node[k]
        assert torch.equal(node, leaf)


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------


def test_a_jax_checkpoint_restores_bit_for_bit(tmp_path):
    """float32, int32 and bfloat16 leaves, each dtype kept."""
    tj, tt = _mixed_trees()
    jckpt.save(str(tmp_path), 3, tj)
    step, got = ckpt.restore(str(tmp_path), device="cpu")
    assert step == 3
    assert got["params"]["h"].dtype == torch.bfloat16
    assert got["opt"]["m"].dtype == torch.bfloat16
    _assert_same_leaves(got, tt)
    _assert_same_leaves(got, tj)


def test_the_ports_files_are_the_references_bytes(tmp_path):
    """Every file of a step, the manifest (shapes, dtypes, crc32) and the
    bf16 leaves' ``<V2`` headers included."""
    tj, tt = _mixed_trees(1)
    jckpt.save(str(tmp_path / "j"), 5, tj)
    ckpt.save(str(tmp_path / "t"), 5, tt)
    a, b = tmp_path / "j" / "step_00000005", tmp_path / "t" / "step_00000005"
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    assert "params__h.npy" in names and "manifest.json" in names
    for f in names:
        assert filecmp.cmp(a / f, b / f, shallow=False), f


def test_the_ports_float_and_int_checkpoints_restore_in_the_reference(
        tmp_path):
    _, tt = _mixed_trees(2)
    tt["params"].pop("h")
    tt["opt"].pop("m")
    ckpt.save(str(tmp_path), 4, tt)
    step, got = jckpt.restore(str(tmp_path))
    assert step == 4
    assert got["params"]["w"].dtype == np.float32
    assert got["opt"]["step"].dtype == np.int32
    _assert_same_leaves(got, tt)


def test_bf16_restores_by_the_manifest_where_the_reference_cannot(tmp_path):
    """Deliberate difference: the reference's restore hands back the
    ``|V2`` array it read, which JAX rejects; the port rebuilds bfloat16
    from the manifest's dtype."""
    tj, _ = _mixed_trees()
    jckpt.save(str(tmp_path), 1, tj)
    _, ref = jckpt.restore(str(tmp_path))
    assert ref["params"]["h"].dtype.kind == "V"
    with pytest.raises(TypeError):
        jnp.asarray(ref["params"]["h"])
    _, got = ckpt.restore(str(tmp_path), device="cpu")
    assert got["params"]["h"].dtype == torch.bfloat16
    assert torch.equal(got["params"]["h"].float(),
                       torch.tensor(np.asarray(tj["params"]["h"],
                                               np.float32)))


def test_a_nonblocking_save_is_immune_to_the_next_in_place_step(
        tmp_path, monkeypatch):
    """The writer is held until an in-place AdamW step has run on the
    saved state: the checkpoint still holds the values of the step that
    was saved, bit for bit."""
    cfg = reduced(get_config(ARCH))
    data = tdata.DataConfig(seq_len=16, global_batch=2,
                            vocab_size=cfg.vocab_size)
    tr = Trainer(cfg, adamw.OptConfig(warmup_steps=1), data,
                 TrainerConfig(), device="cpu")
    state = tr.init_state()
    state, _ = tr.step_fn(state, tdata.to_device(tr.source.batch(0), "cpu"))
    before = [x.clone() for x in tree_leaves(state)]

    gate = threading.Event()
    write = ckpt._save_npy

    def held(*args):
        assert gate.wait(60)
        write(*args)
    monkeypatch.setattr(ckpt, "_save_npy", held)
    th = ckpt.save(str(tmp_path), 1, state, blocking=False)
    state, _ = tr.step_fn(state, tdata.to_device(tr.source.batch(1), "cpu"))
    assert not torch.equal(state["params"]["embed"], before[1])
    gate.set()
    th.join(60)
    assert not th.is_alive()
    _, got = ckpt.restore(str(tmp_path), device="cpu")
    for a, b in zip(tree_leaves(got), before):
        assert torch.equal(a, b)


def test_a_failed_write_raises_from_join(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    with pytest.raises(OSError):
        ckpt.save(str(blocker), 1, _tree())
    th = ckpt.save(str(blocker), 2, _tree(), blocking=False)
    with pytest.raises(OSError):
        th.join(60)


def test_restore_contract_on_one_device(tmp_path, monkeypatch):
    """``shardings=``: the reference's restore places each leaf by its
    target sharding (here on its one-device mesh); the port's holds every
    leaf whole on its device, the same values, and checks the sharding
    against the leaf: a sharded dimension that its mesh axes do not divide
    raises ``ValueError``. Without a card the default device raises."""
    ckpt.save(str(tmp_path), 1, _tree())
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                              ("data", "model"))
    jsh = {"params": {"w": NamedSharding(jmesh, JPS("data", "model"))}}
    jstep_, jgot = jckpt.restore(str(tmp_path), shardings=jsh)
    mesh = make_mesh(2, 2)
    tsh_ = {"params": {"w": sharding.NamedSharding(mesh, PS("data",
                                                            "model"))}}
    step, got = ckpt.restore(str(tmp_path), shardings=tsh_, device="cpu")
    assert step == jstep_ == 1
    for a, b in zip(tree_leaves(got), _jax_leaves(jgot)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ragged = {"params": {"b": sharding.NamedSharding(
        make_mesh(1, 3), PS("model"))}}
    with pytest.raises(ValueError, match="should be divisible by 3"):
        ckpt.restore(str(tmp_path), shardings=ragged, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ckpt.restore(str(tmp_path))


# ---------------------------------------------------------------------------
# the trainer's restart
# ---------------------------------------------------------------------------


def _opt_cfg(**over):
    # a schedule independent of ``steps``, so that partial runs and
    # restarts follow one learning-rate trajectory
    return dict(peak_lr=5e-3, warmup_steps=3, decay_steps=60,
                weight_decay=0.0, **over)


def _trainer(tmp=None, steps=30, fuse=1, seed=0):
    """The reference's ``tests/test_system.py::_trainer``, on the port."""
    cfg = reduced(get_config(ARCH))
    data = tdata.DataConfig(seq_len=32, global_batch=8,
                            vocab_size=cfg.vocab_size, seed=seed)
    tcfg = TrainerConfig(steps=steps, ckpt_dir=tmp, ckpt_every=10,
                         log_every=5, fuse_steps=fuse, seed=seed)
    return Trainer(cfg, adamw.OptConfig(**_opt_cfg()), data, tcfg,
                   device="cpu")


@pytest.mark.parametrize("fuse", [1, 2])
def test_checkpoint_restart_resumes_exactly(tmp_path, fuse):
    """The reference's restart test, held bit for bit over every leaf of
    the state (parameters, both moments, the step)."""
    d = str(tmp_path / "a")
    _, state_full = _trainer(tmp=d, steps=20, fuse=fuse).run()
    assert ckpt.latest_steps(d) == [10, 20]

    # crash after step 10 (checkpoint exists), restart and finish
    d2 = str(tmp_path / "b")
    _trainer(tmp=d2, steps=10, fuse=fuse).run()
    tr3 = _trainer(tmp=d2, steps=20, fuse=fuse)
    start, _ = tr3.restore_or_init()
    assert start == 10
    _, state_resumed = tr3.run()
    logged = [m["step"] for m in tr3.metrics_log]
    assert logged[-1] == 20 and min(logged) > 10
    assert int(state_resumed["opt"]["step"]) == 20
    _assert_same_leaves(state_resumed, state_full)
    _, saved = ckpt.restore(d2, device="cpu")
    _assert_same_leaves(saved, state_full)


def test_a_reference_trainer_checkpoint_resumes_in_the_port(tmp_path):
    """The reference's Trainer writes step 2; the port's restores it bit
    for bit and takes step 3, which agrees with the reference's step 3 at
    the train-step parity tolerance (``tests/test_torch_train.py``)."""
    opt = _opt_cfg(eps=1e-3)
    jcfg = jreduced(jget(ARCH))
    jdc = jdata.DataConfig(seq_len=16, global_batch=4,
                           vocab_size=jcfg.vocab_size)
    d = str(tmp_path / "j")

    def jtrainer(steps):
        return JTrainer(jcfg, jadamw.OptConfig(**opt), jdc,
                        JTrainerConfig(steps=steps, ckpt_dir=d,
                                       ckpt_every=10, log_every=1))
    jtrainer(2).run()
    d_port = str(tmp_path / "t")
    shutil.copytree(d, d_port)
    _, ref_state2 = jckpt.restore(d)

    cfg = reduced(get_config(ARCH))
    tdc = tdata.DataConfig(seq_len=16, global_batch=4,
                           vocab_size=cfg.vocab_size)
    tr = Trainer(cfg, adamw.OptConfig(**opt), tdc,
                 TrainerConfig(steps=3, ckpt_dir=d_port, ckpt_every=10,
                               log_every=1), device="cpu")
    start, state2 = tr.restore_or_init()
    assert start == 2
    _assert_same_leaves(state2, ref_state2)

    jt = jtrainer(3)
    _, ref_state3 = jt.run()
    _, state3 = tr.run()
    (jm,), (tm,) = jt.metrics_log, tr.metrics_log
    assert jm["step"] == tm["step"] == 3
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(tm["lr"], jm["lr"], rtol=1e-6)
    assert int(state3["opt"]["step"]) == 3
    for path, a in ckpt._flatten(state3["params"]):
        b = ref_state3["params"]
        for k in path:
            b = b[k]
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5, err_msg="/".join(path))


def test_launch_train_resumes_from_its_ckpt_dir(tmp_path, monkeypatch,
                                                capsys):
    """``--ckpt-dir`` saves and a second launch resumes: it saves only the
    steps after the first run's last one."""
    from repro_torch.launch import train as launch
    saved = []
    save = ckpt.save

    def spy(directory, step, tree, **kw):
        saved.append(step)
        return save(directory, step, tree, **kw)
    monkeypatch.setattr(ckpt, "save", spy)
    args = ["--reduced", "--device", "cpu", "--seq-len", "16", "--batch",
            "2", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    launch.main(args + ["--steps", "4"])
    assert saved == [2, 4] and ckpt.latest_steps(str(tmp_path)) == [2, 4]
    launch.main(args + ["--steps", "6"])
    assert saved == [2, 4, 6]
    out = capsys.readouterr().out
    assert "done at step 4" in out and "done at step 6" in out


def test_train_example_twin_resumes(tmp_path, monkeypatch, capsys):
    from importlib import util
    spec = util.spec_from_file_location(
        "_torch_train_lm", REPO / "examples" / "torch_train_lm.py")
    mod = util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    saved = []
    save = ckpt.save

    def spy(directory, step, tree, **kw):
        saved.append(step)
        return save(directory, step, tree, **kw)
    monkeypatch.setattr(ckpt, "save", spy)
    args = ["--seq-len", "16", "--batch", "2", "--device", "cpu",
            "--ckpt-dir", str(tmp_path)]
    mod.main(args + ["--steps", "8"])
    mod.main(args + ["--steps", "12"])
    mod.main(args + ["--steps", "12"])
    out = capsys.readouterr().out
    assert saved == [8, 12]
    assert "finished at step 8: loss" in out
    assert "finished at step 12: loss" in out
    assert "finished at step 12: nothing left to train" in out


def test_serve_example_twin_on_the_cpu(capsys):
    from importlib import util
    spec = util.spec_from_file_location(
        "_torch_serve_lm", REPO / "examples" / "torch_serve_lm.py")
    mod = util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--requests", "6", "--slots", "2", "--max-new", "8",
              "--deadline", "30", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "6 requests, 48 new tokens" in out
    assert "'finished_states': {'done': 6}" in out


# ---------------------------------------------------------------------------
# ft/elastic.py
# ---------------------------------------------------------------------------


def test_elastic_host_code_is_the_references():
    """``StragglerMonitor`` through ``plan_remesh``, source for source."""
    def section(pkg):
        text = (REPO / "src" / pkg / "ft" / "elastic.py").read_text()
        return text[text.index("class StragglerMonitor:"):
                    text.index("def recover(")]
    assert section("repro") == section("repro_torch")


def test_elastic_plans_and_heartbeats_as_the_reference():
    for n, model, batch in ((192, 16, 256), (7, 2, 10), (16, 16, 3)):
        assert dataclasses.asdict(elastic.plan_remesh(n, model, batch)) \
            == dataclasses.asdict(jelastic.plan_remesh(n, model, batch))
    with pytest.raises(ValueError):
        elastic.plan_remesh(n_surviving=8, model=16, old_global_batch=256)
    hb = elastic.HeartbeatTracker(4, timeout_s=10.0)
    for h in range(4):
        hb.beat(h, t=100.0)
    assert hb.dead_hosts(now=105.0) == []
    for h in range(3):
        hb.beat(h, t=120.0)
    assert hb.dead_hosts(now=121.0) == [3]


def test_recover_onto_one_device(tmp_path):
    built = []

    def build():
        built.append(1)
        return _tree(5)
    step, state = elastic.recover(str(tmp_path), "cpu", build)
    assert step == 0 and built == [1]
    _assert_same_leaves(state, _tree(5))
    ckpt.save(str(tmp_path), 3, _tree(1))
    ckpt.save(str(tmp_path), 4, _tree(2))
    step, state = elastic.recover(str(tmp_path), "cpu", build)
    assert step == 4
    _assert_same_leaves(state, _tree(2))
    step, state = elastic.recover(str(tmp_path), "cpu", build, step_hint=3)
    assert step == 3
    _assert_same_leaves(state, _tree(1))
    assert built == [1]
