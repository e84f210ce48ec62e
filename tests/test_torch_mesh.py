"""PyTorch port, the mesh machinery with the mesh held as tensor dimensions
on one device: ``core/compat.py`` (the stacked ``shard_map`` and its
counted collectives), ``launch/mesh.py``, ``models/sharding.py``, the spec
helpers of ``models/layers.py`` and ``train/step.py``, ``core/chaining.py``,
``optim/compression.py``, ``models/moe.py``'s expert-parallel route,
MLA's lane-local route, and the train and serve steps that take a mesh.

One subprocess runs the reference over every case of this file on 8 fake
CPU devices (its ``shard_map`` is real there) and writes one ``.npz``; the
port then runs each case on the CPU on the same numpy inputs. Tolerances:
chaining 1e-5 (fp32, both accumulate in fp32), compression ``q`` bit-equal
and mean / residual 1e-6, the expert-parallel route 1e-5, the sharded train
step's loss 5e-4 (the reference's own sharded-versus-single bound),
lane-local MLA 1e-4 (as the MLA family's parity, ``torch_family_parity``).
The specs need no devices: the reference's ``MeshCtx`` reads only
``axis_names`` and ``devices.shape``, so a stand-in mesh serves.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

import torch_shared_run
from conftest import run_devices
from repro.configs import get_config as jget
from repro.models import sharding as jsh
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.configs import ARCH_NAMES, get_config as tget, reduced
from repro_torch.core import chaining, compat
from repro_torch.core.compat import PartitionSpec as PS
from repro_torch.core.staging import Mesh
from repro_torch.launch import mesh as tmesh
from repro_torch.models import moe as tmoe
from repro_torch.models import sharding as tsh
from repro_torch.models import transformer as ttf
from repro_torch.models.layers import init_params, tree_leaves, tree_map
from repro_torch.optim import adamw
from repro_torch.optim.compression import compressed_psum, init_residuals
from repro_torch.train import step as tstep

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

SHAPES = ((8, 16, 12), (4, 8, 8), (16, 12, 4))
GROUPS = (1, 2, 4)
EP_CASES = {
    "deepseek": dict(chunk=4),
    "granite_padded": dict(chunk=8),
}

REFERENCE = r'''
import dataclasses, json, numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as PS
from repro.configs import get_config, reduced
from repro.core.chaining import all_gather_matmul, matmul_reduce_scatter
from repro.core.compat import shard_map
from repro.launch.mesh import make_mesh
from repro.models import transformer as tf
import repro.models.moe as moe_mod
from repro.models.layers import init_params
from repro.models.sharding import MeshCtx
from repro.optim import adamw
from repro.optim.compression import compressed_psum
from repro.train import step as step_lib

out = {}
def put(prefix, tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            put(f"{prefix}/{k}", v)
    else:
        out[prefix] = np.asarray(tree)

# -- chaining: the divisible sweep and the ragged texts (1 x 4 mesh) --------
mesh = make_mesh(1, 4)
rng = np.random.RandomState(0)
for m, k, n in %(shapes)r:
    x = rng.randn(m, k).astype(np.float32)
    w = rng.randn(k, n).astype(np.float32)
    tag = f"chain_{m}x{k}x{n}"
    out[tag + "_x"], out[tag + "_w"] = x, w
    for g in %(groups)r:
        out[f"{tag}_g{g}"] = np.asarray(all_gather_matmul(
            jnp.asarray(x), jnp.asarray(w), mesh, "model", group=g))
    out[tag + "_rs"] = np.asarray(matmul_reduce_scatter(
        jnp.asarray(x), jnp.asarray(w), mesh, "model"))
msgs = {}
def text(name, fn):
    try:
        fn()
    except ValueError as e:
        msgs[name] = str(e)
x10 = jnp.zeros((10, 16)); x8 = jnp.zeros((8, 16)); w = jnp.zeros((16, 12))
xk = jnp.zeros((8, 10)); wk = jnp.zeros((10, 12))
text("ag_m", lambda: all_gather_matmul(x10, w, mesh, "model"))
text("ag_group", lambda: all_gather_matmul(x8, w, mesh, "model", group=3))
text("rs_k", lambda: matmul_reduce_scatter(xk, wk, mesh, "model"))
text("rs_m", lambda: matmul_reduce_scatter(x10, w, mesh, "model"))
text("ag_contract", lambda: all_gather_matmul(x8, jnp.zeros((8, 4)), mesh,
                                              "model"))
text("rs_contract", lambda: matmul_reduce_scatter(x8, jnp.zeros((8, 4)),
                                                  mesh, "model"))
mesh24 = make_mesh(2, 4)
text("device_put", lambda: jax.device_put(
    np.zeros((10, 8), np.float32), NamedSharding(mesh24, PS("model", "data"))))
out["messages"] = np.asarray(json.dumps(msgs))

# -- compression (4 x 1 mesh), q captured at the int8 all_to_all -----------
mesh41 = make_mesh(4, 1)
for case, (shape, seed, rscale) in enumerate((((16,), 0, 0.0),
                                              ((3, 5), 1, 1e-2))):
    r = np.random.RandomState(seed)
    g = r.randn(4, *shape).astype(np.float32)
    res = (r.randn(4, *shape) * rscale).astype(np.float32)
    captured = []
    a2a = jax.lax.all_to_all
    def spy(x, *a, **kw):
        captured.append(x)
        return a2a(x, *a, **kw)
    def device_fn(g_loc, r_loc):
        (mean_g,), (new_r,) = compressed_psum((g_loc[0],), (r_loc[0],),
                                              mesh41, ("data",))
        return mean_g[None], new_r[None], captured[-1][None]
    jax.lax.all_to_all = spy
    try:
        fn = shard_map(device_fn, mesh=mesh41,
                       in_specs=(PS("data"), PS("data")),
                       out_specs=(PS(None), PS("data"), PS("data")),
                       check_vma=False)
        mean_g, new_r, q = fn(jnp.asarray(g), jnp.asarray(res))
    finally:
        jax.lax.all_to_all = a2a
    tag = f"comp{case}"
    out[tag + "_g"], out[tag + "_r"] = g, res
    out[tag + "_mean"] = np.asarray(mean_g)
    out[tag + "_res"] = np.asarray(new_r)
    out[tag + "_q"] = np.asarray(q)

# -- expert parallelism on a 2 x 4 mesh (tests/test_moe.py's two configs) ---
def ep_cfg(name):
    if name == "deepseek":
        cfg = reduced(get_config("deepseek-v3-671b"), mtp_depth=0)
        return dataclasses.replace(cfg, d_model=32,
            moe=dataclasses.replace(cfg.moe, n_experts=8, top_k=2,
                                    expert_d_ff=16, capacity_factor=16.0,
                                    n_shared_experts=0, n_dense_layers=0))
    cfg = reduced(get_config("granite-moe-3b-a800m"))
    return dataclasses.replace(cfg, d_model=32,
        moe=dataclasses.replace(cfg.moe, n_experts=5, top_k=2, expert_d_ff=16,
                                capacity_factor=16.0, pad_experts_to=8))
for name, kw in %(ep)r.items():
    cfg = ep_cfg(name)
    p = init_params(moe_mod.moe_template(cfg), jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (64, cfg.d_model))
    ctx = MeshCtx(mesh=mesh24, batch_axes=("data",))
    moe_mod.EP_CHUNK_TOKENS = kw["chunk"]
    with mesh24:
        y, aux = jax.jit(lambda xx: moe_mod.moe_ep_shard_map(cfg, p, xx,
                                                             ctx))(x)
    put(f"ep_{name}/p", p)
    out[f"ep_{name}/x"], out[f"ep_{name}/y"] = np.asarray(x), np.asarray(y)
    out[f"ep_{name}/aux"] = np.asarray(aux)
moe_mod.EP_CHUNK_TOKENS = 8192
# granite's expert layout (48 padded over 4 lanes: 12 a lane) at a small
# width, capacity factor 16: the reference's empty send slots flood local
# expert 0 (see test_moe_ep_empty_slots_claim_no_capacity)
cfg = get_config("granite-moe-3b-a800m")
cfg = dataclasses.replace(cfg, d_model=64, moe=dataclasses.replace(
    cfg.moe, expert_d_ff=32, capacity_factor=16.0))
p = init_params(moe_mod.moe_template(cfg), jax.random.PRNGKey(0))
x = jax.random.normal(jax.random.PRNGKey(1), (256, cfg.d_model))
with mesh24:
    y, _ = jax.jit(lambda xx: moe_mod.moe_ep_shard_map(
        cfg, p, xx, MeshCtx(mesh=mesh24)))(x)
put("flood/p", p)
out["flood/x"], out["flood/y_ep"] = np.asarray(x), np.asarray(y)
out["flood/y_dense"] = np.asarray(moe_mod.moe_dense_dispatch(cfg, p, x)[0])

# -- the sharded train step on a 2 x 2 mesh --------------------------------
mesh22 = make_mesh(2, 2, devices=jax.devices()[:4])
for name, arch, dense_max in (("dense", "tinyllama-1.1b", None),
                              ("moe_ep", "deepseek-v3-671b", 32)):
    if dense_max:
        moe_mod.DENSE_PATH_MAX_TOKENS = dense_max
    cfg = reduced(get_config(arch), compute_dtype="float32")
    params = init_params(tf.model_template(cfg), jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0,
                              cfg.vocab_size)
    batch = {"tokens": toks, "labels": jnp.roll(toks, -1, 1)}
    opt = adamw.OptConfig()
    state = {"params": params, "opt": adamw.init(opt, params)}
    ctx1 = MeshCtx(mesh=mesh22, batch_axes=("data",))
    b1 = step_lib.make_train_step(cfg, opt, ctx1)
    st_sh = step_lib.named_for(b1.state_specs, b1.abstract_state, mesh22)
    bt_sh = step_lib.named_for(b1.batch_specs, batch, mesh22)
    with mesh22:
        fn = jax.jit(b1.step_fn, in_shardings=(st_sh, bt_sh),
                     out_shardings=(st_sh, None))
        _, m1 = fn(jax.device_put(state, st_sh), jax.device_put(batch, bt_sh))
    put(f"step_{name}/params", params)
    out[f"step_{name}/tokens"] = np.asarray(toks)
    for key in ("loss", "ce", "aux", "grad_norm"):
        out[f"step_{name}/m1_{key}"] = np.asarray(m1[key])
    if name == "dense":
        # the same step with FSDP: every embed dimension sharded over data
        cfg = dataclasses.replace(cfg, fsdp=True)
        b1 = step_lib.make_train_step(cfg, opt, ctx1)
        st_sh = step_lib.named_for(b1.state_specs, b1.abstract_state, mesh22)
        with mesh22:
            fn = jax.jit(b1.step_fn, in_shardings=(st_sh, bt_sh),
                         out_shardings=(st_sh, None))
            _, m1 = fn(jax.device_put(state, st_sh),
                       jax.device_put(batch, bt_sh))
        for key in ("loss", "ce", "aux", "grad_norm"):
            out[f"step_dense_fsdp/m1_{key}"] = np.asarray(m1[key])
moe_mod.DENSE_PATH_MAX_TOKENS = 16384
# the MoE family's one-hot step (granite-moe-3b-a800m: 4 experts padded to
# 48, one dispatch group of the global batch's 64 tokens) on (2,2) and
# (4,1)
cfg = reduced(get_config("granite-moe-3b-a800m"), compute_dtype="float32")
params = init_params(tf.model_template(cfg), jax.random.PRNGKey(0))
toks = jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0, cfg.vocab_size)
batch = {"tokens": toks, "labels": jnp.roll(toks, -1, 1)}
opt = adamw.OptConfig()
put("step_moe/params", params)
out["step_moe/tokens"] = np.asarray(toks)
for tag, mesh_s in (("2x2", mesh22),
                    ("4x1", make_mesh(4, 1, devices=jax.devices()[:4]))):
    ctx1 = MeshCtx(mesh=mesh_s, batch_axes=("data",))
    b1 = step_lib.make_train_step(cfg, opt, ctx1)
    st_sh = step_lib.named_for(b1.state_specs, b1.abstract_state, mesh_s)
    bt_sh = step_lib.named_for(b1.batch_specs, batch, mesh_s)
    with mesh_s:
        fn = jax.jit(b1.step_fn, in_shardings=(st_sh, bt_sh),
                     out_shardings=(st_sh, None))
        _, m1 = fn(jax.device_put({"params": params,
                                   "opt": adamw.init(opt, params)}, st_sh),
                   jax.device_put(batch, bt_sh))
    for key in ("loss", "ce", "aux", "grad_norm"):
        out[f"step_moe_{tag}/m1_{key}"] = np.asarray(m1[key])
# MLA under model: deepseek-v3-671b with fsdp=False (its heads, experts and
# vocab split over model; the one-hot dispatch) on (1,4) and (2,2)
cfg = reduced(get_config("deepseek-v3-671b"), compute_dtype="float32",
              fsdp=False)
params = init_params(tf.model_template(cfg), jax.random.PRNGKey(0))
toks = jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0, cfg.vocab_size)
batch = {"tokens": toks, "labels": jnp.roll(toks, -1, 1)}
put("step_mla/params", params)
out["step_mla/tokens"] = np.asarray(toks)
for tag, mesh_s in (("1x4", make_mesh(1, 4, devices=jax.devices()[:4])),
                    ("2x2", mesh22)):
    ctx1 = MeshCtx(mesh=mesh_s, batch_axes=("data",))
    b1 = step_lib.make_train_step(cfg, opt, ctx1)
    st_sh = step_lib.named_for(b1.state_specs, b1.abstract_state, mesh_s)
    bt_sh = step_lib.named_for(b1.batch_specs, batch, mesh_s)
    with mesh_s:
        fn = jax.jit(b1.step_fn, in_shardings=(st_sh, bt_sh),
                     out_shardings=(st_sh, None))
        _, m1 = fn(jax.device_put({"params": params,
                                   "opt": adamw.init(opt, params)}, st_sh),
                   jax.device_put(batch, bt_sh))
    for key in ("loss", "ce", "aux", "grad_norm"):
        out[f"step_mla_{tag}/m1_{key}"] = np.asarray(m1[key])
# the MoE family under FSDP: the same model and tokens with fsdp=True
# (every embed dimension over data, q_lora / kv_lora where embed leaves
# them) on (4,1) and (2,2)
cfg = dataclasses.replace(cfg, fsdp=True)
for tag, mesh_s in (("4x1", make_mesh(4, 1, devices=jax.devices()[:4])),
                    ("2x2", mesh22)):
    ctx1 = MeshCtx(mesh=mesh_s, batch_axes=("data",))
    b1 = step_lib.make_train_step(cfg, opt, ctx1)
    st_sh = step_lib.named_for(b1.state_specs, b1.abstract_state, mesh_s)
    bt_sh = step_lib.named_for(b1.batch_specs, batch, mesh_s)
    with mesh_s:
        fn = jax.jit(b1.step_fn, in_shardings=(st_sh, bt_sh),
                     out_shardings=(st_sh, None))
        _, m1 = fn(jax.device_put({"params": params,
                                   "opt": adamw.init(opt, params)}, st_sh),
                   jax.device_put(batch, bt_sh))
    for key in ("loss", "ce", "aux", "grad_norm"):
        out[f"step_mla_fsdp_{tag}/m1_{key}"] = np.asarray(m1[key])
# -- lane-local MLA: prefill and decode on a 1 x 4 mesh --------------------
mesh14 = make_mesh(1, 4)
cfg = reduced(get_config("deepseek-v3-671b"))
params = init_params(tf.model_template(cfg), jax.random.PRNGKey(0))
ctx = MeshCtx(mesh=mesh14, batch_axes=("data",))
r = np.random.RandomState(3)
toks = r.randint(0, cfg.vocab_size, size=(2, 6)).astype(np.int32)
put("mla/params", params)
out["mla/tokens"] = toks
with mesh14:
    logits, cache = jax.jit(step_lib.make_prefill_step(cfg, ctx, 16))(
        params, {"tokens": jnp.asarray(toks)})
    out["mla/prefill"] = np.asarray(logits)
    dec = jax.jit(step_lib.make_decode_step(cfg, ctx))
    for i in range(2):
        tok = r.randint(0, cfg.vocab_size, size=(2, 1)).astype(np.int32)
        logits, cache = dec(params, cache, {"tokens": jnp.asarray(tok)})
        out[f"mla/tok{i}"], out[f"mla/decode{i}"] = tok, np.asarray(logits)

# the hybrid and encoder-decoder families under FSDP on (4,1), in float64
# (x64 on from here to the end): zamba2-7b at 4 layers (its shared block
# read by two groups) and seamless-m4t-medium with the stub frontend's
# embeddings. In float32 their grad norms carry the stacks' rounding: the
# reference's own one-device and FSDP float32 steps disagree there by more
# than the 1e-5 the ranks are held to; each also on one device
jax.config.update("jax_enable_x64", True)
mesh_f = make_mesh(4, 1, devices=jax.devices()[:4])
for arch, over in (("zamba2-7b", {"n_layers": 4}),
                   ("seamless-m4t-medium", {})):
    cfg = reduced(get_config(arch), param_dtype="float64",
                  compute_dtype="float64", fsdp=True, **over)
    params = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64),
        init_params(tf.model_template(cfg), jax.random.PRNGKey(0)))
    toks = jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0,
                              cfg.vocab_size)
    batch = {"tokens": toks, "labels": jnp.roll(toks, -1, 1)}
    if cfg.frontend_seq:
        batch["frontend_emb"] = jnp.asarray(np.random.RandomState(2).randn(
            4, cfg.frontend_seq, cfg.frontend_dim))
    ctx1 = MeshCtx(mesh=mesh_f, batch_axes=("data",))
    b1 = step_lib.make_train_step(cfg, opt, ctx1)
    st_sh = step_lib.named_for(b1.state_specs, b1.abstract_state, mesh_f)
    bt_sh = step_lib.named_for(b1.batch_specs, batch, mesh_f)
    with mesh_f:
        fn = jax.jit(b1.step_fn, in_shardings=(st_sh, bt_sh),
                     out_shardings=(st_sh, None))
        _, m1 = fn(jax.device_put({"params": params,
                                   "opt": adamw.init(opt, params)}, st_sh),
                   jax.device_put(batch, bt_sh))
    # the same step on one device: the witness of how far the two
    # packages' float64 steps lie apart (the reference computes attention
    # scores and the logits in float32 whatever its compute dtype)
    b0 = step_lib.make_train_step(cfg, opt, MeshCtx(mesh=None))
    _, m0 = jax.jit(b0.step_fn)({"params": params,
                                 "opt": adamw.init(opt, params)}, batch)
    put(f"step_fsdp_{arch}/params", params)
    for key, val in batch.items():
        if key != "labels":
            out[f"step_fsdp_{arch}/{key}"] = np.asarray(val)
    for key in ("loss", "ce", "grad_norm"):
        out[f"step_fsdp_{arch}/m1_{key}"] = np.asarray(m1[key])
        out[f"step_fsdp_{arch}/m0_{key}"] = np.asarray(m0[key])

np.savez(%(path)r, **out)
print("JAX_MESH_OK")
'''


def reference_npz(tmp_path_factory) -> dict:
    """The reference subprocess's outputs: run once a test session
    (``tests/test_torch_processes.py`` reads its sharded train step too)."""
    def make(path):
        code = REFERENCE % {"path": path, "shapes": SHAPES,
                            "groups": GROUPS, "ep": EP_CASES}
        assert "JAX_MESH_OK" in run_devices(code, n_devices=8)
    path = torch_shared_run.once(tmp_path_factory, "jax_mesh.npz", make)
    return dict(np.load(path))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference_npz(tmp_path_factory)


def _tree(npz, prefix):
    """The nested dict of arrays saved under ``prefix/``."""
    tree = {}
    for key, val in npz.items():
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        parts = key[len(prefix) + 1:].split("/")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = val
    return tree


def _params(npz, prefix, dtype=None):
    return convert.params_from_numpy(_tree(npz, prefix), device="cpu",
                                     dtype=dtype)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got.detach(), np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=atol)


# ---------------------------------------------------------------------------
# the stacked shard_map and its collectives
# ---------------------------------------------------------------------------


def test_split_and_merge_are_the_references_layout():
    """Shard ``i`` of a dimension is its ``i``-th block, the first axis of a
    tuple entry the major one; an unnamed axis is a stride-0 view."""
    mesh = Mesh(("data", "model"), (2, 3))
    x = torch.arange(6 * 4).reshape(6, 4)
    st = compat.split(x, PS(("data", "model"), None), mesh)
    assert st.shape == (2, 3, 1, 4)
    for d in range(2):
        for m in range(3):
            assert torch.equal(st[d, m, 0], x[d * 3 + m])
    st = compat.split(x, PS("model"), mesh)
    assert st.shape == (2, 3, 2, 4) and st.stride()[0] == 0
    assert torch.equal(st[1, 2], x[4:6])
    assert torch.equal(compat.merge(st, PS("model"), mesh), x)
    assert torch.equal(compat.merge(st, PS(), mesh), x[0:2])
    y = compat.split(x, PS(None, "data"), mesh)
    assert torch.equal(compat.merge(y, PS(None, "data"), mesh), x)


def test_shard_map_refuses_a_ragged_split():
    mesh = Mesh(("data", "model"), (2, 4))
    fn = compat.shard_map(lambda x: x, mesh=mesh, in_specs=(PS("model"),),
                          out_specs=PS("model"))
    with pytest.raises(ValueError, match=r"array axis 0 \(of size 10\) to "
                       r"mesh axis 'model' \(of size 4\), but 4 does not "
                       r"evenly divide 10"):
        fn(torch.zeros(10, 3))
    with pytest.raises(RuntimeError, match="inside shard_map"):
        compat.psum(torch.zeros(2), "data")


def test_collectives_and_their_counts():
    mesh = Mesh(("data", "model"), (2, 4))

    def body(x):
        ring = compat.ppermute(x, "model", [(i, (i + 1) % 4)
                                            for i in range(4)])
        with pytest.raises(ValueError, match="not a ring"):
            compat.ppermute(x, "model", [(0, 2)])
        tot = compat.psum(x, "model")
        mx = compat.pmax(x, ("data", "model"))
        gat = compat.all_gather(x, "model")
        a2a = compat.all_to_all(x.reshape(2, 4, 4, 1), "model", 0, 0)
        return ring, tot, mx, gat, a2a

    compat.reset_counts()
    x = torch.arange(32.0).reshape(8, 4)      # device (d, m) holds row 4d+m
    outs = compat.shard_map(
        body, mesh=mesh, in_specs=(PS(("data", "model")),),
        out_specs=(PS(("data", "model")),) * 5)(x)
    ring, tot, mx = (o.reshape(2, 4, 4) for o in outs[:3])
    gat, a2a = outs[3].reshape(2, 4, 4, 4), outs[4].reshape(2, 4, 4)
    rows = x.reshape(2, 4, 4)
    assert torch.equal(ring, torch.roll(rows, 1, dims=1))
    assert torch.equal(tot, rows.sum(1, keepdim=True).expand(2, 4, 4))
    assert torch.equal(mx, rows.amax((0, 1)).expand(2, 4, 4))
    # all_gather: every device of a data row holds the row's four buffers
    assert torch.equal(gat, rows[:, None].expand(2, 4, 4, 4))
    # all_to_all: device m's element j came from device j's element m
    assert torch.equal(a2a, rows.transpose(1, 2))
    got = compat.read_counts()
    assert {k: v["calls"] for k, v in got.items()} == {
        "ppermute": 1, "psum": 1, "pmax": 1, "all_gather": 1,
        "all_to_all": 1, "shard_map": 1}
    local = 4 * 4                             # one device's f32 buffer
    assert got["ppermute"]["bytes"] == local * 8
    assert got["psum"]["bytes"] == 2 * 3 / 4 * local * 8
    assert got["pmax"]["bytes"] == 2 * 7 / 8 * local * 8
    assert got["all_gather"]["bytes"] == 3 * local * 8
    assert got["all_to_all"]["bytes"] == 3 / 4 * local * 8


# ---------------------------------------------------------------------------
# meshes and specs
# ---------------------------------------------------------------------------


def test_mesh_constructors():
    """tests/test_distribution.py::test_mesh_constructors, on no devices."""
    m = tmesh.make_production_mesh()
    assert m.sizes == (16, 16) and m.axis_names == ("data", "model")
    m2 = tmesh.make_production_mesh(multi_pod=True)
    assert m2.sizes == (2, 16, 16)
    assert m2.axis_names == ("pod", "data", "model")
    em, data = tmesh.elastic_mesh(300, model=16)
    assert em.sizes == (18, 16) and data == 18
    em, data = tmesh.elastic_mesh(8, model=16)
    assert em.sizes == (1, 8) and data == 1
    assert tmesh.make_mesh(2, 4, pod=3).shape == {"pod": 3, "data": 2,
                                                  "model": 4}


def _stand_in(sizes):
    names = ("pod", "data", "model")[-len(sizes):]
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(sizes, dtype=object))


def _plain(tree):
    """Spec trees as nested dicts of plain tuples (entries kept)."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e
                 for e in tree)


@pytest.mark.parametrize("sizes", [(16, 16), (2, 16, 16)],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_specs_match_reference(arch, sizes):
    """make_rules, kv_cache_rules, param_specs (through train_state_specs),
    batch_pspecs, cache_pspecs and the sanitized state specs of named_for,
    for every config, equal to the reference's as tuples."""
    batch_axes = ("pod", "data") if len(sizes) == 3 else ("data",)
    names = ("pod", "data", "model")[-len(sizes):]
    jctx = jsh.MeshCtx(mesh=_stand_in(sizes), batch_axes=batch_axes)
    tctx = tsh.MeshCtx(mesh=Mesh(names, sizes), batch_axes=batch_axes)
    cj, ct = jget(arch), tget(arch)
    for fn in ("make_rules", "kv_cache_rules"):
        got, want = getattr(tsh, fn)(ct, tctx), getattr(jsh, fn)(cj, jctx)
        assert (got.mapping, got.mesh_shape) == (want.mapping,
                                                 want.mesh_shape), fn
    specs = tstep.train_state_specs(ct, tctx)
    assert _plain(specs) == _plain(jstep.train_state_specs(cj, jctx))
    for kind in ("train", "prefill"):
        assert _plain(tstep.batch_pspecs(ct, kind, tctx)) == _plain(
            jstep.batch_pspecs(cj, kind, jctx))
    assert _plain(tstep.cache_pspecs(ct, tctx)) == _plain(
        jstep.cache_pspecs(cj, jctx))
    opt = adamw.OptConfig()
    tab = tstep.make_train_state_abstract(ct, opt)
    jab = jstep.make_train_state_abstract(cj, jstep.adamw.OptConfig())
    assert tree_map(lambda a: (tuple(a.shape), str(a.dtype)[6:]), tab) == \
        jax_tree_shapes(jab)
    got = tstep.sanitize_specs(specs, tab, tctx.mesh)
    want = jstep.sanitize_specs(jstep.train_state_specs(cj, jctx), jab,
                                jctx.mesh)
    assert _plain(got) == _plain(want)
    _check_shards(tstep.named_for(specs, tab, tctx.mesh), tab)


def jax_tree_shapes(tree):
    if isinstance(tree, dict):
        return {k: jax_tree_shapes(v) for k, v in tree.items()}
    return tuple(tree.shape), str(tree.dtype)


def _check_shards(named, abstract):
    """Every leaf's shard shape times its mesh axes' sizes is the leaf's
    shape (the sanitized specs always divide)."""
    for sh, a in zip(tree_leaves(named), tree_leaves(abstract)):
        shard = sh.shard_shape(a.shape)
        for dim, entry in enumerate(sh.spec):
            n = int(np.prod([sh.mesh.shape[x]
                             for x in compat.entry_axes(entry)]))
            assert shard[dim] * n == a.shape[dim]


def test_restore_checks_shardings_with_the_references_text(ref, tmp_path):
    """A leaf that a target sharding does not divide raises the
    reference's ``device_put`` text; one that divides restores whole."""
    from repro_torch.checkpoint import ckpt
    import json
    want = json.loads(str(ref["messages"]))["device_put"]
    w = torch.arange(80.0).reshape(10, 8)
    ckpt.save(str(tmp_path), 1, {"w": w})
    mesh = tmesh.make_mesh(2, 4)
    bad = {"w": tsh.NamedSharding(mesh, PS("model", "data"))}
    with pytest.raises(ValueError) as e:
        ckpt.restore(str(tmp_path), shardings=bad, device="cpu")
    tail = want[want.index("which implies"):]
    assert str(e.value).endswith(tail), (str(e.value), tail)
    ok = {"w": tsh.NamedSharding(mesh, PS("data", "model"))}
    step, got = ckpt.restore(str(tmp_path), shardings=ok, device="cpu")
    assert step == 1 and torch.equal(got["w"], w)


# ---------------------------------------------------------------------------
# chaining
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("group", GROUPS + ("rs",))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_chaining_divisible_sweep_matches_reference(ref, shape, group):
    """tests/test_distribution.py's divisible sweep: the output at 1e-5 of
    the reference's, and the ring's ppermute count pinned:
    ``(group - 1) + n_dev/group`` for the all-gather, ``n_dev`` for the
    reduce-scatter."""
    tag = "chain_" + "x".join(map(str, shape))
    x, w = _t(ref[tag + "_x"]), _t(ref[tag + "_w"])
    mesh = tmesh.make_mesh(1, 4)
    compat.reset_counts()
    if group == "rs":
        y = chaining.matmul_reduce_scatter(x, w, mesh, "model")
        want, hops = ref[tag + "_rs"], 4
    else:
        y = chaining.all_gather_matmul(x, w, mesh, "model", group=group)
        want, hops = ref[f"{tag}_g{group}"], (group - 1) + 4 // group
    _close(y, want, 1e-5)
    assert compat.CALLS["ppermute"] == hops
    assert set(compat.CALLS) == {"ppermute", "shard_map"}


def test_chaining_ragged_shapes_raise_the_references_texts(ref):
    import json
    want = json.loads(str(ref["messages"]))
    mesh = tmesh.make_mesh(1, 4)
    x10, x8 = torch.zeros(10, 16), torch.zeros(8, 16)
    w = torch.zeros(16, 12)
    cases = {
        "ag_m": lambda: chaining.all_gather_matmul(x10, w, mesh, "model"),
        "ag_group": lambda: chaining.all_gather_matmul(x8, w, mesh, "model",
                                                       group=3),
        "rs_k": lambda: chaining.matmul_reduce_scatter(
            torch.zeros(8, 10), torch.zeros(10, 12), mesh, "model"),
        "rs_m": lambda: chaining.matmul_reduce_scatter(x10, w, mesh, "model"),
        "ag_contract": lambda: chaining.all_gather_matmul(
            x8, torch.zeros(8, 4), mesh, "model"),
        "rs_contract": lambda: chaining.matmul_reduce_scatter(
            x8, torch.zeros(8, 4), mesh, "model"),
    }
    compat.reset_counts()
    for name, fn in cases.items():
        with pytest.raises(ValueError) as e:
            fn()
        assert str(e.value) == want[name], name
    assert not compat.CALLS           # raised before any ring step


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [0, 1])
def test_compressed_psum_matches_reference(ref, case, monkeypatch):
    """tests/test_substrate.py's inputs (case 0) and a padded, residual-
    carrying case: ``q`` bit-equal, the mean and residual within 1e-6."""
    tag = f"comp{case}"
    g, r = _t(ref[tag + "_g"]), _t(ref[tag + "_r"])
    mesh = tmesh.make_mesh(4, 1)
    captured = []
    a2a = compat.all_to_all

    def spy(x, *a, **kw):
        captured.append(x)
        return a2a(x, *a, **kw)
    monkeypatch.setattr(compat, "all_to_all", spy)

    def device_fn(g_loc, r_loc):
        (mean_g,), (new_r,) = compressed_psum((g_loc,), (r_loc,), mesh,
                                              ("data",))
        return mean_g, new_r, captured[-1]

    compat.reset_counts()
    mean_g, new_r, q = compat.shard_map(
        device_fn, mesh=mesh, in_specs=(PS("data"), PS("data")),
        out_specs=(PS(None), PS("data"), PS("data")))(g, r)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy().reshape(ref[tag + "_q"].shape),
                                  ref[tag + "_q"])
    _close(mean_g, ref[tag + "_mean"], 1e-6)
    _close(new_r, ref[tag + "_res"], 1e-6)
    true_mean = (g + r).numpy().mean(axis=0)
    scale = np.abs(true_mean).max()
    assert np.abs(mean_g.numpy()[0] - true_mean).max() < 0.05 * scale + 0.05
    n = int(np.prod(g.shape[1:]))
    k = -(-n // 4)
    assert {c: v["calls"] for c, v in compat.read_counts().items()} == {
        "pmax": 1, "all_to_all": 1, "all_gather": 2, "shard_map": 1}
    # int8 on the wire: the all_to_all moves 3/4 of each device's 4k bytes
    assert compat.BYTES["all_to_all"] == 3 * k * 4


def test_init_residuals_are_fp32_zeros():
    p = {"a": torch.ones(3, dtype=torch.bfloat16), "b": {"c": torch.ones(2)}}
    r = init_residuals(p)
    assert r["a"].dtype == torch.float32 and not r["a"].any()
    assert r["b"]["c"].shape == (2,)


# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------


def _ep_cfg(name):
    if name == "deepseek":
        cfg = reduced(tget("deepseek-v3-671b"), mtp_depth=0)
        return dataclasses.replace(cfg, d_model=32, moe=dataclasses.replace(
            cfg.moe, n_experts=8, top_k=2, expert_d_ff=16,
            capacity_factor=16.0, n_shared_experts=0, n_dense_layers=0))
    cfg = reduced(tget("granite-moe-3b-a800m"))
    return dataclasses.replace(cfg, d_model=32, moe=dataclasses.replace(
        cfg.moe, n_experts=5, top_k=2, expert_d_ff=16, capacity_factor=16.0,
        pad_experts_to=8))


@pytest.mark.parametrize("name", list(EP_CASES))
def test_moe_ep_shard_map_matches_reference(ref, name, monkeypatch):
    """tests/test_moe.py's two EP configs on a 2 x 4 mesh (padded experts
    in the second): output and aux at 1e-5 of the reference's EP route,
    three all_to_all a chunk, one pmean."""
    cfg = _ep_cfg(name)
    chunk = EP_CASES[name]["chunk"]
    monkeypatch.setattr(tmoe, "EP_CHUNK_TOKENS", chunk)
    p = _params(ref, f"ep_{name}/p")
    x = _t(ref[f"ep_{name}/x"])
    ctx = tsh.MeshCtx(mesh=tmesh.make_mesh(2, 4))
    compat.reset_counts()
    y, aux = tmoe.moe_ep_shard_map(cfg, p, x, ctx)
    _close(y, ref[f"ep_{name}/y"], 1e-5)
    _close(aux, ref[f"ep_{name}/aux"], 1e-5)
    chunks = 64 // 8 // chunk
    assert compat.CALLS["all_to_all"] == 3 * chunks
    assert compat.CALLS["pmean"] == 1


def test_moe_ep_empty_slots_claim_no_capacity(ref):
    """granite's layout, 12 experts a lane, capacity factor 16 (no token
    over capacity): the port's route equals the one-hot dispatch within the
    reference's own bound (tests/test_moe.py: 1e-3 of the largest + 1e-4);
    the reference's route does not — its empty send slots, tagged local
    expert 0, take that expert's capacity and drop real tokens — and the
    port equals it on every token it keeps (the deliberate difference in
    ``moe._ep_device_fn``'s docstring)."""
    full = tget("granite-moe-3b-a800m")
    cfg = dataclasses.replace(full, d_model=64, moe=dataclasses.replace(
        full.moe, expert_d_ff=32, capacity_factor=16.0))
    p = _params(ref, "flood/p")
    x = _t(ref["flood/x"])
    y, _ = tmoe.moe_ep_shard_map(cfg, p, x,
                                 tsh.MeshCtx(mesh=tmesh.make_mesh(2, 4)))
    dense, ref_ep = ref["flood/y_dense"], ref["flood/y_ep"]
    scale = np.abs(dense).max()
    assert np.abs(y.numpy() - dense).max() < 1e-3 * scale + 1e-4
    _close(tmoe.moe_dense_dispatch(cfg, p, x)[0], dense, 1e-5)
    flooded = np.abs(ref_ep - dense).max(axis=-1) > 1e-3 * scale + 1e-4
    assert flooded.sum() > 10, flooded.sum()
    _close(y[~flooded], ref_ep[~flooded], 1e-5)


def test_moe_ep_refuses_a_mesh_that_does_not_divide_the_experts():
    """Three lanes over eight experts: the shard_map raises the ragged-split
    ValueError; moe_block's gate keeps such a mesh on the dense dispatch."""
    cfg = _ep_cfg("deepseek")
    p = init_params(tmoe.moe_template(cfg), torch.Generator().manual_seed(0),
                    device="cpu")
    x = torch.randn(48, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    ctx = tsh.MeshCtx(mesh=tmesh.make_mesh(2, 3))
    with pytest.raises(ValueError, match="does not evenly divide 8"):
        tmoe.moe_ep_shard_map(cfg, p, x, ctx)
    y, aux = tmoe.moe_block(cfg, p, x[None], ctx)
    y0, aux0 = tmoe.moe_block(cfg, p, x[None], None)
    assert torch.equal(y, y0) and torch.equal(aux, aux0)


# ---------------------------------------------------------------------------
# the sharded train step and lane-local MLA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,arch,dense_max", [
    ("dense", "tinyllama-1.1b", None),
    ("moe_ep", "deepseek-v3-671b", 32)])
def test_sharded_train_step_matches_reference(ref, name, arch, dense_max,
                                              monkeypatch):
    """tests/test_distribution.py::test_sharded_train_step_matches_single_
    device on the port: its step on a 2 x 2 mesh against the reference's
    sharded step, loss within the reference's 5e-4; with
    ``DENSE_PATH_MAX_TOKENS`` lowered in both packages, deepseek-v3's MoE
    layer (4 experts, 2 a lane: the two packages' empty-slot rules agree
    there) takes the expert-parallel route inside the step, after its
    dense layer and beside MLA and the MTP module."""
    if dense_max:
        monkeypatch.setattr(tmoe, "DENSE_PATH_MAX_TOKENS", dense_max)
    cfg = reduced(tget(arch), compute_dtype="float32")
    params = _params(ref, f"step_{name}/params")
    toks = _t(ref[f"step_{name}/tokens"])
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    opt = adamw.OptConfig()
    state = {"params": params, "opt": adamw.init(opt, params)}
    ctx = tsh.MeshCtx(mesh=tmesh.make_mesh(2, 2), batch_axes=("data",))
    bundle = tstep.make_train_step(cfg, opt, ctx)
    compat.reset_counts()
    _, m1 = bundle.step_fn(state, batch)
    for key in ("loss", "ce", "aux"):
        assert abs(float(m1[key]) - float(ref[f"step_{name}/m1_{key}"])) \
            < 5e-4, key
    assert abs(float(m1["grad_norm"])
               - float(ref[f"step_{name}/m1_grad_norm"])) < 1e-3
    # each MoE layer's forward: 3 all_to_all (16 tokens a device, one chunk)
    n_moe = params["layers"]["moe"]["router"].shape[0] if dense_max else 0
    assert compat.CALLS["all_to_all"] == 3 * n_moe
    assert compat.CALLS["shard_map"] == n_moe
    _check_shards(tstep.named_for(bundle.state_specs, bundle.abstract_state,
                                  ctx.mesh), bundle.abstract_state)


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)], ids=str)
def test_sharded_moe_train_step_matches_reference(ref, shape):
    """granite-moe-3b-a800m reduced (4 experts padded to 48) on a (2,2) and
    a (4,1) mesh held as tensor dimensions: its one-hot dispatch (one
    group of the global batch) inside the step, loss, ce and aux within
    5e-4 and grad norm within 1e-3 of the reference's sharded step, as the
    dense step."""
    cfg = reduced(tget("granite-moe-3b-a800m"), compute_dtype="float32")
    params = _params(ref, "step_moe/params")
    toks = _t(ref["step_moe/tokens"])
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    opt = adamw.OptConfig()
    ctx = tsh.MeshCtx(mesh=tmesh.make_mesh(*shape), batch_axes=("data",))
    bundle = tstep.make_train_step(cfg, opt, ctx)
    _, m1 = bundle.step_fn({"params": params, "opt": adamw.init(opt, params)},
                           batch)
    tag = "x".join(map(str, shape))
    for key in ("loss", "ce", "aux"):
        assert abs(float(m1[key]) - float(ref[f"step_moe_{tag}/m1_{key}"])) \
            < 5e-4, key
    assert abs(float(m1["grad_norm"])
               - float(ref[f"step_moe_{tag}/m1_grad_norm"])) < 1e-3
    _check_shards(tstep.named_for(bundle.state_specs, bundle.abstract_state,
                                  ctx.mesh), bundle.abstract_state)


def test_sharded_fsdp_train_step_matches_reference(ref):
    """The same dense step with ``fsdp=True`` on the 2 x 2 mesh held as
    tensor dimensions (every embed dimension sharded over data in the
    specs; the stacked step computes the global math) against the
    reference's FSDP step on the same parameters and tokens: loss within
    5e-4, grad norm within 1e-3, as the step without FSDP."""
    cfg = dataclasses.replace(reduced(tget("tinyllama-1.1b"),
                                      compute_dtype="float32"), fsdp=True)
    params = _params(ref, "step_dense/params")
    toks = _t(ref["step_dense/tokens"])
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    opt = adamw.OptConfig()
    ctx = tsh.MeshCtx(mesh=tmesh.make_mesh(2, 2), batch_axes=("data",))
    bundle = tstep.make_train_step(cfg, opt, ctx)
    _, m1 = bundle.step_fn({"params": params, "opt": adamw.init(opt, params)},
                           batch)
    for key in ("loss", "ce", "aux"):
        assert abs(float(m1[key]) - float(ref[f"step_dense_fsdp/m1_{key}"])) \
            < 5e-4, key
    assert abs(float(m1["grad_norm"])
               - float(ref["step_dense_fsdp/m1_grad_norm"])) < 1e-3
    named = tstep.named_for(bundle.state_specs, bundle.abstract_state,
                            ctx.mesh)
    assert any("data" in compat.entry_axes(e) for sh in tree_leaves(named)
               for e in sh.spec)
    _check_shards(named, bundle.abstract_state)


def test_lane_local_mla_prefill_and_decode_match_reference(ref):
    """deepseek-v3-671b reduced on a 1 x 4 mesh: the serve steps' prefill
    takes the lane-local route (heads over the lanes) in both packages;
    the logits of the prefill and two decode steps at 1e-4 of the
    reference's."""
    cfg = reduced(tget("deepseek-v3-671b"))
    params = _params(ref, "mla/params")
    ctx = tsh.MeshCtx(mesh=tmesh.make_mesh(1, 4), batch_axes=("data",))
    compat.reset_counts()
    with torch.no_grad():
        logits, cache = tstep.make_prefill_step(cfg, ctx, 16)(
            params, {"tokens": _t(ref["mla/tokens"])})
        assert compat.CALLS["shard_map"] == cfg.n_layers
        _close(logits, ref["mla/prefill"], 1e-4)
        dec = tstep.make_decode_step(cfg, ctx)
        for i in range(2):
            logits, cache = dec(params, cache,
                                {"tokens": _t(ref[f"mla/tok{i}"])})
            _close(logits, ref[f"mla/decode{i}"], 1e-4)
    # the absorbed decode runs no shard_map; what crosses the lanes is the
    # all-reduce of each split product's output, counted as the ranks of
    # a process mesh run it (``models.sharding.around_split``): MLA's after
    # ``wo`` in every layer, the experts' combined output in each MoE
    # layer, in each of the three forwards
    n_moe = cfg.n_layers - cfg.moe.n_dense_layers
    assert compat.CALLS == {"shard_map": cfg.n_layers,
                            "psum": 3 * (cfg.n_layers + n_moe)}
    ttf.forward(cfg, params, _t(ref["mla/tokens"]))   # resets the context
