"""PyTorch port, the dry-run roofline against the reference's, on the CPU:

- ``repro_torch.core.step_analysis.analyze`` of a torch step (on ``meta``
  tensors, ``target="cpu"``: the CPU's routes, as the reference's host
  devices take) against ``repro.core.hlo_analysis.analyze`` of the compiled
  step: FLOPs within 1 % on one device for reduced tinyllama-1.1b,
  granite-moe-3b-a800m, zamba2-7b and deepseek-v3-671b (train, prefill,
  decode) and per device on the meshes (4,1), (1,4), (2,2); the collective
  bytes of the train step within 1e-4 on (4,1), (1,4) and (2,2), and FSDP
  at (4,1) and (2,2) pinned at its measured ratio (ROADMAP Queue C);
  every kind of step that the dry run counts on a mesh (``CELLS``: prefill,
  decode, the MoE, MLA, SSM, hybrid, vision and encoder-decoder train
  steps, the hybrid family under FSDP, and the expert-parallel
  route at a gate lowered in both packages, ``GATES``, whose all-to-alls
  agree exactly), each within 1 % or pinned
  at its measured ratio with its cause, and flagged where its count is
  known short (``count_short``); the inputs' shard bytes against the
  compiled programs' ``argument_size_in_bytes``. The reference's side runs
  in one subprocess on 4 host devices.
- the count's rules on tiny synthetic steps: a lookup into a
  ``model``-sharded table, products that contract tokens after views and a
  backward, parameters read through a slice.
- twins of the reference's own analyzer and roofline tests, the kernels'
  work counts (counted once on the CPU, the routes' difference exactly the
  kernels' work less the blockwise products), ``meta`` launches, the
  collectives' backward counts, ``launch/dryrun.py``, ``launch/report.py``
  and ``experiments/torch_hillclimb.py``.
"""
import dataclasses
import functools
import importlib.util
import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import run_devices
from repro.launch import report as jreport
from repro_torch.configs import SHAPES, get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import compat, roofline, step_analysis
from repro_torch.core.compat import PartitionSpec as PS
from repro_torch.core.precision import torch_dtype
from repro_torch.core.step_analysis import analyze
from repro_torch.kernels import attention as att
from repro_torch.kernels import axpy as ax
from repro_torch.kernels import build
from repro_torch.kernels import conv as cv
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import ssm_scan as ss
from repro_torch.launch import dryrun, report
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models.layers import abstract_params, init_params
from repro_torch.models.sharding import MeshCtx
from repro_torch.optim import adamw
from repro_torch.train import step as step_lib

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("tinyllama-1.1b", "granite-moe-3b-a800m", "zamba2-7b",
         "deepseek-v3-671b")
KINDS = ("train", "prefill", "decode")
MESHES = {"4x1": (4, 1, False), "1x4": (1, 4, False), "2x2": (2, 2, False),
          "4x1 fsdp": (4, 1, True), "2x2 fsdp": (2, 2, True)}
# every other kind of step on a mesh, reduced, at 8 x 64: (arch, kind,
# data, model[, the config's overrides])
CELLS = {
    "tinyllama-1.1b prefill 1x4": ("tinyllama-1.1b", "prefill", 1, 4),
    "tinyllama-1.1b decode 1x4": ("tinyllama-1.1b", "decode", 1, 4),
    "tinyllama-1.1b decode 4x1": ("tinyllama-1.1b", "decode", 4, 1),
    "deepseek-v3-671b prefill 1x4": ("deepseek-v3-671b", "prefill", 1, 4),
    "deepseek-v3-671b decode 1x4": ("deepseek-v3-671b", "decode", 1, 4),
    "deepseek-v3-671b train 2x2": ("deepseek-v3-671b", "train", 2, 2),
    # MLA, the experts and the vocab under model without FSDP: the cells
    # whose ranks tests/test_torch_processes.py runs
    "deepseek-v3-671b train 1x4 tp": ("deepseek-v3-671b", "train", 1, 4,
                                      {"fsdp": False}),
    "deepseek-v3-671b train 2x2 tp": ("deepseek-v3-671b", "train", 2, 2,
                                      {"fsdp": False}),
    "granite-moe-3b-a800m train 4x1": ("granite-moe-3b-a800m", "train", 4, 1),
    "granite-moe-3b-a800m train 1x4": ("granite-moe-3b-a800m", "train", 1, 4),
    "granite-moe-3b-a800m train 2x2": ("granite-moe-3b-a800m", "train", 2, 2),
    "zamba2-7b train 4x1": ("zamba2-7b", "train", 4, 1),
    "zamba2-7b train 1x4": ("zamba2-7b", "train", 1, 4),
    # the mLSTM blocks under model: the cell whose ranks
    # tests/test_torch_ssm_processes.py runs (there at 8 x 32)
    "xlstm-1.3b train 1x4": ("xlstm-1.3b", "train", 1, 4),
    # the cross layers under model: the cells whose ranks
    # tests/test_torch_cross_processes.py runs (there at 8 x 32, the audio
    # vocab 258) and chip_smoke.py's phase 47 at full width
    "llama-3.2-vision-11b train 1x4": ("llama-3.2-vision-11b", "train", 1,
                                       4, {"fsdp": False}),
    "seamless-m4t-medium train 2x2": ("seamless-m4t-medium", "train", 2, 2,
                                      {"fsdp": False}),
    # the hybrid family under FSDP: the cell whose ranks
    # tests/test_torch_processes.py runs (there at 4 layers)
    "zamba2-7b train 4x1 fsdp": ("zamba2-7b", "train", 4, 1,
                                 {"fsdp": True}),
    # the expert-parallel route, its gate lowered in both packages to the
    # cell's 512 tokens (GATES): the body's all-to-alls and the re-lay of
    # the experts' FFN blocks as blocks of the experts
    "granite-moe-3b-a800m train 2x2 ep": ("granite-moe-3b-a800m", "train",
                                          2, 2),
    # the step in 2 micro-batches (ACCUM): the port's ranks re-lay the
    # batch micro-major and run each strip's dispatch gathers
    "granite-moe-3b-a800m train 2x2 accum2": ("granite-moe-3b-a800m",
                                              "train", 2, 2),
}
# DENSE_PATH_MAX_TOKENS of a cell where it is not the packages' 16384
GATES = {"granite-moe-3b-a800m train 2x2 ep": 8 * 64}
# grad_accum of a cell where it is not 1
ACCUM = {"granite-moe-3b-a800m train 2x2 accum2": 2}
FLOPS_TOL = 0.01
# tinyllama-1.1b's train step and granite-moe-3b-a800m's on (1,4) within
# 1e-4: the count derives the cross-entropy's reductions over the
# vocab-sharded logits and no model all-reduce for a gradient every device
# computes whole (ROADMAP Queue C, open fault 1); the reference's 6 bytes
# left on (1,4) are a f32[] member of its gold logits' tuple all-reduce
COLL_TOL = {"4x1": 1e-4, "1x4": 1e-4, "2x2": 1e-4,
            "granite-moe-3b-a800m train 1x4": 1e-4,
            "tinyllama-1.1b prefill 1x4": 0.01,
            "tinyllama-1.1b decode 1x4": 0.01,
            "zamba2-7b train 4x1": 0.01,
            # all-reduces alone on both sides (test below); the reference's
            # 96 and 76 bytes left are scalar members of its tuple
            # all-reduces
            "llama-3.2-vision-11b train 1x4": 1e-4,
            "seamless-m4t-medium train 2x2": 1e-4}
# the cross layers' cells, held kind by kind
CROSS_CELLS = ("llama-3.2-vision-11b train 1x4",
               "seamless-m4t-medium train 2x2")
# FLOPs a device, port / reference, where the reference's partitioner does
# not split the products evenly and the port's even split is a
# perfect-division bound (ROADMAP Queue C, the dry run's deliberate
# differences): the one-hot MoE dispatch's products (granite-moe-3b-a800m:
# 625 M, 1,114 M and 741 M a device where the port counts 488 M on each
# mesh), and deepseek-v3-671b's router and
# MLA latent down-projections (``wq_a``, ``wkv_a``, replicated over model),
# which the reference runs whole on every device
FLOPS_PINNED = {
    "deepseek-v3-671b prefill 1x4": 0.94579,
    "deepseek-v3-671b decode 1x4": 0.85695,
    "deepseek-v3-671b train 2x2": 0.98457,
    "deepseek-v3-671b train 1x4 tp": 0.88568,
    "deepseek-v3-671b train 2x2 tp": 0.88685,
    "granite-moe-3b-a800m train 4x1": 0.77992,
    "granite-moe-3b-a800m train 1x4": 0.43776,
    "granite-moe-3b-a800m train 2x2": 0.65812,
    # in 2 micro-batches a group holds half the tokens at half the
    # capacity: the port's even split counts 381 M a device (488 M in one
    # batch), the reference's scan runs 968 M (741 M in one batch)
    "granite-moe-3b-a800m train 2x2 accum2": 0.39334,
}
# collective bytes a device, port / reference, pinned at the measured
# ratio: (all kinds, all-reduce alone, cause). The reference's kinds that
# the port derives none of are partitioner choices (ROADMAP Queue C).
COLL_PINNED = {
    "deepseek-v3-671b prefill 1x4": (
        0.91192, 0.91192,
        "the reference all-reduces the lookup after its cast to the f32 "
        "compute dtype (196,608 bytes, the port's bf16 result 98,304) and "
        "a f32[1,1024] tuple member (6,144)"),
    "deepseek-v3-671b decode 1x4": (
        0.56230, 0.66415,
        "the lookup after its cast to f32 (1,536 more); MLA's absorbed "
        "decode: all-reduces of (8,16,4,1) scores and (8,4,1) and "
        "all-gathers of (8,1,4,16) and (8,1,4,8), 11,616 bytes"),
    "deepseek-v3-671b train 2x2": (
        0.19796, 0.36561,
        "FSDP (open fault 2): the partitioner moves activations where the "
        "port gathers weights, plus an all-to-all of 1,146,880 and "
        "collective-permutes of 401,408 (0.18842 / 0.34420 while the "
        "count derived MLA's and the experts' all-reduces from the split "
        "tables: it missed k_rope's cotangent, 16,384, and the experts' "
        "forward or backward all-reduce and their gates', 67,584, which "
        "the tensor-parallel ranks move; 0.17852 / 0.34679 while the "
        "replicated leaves' gradients were all-reduced over model and the "
        "cross-entropy's vocab reductions were not derived; 0.17737 while "
        "a backward that reads a leaf's cast was not counted as reading "
        "the leaf: the bf16 parameters, cast to the f32 compute dtype, are "
        "gathered again for the backward, all-gathers 105,376 -> 202,560, "
        "as the FSDP ranks gather them)"),
    "deepseek-v3-671b train 1x4 tp": (
        0.95495, 0.95495,
        "the reference all-reduces both lookups (the stack's and the MTP "
        "module's) after their cast to the f32 compute dtype (393,216 "
        "bytes, the port's bf16 results 196,608), a f32[1,1024] tuple "
        "member (6,144) and scalar tuple members (144); MLA's latent "
        "cotangents, the experts' tokens, gates and output and the "
        "cross-entropies move the same bytes on both sides"),
    "deepseek-v3-671b train 2x2 tp": (
        0.73873, 0.74146,
        "as on (1,4), the lookups in f32 (131,072 where the port's bf16 "
        "move 65,536); the reference reduces the gradients over data in "
        "f32 before their cast to the bf16 parameters' dtype, where the "
        "port's data-parallel mean moves the bf16 gradients (210,752), "
        "all-reduces the one-hot dispatch's buffer over data "
        "(f32[1,2,320,64], 163,840) and all-gathers routing tensors "
        "(8,192), where the port's ranks all-gather each other's "
        "per-expert counts (16)"),
    "granite-moe-3b-a800m train 4x1": (
        0.51077, 0.51690,
        "the reference all-reduces the one-hot dispatch's buffers over "
        "data, f32[1,4,320,64] and f32[1,64,4,320], 1,474,560 bytes (its "
        "one group cannot split over data), and all-gathers 36,864; the "
        "gradient reductions agree (test below); the port's ranks "
        "all-gather each other's per-expert counts, 48 bytes a layer "
        "(0.51074 before they did)"),
    "granite-moe-3b-a800m train 2x2": (
        0.72904, 0.73321,
        "the reference all-reduces the dispatch's buffers over data as "
        "well as model (2,949,120), and all-gathers 24,576; the port's "
        "ranks all-reduce over model the whole buffer of the one group's "
        "capacity on each data rank (1,966,080, where the count derived "
        "983,040 for a buffer split over data: 0.50168 / 0.50454 then) "
        "and all-gather each other's per-expert counts, 16 bytes a layer "
        "(0.50135 / 0.50422 while the replicated leaves' gradients were "
        "all-reduced over model and the cross-entropy's vocab reductions "
        "were not derived)"),
    "granite-moe-3b-a800m train 2x2 ep": (
        0.92957, 0.97187,
        "the expert-parallel route's all-to-alls agree exactly (2,688,256 "
        "bytes a device: the body's three a MoE layer and its backward's "
        "two, and the re-lay of the experts' FFN blocks as blocks of the "
        "experts, forward and backward; test below); the reference's "
        "partitioner all-gathers the attention's and the embedding's "
        "weights (360,448), which the port keeps whole, and reduces "
        "tuples of gradients and activations (3,445,688) where the port "
        "derives the tensor-parallel activation all-reduces and every "
        "padded slot's gradient mean (3,348,760)"),
    "granite-moe-3b-a800m train 2x2 accum2": (
        0.95899, 0.95895,
        "the micro-major batch: the reference's partitioner lays the "
        "reshaped (2, 4, 64) token and label ids out over data by "
        "collective-permutes (2,048 bytes a device: each data rank swaps "
        "the half of its rows that belongs to the other rank's block of "
        "each micro-batch), where the port's ranks all-gather the ids "
        "(2,048 bytes a device, counted all-gather) and keep their rows; "
        "beside them the port all-gathers the per-expert counts once a "
        "strip (64), and the reference all-reduces 3,287,072 (its "
        "dispatch buffers over data in each strip, gradient tuples "
        "2,172,960) where the port moves 3,152,128, each strip's "
        "tensor-parallel all-reduces and the gradient mean once, the same "
        "bytes as in one batch"),
    "2x2 fsdp": (
        0.36775, 0.45062,
        "FSDP on (2,2) (open fault 2 on a second mesh): the port's ranks "
        "move exactly the count (tests/test_torch_processes.py), the "
        "weights' gathers (214,272) and reduce-scatter (115,328) beside "
        "the tensor-parallel all-reduces (1,051,648); the reference's "
        "partitioner all-gathers 896,896, all-reduces 2,333,784, moves "
        "524,288 by all-to-all and 1,024 by collective-permute, and "
        "reduce-scatters nothing: 1,381,248 / 3,755,992 bytes a device"),
    "zamba2-7b train 4x1 fsdp": (
        0.14946, 0.00283,
        "FSDP (open fault 2 on the hybrid family): the port's ranks move "
        "exactly the count (tests/test_torch_processes.py), the weights' "
        "gathers (659,328) and reduce-scatters (354,240) beside the "
        "gradient means of the Mamba2 leaves FSDP leaves whole (10,464); "
        "the reference's partitioner all-gathers 2,755,392 (activations "
        "such as f32[8,64,280] and f32[8,64,128]), all-reduces 3,703,098 "
        "and moves 393,216 by all-to-all: 1,024,032 / 6,851,706 bytes a "
        "device. It gathers each of the shared block's weights once a "
        "step, at 2 layers (one group) and at 4 (two) alike, where the "
        "port gathers it once in the forward and once for the backward"),
    "zamba2-7b train 1x4": (
        0.97290, 0.96043,
        "the port's ranks re-lay each Mamba2 block onto their heads "
        "themselves: the fused projection (z | x | B | C | dt) and the "
        "conv's weights all-gathered over model and their cotangents "
        "reduce-scattered (864,480 bytes a device each way), the norm's "
        "sum of squares all-reduced both ways, the replicated a_log, "
        "d_skip and dt_bias sliced to the rank's heads and their "
        "gradients all-reduced; the reference's partitioner moves "
        "collective-permutes of 1,228,800 and all-gathers of 516,528 "
        "instead, and all-reduces 98,112 more (0.56073 / 0.95547 while "
        "the count derived Megatron's all-reduces from the split "
        "projections and no re-lay, the term then known short)"),
    "xlstm-1.3b train 1x4": (
        0.80912, 0.46030,
        "the port's ranks all-gather the up projection's column blocks "
        "and reduce-scatter its cotangent, reduce-scatter the partial "
        "products with wq, wk and wv by heads and all-gather their "
        "cotangents (1,572,864 bytes a device of each kind), and "
        "all-reduce the gates, the norm's sum of squares and the gate "
        "biases' gradients (1,299,552 in all with the tensor-parallel "
        "all-reduces); the reference's partitioner all-reduces 2,823,252 "
        "(the q, k and v partial sums whole), collective-permutes "
        "1,441,792, all-gathers 1,204,368 and moves 24,576 by "
        "all-to-all"),
}
# the terms each cell's count is known short of (``count_short``)
_MOE = ["collective: moe one-hot dispatch resharded",
        "flops: even split of the moe dispatch"]
_MLA = ["flops: even split of mla's latent projections"]
SHORT = {
    "deepseek-v3-671b prefill 1x4": _MOE + _MLA,
    "deepseek-v3-671b decode 1x4": ["collective: mla decode gathers"] + _MOE
    + _MLA,
    "deepseek-v3-671b train 2x2": ["collective: fsdp"] + _MOE + _MLA,
    "deepseek-v3-671b train 1x4 tp": _MOE + _MLA,
    "deepseek-v3-671b train 2x2 tp": _MOE + _MLA,
    "granite-moe-3b-a800m train 4x1": _MOE,
    "granite-moe-3b-a800m train 1x4": _MOE,
    "granite-moe-3b-a800m train 2x2": _MOE,
    "granite-moe-3b-a800m train 2x2 accum2": _MOE,
    "zamba2-7b train 4x1 fsdp": ["collective: fsdp"],
    "4x1 fsdp": ["collective: fsdp"],
    "2x2 fsdp": ["collective: fsdp"],
}
# the port's FSDP collectives (a gather of each sharded parameter in the
# forward and in the backward that reads it, a reduce-scatter of its
# gradient: 640,896 + 345,024 bytes) against the reference's partitioner,
# which gathers parameters for 295,872 and reduces 150,606 but moves
# 6,336,384 bytes of activations (all-gathers, all-reduces, all-to-alls):
# 985,920 / 6,782,862 bytes (ROADMAP Queue C); the port's FSDP ranks move
# exactly the count (tests/test_torch_processes.py)
FSDP_RATIO = 0.14535

REFERENCE = r'''
import dataclasses, json
import jax, jax.numpy as jnp
from repro.configs import get_config, reduced
from repro.configs.base import ShapeConfig
from repro.core.hlo_analysis import analyze
from repro.launch.mesh import make_mesh
from repro.models import transformer as tf
from repro.models.layers import abstract_params
from repro.models.sharding import MeshCtx
from repro.optim import adamw
from repro.train import step as step_lib


def compile_cell(cfg, shape, mesh, grad_accum=1):
    ctx = MeshCtx(mesh=mesh, batch_axes=("data",))
    specs_in = tf.input_specs(cfg, shape)
    with mesh:
        if shape.kind == "train":
            b = step_lib.make_train_step(
                cfg, adamw.OptConfig(moment_dtype=cfg.opt_state_dtype), ctx,
                grad_accum=grad_accum)
            st = step_lib.named_for(b.state_specs, b.abstract_state, mesh)
            bt = step_lib.named_for(b.batch_specs, specs_in, mesh)
            low = jax.jit(b.step_fn, in_shardings=(st, bt),
                          out_shardings=(st, None)).lower(b.abstract_state,
                                                          specs_in)
        else:
            ap = abstract_params(tf.model_template(cfg),
                                 jnp.dtype(cfg.param_dtype))
            ps = step_lib.named_for(
                step_lib.train_state_specs(cfg, ctx)["params"], ap, mesh)
            if shape.kind == "prefill":
                fn = step_lib.make_prefill_step(cfg, ctx, shape.seq_len)
                bs = step_lib.named_for(step_lib.batch_pspecs(
                    cfg, "prefill", ctx), specs_in, mesh)
                low = jax.jit(fn, in_shardings=(ps, bs)).lower(ap, specs_in)
            else:
                fn = step_lib.make_decode_step(cfg, ctx)
                cache = specs_in["cache"]
                batch = {k: v for k, v in specs_in.items() if k != "cache"}
                cs = step_lib.named_for(step_lib.cache_pspecs(cfg, ctx),
                                        cache, mesh)
                bs = step_lib.named_for(step_lib.batch_pspecs(
                    cfg, "decode", ctx), batch, mesh)
                low = jax.jit(fn, in_shardings=(ps, cs, bs)).lower(
                    ap, cache, batch)
    comp = low.compile()
    st = analyze(comp.as_text(), n_devices=mesh.devices.size)
    return {"flops": st.flops, "collective_bytes": st.collective_bytes,
            "collective_by_kind": dict(st.collective_by_kind),
            "tuple_all_reduce": sum(v for k, v in st.top_collectives
                                    if k.startswith("all-reduce (")),
            "bytes": st.bytes_accessed,
            "argument_bytes": comp.memory_analysis().argument_size_in_bytes}


out = {}
for a in %(archs)r:
    cfg = reduced(get_config(a))
    for kind in %(kinds)r:
        out[f"{a} {kind}"] = compile_cell(cfg, ShapeConfig(kind, 64, 2, kind),
                                          make_mesh(1, 1))
cfg = reduced(get_config("tinyllama-1.1b"))
for key, (d, m, fsdp) in %(meshes)r.items():
    out[key] = compile_cell(dataclasses.replace(cfg, fsdp=fsdp),
                            ShapeConfig("train", 64, 8, "train"),
                            make_mesh(d, m))
from repro.models import moe as moe_mod
for key, (a, kind, d, m, *over) in %(cells)r.items():
    moe_mod.DENSE_PATH_MAX_TOKENS = %(gates)r.get(key, 16384)
    out[key] = compile_cell(reduced(get_config(a), **(over or [{}])[0]),
                            ShapeConfig(kind, 64, 8, kind), make_mesh(d, m),
                            %(accum)r.get(key, 1))
moe_mod.DENSE_PATH_MAX_TOKENS = 16384
# the backward of a shard_map's psum / pmean: the gradient program alone
from jax.sharding import PartitionSpec as P
from repro.core.compat import shard_map
mesh14 = make_mesh(1, 4)
for kind in ("psum", "pmean"):
    def loss(x, w, op=getattr(jax.lax, kind)):
        y = shard_map(lambda s: op(s, "model"), mesh=mesh14,
                      in_specs=(P("model"),), out_specs=P("model"),
                      check_vma=False)(x)
        return jnp.sum(y * w)
    comp = jax.jit(jax.grad(loss)).lower(jnp.ones((32, 6)),
                                         jnp.ones((32, 6))).compile()
    out[kind + " backward"] = dict(
        analyze(comp.as_text(), n_devices=4).collective_by_kind)
print("REF", json.dumps(out))
''' % {"archs": ARCHS, "kinds": KINDS, "meshes": MESHES, "cells": CELLS,
       "gates": GATES, "accum": ACCUM}


@pytest.fixture(scope="module")
def ref():
    out = run_devices(REFERENCE, n_devices=4)
    line = next(ln for ln in out.splitlines() if ln.startswith("REF "))
    return json.loads(line[4:])


def _cell(key):
    if key in MESHES:
        d, m, fsdp = MESHES[key]
        cfg = dataclasses.replace(reduced(get_config("tinyllama-1.1b")),
                                  fsdp=fsdp)
        return cfg, ShapeConfig("train", 64, 8, "train"), make_mesh(d, m)
    if key in CELLS:
        arch, kind, d, m, *over = CELLS[key]
        return reduced(get_config(arch), **(over or [{}])[0]), \
            ShapeConfig(kind, 64, 8, kind), make_mesh(d, m)
    arch, kind = key.split()
    return reduced(get_config(arch)), ShapeConfig(kind, 64, 2, kind), \
        make_mesh(1, 1)


@functools.lru_cache(maxsize=None)
def _count(key, target="cpu"):
    """The port's count of the reference's cell ``key``: the dry run's own
    ``count_step``, with the host's routes (and the cell's gate and
    micro-batches); each cell counted once a process (the tests read
    it)."""
    cfg, shape, mesh = _cell(key)
    saved = moe.DENSE_PATH_MAX_TOKENS
    moe.DENSE_PATH_MAX_TOKENS = GATES.get(key, saved)
    try:
        return dryrun.count_step(cfg, shape, mesh, target=target,
                                 grad_accum=ACCUM.get(key, 1))
    finally:
        moe.DENSE_PATH_MAX_TOKENS = saved


ONE = [f"{a} {k}" for a in ARCHS for k in KINDS]


# ---------------------------------------------------------------------------
# the count against the reference's hlo_analysis
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", ONE + list(MESHES) + list(CELLS))
def test_flops_per_device_match_the_reference(ref, key):
    got, want = _count(key).flops, ref[key]["flops"]
    if key in FLOPS_PINNED:
        assert abs(got / want - FLOPS_PINNED[key]) < 5e-5, (key, got, want)
    else:
        assert abs(got / want - 1) <= FLOPS_TOL, (key, got, want)


@pytest.mark.parametrize("key", list(MESHES) + list(CELLS))
def test_collective_bytes_match_the_reference(ref, key):
    st = _count(key)
    want = ref[key]["collective_bytes"]
    assert sorted(st.count_short) == sorted(SHORT.get(key, [])), key
    if want == 0:           # tinyllama-1.1b's decode, data-parallel
        assert st.collective_bytes == 0 and st.collective_count == 0, key
        return
    ratio = st.collective_bytes / want
    if key in COLL_TOL:
        assert abs(ratio - 1) <= COLL_TOL[key], (key, st.collective_bytes,
                                                 want)
    elif key in COLL_PINNED:
        total, all_reduce, _cause = COLL_PINNED[key]
        assert abs(ratio - total) < 5e-5, (key, st.collective_bytes, want,
                                           ratio)
        got_ar = st.collective_by_kind["all-reduce"]
        want_ar = ref[key]["collective_by_kind"]["all-reduce"]
        assert abs(got_ar / want_ar - all_reduce) < 5e-5, (key, got_ar,
                                                           want_ar)
    else:
        assert abs(ratio - FSDP_RATIO) < 5e-5, (key, st.collective_bytes,
                                                want, ratio)
        assert set(st.collective_by_kind) == {"all-gather",
                                              "reduce-scatter"}
        assert set(ref[key]["collective_by_kind"]) == {
            "all-gather", "all-reduce", "all-to-all"}


@pytest.mark.parametrize("key", CROSS_CELLS)
def test_the_cross_cells_match_the_reference_kind_by_kind(ref, key):
    """The vision model's cross layers on (1,4) and the encoder-decoder
    model on (2,2) without FSDP (the heads and FFN columns of the self,
    cross and encoder layers and the vocab over model): all-reduces alone
    on both sides, within 1e-4 of the reference's (4,137,984 and 1,710,080
    bytes a device), the count short of nothing."""
    st = _count(key)
    want = ref[key]["collective_by_kind"]
    assert set(st.collective_by_kind) == set(want) == {"all-reduce"}, (
        st.collective_by_kind, want)
    got = st.collective_by_kind["all-reduce"]
    assert abs(got / want["all-reduce"] - 1) <= 1e-4, (got, want)
    assert got == {"llama-3.2-vision-11b train 1x4": 4_137_984,
                   "seamless-m4t-medium train 2x2": 1_710_080}[key]
    assert not st.count_short, st.count_short


@pytest.mark.parametrize("key", list(GATES))
def test_the_ep_routes_all_to_alls_match_the_reference(ref, key):
    """At a gate lowered to the cell's tokens in both packages, the
    expert-parallel route's all-to-all bytes a device equal the
    reference's exactly, and are the sum of: the body's exchanges a MoE
    layer (the tokens and their int32 expert ids to their lanes, the
    outputs back; the backward's inverse of the two float ones) and the
    re-lay of granite-moe-3b-a800m's three padded tables from their FFN
    blocks over model to blocks of the experts, forward and backward,
    which the port derives from the body's in_spec against the tables'
    specs and the reference's partitioner inserts."""
    st = _count(key)
    want = ref[key]["collective_by_kind"]["all-to-all"]
    assert st.collective_by_kind["all-to-all"] == want, (
        st.collective_by_kind, ref[key]["collective_by_kind"])
    cfg, shape, mesh = _cell(key)
    m, n = mesh.shape["model"], math.prod(mesh.sizes)
    moved = (m - 1) / m
    chunk = shape.global_batch * shape.seq_len // n
    cap_send = max(int(chunk * cfg.moe.top_k * cfg.moe.capacity_factor / m),
                   cfg.moe.top_k)
    body = (4 * m * cap_send * cfg.d_model * 4 + m * cap_send * 4) * moved
    table = cfg.moe.n_experts_padded * cfg.d_model * cfg.moe.expert_d_ff \
        * 4 / m
    relay = 2 * 3 * table * moved
    assert want == cfg.n_layers * (body + relay), (want, body, relay)


def test_padded_experts_reduce_the_live_slice_as_the_reference(ref):
    """granite-moe-3b-a800m on (4, 1): the one-hot dispatch reads 4 of the
    48 padded expert slots, so its gradient all-reduces cover those (the
    others' gradients are identically zero); every all-reduce the port
    counts there is a gradient reduction (beside them it counts the
    ranks' all-gather of their per-expert counts), and they agree with the
    reference's gradient tuples within 1 %."""
    key = "granite-moe-3b-a800m train 4x1"
    st = _count(key)
    want = ref[key]["tuple_all_reduce"]
    got = st.collective_by_kind["all-reduce"]
    assert abs(got / want - 1) <= 0.01, (got, want)
    assert set(st.collective_by_kind) == {"all-reduce", "all-gather"}
    cfg = _cell(key)[0]
    live = cfg.moe.n_experts / cfg.moe.n_experts_padded
    tables = [k for k, _ in st.top_collectives if k.startswith(
        f"all-reduce float32[{cfg.n_layers}, {cfg.moe.n_experts_padded},")]
    assert len(tables) == 3 and all(f" read {live:.4g} " in k
                                    for k in tables), tables


def test_the_ep_route_reads_every_expert_and_reduces_it_whole(monkeypatch):
    """The expert-parallel route (which every production MoE cell takes)
    reads every padded slot, so its tables' gradient reductions stay
    whole; the one-hot dispatch on the same mesh reduces the live slice."""
    cfg = reduced(get_config("granite-moe-3b-a800m"))
    shape, mesh = ShapeConfig("train", 64, 8, "train"), make_mesh(2, 2)
    prefix = f"all-reduce float32[{cfg.n_layers}, {cfg.moe.n_experts_padded},"

    def tables(st):
        return sorted(k for k, _ in st.top_collectives
                      if k.startswith(prefix))
    dense = tables(dryrun.count_step(cfg, shape, mesh, target="cpu"))
    monkeypatch.setattr(moe, "DENSE_PATH_MAX_TOKENS", 64)
    ep = dryrun.count_step(cfg, shape, mesh, target="cpu")
    assert "collective: moe one-hot dispatch resharded" not in ep.count_short
    assert ep.collective_by_kind["all-to-all"] > 0
    assert len(tables(ep)) == 3 and not any(" read " in k
                                            for k in tables(ep))
    assert len(dense) == 3 and all(" read " in k for k in dense)


@pytest.mark.parametrize("op", ("index", "embedding", "index_select"))
def test_a_lookup_into_a_model_sharded_table_all_reduces_once(op):
    """A lookup into a table whose rows are sharded over ``model`` sums
    the shards' rows: one all-reduce of its result in the forward; its
    backward (a scatter of the replicated cotangent into the local shard)
    moves nothing. Rows replicated: nothing moves at all."""
    table = torch.empty((64, 16), device="meta", requires_grad=True)
    ids = torch.empty((8, 5), dtype=torch.long, device="meta")
    look = {"index": lambda t, i: t[i],
            "embedding": lambda t, i: torch.nn.functional.embedding(i, t),
            "index_select": lambda t, i: torch.index_select(
                t, 0, i.reshape(-1))}[op]
    mesh = make_mesh(1, 4)
    for backward in (False, True):
        def step(t, i):
            y = look(t, i)
            if backward:
                y.sum().backward()
        st = analyze(step, table, ids, n_devices=4, mesh=mesh,
                     specs=(PS("model", None), None), params=table)
        r = 8 * 5 * 16 * 4                  # the result, replicated
        assert dict(st.collective_by_kind) == {"all-reduce": 2 * r * 3 / 4}
        assert st.collective_count == 1 and st.lookups == 1
    st = analyze(step, table, ids, n_devices=4, mesh=mesh,
                 specs=(PS(None, "model"), None), params=table)
    assert st.collective_count == 0 and st.lookups == 0


@pytest.mark.parametrize("sharded", (True, False))
def test_the_cross_entropys_vocab_reductions_all_reduce(sharded):
    """Logits whose vocab is sharded over ``model`` (an unembedding
    sharded on its output dimension): the cross-entropy's logsumexp
    all-reduces its result twice (the running max and the sum of
    exponentials) and the gold logit's gather once, in the forward; their
    backward moves nothing (nor does the unembedding's gradient, which
    contracts tokens; the input takes none here). With the vocab
    replicated nothing moves."""
    b, s, d, v = 8, 5, 16, 64
    x = torch.empty((b, s, d), device="meta")
    w = torch.empty((d, v), device="meta", requires_grad=True)
    labels = torch.empty((b, s), dtype=torch.long, device="meta")

    def step(x, w, labels):
        tf._ce(x @ w, labels).backward()
    st = analyze(step, x, w, labels, n_devices=4, mesh=make_mesh(1, 4),
                 specs=(None, PS(None, "model" if sharded else None), None),
                 params=w)
    if not sharded:
        assert st.collective_count == 0
        return
    moved = 2 * (b * s * 4) * 3 / 4                 # one f32 (b, s) result
    assert dict(st.collective_by_kind) == {"all-reduce": 3 * moved}
    assert sorted(k for k, _ in st.top_collectives) == [
        f"all-reduce float32[{b}, {s}, 1] g=4"] + [
        f"all-reduce float32[{b}, {s}] g=4"] * 2


@pytest.mark.parametrize("mesh", ((1, 4), (4, 1), (2, 2)))
def test_a_norm_weights_gradient_is_all_reduced_over_the_batch_axes(mesh):
    """A norm weight scales replicated activations: every device computes
    its gradient whole from them, so it is all-reduced over the batch axes
    that split the tokens and never over ``model``."""
    d = 16
    x = torch.empty((8, 5, d), device="meta", requires_grad=True)
    g = torch.empty((d,), device="meta", requires_grad=True)

    def step(x, g):
        (x * g).square().sum().backward()
    data, model = mesh
    st = analyze(step, x, g, n_devices=data * model,
                 mesh=make_mesh(data, model), specs=(PS("data"), None),
                 params=g)
    if data == 1:
        assert st.collective_count == 0
        return
    assert dict(st.collective_by_kind) == {
        "all-reduce": 2 * d * 4 * (data - 1) / data}
    assert [k for k, _ in st.top_collectives] == [
        f"all-reduce float32[{d}] g={data}"]


@pytest.mark.parametrize("mesh", ((1, 4), (2, 2)))
def test_a_replicated_bias_on_a_split_activation_is_all_reduced_over_model(
        mesh):
    """A leaf replicated over ``model`` that the forward adds to an
    activation split over it (a bias on a column-sharded product's
    result, as Mamba2's ``dt_bias`` on the per-head ``dt``): each device
    holds only its slice of the bias's gradient, so it is all-reduced
    over ``model`` as well as the batch axes; the norm weight beside it,
    applied to the replicated input, over the batch axes only."""
    d, h = 16, 32
    x = torch.empty((8, 5, d), device="meta")
    p = {"g": torch.empty((d,), device="meta", requires_grad=True),
         "w1": torch.empty((d, h), device="meta", requires_grad=True),
         "b": torch.empty((h,), device="meta", requires_grad=True),
         "w2": torch.empty((h, d), device="meta", requires_grad=True)}

    def step(x, p):
        y = torch.tanh((x * p["g"]) @ p["w1"] + p["b"]) @ p["w2"]
        y.sum().backward()
    data, model = mesh
    st = analyze(step, x, p, n_devices=data * model,
                 mesh=make_mesh(data, model),
                 specs=(PS("data"), {"g": None, "w1": PS(None, "model"),
                                     "b": None, "w2": PS("model", None)}),
                 params=p)
    labels = [k for k, _ in st.top_collectives]
    assert [k for k in labels if k.startswith("all-reduce float32[32] ")] \
        == [f"all-reduce float32[{h}] g={data * model}"]
    assert [k for k in labels if k.startswith("all-reduce float32[16] ")] \
        == ([f"all-reduce float32[{d}] g={data}"] if data > 1 else [])


@pytest.mark.parametrize("kind", ("psum", "pmean"))
def test_a_reductions_backward_moves_what_the_references_does(ref, kind):
    """The backward of a ``shard_map``'s psum / pmean on (1,4) is an
    all-reduce of the cotangent: the port's count of it (forward and
    backward less forward) equals the reference's gradient program's."""
    mesh = make_mesh(1, 4)

    def run(backward):
        x = torch.ones((32, 6), requires_grad=True)
        w = torch.ones((32, 6))

        def step(x):
            op = getattr(compat, kind)
            y = compat.shard_map(lambda s: op(s, "model"), mesh=mesh,
                                 in_specs=(PS("model"),),
                                 out_specs=PS("model"))(x)
            if backward:
                (y * w).sum().backward()
        return analyze(step, x, n_devices=4, mesh=mesh, target="cpu")
    both, fwd = run(True), run(False)
    got = both.collective_by_kind["all-reduce"] \
        - fwd.collective_by_kind["all-reduce"]
    assert got == ref[kind + " backward"]["all-reduce"] == 288.0


def test_a_product_over_tokens_derives_no_collective():
    """Tensor parallelism over heads: the heads' tag survives the merge
    of (batch, heads) for the score products and the split back, so the
    backward's weight-gradient products, which contract tokens, derive
    nothing. What moves: the output projection's all-reduce forward and
    the input's gradient all-reduce backward."""
    b, s, d, h, hd = 2, 16, 32, 4, 8
    x = torch.empty((b, s, d), device="meta", requires_grad=True)
    wq = torch.empty((d, h * hd), device="meta", requires_grad=True)
    wo = torch.empty((h * hd, d), device="meta", requires_grad=True)

    def step(x, wq, wo):
        q = (x @ wq).view(b, s, h, hd).permute(0, 2, 1, 3)
        q = q.reshape(b * h, s, hd)                 # (batch, heads) merged
        p = torch.softmax(q @ q.transpose(1, 2), dim=-1)
        o = (p @ q).view(b, h, s, hd).transpose(1, 2).reshape(b, s, h * hd)
        (o @ wo).sum().backward()
    st = analyze(step, x, wq, wo, n_devices=4, mesh=make_mesh(1, 4),
                 specs=(None, PS(None, "model"), PS("model", None)),
                 params=(wq, wo))
    moved = 2 * (b * s * d * 4) * 3 / 4            # one (b, s, d) result
    assert st.collective_count == 2, st.top_collectives
    assert dict(st.collective_by_kind) == {"all-reduce": 2 * moved}
    assert {k for k, _ in st.top_collectives} == {
        f"all-reduce float32[{b * s}, {d}] g=4"}
    # the tags themselves: (batch, heads) -> merged -> split back
    tag = frozenset({("model", 1)})
    merged = step_analysis._reshape_tags(
        (frozenset(), tag, frozenset(), frozenset()), (b, h, s, hd),
        (b * h, s, hd))
    assert merged == (frozenset({("model", b)}), frozenset(), frozenset())
    assert step_analysis._reshape_tags(merged, (b * h, s, hd),
                                       (b, h, s, 1, hd))[:2] == (
        frozenset(), tag)


@pytest.mark.parametrize("stacked", (False, True))
def test_a_parameter_read_through_a_slice_moves_that_extent(stacked):
    """A table of 12 padded slots read only through ``[:3]`` (per layer,
    when stacked): its gradient all-reduce (replicated over data) and,
    under FSDP, its gathers and reduce-scatter cover 3/12 of it; read
    whole as well, it moves whole."""
    shape = (2, 12, 8, 8) if stacked else (12, 8, 8)
    w = torch.empty(shape, device="meta", requires_grad=True)
    x = torch.empty((16, 3, 8), device="meta", requires_grad=True)
    full = w.numel() * 4

    def step(w, x, whole=False):
        ws = w.unbind(0) if stacked else [w]
        y = x
        for wl in ws:
            y = torch.bmm(y.transpose(0, 1), wl[:3]).transpose(0, 1)
        if whole:
            y = y + w.sum()
        y.sum().backward()
    lead = (None,) if stacked else ()
    # (spec, shards, collectives by kind: how many)
    for spec, shards, calls in (
            (PS(*lead, None, None, None), 1, {"all-reduce": 1}),
            (PS(*lead, None, "data", None), 4,
             {"all-gather": 2, "reduce-scatter": 1})):
        for whole, part in ((False, 3 / 12), (True, 1.0)):
            st = analyze(lambda w, x: step(w, x, whole), w, x, n_devices=4,
                         mesh=make_mesh(4, 1), specs=(spec, PS("data")),
                         params=w)
            shard = full * part / shards
            want = {"all-reduce": 2 * shard * 3 / 4,
                    "all-gather": 2 * shard * 4 * 3 / 4,
                    "reduce-scatter": shard * 3}
            assert dict(st.collective_by_kind) == {
                k: want[k] for k in calls}, (spec, whole)
            assert st.collective_count == sum(calls.values())


def test_an_fsdp_parameter_is_gathered_again_for_the_backward():
    """A parameter sharded over a batch axis is gathered in the forward
    and again in the backward that reads it (dX = dY W^T), whether or not
    the backward recomputes the forward; its gradient is reduce-scattered
    once."""
    w = torch.empty((64, 32), device="meta", requires_grad=True)
    x = torch.empty((16, 64), device="meta", requires_grad=True)

    def step(w, x):
        (x @ w).sum().backward()
    st = analyze(step, w, x, n_devices=4, mesh=make_mesh(4, 1),
                 specs=(PS("data", None), PS("data", None)), params=w)
    full = 64 * 32 * 4
    assert st.collective_count == 3
    assert dict(st.collective_by_kind) == {
        "all-gather": 2 * full * 3 / 4, "reduce-scatter": full / 4 * 3}
    # the forward alone gathers once and reduces nothing
    st = analyze(lambda w, x: x @ w, w, x, n_devices=4, mesh=make_mesh(4, 1),
                 specs=(PS("data", None), PS("data", None)), params=w)
    assert dict(st.collective_by_kind) == {"all-gather": full * 3 / 4}


def test_a_backward_that_reads_a_cast_of_an_fsdp_parameter_gathers_it():
    """A parameter used in the compute dtype (its cast, as every model's
    products use a float32 weight in bfloat16) is read by the backward
    through the cast that the product saved: it is gathered again there,
    as when the product saves the parameter itself; a cast whose
    backward does not read it (a lookup's table) is gathered once."""
    w = torch.empty((64, 32), device="meta", requires_grad=True)
    x = torch.empty((16, 64), device="meta", dtype=torch.bfloat16,
                    requires_grad=True)
    full = 64 * 32 * 4
    for use, gathers in ((lambda w, x: x @ w.to(torch.bfloat16), 2),
                         (lambda w, x: w.to(torch.bfloat16)[
                             torch.zeros((3,), dtype=torch.long,
                                         device="meta")], 1)):
        def step(w, x, use=use):
            use(w, x).float().sum().backward()
        st = analyze(step, w, x, n_devices=4, mesh=make_mesh(4, 1),
                     specs=(PS("data", None), PS("data", None)), params=w)
        assert dict(st.collective_by_kind) == {
            "all-gather": gathers * full * 3 / 4,
            "reduce-scatter": full / 4 * 3}, gathers


# the port's eager bytes over the reference's fused count, by kind: the
# train steps' elementwise chains run unfused here; the reference's decode
# returns a copy of its whole (undonated) cache (measured on these cells:
# train 1.015-1.831, prefill 0.888-1.145, decode 0.181-0.494)
BYTES_RATIO = {"train": (1.0, 2.0), "prefill": (0.85, 1.2),
               "decode": (0.15, 0.55)}


@pytest.mark.parametrize("key", ONE)
def test_bytes_differ_from_the_references_as_stated(ref, key):
    lo, hi = BYTES_RATIO[key.split()[1]]
    ratio = _count(key).bytes_accessed / ref[key]["bytes"]
    assert lo <= ratio <= hi, (key, ratio)


@pytest.mark.parametrize("key", ONE + list(MESHES) + list(CELLS))
def test_argument_bytes_match_the_reference(ref, key):
    """Equal, except where the reference's ``jax.jit`` drops arguments the
    step never reads (``keep_unused=False``): deepseek-v3-671b's
    multi-token-prediction module in prefill and decode (its shard bytes
    on a mesh). The port counts every input it is given."""
    got, want = _count(key).argument_bytes, ref[key]["argument_bytes"]
    cfg, shape, mesh = _cell(key)
    if cfg.mtp_depth and shape.kind != "train":
        mtp = abstract_params(tf.model_template(cfg)["mtp"],
                              torch_dtype(cfg.param_dtype))
        specs = step_lib.train_state_specs(
            cfg, MeshCtx(mesh=mesh, batch_axes=("data",)))["params"]["mtp"]
        unread = analyze(lambda p: None, mtp, n_devices=math.prod(mesh.sizes),
                         mesh=mesh, specs=(specs,)).argument_bytes
        assert got - want == unread, (key, got, want, unread)
    else:
        assert got == want, (key, got, want)


# ---------------------------------------------------------------------------
# twins of the reference's tests/test_distribution.py analyzer tests
# ---------------------------------------------------------------------------


def test_analyzer_counts_every_trip_of_a_loop():
    """Twin of ``test_hlo_analyzer_counts_while_trip``: 8 products of
    64^3 in a loop count 8 * 2 * 64^3 (the port sees every trip)."""
    def scanned(x, w):
        for i in range(w.shape[0]):
            x = x @ w[i]
        return x
    st = analyze(scanned, torch.empty((64, 64), device="meta"),
                 torch.empty((8, 64, 64), device="meta"))
    assert st.flops == 8 * 2 * 64 ** 3
    assert dict(st.dot_flops_by_shape) == {"float32[64, 64]": st.flops}


def test_analyzer_counts_the_collective_of_a_sharded_product():
    """Twin of ``test_hlo_analyzer_collectives``: on a (1, 4) mesh, a
    product over a dimension sharded on ``model`` ends in an all-reduce of
    its result (the ring model's 2 R (g-1)/g, R the result a device)."""
    a = torch.empty((64, 64), device="meta")
    st = analyze(lambda a: a @ a.t(), a, n_devices=4, mesh=make_mesh(1, 4),
                 specs=(PS(None, "model"),), params=a)
    r = 64 * 64 * 4                       # one device's (replicated) result
    assert st.collective_bytes == 2 * r * 3 / 4 > 0
    assert dict(st.collective_by_kind) == {"all-reduce": st.collective_bytes}
    assert st.collective_count == 1
    # rows sharded instead: the product is local, nothing moves
    st = analyze(lambda a: a @ a.t(), a, n_devices=4, mesh=make_mesh(1, 4),
                 specs=(PS("model", None),), params=a)
    assert st.collective_bytes == 0 and st.flops == 2 * 64 ** 3 / 4


def test_roofline_terms_math():
    """Twin of the reference's ``test_roofline_terms_math``, on the H100's
    rates."""
    cfg = get_config("tinyllama-1.1b")
    mf = roofline.model_flops(cfg, SHAPES["train_4k"])
    assert mf == 6.0 * cfg.active_param_count() * 256 * 4096
    rl = roofline.build(cfg, SHAPES["train_4k"], "test", 256,
                        step_analysis.StepStats())
    assert rl.compute_s == 0 and rl.bottleneck in ("compute", "memory",
                                                   "collective")
    st = step_analysis.StepStats(flops=989e12, bytes_accessed=3.35e12,
                                 collective_bytes=450e9)
    rl = roofline.build(cfg, SHAPES["train_4k"], "test", 256, st)
    assert (rl.compute_s, rl.memory_s, rl.collective_s) == (1.0, 1.0, 1.0)
    assert rl.achievable_step_s == 1.0 and rl.useful_ratio == mf / (
        989e12 * 256) and rl.mfu_bound == mf / (256 * 989e12)
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    assert roofline.build(f32, SHAPES["train_4k"], "t", 1,
                          st).compute_s == 989e12 / 67e12


# ---------------------------------------------------------------------------
# the kernels' work counts
# ---------------------------------------------------------------------------


def _tiny_train(**upd):
    cfg = dataclasses.replace(reduced(get_config("tinyllama-1.1b")), **upd)
    opt = adamw.OptConfig(moment_dtype=cfg.opt_state_dtype)
    return cfg, step_lib.make_train_step(cfg, opt), opt


def test_a_kernel_counts_once_on_the_cpu(monkeypatch):
    """On CPU tensors with the route on, each wrapper's plain version runs
    and none of its aten operations is counted: the step's count equals
    the ``meta`` count for the card's route (``target="cuda"``), and each
    kernel's calls equal its plain version's runs."""
    cfg, bundle, opt = _tiny_train(attn_flash="on")
    params = init_params(tf.model_template(cfg),
                         torch.Generator().manual_seed(0), device="cpu")
    state = {"params": params, "opt": adamw.init(opt, params)}
    rng = np.random.RandomState(0)
    batch = {k: torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 64))
                                 .astype(np.int32)) for k in ("tokens",
                                                              "labels")}
    runs = {k: 0 for k in att.LAUNCHES}
    for name in runs:
        plain = getattr(att, f"{name}_plain")

        def counted(*a, _name=name, _plain=plain, **kw):
            runs[_name] += 1
            return _plain(*a, **kw)
        monkeypatch.setattr(att, f"{name}_plain", counted)
    on_cpu = analyze(bundle.step_fn, state, batch, params=state["params"])
    _, meta_bundle, _ = _tiny_train()
    on_meta = analyze(meta_bundle.step_fn, meta_bundle.abstract_state,
                      tf.input_specs(cfg, ShapeConfig("t", 64, 2, "train")),
                      params=meta_bundle.abstract_state["params"],
                      target="cuda")
    assert runs == {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
    assert {k: v["calls"] for k, v in on_cpu.kernels.items()} == runs
    assert on_cpu.kernels == on_meta.kernels
    assert (on_cpu.flops, on_cpu.bytes_accessed) == (on_meta.flops,
                                                     on_meta.bytes_accessed)


def test_the_routes_differ_by_the_kernels_work_less_the_blockwise_products():
    """target="cuda" takes the kernels where target="cpu" takes the
    blockwise branches: at S 64 the quadratic one, q.k and p.v forward and
    their four gradient products, 12 * B * H * S^2 * D a layer."""
    cfg, bundle, _ = _tiny_train()
    args = (bundle.abstract_state,
            tf.input_specs(cfg, ShapeConfig("t", 64, 2, "train")))
    kw = dict(params=bundle.abstract_state["params"])
    card = analyze(bundle.step_fn, *args, target="cuda", **kw)
    host = analyze(bundle.step_fn, *args, target="cpu", **kw)
    work = sum(k["flops"] for k in card.kernels.values())
    h, d = cfg.n_heads_padded, cfg.resolved_head_dim
    blockwise = 12 * 2 * h * 64 ** 2 * d * cfg.n_layers
    assert host.kernels == {}
    assert card.flops - host.flops == work - blockwise
    elt = torch_dtype(cfg.compute_dtype).itemsize
    assert work == sum(att.work(op, 2 * h, 64, 64, d, elt)[0] * n
                       for op, n in (("flash_fwd", 2), ("flash_bwd_dq", 2),
                                     ("flash_bwd_dkv", 2)))


def test_attention_work_is_the_bound_formula():
    """At the train shape (4, 32, 2048, 64) bf16 causal the three kernels
    do the causal triangle's 6.9e10 / 1.0e11 / 1.4e11 FLOP (PERF.md)."""
    g, s, d = 4 * 32, 2048, 64
    pairs = s * (s + 1) / 2
    for op, n in (("flash_fwd", 2), ("flash_bwd_dq", 3),
                  ("flash_bwd_dkv", 4)):
        flops, nbytes = att.work(op, g, s, s, d, 2)
        assert flops == n * 2 * d * g * pairs
    assert [f"{att.work(op, g, s, s, d, 2)[0]:.1e}" for op in
            ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")] == [
                "6.9e+10", "1.0e+11", "1.4e+11"]
    assert att.work("flash_fwd", 2, 128, 1600, 128, 2, causal=False)[0] \
        == 2 * 2 * 128 * 2 * 128 * 1600


def test_the_wrappers_on_meta_return_shapes_and_record_their_work():
    meta = dict(device="meta")
    bf = torch.bfloat16
    calls = [
        ("matmul", lambda: mm.matmul(torch.empty((8, 256), dtype=bf, **meta),
                                     torch.empty((256, 512), dtype=bf, **meta),
                                     out_dtype=torch.float32),
         (8, 512), torch.float32, mm.work(8, 256, 512, 2, 4)),
        ("matmul_int8", lambda: mm.matmul_int8(
            torch.empty((32, 128), dtype=torch.int8, **meta),
            torch.empty((128, 256), dtype=torch.int8, **meta)),
         (32, 256), torch.int32, mm.work(32, 128, 256, 1, 4)),
        ("axpy", lambda: ax.axpy(2.0, torch.empty(1024, **meta),
                                 torch.empty(1024, **meta)),
         (1024,), torch.float32, ax.work(1024, 4)),
        ("conv2d_direct", lambda: cv.conv2d_direct(
            torch.empty((3, 118, 118), **meta),
            torch.empty((64, 3, 7, 7), **meta)),
         (64, 112, 112), torch.float32, cv.work(3, 118, 118, 64, 7, 7, 4, 4)),
        ("ssm_scan", lambda: ss.ssm_scan(
            torch.empty((8, 256, 64), **meta), torch.empty((8, 256, 64),
                                                           **meta),
            torch.empty((8, 256, 32), **meta), torch.empty((8, 256), **meta),
            torch.empty((8, 256), **meta), chunk=128),
         (8, 256, 32), torch.float32, ss.work(8, 256, 64, 32, 128, 4)),
    ]
    for name, call, shape, dtype, (flops, nbytes) in calls:
        out = call()
        assert (out.device.type, tuple(out.shape), out.dtype) == (
            "meta", shape, dtype), name
        st = analyze(call)
        assert st.kernels == {name: {"calls": 1, "flops": flops,
                                     "bytes": nbytes}}, name
        assert (st.flops, st.bytes_accessed) == (flops, nbytes), name
    q = torch.empty((1, 2, 128, 64), dtype=bf, **meta)
    out = att.flash_attention(q, q, q)
    assert (tuple(out.shape), out.dtype) == ((1, 2, 128, 64), bf)


def test_a_launch_outside_a_work_count_raises_under_analyze():
    def rogue():
        build.launch(lambda *a: 0, torch.device("cpu"))
    with pytest.raises(RuntimeError, match="without a work count"):
        analyze(rogue)


def test_the_attention_route_on_meta_follows_the_target():
    seen = []

    def probe():
        seen.append(attn_mod.flash_route_enabled("auto", "meta"))
    assert attn_mod.flash_route_enabled("auto", "meta") is False
    analyze(probe, target="cuda")
    analyze(probe, target="cpu")
    assert seen == [True, False]
    assert attn_mod.flash_route_enabled("auto", "cpu") is False


# ---------------------------------------------------------------------------
# compat's collectives: their backward counts
# ---------------------------------------------------------------------------


def _plain(kind, x, d, lead, n):
    """The stacked operation as compat wrote it before it was counted."""
    if kind == "psum":
        return x.sum(dim=(d,), keepdim=True).expand(x.shape)
    if kind == "pmean":
        return x.mean(dim=(d,), keepdim=True).expand(x.shape)
    if kind == "pmax":
        return x.amax(dim=(d,), keepdim=True).expand(x.shape)
    if kind == "all_gather":
        return x.movedim(d, lead - 1).unsqueeze(d).expand(
            x.shape[:lead] + (n,) + x.shape[lead:])
    if kind == "all_to_all":
        return x.transpose(d, lead)
    return torch.roll(x, shifts=1, dims=d)


@pytest.mark.parametrize("kind", ("psum", "pmean", "pmax", "all_gather",
                                  "all_to_all", "ppermute"))
def test_each_collective_counts_its_backward(kind):
    """The backward is the real mesh's collective for it, counted under
    the forward's kind (as many bytes as the forward: the reductions' an
    all-reduce of the cotangent, pmax's with its tie mask, twice as many),
    and its gradient is the one autograd took through the plain stacked
    operation, bit for bit."""
    mesh = make_mesh(2, 4)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(32, 6)).float()     # (4, 6) a device
    w = torch.from_numpy(rng.randn(*((2, 4, 4, 4, 6) if kind == "all_gather"
                                     else (2, 4, 4, 6)))).float()
    call = {"psum": lambda s: compat.psum(s, "model"),
            "pmean": lambda s: compat.pmean(s, "model"),
            "pmax": lambda s: compat.pmax(s, "model"),
            "all_gather": lambda s: compat.all_gather(s, "model"),
            "all_to_all": lambda s: compat.all_to_all(s, "model", 0, 0),
            "ppermute": lambda s: compat.ppermute(
                s, "model", [(i, (i + 1) % 4) for i in range(4)])}[kind]
    grads = []
    for plain in (False, True):
        xs = x.clone().requires_grad_(True)

        def body(s):
            y = _plain(kind, s, 1, 2, 4) if plain else call(s)
            return (y * w).sum(dim=tuple(range(2, y.dim())), keepdim=True)
        compat.reset_counts()
        out = compat.shard_map(body, mesh=mesh, in_specs=(PS(("data",
                                                                "model")),),
                               out_specs=PS(("data", "model")))(xs)
        out.sum().backward()
        grads.append(xs.grad)
        if not plain:
            fwd = dict(compat.CALLS), dict(compat.BYTES)
            bwd = dict(compat.CALLS_BWD), dict(compat.BYTES_BWD)
    assert torch.equal(grads[0], grads[1])
    assert fwd[0][kind] == 1 and bwd[0] == {kind: 1}
    want = fwd[1][kind] * (2 if kind == "pmax" else 1)
    assert bwd[1].get(kind, 0) == want and fwd[1][kind] > 0


# ---------------------------------------------------------------------------
# launch/dryrun.py, launch/report.py, experiments/torch_hillclimb.py
# ---------------------------------------------------------------------------


KEYS = {"arch", "shape", "mesh", "tag", "n_devices", "kind", "trace_s",
        "memory_analysis", "per_device_state_bytes",
        "per_device_peak_bytes_est", "fits_h100_80g",
        "count_short", "roofline",
        "params_total", "params_active"}
ROOFLINE_KEYS = {"arch", "shape", "mesh", "n_devices", "compute_s",
                 "memory_s", "collective_s", "hlo_flops_per_dev",
                 "hlo_bytes_per_dev", "coll_bytes_per_dev",
                 "model_flops_total", "useful_ratio", "bottleneck",
                 "achievable_step_s", "mfu_bound", "detail"}


def test_run_cell_counts_a_production_cell_on_meta(tmp_path):
    r = dryrun.run_cell("tinyllama-1.1b", "decode_32k", False, str(tmp_path))
    assert set(r) == KEYS and set(r["roofline"]) == ROOFLINE_KEYS
    assert set(r["memory_analysis"]) == {"argument_size_in_bytes",
                                         "temp_size_in_bytes"}
    assert (r["n_devices"], r["mesh"], r["kind"]) == (256, "pod16x16",
                                                      "decode")
    assert r["count_short"] == []
    rl = r["roofline"]
    # one lookup into the vocab-sharded table, one all-reduce of its result
    assert rl["detail"]["lookups"] == 1
    assert rl["bottleneck"] == "memory" and rl["compute_s"] > 0
    assert rl["detail"]["kernels"] == {}        # decode takes no kernel
    saved = json.loads((tmp_path /
                        "tinyllama-1.1b_decode_32k_pod16x16.json").read_text())
    assert saved["roofline"]["hlo_flops_per_dev"] == rl["hlo_flops_per_dev"]


def test_cell_config_takes_the_prefill_profile_then_the_overrides():
    """As the reference's run_cell: FSDP off for prefill (stationary
    weights at serve time), kept for decode and train; overrides last."""
    ds = get_config("deepseek-v3-671b")
    assert ds.fsdp
    assert dryrun.cell_config(ds, SHAPES["prefill_32k"]).fsdp is False
    assert dryrun.cell_config(ds, SHAPES["decode_32k"]).fsdp is True
    assert dryrun.cell_config(ds, SHAPES["train_4k"]).fsdp is True
    assert dryrun.cell_config(ds, SHAPES["prefill_32k"],
                              {"fsdp": True}).fsdp is True


def test_dryrun_cli_needs_no_card(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "tinyllama-1.1b", "--shape", "train_4k", "--out", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=600, cwd=REPO)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.startswith("OK   tinyllama-1.1b")
    r = json.loads((tmp_path /
                    "tinyllama-1.1b_train_4k_pod16x16.json").read_text())
    cfg = get_config("tinyllama-1.1b")
    kernels = r["roofline"]["detail"]["kernels"]
    # the card's route: full remat runs the forward kernel twice a layer
    assert {k: v["calls"] for k, v in kernels.items()} == {
        "flash_fwd": 2 * cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
        "flash_bwd_dkv": cfg.n_layers}
    assert r["fits_h100_80g"] is True


def _rows():
    def row(arch, shape, mesh, kind, c, m, x, mfu, fits):
        step = max(c, m, x)
        bot = ("compute", "memory", "collective")[[c, m, x].index(step)]
        return {"arch": arch, "shape": shape, "mesh": mesh, "kind": kind,
                "memory_analysis": {"argument_size_in_bytes": 9.05e9,
                                    "temp_size_in_bytes": 5.4e9},
                "fits_h100_80g": fits, "roofline": {
                    "compute_s": c, "memory_s": m, "collective_s": x,
                    "bottleneck": bot, "useful_ratio": 0.79,
                    "mfu_bound": mfu, "achievable_step_s": step}}
    return [row("llama3-8b", "train_4k", "pod16x16", "train", 0.25, 0.14,
                0.44, 0.449, True),
            row("granite-moe-3b-a800m", "train_4k", "pod16x16", "train",
                0.07, 0.18, 0.14, 0.119, True),
            row("deepseek-v3-671b", "prefill_32k", "pod16x16", "prefill",
                1.04, 11.98, 0.62, 0.028, False),
            row("llama3-8b", "train_4k", "pod2x16x16", "train", 0.13, 0.07,
                0.9, 0.2, True)]


def test_report_twin_prints_the_reference_table():
    rows = _rows()
    as_ref = [dict(r, fits_v5e_16g=r["fits_h100_80g"]) for r in rows]
    assert report.HEADER == jreport.HEADER
    assert [report.fmt_row(r) for r in rows] == \
        [jreport.fmt_row(r) for r in as_ref]
    got, want = report.pick_hillclimb(rows), jreport.pick_hillclimb(as_ref)
    assert {k: (r["arch"], r["shape"]) for k, r in got.items()} == \
        {k: (r["arch"], r["shape"]) for k, r in want.items()}


def test_report_cli_reads_the_dry_runs_reports(tmp_path, capsys):
    for r in _rows():
        (tmp_path / f"{r['arch']}_{r['shape']}_{r['mesh']}.json").write_text(
            json.dumps(r))
    report.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == report.HEADER.splitlines()[0] and len(out) == 2 + 4 + 4
    assert out[-1].startswith("hillclimb[paper_representative]: llama3-8b")


def test_report_names_the_cells_whose_collectives_are_counted_short(
        tmp_path, capsys):
    rows = _rows()
    rows[0]["count_short"] = ["collective: fsdp"]
    rows[1]["count_short"] = ["collective: moe one-hot dispatch resharded",
                              "flops: even split of the moe dispatch"]
    for r in rows:
        (tmp_path / f"{r['arch']}_{r['shape']}_{r['mesh']}.json").write_text(
            json.dumps(r))
    report.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[2 + 4:2 + 4 + 2] == [
        "count short (ROADMAP Queue C): granite-moe-3b-a800m train_4k "
        "pod16x16: collective: moe one-hot dispatch resharded; flops: even "
        "split of the moe dispatch",
        "count short (ROADMAP Queue C): llama3-8b train_4k pod16x16: "
        "collective: fsdp"]
    assert out[-1].startswith("hillclimb[paper_representative]: llama3-8b")
    assert out[-1].endswith(" (count short: collective: fsdp)")


def test_hillclimb_iteration_2_shows_the_chunk_knob_moves_nothing(
        tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(attn_mod, "KV_CHUNK", attn_mod.KV_CHUNK)
    spec = importlib.util.spec_from_file_location(
        "_torch_hillclimb", REPO / "experiments" / "torch_hillclimb.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--iter", "2", "--cell", "llama3", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[hc2] llama3-8b train_4k:" in out
    assert out.rstrip().endswith("no change")
    assert attn_mod.KV_CHUNK == 2048
    assert (tmp_path / "llama3-8b_train_4k_pod16x16_hc2.json").exists()
