"""PyTorch port, the mesh over processes: ``core/compat.py``'s process
route (``launch/mesh.py::make_process_mesh``, gloo on the CPU), every body
that the stacked route runs, unchanged, the data-parallel train step, and
the dense family's tensor-parallel and FSDP train and serve steps.

One module fixture spawns 4 gloo ranks once and runs every case of
``tests/torch_process_cases.py`` there; each case also runs on rank 0 on
the stacked route (or the one-device step) on the same inputs. Held:
each collective and its backward on (2,2) and (4,1) (float32 to 1e-6,
integers exact), the ring matmuls to 1e-5, the compressed all-reduce's
``q`` bit-equal and its mean and residual to 1e-6, the pipeline's loss and
gradients over 4 stages to 1e-6, the expert-parallel MoE on (2,2) to 1e-5,
and in every case the collectives' calls a rank and bytes summed over the
ranks equal to the stacked route's, forward and backward; the local-axes
rule; the
data-parallel step on (4,1) against the one-device step (float32 loss and
grad norm to 1e-5 relative, float64 parameters to 1e-10) and its
gradient all-reduce's bytes against the dry run's count; the
tensor-parallel step of reduced tinyllama-1.1b on (1,4) and (2,2) (float32
step by step to 1e-5 relative, float64 through the Trainer to 1e-10, the
bytes against the dry run's count, 2 kv heads on (1,4), checkpoints both
ways) and its serve steps and engine on (1,4); its FSDP step with fsdp=True
on (4,1) and (2,2) (float32 step by step at remat "none" and "full",
float64 through the Trainer, the gathers and reduce-scatters against the
dry run's count, grad_accum=2, the gathered leaves freed after the
forward, the other dense configs, checkpoints both ways) and serve steps
on (2,2); the MoE family's train step, reduced granite-moe-3b-a800m on
(4,1), (2,2) and (1,4) (one dispatch group and the Switch aux loss over
the global batch, the experts' FFN split over model; float32 metrics to
1e-6 and float64 to 1e-10 step by step, the dropped pairs, the bytes
against the dry run's count), at capacity factor 0.5, with groups of 64
by the global count, a vocab of 257 on (1,4) and reduced
deepseek-v3-671b data-parallel, with every rank's routes held against the
one-device step's (no flipped pair); MLA under the model axis, reduced
deepseek-v3-671b with fsdp=False on (1,4) and (2,2) (its heads, routed
experts and vocab split over the ranks: the train step against the
one-device step, at capacity factor 0.5, against the reference's sharded
step, the bytes against the dry run's count, checkpoints both ways) and
its serve steps on (1,4); the MoE family under FSDP, reduced
deepseek-v3-671b as configured on (4,1) and (2,2) (the same checks, and
remat "none", the gathered leaves freed, the reference's FSDP step) and
served on (2,2), and granite-moe-3b-a800m's padded tables under FSDP;
a ``compat.Held`` input's block and its gradient; the expert-parallel
route over processes (deepseek-v3-671b's experts blocks held on (1,2)
and, as configured, on (2,2); granite-moe-3b-a800m's FFN blocks re-laid
on (1,4) and (2,2)) trained against the stacked route's step and served
against its serve steps, the bytes against the dry run's count, drops,
a planted fault, what the counts leave out and checkpoints;
the MoE step in micro-batches (each rank's strip its data block of the
global micro-batch) on the one-hot dispatch and the expert-parallel
route, with and without FSDP, against the one-device or the stacked
step in as many micro-batches, the bytes against the dry run's count in
micro-batches, drops by micro-batch, a planted fault and checkpoints;
the SSM, hybrid, vision and encoder-decoder families under FSDP on (4,1)
(xlstm-1.3b, zamba2-7b, llama-3.2-vision-11b, seamless-m4t-medium
reduced: float32 step by step at remat "none" and "full" and float64
against the one-device step, the bytes against the dry run's count, the
serve steps and each rank's cache rows, the gathered leaves freed,
zamba2-7b's shared block gathered once a forward and a planted fault
gathering it at each use, a step in micro-batches, checkpoints); and
what the route refuses (those four families at model > 1 under FSDP,
and the serving engine's slots that the data ranks do not split).
The reference runs once a session, in ``tests/test_torch_mesh.py``'s
subprocess (``torch_shared_run``): its sharded train step on (2,2) is held
against the tensor-parallel step on the same parameters and tokens, and
its FSDP step against the port's FSDP step, its MoE step on (4,1)
and (2,2) against the port's MoE step, and its deepseek-v3-671b step on
(1,4) and (2,2) against the port's MLA step, and with fsdp=True on (4,1)
and (2,2) against the port's FSDP step, and on its expert-parallel route
on (2,2) against the port's, and its FSDP steps of zamba2-7b and
seamless-m4t-medium on (4,1), in float64, against the port's. The
stacked route and the one-device step are held against it in
``tests/test_torch_mesh.py``, ``tests/test_torch_pipeline.py`` and
``tests/test_torch_train.py``.
"""
import os

import pytest
import torch

import torch_process_cases as pc
from test_torch_mesh import _tree, reference_npz
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import compat
from repro_torch.core.compat import ProcessMesh
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh, make_process_mesh

pytestmark = pytest.mark.torch
torch.set_num_threads(1)


def _collective_tags():
    tags = []
    for shape, axes_list in pc.COLLECTIVE_AXES.items():
        for axes in axes_list:
            for kind in pc.KINDS:
                if kind in ("all_gather", "all_to_all", "ppermute") \
                        and isinstance(axes, tuple):
                    continue
                tags.append(f"{shape} {axes} {kind}")
                if kind in pc.INT_KINDS:
                    tags.append(f"{shape} {axes} {kind} int")
    return tags


def _family_step(ref, arch) -> dict:
    """The reference's FSDP step of ``arch`` on (4,1) from its subprocess:
    parameters, tokens (and frontend embeddings), metrics."""
    tag = f"step_fsdp_{arch}"
    out = {"params": _tree(ref, f"{tag}/params"),
           "tokens": ref[f"{tag}/tokens"],
           "metrics": {k: float(ref[f"{tag}/m1_{k}"])
                       for k in ("loss", "ce", "grad_norm")},
           "metrics_one": {k: float(ref[f"{tag}/m0_{k}"])
                           for k in ("loss", "ce", "grad_norm")}}
    if f"{tag}/frontend_emb" in ref:
        out["frontend_emb"] = ref[f"{tag}/frontend_emb"]
    return out


@pytest.fixture(scope="module")
def res(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("processes"))
    ref = reference_npz(tmp_path_factory)
    torch.save({"params": _tree(ref, "step_dense/params"),
                "tokens": ref["step_dense/tokens"],
                "metrics": {k: float(ref[f"step_dense/m1_{k}"])
                            for k in ("loss", "ce", "grad_norm")},
                "metrics_fsdp": {k: float(ref[f"step_dense_fsdp/m1_{k}"])
                                 for k in ("loss", "ce", "grad_norm")},
                "moe_params": _tree(ref, "step_moe/params"),
                "moe_tokens": ref["step_moe/tokens"],
                "moe_metrics": {(d, m): {k: float(ref[
                    f"step_moe_{d}x{m}/m1_{k}"]) for k in (
                        "loss", "ce", "aux", "grad_norm")}
                    for d, m in pc.REFERENCE_MOE},
                "mla_params": _tree(ref, "step_mla/params"),
                "mla_tokens": ref["step_mla/tokens"],
                "mla_metrics": {(d, m): {k: float(ref[
                    f"step_mla_{d}x{m}/m1_{k}"]) for k in (
                        "loss", "ce", "aux", "grad_norm")}
                    for d, m in pc.MLA_MESHES},
                "mla_fsdp_metrics": {(d, m): {k: float(ref[
                    f"step_mla_fsdp_{d}x{m}/m1_{k}"]) for k in (
                        "loss", "ce", "aux", "grad_norm")}
                    for d, m in pc.MLA_FSDP_MESHES},
                "moe_ep_params": _tree(ref, "step_moe_ep/params"),
                "moe_ep_tokens": ref["step_moe_ep/tokens"],
                "moe_ep_metrics": {k: float(ref[f"step_moe_ep/m1_{k}"])
                                   for k in ("loss", "ce", "aux",
                                             "grad_norm")},
                "families": {arch: _family_step(ref, arch)
                             for arch in pc.REFERENCE_FAMILIES}},
               os.path.join(out, pc.REFERENCE_STEP))
    return pc.spawn(out)


def _case(res, name):
    got = res[name]
    if "error" in got:
        raise AssertionError(f"case {name} raised on rank 0:\n{got['error']}")
    return got


@pytest.mark.parametrize("tag", _collective_tags())
def test_each_collective_and_its_backward_match_the_stacked_route(res, tag):
    """The body ``collective(x) * w`` (``w`` differs on every device), its
    output and the gradient of its sum; calls a rank and bytes summed over
    the ranks equal to the stacked route's, forward and backward."""
    pc.check_pair("collectives", tag, _case(res, "collectives")[tag])


@pytest.mark.parametrize("tag", ["ag g1", "ag g2", "ag g4", "rs"])
def test_ring_matmuls_run_unchanged_on_processes(res, tag):
    """``core/chaining.py`` on (1,4): ``_dot``'s replicated operand and
    ``idx.numel()`` read the rank's stacks of extent 1."""
    pc.check_pair("chaining", tag, _case(res, "chaining")[tag])


@pytest.mark.parametrize("tag", ["comp0", "comp1"])
def test_compressed_psum_runs_unchanged_on_processes(res, tag):
    """``q`` (int8, at the all_to_all) bit-equal; mean and residual to
    1e-6."""
    pc.check_pair("compression", tag, _case(res, "compression")[tag])


def test_pipeline_loss_over_four_stages_on_processes(res):
    pc.check_pair("pipeline", "pipe", _case(res, "pipeline")["pipe"])


def test_moe_ep_on_a_two_by_two_process_mesh(res):
    """Output, aux and the gradients of the tokens and of the gate table;
    three all_to_all a chunk a rank."""
    pair = _case(res, "moe_ep")["ep"]
    pc.check_pair("moe_ep", "ep", pair)
    fwd, _ = pair["proc"][1]
    assert fwd["all_to_all"]["calls"] == 3 * (64 // 4 // 4)


def test_lane_local_mla_prefill_and_decode_on_processes(res):
    """Reduced deepseek-v3-671b's prefill and two absorbed decode steps on
    (1,4), each rank on its blocks (heads, experts, vocab; the latent
    cache whole): logits to 1e-4 of the one-device steps and of the
    stacked route's lane-local prefill (one ``shard_map`` a layer, none on
    the ranks)."""
    pc.check_mla_serve_logits(_case(res, "mla"))


def test_mla_serves_the_expert_parallel_route_on_the_ranks_blocks(res):
    """Reduced deepseek-v3-671b's prefill at or above a lowered
    ``DENSE_PATH_MAX_TOKENS`` on (1,4): each rank runs the expert-parallel
    route on its block of the experts, logits to 1e-4 of the stacked
    route's on the global tables."""
    pc.check_mla_ep_serve(_case(res, "mla"))


def test_mla_serve_bytes_equal_the_dry_runs_count(res):
    """Per step the all-reduces of the ranks (MLA's after ``wo``, the
    experts' and the FFNs' outputs, the lookup) summed over them equal the
    dry run's count times the ranks, beside one all-gather of the last
    logits."""
    pc.check_mla_serve_bytes(_case(res, "mla"))


def test_local_axes_leave_a_ranks_own_block_alone(res):
    """With ``data`` local, a rank's own rows in give its own rows of the
    global output out, and the gradient of its rows; with no local axis
    the body takes and gives global tensors."""
    errs = pc.check("local_axes", _case(res, "local_axes"))
    assert set(errs) == {"local y", "local grad", "global"}


def test_data_parallel_step_matches_the_one_device_step(res):
    pc.check("dp_train", _case(res, "dp_train"))


def test_gradient_all_reduce_bytes_equal_the_dry_runs_count(res):
    """The step's pmean bytes, summed over the ranks, less the loss
    metrics' one call, equal the dry run's gradient all-reduces on (4,1)
    for the same cell, times its 4 devices."""
    dp = _case(res, "dp_train")
    cfg = reduced(get_config("tinyllama-1.1b"))
    shape = ShapeConfig("train", pc.DP["seq_len"], pc.DP["global_batch"],
                        "train")
    st = dryrun.count_step(cfg, shape, make_mesh(4, 1), target="cpu")
    assert set(st.collective_by_kind) == {"all-reduce"}
    steps, n = pc.DP["steps"], pc.WORLD
    got = dp["f32"]["counts"][0]["pmean"]["bytes"] / steps \
        - pc.metric_bytes(3, 4, n)            # loss, ce, aux in float32
    assert got == pytest.approx(n * st.collective_by_kind["all-reduce"],
                                rel=0, abs=n), (got, st.collective_by_kind)


def test_what_the_process_route_refuses(res):
    """A wrong world size, the cross families and heads the model axis
    does not divide at model > 1 (a dense and an SSM config), a KV cache
    split over kv_seq, a MoE step in micro-batches whose rows the data
    ranks do not split, FSDP of
    the hybrid and vision families at model > 1 (of zamba2-7b's serving
    engine too), the serving engine's slots that FSDP's data ranks do not
    split, a collective outside a body, and device "cuda" on the gloo
    group, each with its own text."""
    got = _case(res, "refusals")
    assert got["outside"] == "a collective runs only inside shard_map's body"
    assert "grad_accum=4 cuts the global batch's 8 rows into micro-batches " \
        "of 2 rows, which 4 data ranks" in got["accum_rows"]
    pc.check("refusals", got)


@pytest.mark.parametrize("shape", pc.TP_MESHES, ids=str)
def test_tensor_parallel_step_matches_the_one_device_step(res, shape):
    """Reduced tinyllama-1.1b: float32 step by step, each from the same
    state, to 1e-5 relative; float64 through the Trainer to 1e-10; each
    rank's blocks of the reference's shard shapes; the replicated leaves
    equal on every rank."""
    pc.check_tp_mesh(_case(res, "tp_train"), shape)


@pytest.mark.parametrize("shape", pc.TP_MESHES, ids=str)
def test_tensor_parallel_bytes_equal_the_dry_runs_count(res, shape):
    """The all-reduces that the ranks run (Megatron's pairs, the
    vocab-split lookup and cross-entropy, the data-parallel gradient mean)
    move, summed over the ranks, the dry run's count of the same cell
    times the ranks, less the grad norm's scalar and the loss metrics."""
    pc.check_tp_bytes(_case(res, "tp_train"), shape)


def test_tensor_parallel_step_where_the_model_axis_does_not_divide_kv(res):
    """2 kv heads on (1,4): each rank reads them whole and takes the groups
    its heads read; the cotangents of k and v are all-reduced."""
    pc.check_tp_config(_case(res, "tp_train"), "kv2")


@pytest.mark.parametrize("arch", pc.TP_ARCHS)
def test_tensor_parallel_step_of_each_dense_config(res, arch):
    """llama3-8b, stablelm-1.6b (parallel block) and starcoder2-3b (tied
    head, GELU, 4 heads padded to 32 with 2 kv heads) reduced, float64
    through the Trainer on (1,4) against the one-device trainer."""
    pc.check_tp_config(_case(res, "tp_train"), arch)


def test_tensor_parallel_step_matches_the_references_sharded_step(res):
    """The reference's float32 step on a (2,2) mesh (its parameters and
    tokens): loss, ce and grad norm to 1e-5 relative."""
    got = _case(res, "tp_train")
    assert got["reference"] is not None
    pc.check_tp_reference(got)


def test_tensor_parallel_checkpoints_move_to_one_device_and_back(res):
    pc.check_tp_ckpt(_case(res, "tp_train"))


def test_tensor_parallel_serve_steps_match_the_one_device_steps(res):
    """Prefill of 8 x 64 and 2 decode steps on (1,4): logits to 1e-5, the
    cache's k/v of the rank's kv heads."""
    pc.check_tp_serve_logits(_case(res, "tp_serve"))


def test_tensor_parallel_serve_bytes_equal_the_dry_runs_count(res):
    pc.check_tp_serve_bytes(_case(res, "tp_serve"))


def test_tensor_parallel_engine_emits_the_same_tokens_on_every_rank(res):
    pc.check_tp_engine(_case(res, "tp_serve"))


@pytest.mark.parametrize("key", ["tp_odd", "tp_ssm_odd", "tp_cross_odd",
                                 "tp_kv_seq"])
def test_tensor_parallel_refusals_name_their_queue_item(res, key):
    """On model > 1: a dense config whose 6 heads 4 ranks do not divide, a
    reduced xlstm-1.3b whose 2 mLSTM heads they do not divide, a reduced
    llama-3.2-vision-11b whose 6 heads (its self and cross layers') they
    do not divide, and a KV cache that the reference splits over kv_seq,
    each a NotImplementedError naming its queue item (2.6)."""
    got = _case(res, "refusals")[key]
    assert got is not None and pc.refusal_texts()[key] in got, got
    assert "A13c item 2." in got, got


@pytest.mark.parametrize("shape", pc.FSDP_MESHES, ids=str)
def test_fsdp_step_matches_the_one_device_step(res, shape):
    """Reduced tinyllama-1.1b with ``fsdp=True``: float32 step by step,
    each from the same state, to 1e-5 relative at ``remat="none"`` and
    ``"full"``; float64 through the Trainer to 1e-10; each rank's blocks
    of the reference's FSDP shard shapes, equal on the ranks whose
    coordinates agree along the axes that cut them."""
    pc.check_fsdp_mesh(_case(res, "fsdp_train"), shape)


@pytest.mark.parametrize("shape", pc.FSDP_MESHES, ids=str)
def test_fsdp_bytes_equal_the_dry_runs_count(res, shape):
    """Every leaf gathered in the forward and again for the backward that
    reads it (the embedding's lookup does not), one reduce-scatter of
    its gradient and no pmean of it: the bytes by kind, summed over the
    ranks, equal to the dry run's count of the same cell (on (4,1):
    640,896 + 345,024 a device), at ``remat="none"`` and ``"full"``."""
    got = pc.check_fsdp_bytes(_case(res, "fsdp_train"), shape)
    if shape == (4, 1):
        assert got["none"]["all-gather"] == 4 * 640_896
        assert got["none"]["reduce-scatter"] == 4 * 345_024


def test_fsdp_step_with_grad_accum_gathers_once_a_micro_batch(res):
    pc.check_fsdp_accum(_case(res, "fsdp_train"))


def test_fsdp_gathered_leaves_are_freed_after_the_forward(res):
    """No product keeps a gathered leaf: each saves a handle to the rank's
    block, and the backward gathers the leaf again."""
    pc.check_fsdp_freed(_case(res, "fsdp_train"))


@pytest.mark.parametrize("arch", pc.TP_ARCHS)
def test_fsdp_step_of_each_dense_config(res, arch):
    """llama3-8b, stablelm-1.6b (parallel block) and starcoder2-3b (tied
    head: the table the lookup gathered is the head's) reduced with
    ``fsdp=True``, float64 through the Trainer on (2,2) against the
    one-device trainer."""
    pc.check_tp_config(_case(res, "fsdp_train"), arch)


def test_fsdp_step_matches_the_references_fsdp_step(res):
    """The reference's float32 FSDP step on a (2,2) mesh (its parameters
    and tokens): loss, ce and grad norm to 1e-5 relative."""
    got = _case(res, "fsdp_train")
    assert got["reference"] is not None
    pc.check_tp_reference(got)


def test_fsdp_checkpoints_move_to_one_device_and_back(res):
    """A (4,1) FSDP checkpoint (the global state, gathered to rank 0)
    restored by the one-device trainer, and a one-device checkpoint
    restored on (4,1) (each rank its blocks of the parameters and
    moments), byte for byte."""
    pc.check_tp_ckpt(_case(res, "fsdp_train"))


def test_fsdp_serve_steps_match_the_one_device_steps(res):
    """Prefill of 8 x 64 and 2 decode steps on (2,2), each data rank its 4
    prompts: logits, whole on every rank, to 1e-5; the cache of the
    rank's rows and kv heads."""
    pc.check_fsdp_serve_logits(_case(res, "fsdp_serve"))


def test_fsdp_serve_bytes_equal_the_dry_runs_count(res):
    pc.check_fsdp_serve_bytes(_case(res, "fsdp_serve"))


@pytest.mark.parametrize("key,item", [
    ("fsdp_hybrid_model", "A13c item 2.6)"),
    ("fsdp_vision_model", "A13c item 2.6)"),
    ("fsdp_engine_slots", "a multiple of the data extent"),
    ("fsdp_hybrid_engine", "A13c item 2.6)")])
def test_fsdp_refusals_name_their_queue_item(res, key, item):
    """FSDP over processes at model > 1 of zamba2-7b (its prefill step
    and its serving engine) and of the vision family (its decode step) on
    (2,2): a NotImplementedError naming item 2.6, the SSM, hybrid, vision
    and encoder-decoder families under FSDP with model > 1; the serving
    engine under FSDP on
    (4,1) with 6 slots, which its 4 data ranks do not split: a ValueError
    naming the rule."""
    got = _case(res, "refusals")[key]
    assert got is not None and pc.refusal_texts()[key] in got, got
    assert item in got, got


@pytest.mark.parametrize("shape", pc.MOE_MESHES, ids=str)
def test_moe_step_matches_the_one_device_step(res, shape):
    """Reduced granite-moe-3b-a800m (4 experts padded to 48, top 2, one
    dispatch group of the global batch's 256 tokens): 3 steps, each from
    the same state as the one-device step, the loss, ce, aux, grad norm
    and lr within 1e-6 relative in float32 and 1e-10 in float64, the
    parameters after each within 1e-10 in float64 (float32: ``MOE_TOL``);
    no pair dropped there, as on one device."""
    pc.check_moe_mesh(_case(res, "moe_train"), shape)


@pytest.mark.parametrize("shape", pc.MOE_MESHES, ids=str)
def test_moe_bytes_equal_the_dry_runs_count(res, shape):
    """The ranks' collectives by kind, summed, equal to the dry run's count
    of the same cell times the ranks: the counts' all-gather over data a
    MoE layer (none on (1,4)), the buffer's all-reduces over model (the
    whole buffer on every data rank), the gradient means of the live
    experts of the padded tables; beside them the grad norm's scalar and
    the loss metrics' mean."""
    got = pc.check_moe_bytes(_case(res, "moe_train"), shape)
    cfg = pc._moe_cfg()
    d, m = shape
    if d > 1:       # one (4,) int32 vector a layer, from each of d ranks
        assert got["all-gather"] == d * m * cfg.n_layers * (d - 1) * 4 \
            * cfg.moe.n_experts
    else:
        assert "all-gather" not in got


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)], ids=str)
def test_moe_step_where_capacity_drops_pairs(res, shape):
    """Capacity factor 0.5 (64 slots an expert for 512 pairs): the one
    group drops pairs every step, the ranks after the first most of them
    (their slots come after the first ranks' counts); float64 within 1e-10
    of the one-device step, and the drops, summed over the data ranks,
    equal to its drops."""
    pc.check_moe_drops(_case(res, "moe_train"), shape)


def test_moe_group_size_reads_the_global_count(res):
    """``DENSE_PATH_MAX_TOKENS`` lowered to 256 and 8 x 64 tokens on
    (4,1): the global 512 tokens take groups of 64, where a rank's 128
    would take one group of 128; float64 within 1e-10 of the one-device
    step, drops equal (by rank: each rank's groups are its own, not blocks
    of one group)."""
    pc.check_moe_steps("groups", _case(res, "moe_train")["groups"],
                       pc.MOE_TOL["f64"], blocks=False)


def test_moe_step_with_a_vocab_the_model_axis_does_not_divide(res):
    """A vocab of 257 on (1,4): every rank holds the tied table whole, the
    lookup, head and cross-entropy unsplit; float64 within 1e-10."""
    pc.check_moe_steps("vocab257", _case(res, "moe_train")["vocab257"],
                       pc.MOE_TOL["f64"], model=4)


def test_deepseek_moe_step_data_parallel(res):
    """Reduced deepseek-v3-671b with ``fsdp=False`` on (4,1): MLA, a dense
    first layer, shared experts and the MTP module beside the MoE layer,
    data-parallel; float64 within 1e-10 of the one-device step."""
    pc.check_moe_steps("deepseek", _case(res, "moe_train")["deepseek"],
                       pc.MOE_TOL["f64"])


def test_moe_step_matches_the_references_sharded_step(res):
    """The reference's float32 step of reduced granite-moe-3b-a800m on
    (4,1) and (2,2) (its parameters and tokens): loss, ce, aux and grad
    norm within 1e-5 relative."""
    got = _case(res, "moe_train")
    assert got["reference"] is not None
    assert set(got["reference"]) == set(pc.REFERENCE_MOE)
    pc.check_moe_reference(got)


@pytest.mark.parametrize("shape", pc.MLA_MESHES, ids=str)
def test_mla_step_matches_the_one_device_step(res, shape):
    """Reduced deepseek-v3-671b with ``fsdp=False`` (MLA's heads, the
    routed experts, the shared expert's and the dense FFNs' columns and
    the vocab split over model; the MTP module's GQA layer, lookup and
    cross-entropy too): 3 steps, each from the same state as the
    one-device step, the loss, ce, aux, mtp, grad norm and lr within 1e-6
    relative in float32 (or twice what float32 resolves there) and 1e-10
    in float64, the parameters after each within 1e-10 in float64; no
    route flipped, the drops equal."""
    pc.check_mla_mesh(_case(res, "mla_train"), shape)


@pytest.mark.parametrize("shape", pc.MLA_MESHES, ids=str)
def test_mla_bytes_equal_the_dry_runs_count(res, shape):
    """The ranks' collectives by kind, summed, equal to the dry run's count
    of the same cell times the ranks (beside the grad norm's scalar and
    the loss metrics' mean): MLA's all-reduce after ``wo`` and of its
    latent cotangents, the experts' of the tokens, their gates and the
    combined output, the counts' all-gather over data on (2,2)."""
    got = pc.check_mla_bytes(_case(res, "mla_train"), shape)
    assert ("all-gather" in got) == (shape[0] > 1), got


def test_mla_step_where_capacity_drops_pairs(res):
    """Capacity factor 0.5 on (2,2), float64: each rank of a data
    coordinate drops that block's pairs of the one-device step's one
    group, the second block most of them."""
    pc.check_mla_drops(_case(res, "mla_train"))


def test_mla_step_matches_the_references_sharded_step(res):
    """The reference's float32 step of reduced deepseek-v3-671b with
    ``fsdp=False`` on (1,4) and (2,2) (its parameters and tokens): loss,
    ce, aux and grad norm within 1e-5 relative."""
    got = _case(res, "mla_train")
    assert got["reference"] is not None
    assert set(got["reference"]) == set(pc.MLA_MESHES)
    pc.check_moe_reference(got)


def test_mla_checkpoints_move_to_one_device_and_back(res):
    """A (1,4) checkpoint of reduced deepseek-v3-671b (the global state,
    gathered to rank 0) restored by the one-device trainer, and a
    one-device checkpoint restored on (1,4) (each rank its blocks), byte
    for byte."""
    pc.check_tp_ckpt(_case(res, "mla_train"))


@pytest.mark.parametrize("shape", pc.MLA_FSDP_MESHES, ids=str)
def test_moe_fsdp_step_matches_the_one_device_step(res, shape):
    """Reduced deepseek-v3-671b as configured (fsdp=True, remat "full"):
    every leaf's block over data (embed, and q_lora / kv_lora where embed
    leaves them), the experts, MLA's heads and the vocab over model on
    (2,2); each MoE layer, the dense layer and the MTP module gathering
    their leaves. 3 steps, each from the same state as the one-device
    step, the loss, ce, aux, mtp, grad norm and lr within 1e-6 relative
    in float32 (or twice what float32 resolves there) and 1e-10 in
    float64, the parameters after each within 1e-10 in float64; no route
    flipped, the drops equal."""
    pc.check_mla_fsdp_mesh(_case(res, "mla_fsdp"), shape)


@pytest.mark.parametrize("shape", pc.MLA_FSDP_MESHES, ids=str)
def test_moe_fsdp_bytes_equal_the_dry_runs_count(res, shape):
    """The ranks' collectives by kind, summed, equal to the dry run's count
    of the same cell with fsdp=True times the ranks: each leaf gathered
    in the forward and in the checkpoint's recompute, its gradient
    reduce-scattered, no pmean of it; the counts' all-gather over data;
    on (2,2) the model axis's all-reduces; beside them the grad norm's
    scalar and the loss metrics' mean."""
    got = pc.check_mla_fsdp_bytes(_case(res, "mla_fsdp"), shape)
    assert got["all-gather"] > 0 and got["reduce-scatter"] > 0, got


def test_moe_fsdp_step_where_capacity_drops_pairs(res):
    """Capacity factor 0.5 on (2,2) under FSDP, float64: each rank of a
    data coordinate drops that block's pairs of the one-device step's one
    group."""
    pc.check_mla_fsdp_drops(_case(res, "mla_fsdp"))


def test_moe_fsdp_step_without_a_checkpoint_regathers_for_the_backward(res):
    """One float32 step at remat "none" on (2,2): each layer under
    ``Fsdp.regather``, the products' saved views of a gathered leaf
    sharing one gather in the backward; within 1e-6 of the one-device
    step (or twice what float32 resolves), the bytes its own count's and
    the gathers and reduce-scatters those of "full"."""
    pc.check_mla_fsdp_none(_case(res, "mla_fsdp"))


def test_moe_fsdp_gathered_leaves_are_freed_after_the_forward(res):
    """On (4,1) at remat "none": no gathered leaf of the layers, the head
    or the MTP module is alive after the loss's forward; the backward
    gathers each again once (the two heads share the head's) but the
    table."""
    pc.check_fsdp_freed(_case(res, "mla_fsdp"),
                        pc._mla_fsdp_cfg(remat="none"))


def test_padded_moe_fsdp_moves_the_live_experts_alone(res):
    """Reduced granite-moe-3b-a800m with fsdp=True on (2,2), float64, 3
    steps within 1e-10 of the one-device step; its 48-row expert tables
    (4 live) gathered and reduce-scattered on the live rows, so that the
    bytes equal the dry run's count."""
    pc.check_granite_fsdp(_case(res, "mla_fsdp"))


def test_moe_fsdp_step_matches_the_references_fsdp_step(res):
    """The reference's float32 FSDP step of reduced deepseek-v3-671b on
    (4,1) and (2,2) (its parameters and tokens): loss, ce, aux and grad
    norm within 1e-5 relative."""
    got = _case(res, "mla_fsdp")
    assert got["reference"] is not None
    assert set(got["reference"]) == set(pc.MLA_FSDP_MESHES)
    pc.check_moe_reference(got)


def test_moe_fsdp_checkpoints_move_to_one_device_and_back(res):
    """A (4,1) FSDP checkpoint of reduced deepseek-v3-671b (the global
    state, gathered to rank 0) restored by the one-device trainer, and a
    one-device checkpoint restored on (4,1) (each rank its blocks), byte
    for byte."""
    pc.check_tp_ckpt(_case(res, "mla_fsdp"))


def test_moe_fsdp_serve_steps_match_the_one_device_steps(res):
    """Prefill of 4 x 6 and 2 absorbed decode steps on (2,2) under FSDP,
    each data rank its 2 prompts in one dispatch group over the ranks:
    logits, whole on every rank, to 1e-5; the latent cache of the rank's
    rows."""
    pc.check_mla_fsdp_serve_logits(_case(res, "mla_fsdp_serve"))


def test_moe_fsdp_serve_bytes_equal_the_dry_runs_count(res):
    """The prefill's and each decode step's bytes by kind equal to the dry
    run's count of the same step with fsdp=True times the ranks, beside
    the last logits' two all-gathers."""
    pc.check_mla_fsdp_serve_bytes(_case(res, "mla_fsdp_serve"))


@pytest.mark.parametrize("arch", pc.FAMILIES)
def test_families_fsdp_step_matches_the_one_device_step(res, arch):
    """The SSM, hybrid, vision and encoder-decoder families reduced with
    ``fsdp=True`` on (4,1) (zamba2-7b at 4 layers, its shared block read
    by two groups; the vision cross gate 0.5; the frontend's embeddings
    cut by the tokens' rows): float32 step by step, each from the same
    state, to 1e-5 relative at ``remat="none"`` (and zamba2-7b at
    ``"full"``; xlstm-1.3b's grad norm at its 1e-3 rule); float64 along 3
    steps to 1e-5 (metrics) and 1e-10 (parameters) of the one-device run;
    each
    rank's blocks of the reference's FSDP shard shapes, the mix layers'
    leaves without embed whole on every rank."""
    pc.check_family_mesh(_case(res, "families_fsdp"), arch)


@pytest.mark.parametrize("arch", pc.FAMILIES)
def test_families_fsdp_bytes_equal_the_dry_runs_count(res, arch):
    """Every cut leaf gathered in the forward and again for the backward
    that reads it (zamba2-7b's shared block once each way), one
    reduce-scatter of its gradient, one pmean a step of each leaf FSDP
    leaves whole: the bytes by kind, summed over the ranks, equal to the
    dry run's count of the same cell, at ``remat="none"`` (and zamba2-7b
    at ``"full"``, its shared block gathered again in the recompute's
    first use)."""
    got = pc.check_family_bytes(_case(res, "families_fsdp"), arch)
    if "full" in got:
        for k in ("all-gather", "reduce-scatter"):
            assert got["f32"][k] == got["full"][k], got


@pytest.mark.parametrize("arch", pc.FAMILIES)
def test_families_fsdp_serve_steps_match_the_one_device_steps(res, arch):
    """Prefill of 8 x 64 and 2 decode steps on (4,1), each data rank its 2
    prompts: logits, whole on every rank, to 1e-5; the SSM state, the
    shared block's KV and the encoder's memory rank 0's rows of the
    one-device cache; each step's bytes the dry run's count beside the
    last logits' gather over data."""
    pc.check_family_serve(_case(res, "families_fsdp"), arch)


@pytest.mark.parametrize("arch", ["zamba2-7b", "seamless-m4t-medium"])
def test_families_fsdp_gathered_leaves_are_freed_after_the_forward(res, arch):
    """At ``remat="none"`` no gathered leaf of the mix, encoder, cross or
    decoder layers, the shared block or the head is alive after the
    loss's forward; the forward gathers each cut leaf once (the shared
    block once for its two groups), the backward each again but the table
    and the first encoder norm."""
    got = pc.check_family_freed(_case(res, "families_fsdp"), arch)
    assert got["gathers"] > 0


def test_families_fsdp_shared_block_gathered_at_each_use_is_caught(res):
    """The bytes check is not vacuous: zamba2-7b's step with its shared
    block gathered at each group's use keeps the one-device metrics but
    moves one more gather of the block than the count."""
    got = pc.check_family_fault(_case(res, "families_fsdp"))
    assert got["extra all-gather"] > 0


def test_families_fsdp_step_with_grad_accum_gathers_once_a_micro_batch(res):
    """xlstm-1.3b in 2 micro-batches on (4,1): within 1e-5 of the one-device
    step (its grad norm at its rule), its gathers and reduce-scatters the
    dry run's count in 2 micro-batches."""
    assert pc.check_family_accum(_case(res, "families_fsdp")) <= pc.TOL[
        "tp_f32"]


@pytest.mark.parametrize("arch", pc.REFERENCE_FAMILIES)
def test_families_fsdp_step_matches_the_references_fsdp_step(res, arch):
    """The reference's FSDP step on a (4,1) mesh of reduced zamba2-7b (4
    layers) and seamless-m4t-medium (with frontend embeddings), in
    float64 (in float32 their grad norms carry the stacks' rounding: the
    reference's own one-device and FSDP steps disagree by more than 1e-5
    there), its parameters and batch: loss and ce to 1e-5 relative; the
    grad norm to 1e-5, or where the two packages' one-device float64
    steps lie further apart (the reference's attention scores and logits
    stay float32), to twice their gap; the port's one-device step equal
    to the ranks' to 1e-10."""
    got = _case(res, "families_fsdp")
    assert got["reference"] is not None
    pc.check_family_reference(got, arch)


def test_families_fsdp_checkpoints_move_to_one_device_and_back(res):
    """A (4,1) FSDP checkpoint of reduced zamba2-7b (the global state,
    gathered to rank 0) restored by the one-device trainer, and a
    one-device checkpoint restored on (4,1) (each rank its blocks of the
    mix layers' cut and whole leaves and of the shared block), byte for
    byte."""
    pc.check_tp_ckpt(_case(res, "families_fsdp"))


@pytest.mark.parametrize("key", list(pc.micro_cells()))
def test_moe_step_in_micro_batches_matches_the_one_device_step(res, key):
    """The MoE step in 2 micro-batches over processes, each rank's strip
    its data block of the global micro-batch (the re-lay of
    ``train.step.micro_major``): deepseek-v3-671b as configured (FSDP) on
    (4,1) and granite-moe-3b-a800m on (2,2) on the one-hot dispatch,
    against the one-device step in 2 micro-batches; deepseek-v3-671b as
    configured, granite-moe-3b-a800m with fsdp=True (its FFN blocks
    re-laid) and deepseek-v3-671b with fsdp=False on (2,2) on the
    expert-parallel route (the gate lowered to a micro-batch's 128
    tokens), against the stacked route's step in 2 micro-batches. 3
    steps each from the same state: float64 within 1e-10 (metrics and
    parameters), float32 metrics within 1e-6 or twice what float32
    resolves of float64; no route flipped; each rank's drops its
    device's (expert-parallel) or, in each micro-batch, its data
    block's (one-hot)."""
    pc.check_micro_cell(_case(res, "moe_micro"), key)


@pytest.mark.parametrize("key", list(pc.micro_cells()))
def test_moe_micro_bytes_equal_the_dry_runs_count(res, key):
    """The ranks' bytes by kind, summed, equal to the dry run's count of
    the same cell in 2 micro-batches times the ranks: each strip's FSDP
    gathers and reduce-scatters, dispatch gathers, all-to-alls and
    re-lays of the experts, the batch's micro-major all-gathers once, the
    gradient mean once; beside them the grad norm's scalar and the loss
    metrics' mean."""
    got = pc.check_micro_bytes(_case(res, "moe_micro"), key)
    assert got["all-gather"] > 0, got


def test_moe_micro_step_where_capacity_drops_pairs(res):
    """Capacity factor 0.5, granite-moe-3b-a800m on (2,2), one float64
    step in 2 micro-batches: each rank's drops in each micro-batch are
    the one-device step's drops of its data block of that micro-batch,
    and every micro-batch drops pairs."""
    pc.check_micro_dropping(_case(res, "moe_micro"))


def test_moe_micro_step_without_the_relay_is_caught(res):
    """The check is not vacuous: the same (2,2) granite step on each
    rank's contiguous strips (no re-lay) misses the one-device step's
    aux or parameters by more than 1e-10."""
    pc.check_micro_fault(_case(res, "moe_micro"))


def test_moe_micro_checkpoints_move_to_one_device_and_back(res):
    """A (2,2) granite-moe-3b-a800m trainer in 2 micro-batches takes 2
    steps; its checkpoint (the global state, gathered to rank 0) is
    restored by the one-device trainer, and a one-device checkpoint on
    (2,2) (each rank its blocks), byte for byte."""
    pc.check_tp_ckpt(_case(res, "moe_micro"), pc.MICRO_CKPT_STEPS)


@pytest.mark.parametrize("tag", ["(1, 2)", "(2, 2)"])
def test_a_held_input_keeps_the_ranks_block_and_its_gradient(res, tag):
    """``compat.Held``: each rank passes its block of rows along model,
    neither cut nor gathered there; its gradient is the block's own (the
    stacked route's gradient of the whole tensor, sliced: no sum over
    model), summed over data where data replicates it."""
    pc.check_held(_case(res, "held"), tag)


@pytest.mark.parametrize("key", list(pc.ep_cases()))
def test_ep_step_matches_the_stacked_step(res, key):
    """The expert-parallel route over processes, ``DENSE_PATH_MAX_TOKENS``
    lowered to the 256 global tokens: reduced deepseek-v3-671b on (1,2)
    without FSDP (two such meshes side by side) and on (2,2) as
    configured, each rank on its block of the experts (held, under FSDP
    gathered over data); reduced granite-moe-3b-a800m on (1,4) and (2,2),
    each rank's FFN blocks of the padded tables re-laid as blocks of the
    experts by an all-to-all. 3 steps, each from the same state as the
    stacked route's step on a mesh of the same shape (per-lane
    capacities, the aux loss averaged over the devices): float64 within
    1e-10 (metrics and parameters), float32 within 1e-6 or twice what it
    resolves there; each rank's dropped pairs its device's there, no
    route flipped."""
    pc.check_ep_mesh(_case(res, "ep_train"), key)


@pytest.mark.parametrize("key", list(pc.ep_cases()))
def test_ep_bytes_equal_the_dry_runs_count(res, key):
    """The ranks' bytes by kind, summed, equal to the dry run's count of
    the same cell at the same gate times the ranks: the body's three
    all-to-alls a MoE layer and granite's re-lay of its three tables,
    forward, backward and in the recompute; the tensor-parallel
    all-reduces; every padded slot's gradient mean (FSDP's gathers and
    reduce-scatters); beside them the grad norm's scalar and the loss
    metrics' mean."""
    cfg, shape, worlds = pc.ep_cases()[key]
    got = pc.check_ep_bytes(pc._ep_rows(_case(res, "ep_train"), key), cfg,
                            shape, worlds)
    assert got["all-to-all"] > 0, got


def test_ep_step_where_no_pair_drops_keeps_the_one_device_ce(res):
    """Capacity factor 16 on (2,2), granite-moe-3b-a800m: neither the
    route nor the one-device one-hot step drops a pair (asserted from the
    capacities), so the cross-entropy is the one-device step's within
    1e-10 in float64."""
    pc.check_ep_no_drops(_case(res, "ep_train"))


def test_ep_step_where_capacity_drops_pairs(res):
    """Capacity factor 0.5 on (2,2), deepseek-v3-671b as configured,
    float64: every rank drops pairs (at its lane's send slots and at its
    experts' slots), each exactly those of its device on the stacked
    route, within 1e-10."""
    pc.check_ep_drops(_case(res, "ep_train"))


def test_ep_held_tables_passed_as_replicated_are_caught(res):
    """The check is not vacuous: with the held tables passed as
    replicated, each block's gradient sums the other lane's experts', and
    the step misses the stacked route's by more than 1e-10."""
    pc.check_ep_replicated(_case(res, "ep_train"))


def test_ep_step_matches_the_references_ep_step(res):
    """The reference's float32 step of reduced deepseek-v3-671b as
    configured on its expert-parallel route on (2,2) (its parameters and
    tokens, the gate lowered to 32 in both packages): loss, ce and aux
    within 5e-4 and grad norm within 1e-3, three all-to-alls."""
    got = _case(res, "ep_train")
    assert got["reference"] is not None
    pc.check_ep_reference(got)


def test_ep_uncounted_payloads_are_the_bodys_global_tensors(res):
    """What the counts leave out, measured on the ranks by
    ``torch.distributed``'s payloads: two all-gathers a MoE layer over
    model (the EP body's output and its tokens' gradient) and one
    all-reduce (the router's gradient), the same on every rank."""
    pc.check_ep_uncounted(_case(res, "ep_train"))


def test_ep_checkpoints_move_to_one_device_and_back(res):
    """A (2,2) checkpoint of reduced granite-moe-3b-a800m trained on the
    expert-parallel route (the global state, gathered to rank 0) restored
    by the one-device trainer, and a one-device checkpoint restored on
    (2,2) (each rank its blocks), byte for byte."""
    pc.check_tp_ckpt(_case(res, "ep_train"))


EP_SERVE_KEYS = [(name, shape) for shape in pc.EP_GRANITE_MESHES
                 for name in ("granite", "mla")]


@pytest.mark.parametrize("name,shape", EP_SERVE_KEYS)
def test_ep_serve_steps_match_the_stacked_route(res, name, shape):
    """The prefill of 4 x 8 at a gate lowered to its 32 tokens (the
    expert-parallel route: granite-moe-3b-a800m re-laid, deepseek-v3-671b
    as configured held, each data rank its rows under FSDP on (2,2)),
    then 2 decode steps: logits, whole on every rank, within 1e-5 of the
    stacked route's."""
    pc.check_ep_serve_logits(_case(res, "ep_serve"), f"{name} {shape}")


@pytest.mark.parametrize("name,shape", EP_SERVE_KEYS)
def test_ep_serve_bytes_equal_the_dry_runs_count(res, name, shape):
    """The prefill's bytes by kind (its all-to-alls and re-lay among them)
    and each decode step's where the ranks' rows are the count's: the dry
    run's count of the same step times the ranks, beside the last
    logits' all-gathers."""
    pc.check_ep_serve_bytes(_case(res, "ep_serve"), name, shape)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "llama3-8b",
                                  "stablelm-1.6b", "starcoder2-3b",
                                  "granite-moe-3b-a800m", "deepseek-v3-671b"])
@pytest.mark.parametrize("shape", [(2, 1), (4, 1), (2, 2), (4, 2)], ids=str)
def test_each_fsdp_block_has_the_references_shard_shape(arch, shape):
    """``shard_params`` at full width with ``fsdp=True`` on ``meta``: on
    every rank of ``shape`` each leaf's block has ``named_for``'s FSDP
    shard shape, the ranks' blocks tile the leaf, and the Trainer's
    ``abstract_state`` is the rank's. The blocks cut over data are those
    of the leaves whose sanitized spec names data: every leaf of a dense
    model (every embed dimension); of a MoE model those that
    ``named_for`` puts there (embed takes data first, so q_lora and
    kv_lora stay whole beside it), each cut at the dimension that
    ``Fsdp.dim`` gathers. No process group is needed."""
    import dataclasses
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import abstract_params, tree_leaves
    from repro_torch.models.sharding import (MeshCtx, fsdp_split,
                                             shard_params)
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep
    cfg = dataclasses.replace(get_config(arch), fsdp=True)
    tree = abstract_params(tf.model_template(cfg))
    d, m = shape
    for r in range(d * m):
        mesh = ProcessMesh(("data", "model"), (d, m), r,
                           torch.device("cpu"), {})
        ctx = MeshCtx(mesh=mesh)
        specs = tstep.train_state_specs(cfg, ctx)["params"]
        named = tstep.named_for(specs, tree, mesh)
        blocks = shard_params(tree, specs, mesh)
        fs = fsdp_split(cfg, ctx)
        tiles = over_data = 0
        for b, sh, t, spec in zip(tree_leaves(blocks), tree_leaves(named),
                                  tree_leaves(tree), tree_leaves(fs.specs)):
            assert tuple(b.shape) == sh.shard_shape(t.shape)
            index = sh.block_index(t.shape)
            assert all(i.stop - i.start == n for i, n in zip(index, b.shape))
            data = [i for i, e in enumerate(sh.spec)
                    if "data" in compat.entry_axes(e)]
            over_data += bool(data)
            assert fs.dim(spec) == (data[0] if data else None)
            # the block is the leaf's d-th part along that dimension
            tiles += bool(data) and b.shape[data[0]] * d * (
                m if "model" in compat.entry_axes(sh.spec[data[0]])
                else 1) == t.shape[data[0]]
        leaves = len(list(tree_leaves(tree)))
        assert tiles == over_data
        if cfg.is_moe:
            assert 0 < over_data <= leaves
            # (layers, embed, ...): embed over data, the rest as the rules
            # leave it (q_lora / kv_lora whole beside it)
            lay = named["layers"]
            cuts = [compat.entry_axes(e) for e in lay["moe"]["router"].spec]
            assert cuts[:2] == [(), ("data",)], cuts
            if cfg.use_mla:
                for k in ("wq_a", "wkv_a"):
                    cuts = [compat.entry_axes(e) for e in lay["attn"][k].spec]
                    assert cuts == [(), ("data",), ()], (k, cuts)
        else:
            assert over_data == leaves      # every leaf over data
        local = tstep.make_train_step(cfg, adamw.OptConfig(),
                                      ctx).abstract_state["params"]
        assert [tuple(t.shape) for t in tree_leaves(local)] == [
            tuple(b.shape) for b in tree_leaves(blocks)]


@pytest.mark.parametrize("arch", pc.FAMILIES)
@pytest.mark.parametrize("d", [2, 4])
def test_each_family_fsdp_block_has_the_references_shard_shape(arch, d):
    """The SSM, hybrid, vision and encoder-decoder families at full width
    with ``fsdp=True`` on (d,1), on ``meta``: on every rank each leaf's
    block has ``named_for``'s FSDP shard shape and the ranks' blocks tile
    it; the leaves cut over data are those with an ``embed`` dimension,
    each at the dimension ``Fsdp.dim`` gathers, and the rest (the mix
    layers' convolution, gates, ``a_log``, ``dt_bias``, ``d_skip``,
    ``norm``, mLSTM's ``wq`` / ``wk`` / ``wv``; the cross gate) whole
    (every leaf of the encoder-decoder model is cut); the Trainer's
    ``abstract_state`` is the rank's. No process group is needed."""
    import dataclasses
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import (P, abstract_params,
                                           tree_leaves)
    from repro_torch.models.sharding import (MeshCtx, fsdp_split,
                                             shard_params)
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep
    cfg = dataclasses.replace(get_config(arch), fsdp=True)
    tmpl = tf.model_template(cfg)
    tree = abstract_params(tmpl)

    def leaves(t):
        if isinstance(t, P):
            yield t
        else:
            for k in sorted(t):
                yield from leaves(t[k])
    embed = [any(a in ("embed", "embed2") for a in p.axes)
             for p in leaves(tmpl)]
    # every leaf of the encoder-decoder model has an embed dimension
    assert sum(embed) > 0 and (sum(embed) < len(embed)) == (
        cfg.family != "audio")
    for r in range(d):
        mesh = ProcessMesh(("data", "model"), (d, 1), r,
                           torch.device("cpu"), {})
        ctx = MeshCtx(mesh=mesh)
        specs = tstep.train_state_specs(cfg, ctx)["params"]
        named = tstep.named_for(specs, tree, mesh)
        blocks = shard_params(tree, specs, mesh)
        fs = fsdp_split(cfg, ctx)
        cut = []
        for b, sh, t, spec in zip(tree_leaves(blocks), tree_leaves(named),
                                  tree_leaves(tree), tree_leaves(fs.specs)):
            assert tuple(b.shape) == sh.shard_shape(t.shape)
            index = sh.block_index(t.shape)
            assert all(i.stop - i.start == n for i, n in zip(index, b.shape))
            data = [i for i, e in enumerate(sh.spec)
                    if "data" in compat.entry_axes(e)]
            assert fs.dim(spec) == (data[0] if data else None)
            if data:
                assert b.shape[data[0]] * d == t.shape[data[0]]
            cut.append(bool(data))
        assert cut == embed, (arch, cut, embed)
        local = tstep.make_train_step(cfg, adamw.OptConfig(),
                                      ctx).abstract_state["params"]
        assert [tuple(t.shape) for t in tree_leaves(local)] == [
            tuple(b.shape) for b in tree_leaves(blocks)]


def test_gather_from_a_group_of_one_moves_nothing():
    """FSDP's gather over an axis of one rank is the identity and counts
    nothing (no process group is needed)."""
    mesh = ProcessMesh(("data", "model"), (1, 1), 0, torch.device("cpu"),
                       {frozenset({"data"}): (None, (0,))})
    x = torch.randn(4, 3, requires_grad=True)
    compat.reset_counts()
    assert compat.gather_from(x, mesh, "data", 0) is x
    assert compat.read_counts() == {}


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "llama3-8b",
                                  "stablelm-1.6b", "starcoder2-3b",
                                  "granite-moe-3b-a800m", "deepseek-v3-671b"])
@pytest.mark.parametrize("m", [2, 4, 8])
def test_each_block_has_the_references_shard_shape(arch, m):
    """``shard_params`` at full width on ``meta``: on every rank of (1,m)
    each leaf's block has ``named_for``'s shard shape, and the ranks'
    blocks tile the leaf (the kv heads whole where m does not divide
    them). No process group is needed."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import abstract_params, tree_leaves
    from repro_torch.models.sharding import (MeshCtx, NamedSharding,
                                             shard_params)
    from repro_torch.train import step as tstep
    cfg = get_config(arch)
    tree = abstract_params(tf.model_template(cfg))
    for r in range(m):
        mesh = ProcessMesh(("data", "model"), (1, m), r,
                           torch.device("cpu"), {})
        specs = tstep.train_state_specs(cfg, MeshCtx(mesh=mesh))["params"]
        named = tstep.named_for(specs, tree, mesh)
        blocks = shard_params(tree, specs, mesh)
        for b, sh, t in zip(tree_leaves(blocks), tree_leaves(named),
                            tree_leaves(tree)):
            assert tuple(b.shape) == sh.shard_shape(t.shape)
            assert isinstance(sh, NamedSharding)
            index = sh.block_index(t.shape)
            assert all(i.stop - i.start == n for i, n in zip(index, b.shape))


def test_make_process_mesh_takes_only_the_named_backends():
    """gloo on the card only when named; nccl never on the CPU."""
    with pytest.raises(ValueError, match="backend 'nccl' for device 'cpu'"):
        make_process_mesh(1, 1, device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="backend 'mpi'"):
        make_process_mesh(1, 1, device="cuda", backend="mpi")


def test_the_process_mesh_answers_as_a_mesh():
    """Row-major coordinates, the shape the spec helpers read, and the
    local axes; no process group is needed to ask."""
    mesh = ProcessMesh(("data", "model"), (2, 3), 4, torch.device("cpu"), {})
    assert mesh.shape == {"data": 2, "model": 3}
    assert mesh.coords_of(4) == (1, 1) and mesh.coord("model") == 1
    assert [mesh.coords_of(r) for r in range(6)] == [
        (d, m) for d in range(2) for m in range(3)]
    assert mesh.with_local(("data",)).local == ("data",)
    with pytest.raises(ValueError, match="not in the mesh"):
        mesh.with_local(("pod",))
    assert compat.is_process_mesh(mesh)
    assert not compat.is_process_mesh(make_mesh(2, 3))


def test_make_process_mesh_refuses_before_joining(monkeypatch):
    """Outside torchrun and without an init method it raises; so does a
    world of the wrong size, before any group is joined."""
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="not under torchrun"):
        make_process_mesh(2, 1, device="cpu")
    with pytest.raises(ValueError, match="needs 2 processes, the world has 3"):
        make_process_mesh(2, 1, device="cpu", init_method="file:///nowhere",
                          rank=0, world_size=3)
    with pytest.raises(ValueError, match="no process route"):
        make_process_mesh(1, 1, device="meta")
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_each_rank_trains_on_its_block_of_the_global_batch():
    """On a (4,1) process mesh the Trainer takes the rows of its ``data``
    coordinate from the same source: the four blocks are the one-device
    batch. No process group is needed to build it."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = reduced(get_config("tinyllama-1.1b"))
    data = DataConfig(seq_len=8, global_batch=8, vocab_size=cfg.vocab_size)

    def trainer(mesh):
        return Trainer(cfg, adamw.OptConfig(), data, TrainerConfig(steps=1),
                       mesh=mesh, device="cpu")
    whole = trainer(None).batch(3)
    blocks = [trainer(ProcessMesh(("data", "model"), (4, 1), r,
                                  torch.device("cpu"), {})).batch(3)
              for r in range(4)]
    for key in ("tokens", "labels"):
        assert (torch.as_tensor(whole[key]) == torch.cat(
            [torch.as_tensor(b[key]) for b in blocks])).all()
    with pytest.raises(ValueError, match="does not split over 3 ranks"):
        trainer(ProcessMesh(("data", "model"), (3, 1), 0,
                            torch.device("cpu"), {}))
