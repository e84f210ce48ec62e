"""PyTorch port, the ``ServingEngine`` under FSDP over processes: one
scheduler on every rank, each data rank its block of the slot pool
(``serving/engine.py``), on 4 gloo ranks on the CPU.

One module fixture spawns 4 gloo ranks for this file's case alone
(``tests/torch_process_cases.py::case_engine_fsdp``; the spawn of
``tests/test_torch_processes.py`` is another, so that ``--dist loadfile``
runs the two on different workers). Every config and mesh of
``ENGINE_FSDP_RUNS`` (reduced tinyllama-1.1b, granite-moe-3b-a800m,
deepseek-v3-671b as configured, xlstm-1.3b and zamba2-7b, all with
``fsdp=True``, on (4,1), and tinyllama-1.1b and deepseek-v3-671b on
(2,2)) serves 6 requests through 4 slots on the rank's blocks of one
seeded init. Held: every rank's tokens equal, and equal to the one-device
engine's on the whole parameters (greedy; on (4,1) also two requests
sampled and the degrade ladder's bf16 rung), tinyllama-1.1b's greedy
tokens to the reference's own one-device engine on its serving fixture's
parameters; each step's collectives, summed over the ranks, kind by kind,
against the dry run's count of the serve step of the same shape (the
differences pinned in ``engine_bytes_want``); no gathered leaf alive
between steps, and only the rank's blocks held; granite-moe-3b-a800m's
prefill where the prompt's own dispatch group drops pairs, and a planted
fault (the prompt as each rank's row, d copies in one group) caught; a
length corrupted in one rank's row and a NaN slot, detected with the same
events at the same tick on every rank. What the engine refuses under
FSDP is held in ``tests/test_torch_processes.py``
(``test_fsdp_refusals_name_their_queue_item``).
"""
import os

import jax
import numpy as np
import pytest
import torch

import torch_process_cases as pc
from repro import serving as jserving
from repro.serving import faults as jfaults

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

# the guard of this file's spawn (it takes ~30 s alone, ~46 s beside the
# suite's other xdist workers)
SPAWN_TIMEOUT_S = 400.0


@pytest.fixture(scope="module")
def res(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("engine_processes"))
    _, params_j = jfaults.fixture()
    torch.save(jax.tree_util.tree_map(np.asarray, params_j),
               os.path.join(out, pc.REFERENCE_ENGINE))
    return pc.spawn(out, cases=pc.ENGINE_CASES,
                    timeout_s=SPAWN_TIMEOUT_S)["engine_fsdp"]


def _run_id(key):
    arch, shape, tag = key
    return f"{arch}-{shape[0]}x{shape[1]}-{tag}"


RUNS = pc.engine_runs()


@pytest.mark.parametrize("key", RUNS, ids=_run_id)
def test_engine_tokens_match_the_one_device_engine(res, key):
    """Every rank's tokens equal to every other rank's and to the
    one-device engine's on the whole parameters, every request done:
    greedy, or with two requests at temperature 0.8 and the bf16 rung
    while the pressure is at 1.25 or above."""
    arch, shape, tag = key
    run = res[arch, shape][tag]
    assert pc.engine_tokens(run) == run["one"]["tokens"]
    if tag == "sampled":
        modes = {s["mode"] for s in run["ranks"][0]["record"]
                 if s["kind"] == "decode"}
        assert modes == {"bf16", "fp32"}, modes


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)], ids=str)
def test_engine_tokens_match_the_references_engine(res, shape):
    """tinyllama-1.1b on the reference's serving fixture's parameters: the
    ranks' greedy tokens equal to the reference's one-device
    ``repro.serving.ServingEngine`` on the same requests."""
    cfg_j, params_j = jfaults.fixture()
    e = pc.ENGINE_FSDP
    eng = jserving.ServingEngine(cfg_j, params_j, slots=e["slots"],
                                 max_seq=e["max_seq"])
    for q in pc.engine_requests(pc.engine_cfg("tinyllama-1.1b")):
        assert eng.submit(jserving.Request(
            uid=q.uid, prompt=q.prompt,
            max_new_tokens=q.max_new_tokens)) is None
    want = {q.uid: [int(t) for t in q.out_tokens]
            for q in eng.run_to_completion()}
    assert pc.engine_tokens(res["tinyllama-1.1b", shape]["greedy"]) == want


@pytest.mark.parametrize("key", RUNS, ids=_run_id)
def test_engine_step_bytes_equal_the_dry_runs_count(res, key):
    """Each prefill, decode and audit of the run, bytes by kind summed
    over the ranks, equal to the dry run's count of the serve step of the
    same shape times the ranks, with the pinned differences of
    ``engine_bytes_want`` (the last logits' gathers, the replicated
    prompt's reductions, the audit's gather of the lengths); on the bf16
    rung the count of the config stored in bfloat16: the gathers move
    the rung's dtype."""
    arch, shape, tag = key
    seen = pc.check_engine_bytes(res[arch, shape][tag], pc.engine_cfg(arch),
                                 shape)
    assert {k.split()[0] for k in seen} == {"prefill", "decode", "audit"}


@pytest.mark.parametrize("key", RUNS, ids=_run_id)
def test_engine_holds_only_its_blocks_between_steps(res, key):
    """No leaf that FSDP gathered is alive before any step or after the
    run on any rank (each forward frees what it gathers), and every
    parameter tree the engine keeps has the shapes of the rank's blocks:
    an engine that gathered the model once and served it whole would
    fail this and the bytes."""
    arch, shape, tag = key
    pc.check_engine_blocks(res[arch, shape][tag])


def test_engine_moe_prefill_where_the_prompt_drops_pairs(res):
    """granite-moe-3b-a800m at capacity factor 0.5: the one-device
    engine's prefills drop pairs (the prompt its own group), each rank's
    prefill drops the same pairs, each decode's group over the ranks'
    rows keeps what the one-device decode keeps, and the tokens agree."""
    run = res["drops"]
    assert pc.engine_drops(run) > 0
    assert pc.engine_dispatch_faults(run) == []
    pc.check_engine_blocks(run)
    assert pc.engine_tokens(run) == run["one"]["tokens"]


def test_engine_prompt_prefilled_as_each_ranks_row_is_caught(res):
    """A planted fault: each prompt prefilled under the decode's context
    (the batch axes local, the prompt as each rank's row: d copies in one
    dispatch group) keeps other pairs than the one-device prefill: the
    first step already differs (the later ones follow from it)."""
    faults = pc.engine_dispatch_faults(res["drops fault"])
    assert faults and faults[0][:2] == (0, "prefill"), faults


@pytest.mark.parametrize("fault", ["corrupt", "nan"])
def test_engine_audit_detects_on_every_rank(res, fault):
    """A KV length corrupted in the row of one rank's block (global slot 3,
    data rank 3's) and a NaN injected into slot 3's logits, at tick 3:
    every rank records the same events at the same tick as the one-device
    engine (``I_KV_BOUNDS``, then ``I_SLOT_LEAK`` of the stale snapshot;
    ``I_NAN_LOGITS``), retries the request, and emits the same tokens."""
    run = res[fault]
    a = pc.ENGINE_AUDIT
    want = [(a["tick"], "I_KV_BOUNDS", a["slot"]),
            (a["tick"], "I_SLOT_LEAK", a["slot"])] if fault == "corrupt" \
        else [(a["tick"], "I_NAN_LOGITS", a["slot"])]
    assert pc.engine_events(run) == want
    assert pc.engine_tokens(run) == run["one"]["tokens"]
