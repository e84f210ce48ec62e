"""Long-context attention benchmark + correctness gates on the PyTorch port.
The twin of ``benchmarks/attention_long.py``: the same sweep, paths, rows,
gates and exit rule, on the card (``--device``, default ``cuda``; raises
without one).

Three attention paths over a sequence sweep, forward AND forward+backward,
through ``repro_torch.models.attention.chunked_attention``:

- ``quadratic``  — one materialized masked softmax (threshold fast path,
  the kernel route off). Only run while its (B,H,S,S) fp32 score tensor
  fits ``--quadratic-budget-mb``; the largest fitting S is the
  *quadratic ceiling* the blockwise path must beat.
- ``blockwise``  — the triangular q-block loop over KV chunks (kernel
  route off) under the "dots" checkpoint policy.
- ``kernel``     — the hand-written CUDA blockwise-attention kernels
  (forward, and the dQ and dK/dV kernels in the backward). Timed only on
  the card: on the CPU the wrapper runs its plain versions, so its rows
  are emitted as ``skipped`` with the reason.

Each path is timed over the reference's 2 iterations after one warm call:
between two CUDA events on the card, by the host clock on the CPU. Per
row: seconds, tokens/s, and ``score_mb`` — the peak-memory proxy (bytes
of attention scores the path materializes at once: S*S for quadratic,
S*chunk for blockwise, bq*bk per block for the kernel).

Gates (exit nonzero on failure):

1. backward-matches-reference: autograd through ``ops.flash_attention``
   (on the card the CUDA forward and backward kernels; on the CPU their
   plain versions) against a plain quadratic softmax's gradients at
   1e-5 (fp32) and 2e-2 (bf16). The reference's ``interpret=True`` has
   no twin.
2. causal-skip probe: the forward's trip count equals the triangular
   bound n_k*(n_k+1)/2 per (batch*head, q-sweep).
3. throughput: on the card, kernel >= blockwise fwd+bwd tokens/s at
   ``--gate-seq`` (the reference's TPU form); on the CPU, blockwise >=
   quadratic (its CPU form).
4. long-context train step: one train step of the reduced tinyllama-1.1b
   at 4x the quadratic ceiling (``AttnOverrides(flash="auto", chunk=512,
   block_remat="dots")``: the kernels on the card, the checkpointed
   blockwise loop on the CPU) completes with a finite loss.

Results land in ``torch_BENCH_attention.json``. Usage:

  PYTHONPATH=src python -m benchmarks.torch_attention_long [--smoke]
      [--out torch_BENCH_attention.json] [--quadratic-budget-mb 64]
      [--gate-seq auto] [--skip-train-gate] [--device cuda]
"""
import argparse
import json
import math
import time

import numpy as np
import torch

from benchmarks.torch_timing import seconds_per_call
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import attention as A

FULL_SEQS = [1024, 2048, 4096, 8192, 16384, 32768]
SMOKE_SEQS = [512, 1024, 2048, 4096]
ITERS = 2                      # the reference's iteration count
KERNEL_BLOCK = 128             # ops.flash_attention's default bq = bk


def quadratic_score_bytes(b: int, h: int, s: int) -> int:
    """fp32 (B,H,S,S) score tensor the materialized path allocates."""
    return b * h * s * s * 4


def quadratic_ceiling(budget_mb: float, b: int, h: int) -> int:
    """Largest power-of-two S whose score tensor fits the budget."""
    s = 256
    while quadratic_score_bytes(b, h, 2 * s) <= budget_mb * 2**20:
        s *= 2
    return s


def _inputs(rng, b, s, h, d, dtype, device):
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, d)))
               .to(device, dtype) for _ in range(3))
    pos = torch.arange(s, dtype=torch.int32, device=device)[None] \
        .expand(b, s)
    valid = torch.ones((b, s), dtype=torch.bool, device=device)
    return q, k, v, pos, valid


def _path_fn(path: str, pos, valid, s: int, chunk: int):
    """(q,k,v) -> out for one measured attention path."""
    if path == "quadratic":
        kw = dict(threshold=s, use_flash="off")
    elif path == "blockwise":
        kw = dict(threshold=min(chunk, s // 2), chunk=min(chunk, s // 2),
                  use_flash="off", block_remat="dots")
    else:  # kernel
        kw = dict(use_flash="on")
    return lambda q, k, v: A.chunked_attention(q, k, v, pos, valid,
                                               triangular=True, **kw)


def _fwd_bwd(fn, q, k, v):
    """() -> dq, dk, dv of sum(fn(q, k, v)) in fp32."""
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]

    def call():
        out = fn(*leaves).float().sum()
        return torch.autograd.grad(out, leaves)
    return call


def bench_rows(seqs, *, b, h, d, chunk, budget_mb, dtype=torch.bfloat16,
               emit=print, device=None):
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    rows = []
    rng = np.random.default_rng(0)
    ceiling = quadratic_ceiling(budget_mb, b, h)
    for s in seqs:
        q, k, v, pos, valid = _inputs(rng, b, s, h, d, dtype, dev)
        for path in ("quadratic", "blockwise", "kernel"):
            row = {"path": path, "seq": s, "tokens": b * s}
            if path == "quadratic" and s > ceiling:
                row["skipped"] = (f"score tensor "
                                  f"{quadratic_score_bytes(b, h, s)/2**20:.0f}"
                                  f"MB > budget {budget_mb}MB")
            elif path == "kernel" and not on_card:
                row["skipped"] = ("CPU host: the wrapper would time the "
                                  "kernels' plain versions (gates 1, 2 and "
                                  "4 below still take the kernel route)")
            else:
                fn = _path_fn(path, pos, valid, s, chunk)
                with torch.no_grad():
                    t_f = seconds_per_call(lambda: fn(q, k, v), dev, ITERS)
                t_fb = seconds_per_call(_fwd_bwd(fn, q, k, v), dev, ITERS)
                score_b = {"quadratic": quadratic_score_bytes(b, h, s),
                           "blockwise": b * h * s * min(chunk, s // 2) * 4,
                           "kernel": b * h * KERNEL_BLOCK ** 2 * 4}[path]
                row.update(
                    fwd_s=round(t_f, 5), fwd_bwd_s=round(t_fb, 5),
                    fwd_tokens_per_s=round(b * s / t_f, 1),
                    fwd_bwd_tokens_per_s=round(b * s / t_fb, 1),
                    score_mb=round(score_b / 2**20, 2))
            rows.append(row)
            emit("attention_long," +
                 ",".join(f"{kk}={vv}" for kk, vv in row.items()))
        del q, k, v
    return rows, ceiling


# ---------------------------------------------------------------------------
# Gates
# ---------------------------------------------------------------------------


def attention_ref(q, k, v, *, causal: bool = True, kv_valid=None):
    """Plain quadratic attention: q (B,H,Sq,D); k,v (B,H,Sk,D); kv_valid
    (B,Sk) bool or None. Scores in fp32; causal masking compares raw
    row/column indices, and rows with NO valid key output zeros (the
    kernel's conventions, as the reference's ``flash_attention_ref``)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    sq, sk = q.shape[2], k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    mask = torch.ones((q.shape[0], 1, sq, sk), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask = mask & (torch.arange(sq, device=q.device)[:, None]
                       >= torch.arange(sk, device=q.device)[None, :])
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, None, :]
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(dim=-1, keepdim=True), p, torch.zeros_like(p))
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


def gate_backward_matches_ref(emit=print, device=None):
    """Gate 1: the kernel route's grads vs the plain oracle's grads."""
    dev = resolve_device(device)
    rng = np.random.default_rng(1)
    results = []
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        for causal in (True, False):
            b, h, sq, d = 2, 2, 192, 32      # ragged: not a block multiple
            q, k, v = (torch.from_numpy(rng.standard_normal((b, h, sq, d)))
                       .to(dev, dtype) for _ in range(3))
            kv_valid = torch.from_numpy(rng.random((b, sq)) < 0.9).to(dev)

            def grads(attn, **kw):
                leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
                o = attn(*leaves, kv_valid=kv_valid, causal=causal, **kw)
                return torch.autograd.grad(
                    torch.sum(o.float() * 0.01), leaves)

            gk = grads(ops.flash_attention, bq=64, bk=64)
            gr = grads(attention_ref)
            err = max(float((a.float() - b_.float()).abs().max())
                      for a, b_ in zip(gk, gr))
            ok = err <= tol
            results.append(ok)
            emit(f"attention_gate,gate=backward_matches_ref,"
                 f"dtype={str(dtype).replace('torch.', '')},causal={causal},"
                 f"max_err={err:.2e},tol={tol},ok={ok}")
    return all(results)


def gate_causal_skip(emit=print, device=None):
    """Gate 2: issued-iteration probe equals the triangular bound."""
    from repro_torch.kernels.attention import flash_attention_probe
    dev = resolve_device(device)
    rng = np.random.default_rng(2)
    b, h, s, d, blk = 2, 2, 256, 32, 64
    q = torch.from_numpy(rng.standard_normal((b, h, s, d))).to(
        dev, torch.float32)
    with torch.no_grad():
        _, probe = flash_attention_probe(q, q, q, causal=True, bq=blk,
                                         bk=blk)
    issued = int(probe.sum())
    n = s // blk
    tri = b * h * n * (n + 1) // 2
    full = b * h * n * n
    ok = issued == tri
    emit(f"attention_gate,gate=causal_skip,issued={issued},"
         f"triangular={tri},full_grid={full},ok={ok}")
    return ok


def gate_blockwise_beats_quadratic(rows, gate_seq, emit=print, device=None):
    """Gate 3: at the gate seq, the streaming path must not lose to the
    materialized one (CPU); on the card: kernel must beat blockwise."""
    on_card = resolve_device(device).type == "cuda"
    fast, slow = ("kernel", "blockwise") if on_card \
        else ("blockwise", "quadratic")
    by = {(r["path"], r["seq"]): r for r in rows}
    rf, rs = by.get((fast, gate_seq)), by.get((slow, gate_seq))
    if not rf or not rs or "skipped" in rf:
        emit(f"attention_gate,gate=throughput,ok=skip,"
             f"reason=no {fast} row at seq {gate_seq}")
        return True
    if "skipped" in rs:  # the slow path could not even run: trivially won
        emit(f"attention_gate,gate=throughput,ok=True,"
             f"reason={slow} skipped at seq {gate_seq}")
        return True
    ratio = rf["fwd_bwd_tokens_per_s"] / rs["fwd_bwd_tokens_per_s"]
    ok = ratio >= 1.0
    emit(f"attention_gate,gate=throughput,seq={gate_seq},fast={fast},"
         f"slow={slow},ratio={ratio:.2f},ok={ok}")
    return ok


def gate_long_train_step(train_seq, emit=print, device=None):
    """Gate 4: one train step at 4x the quadratic ceiling completes."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import init_params
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_lib

    dev = resolve_device(device)
    cfg = reduced(get_config("tinyllama-1.1b"))
    params = init_params(tf.model_template(cfg),
                         torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    toks = torch.randint(0, cfg.vocab_size, (1, train_seq), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    attn = step_lib.AttnOverrides(flash="auto", chunk=512,
                                  block_remat="dots")
    bundle = step_lib.make_train_step(cfg, adamw.OptConfig(), attn=attn)
    state = {"params": params, "opt": adamw.init(adamw.OptConfig(), params)}
    t0 = time.perf_counter()
    _, metrics = bundle.step_fn(state, batch)
    loss = float(metrics["loss"])
    ok = math.isfinite(loss)
    emit(f"attention_gate,gate=long_train_step,seq={train_seq},"
         f"loss={loss:.4f},wall_s={time.perf_counter()-t0:.1f},ok={ok}")
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default="torch_BENCH_attention.json")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=1024)
    ap.add_argument("--quadratic-budget-mb", type=float, default=None,
                    help="score-tensor budget defining the quadratic "
                    "ceiling (default 64 smoke / 1024 full)")
    ap.add_argument("--gate-seq", type=int, default=None,
                    help="seq for the throughput gate (default: largest "
                    "swept seq, >= 8192 in full runs)")
    ap.add_argument("--skip-train-gate", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    seqs = SMOKE_SEQS if args.smoke else FULL_SEQS
    budget = args.quadratic_budget_mb or (64 if args.smoke else 1024)
    rows, ceiling = bench_rows(seqs, b=args.batch, h=args.heads,
                               d=args.head_dim, chunk=args.chunk,
                               budget_mb=budget, device=dev)
    gate_seq = args.gate_seq or seqs[-1]
    train_seq = 4 * ceiling

    gates = {
        "backward_matches_ref": gate_backward_matches_ref(device=dev),
        "causal_skip": gate_causal_skip(device=dev),
        "throughput": gate_blockwise_beats_quadratic(rows, gate_seq,
                                                     device=dev),
    }
    if not args.skip_train_gate:
        gates["long_train_step"] = gate_long_train_step(train_seq,
                                                        device=dev)

    res = {"backend": dev.type,
           "device": torch.cuda.get_device_name(dev)
           if dev.type == "cuda" else "cpu",
           "smoke": args.smoke,
           "quadratic_budget_mb": budget, "quadratic_ceiling": ceiling,
           "train_gate_seq": train_seq, "gate_seq": gate_seq,
           "rows": rows, "gates": gates}
    with open(args.out, "w") as f:
        json.dump(res, f, indent=2)
    print(f"wrote {args.out}")
    bad = [g for g, ok in gates.items() if not ok]
    if bad:
        raise SystemExit(f"attention gates FAILED: {bad}")
    return res


if __name__ == "__main__":
    main()
