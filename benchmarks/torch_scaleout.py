"""Cluster scale-out sweep (AraXL) on the PyTorch port: the twin of
``benchmarks/scaleout.py``. Total lanes 4 -> 64 x cluster shapes.

At a fixed total lane count, what does carving the lanes into clusters
cost (interconnect hops) and buy (per-cluster VLSU arbitration)? Two
rulers per point, both pure host (the port's copies of the reference's
modules, so the rows equal the reference's):

1. ``predicted`` — the closed-form analytical model
   (``perfmodel.matmul_cycles`` / ``reduction_cycles`` with
   ``clusters=``).
2. ``achieved`` — the event-driven instruction scoreboard
   (``vector_engine.simulate_timing(clusters=)``) over the real
   strip-mined programs (``isa.matmul_program`` and a VLD+VREDSUM loop).

The run fails if any achieved/predicted ratio leaves ``[1/max_ratio,
max_ratio]`` (default 2.6). Shapes swept per total-lane count N: 1xN
(flat, the single-core Ara), 2xN/2, 4xN/4 (AraXL-style grids).

``--verify`` additionally runs the functional smoke in this process: the
port's ClusterEngine at each requested topology executes random
differential programs on ``--device`` (default ``cuda``; ``cpu`` runs it
on the CPU) and must match the port's ReferenceEngine on the same device
bit for bit (the two-stage fold over clusters and lanes is algebraically
the flat one — this catches it drifting).

Results land in ``BENCH_scaleout.json`` and print as
``scaleout,key=value,...`` lines.

  PYTHONPATH=src python benchmarks/torch_scaleout.py \
      [--matmul-n 128] [--reduce-n 4096] [--max-ratio 2.0] \
      [--verify] [--verify-topologies 2x2,4x2] [--device cuda] \
      [--out BENCH_scaleout.json]
"""
import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs.ara import AraConfig
from repro_torch.core import isa
from repro_torch.core import perfmodel as pm
from repro_torch.core import staging
from repro_torch.core.cluster import ClusterEngine
from repro_torch.core.vector_engine import ReferenceEngine, simulate_timing
from repro_torch.testing import differential as diff

TOTAL_LANES = (4, 8, 16, 32, 64)
CLUSTER_SHAPES = (1, 2, 4)


def reduction_program(n, vlmax, sew=64):
    """Strip-mined VLD + VREDSUM loop, the program-level twin of
    perfmodel.reduction_cycles."""
    prog, c = [], 0
    while c < n:
        vl = min(n - c, vlmax)
        prog += [isa.VSETVL(vl, sew), isa.VLD(8, c), isa.VREDSUM(16, 8)]
        c += vl
    return prog


def sweep(matmul_n=128, reduce_n=4096):
    rows = []
    for lanes in TOTAL_LANES:
        cfg = AraConfig(lanes=lanes)
        mm_prog = isa.matmul_program(matmul_n, 0, matmul_n ** 2,
                                     2 * matmul_n ** 2, t=4, vlmax=matmul_n)
        rd_prog = reduction_program(reduce_n, cfg.vlmax(64, 1))
        for clusters in CLUSTER_SHAPES:
            if lanes % clusters or clusters > lanes:
                continue
            lpc = lanes // clusters
            for kern, prog, vlm, pred in (
                    ("matmul", mm_prog, matmul_n,
                     pm.matmul_cycles(cfg, matmul_n, clusters=clusters)),
                    ("reduction", rd_prog, cfg.vlmax(64, 1),
                     pm.reduction_cycles(cfg, reduce_n, clusters=clusters))):
                ach = simulate_timing(prog, cfg, vlmax=vlm,
                                      clusters=clusters).cycles
                rows.append({
                    "kernel": kern, "lanes": lanes, "clusters": clusters,
                    "lanes_per_cluster": lpc,
                    "shape": f"{clusters}x{lpc}",
                    "n": matmul_n if kern == "matmul" else reduce_n,
                    "predicted_cycles": round(pred, 1),
                    "achieved_cycles": round(ach, 1),
                    "achieved_over_predicted": round(ach / pred, 3),
                    "cluster_hop_cycles": pm.CLUSTER_HOP
                    * pm.tree_hops(clusters),
                })
    # annotate each row with its cost relative to the flat (1xN) shape
    # at the same kernel/lane count — the crossover chart
    flat = {(r["kernel"], r["lanes"]): r for r in rows if r["clusters"] == 1}
    for r in rows:
        f = flat[(r["kernel"], r["lanes"])]
        r["vs_flat"] = {"predicted": round(
            r["predicted_cycles"] / f["predicted_cycles"], 3),
            "achieved": round(r["achieved_cycles"] / f["achieved_cycles"], 3)}
    return rows


def check_rows(rows, max_ratio):
    """Cross-validation + topology-sanity gates over the sweep.

    Deliberately NOT asserted: "flat (1xN) is always cheapest". It isn't
    — at high lane counts both rulers agree clustering WINS on
    memory-dominated kernels, because per-cluster VLSU arbitration
    (C_MEM_LANE x lanes/clusters) shrinks faster than the log-depth hop
    term grows. That crossover is the AraXL motivation and the sweep's
    point; the JSON charts it via ``vs_flat``.
    """
    errs = []
    for r in rows:
        q = r["achieved_over_predicted"]
        if not (1.0 / max_ratio <= q <= max_ratio):
            errs.append(f"{r['kernel']} {r['shape']}: achieved/predicted "
                        f"{q} outside [{1 / max_ratio:.2f}, {max_ratio}]")
    # the reduction's serial tail can never be clustered away: its
    # closed form is RED_HOP*tree_hops(lpc) + CLUSTER_HOP*tree_hops(c)
    # per strip, strictly increasing in c because CLUSTER_HOP > RED_HOP
    # — if this ever inverts, a hop-term sign flipped somewhere
    by_point = {}
    for r in rows:
        if r["kernel"] == "reduction":
            by_point.setdefault(r["lanes"], []).append(r)
    for lanes, pts in by_point.items():
        pts = sorted(pts, key=lambda p: p["clusters"])
        for a, b in zip(pts, pts[1:]):
            if b["predicted_cycles"] < a["predicted_cycles"]:
                errs.append(
                    f"reduction lanes={lanes}: predicted cycles fell "
                    f"{a['shape']}->{b['shape']} "
                    f"({a['predicted_cycles']} -> {b['predicted_cycles']}) "
                    f"— the inter-cluster hop term lost its cost")
    return errs


# ---------------------------------------------------------------------------
# --verify: functional ClusterEngine == ReferenceEngine smoke, in process
# ---------------------------------------------------------------------------


def _bits(x):
    x = np.asarray(x)
    return x.view(f"u{x.itemsize}")


def _same_bits(a, b) -> bool:
    """Equal dtype, shape and bit patterns (any NaN matches any NaN)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    same = _bits(a) == _bits(b)
    if a.dtype.kind == "f":
        same |= np.isnan(a) & np.isnan(b)
    return bool(np.all(same))


def run_verify(topologies, device="cuda"):
    """Per topology, a fresh runner cache, the port's ReferenceEngine and
    ClusterEngine (float64) on ``device`` over 2 random programs per cell
    of SEW {64, 32, 8} x LMUL {1, 2}; every memory word and scalar
    register bit-equal, one runner built per engine."""
    out = {"topologies": [f"{c}x{l}" for c, l in topologies],
           "device": str(device), "bit_exact": True, "checked": {},
           "seconds": {}}
    for clusters, lpc in topologies:
        cache = staging.TraceCache()
        ref = ReferenceEngine(AraConfig(lanes=2), vlmax=diff.VLMAX64,
                              dtype=torch.float64, cache=cache,
                              device=device)
        clu = ClusterEngine(AraConfig(lanes=2), clusters=clusters,
                            lanes_per_cluster=lpc, vlmax=diff.VLMAX64,
                            dtype=torch.float64, cache=cache, device=device)
        want = []

        def batch_ref(progs, mems, sregs):
            want.append(diff.engine_batch(ref)(progs, mems, sregs))
            return want[-1]

        def batch_clu(progs, mems, sregs):
            got = diff.engine_batch(clu)(progs, mems, sregs)
            (m1, s1), (m2, s2) = got, want[-1]
            for i in range(len(m1)):
                if not (_same_bits(m1[i], m2[i]) and _same_bits(
                        [s1[i][k] for k in range(32)],
                        [s2[i][k] for k in range(32)])):
                    raise AssertionError(f"program {i} differs in its bits")
            return got

        t0 = time.perf_counter()
        checked = diff.run_cells(
            batch_ref, batch_clu,
            diff.cells(2, sews=(64, 32, 8), lmuls=(1, 2)), n_ops=8,
            tol={64: 0, 32: 0, 16: 0, 8: 0},
            label=f"scaleout-verify-{clusters}x{lpc}")
        if cache.stats.compiles != 2:
            raise AssertionError(f"{cache.stats}: one runner per engine")
        tag = f"{clusters}x{lpc}"
        out["checked"][tag] = checked
        out["seconds"][tag] = time.perf_counter() - t0
        print(f"SCALEOUT_VERIFY_OK {tag} {checked}", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--matmul-n", type=int, default=128)
    ap.add_argument("--reduce-n", type=int, default=4096)
    ap.add_argument("--max-ratio", type=float, default=2.6,
                    help="fail if achieved/predicted leaves [1/r, r]; "
                         "the sweep spans 0.42..2.15 at the defaults "
                         "(the scoreboard sees chaining the closed form "
                         "charges, and vice versa) — this is a same-"
                         "order cross-validation, not a curve fit")
    ap.add_argument("--verify", action="store_true",
                    help="also run the ClusterEngine-vs-ReferenceEngine "
                         "bit-exact smoke on --device (in process)")
    ap.add_argument("--verify-topologies", default="2x2,4x2",
                    help="comma list of CxL cluster shapes for --verify")
    ap.add_argument("--device", default="cuda",
                    help="torch device of --verify's engines "
                         "(default: cuda)")
    ap.add_argument("--out", default="BENCH_scaleout.json")
    args = ap.parse_args()

    rows = sweep(matmul_n=args.matmul_n, reduce_n=args.reduce_n)
    for r in rows:
        print("scaleout," + ",".join(f"{k}={v}" for k, v in r.items()),
              flush=True)
    errs = check_rows(rows, args.max_ratio)

    res = {"bench": "scaleout",
           "config": {"matmul_n": args.matmul_n, "reduce_n": args.reduce_n,
                      "max_ratio": args.max_ratio,
                      "total_lanes": list(TOTAL_LANES),
                      "cluster_shapes": list(CLUSTER_SHAPES)},
           "rows": rows}
    if args.verify:
        topos = [tuple(int(x) for x in t.split("x"))
                 for t in args.verify_topologies.split(",")]
        res["verify"] = run_verify(topos, device=args.device)

    with open(args.out, "w") as f:
        json.dump(res, f, indent=2)
    print(f"wrote {args.out}")
    if errs:
        raise SystemExit("scaleout FAILED:\n  " + "\n  ".join(errs))
    print("scaleout OK")


if __name__ == "__main__":
    main()
