"""Aggregate the dry run's JSONs into the roofline table: the twin of the
reference's ``launch/report.py``, reading ``launch/dryrun.py``'s reports
(the ``fits`` column reads ``fits_h100_80g``; every cell whose report
lists terms in ``count_short`` is named with them under the table, and
they stand beside a hillclimb pick).

Usage: PYTHONPATH=src python -m repro_torch.launch.report
           [--dir experiments/dryrun_torch]
Prints markdown; also selects the three hillclimb candidates
(worst mfu-bound train cell, most collective-bound cell, most
paper-representative cell).
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def load_all(d: str, tag: str = "") -> list[dict]:
    rows = []
    for fn in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(fn) as f:
            r = json.load(f)
        if r.get("skipped"):
            continue
        if (r.get("tag") or "") != tag:
            continue
        rows.append(r)
    return rows


def fmt_row(r: dict) -> str:
    rl = r["roofline"]
    mem = r.get("memory_analysis") or {}
    arg_gb = (mem.get("argument_size_in_bytes") or 0) / 1e9
    tmp_gb = (mem.get("temp_size_in_bytes") or 0) / 1e9
    return ("| {arch} | {shape} | {mesh} | {c:.4f} | {m:.4f} | {x:.4f} | "
            "{bot} | {useful:.2f} | {mfu:.3f} | {arg:.1f}+{tmp:.1f} | {fit} |"
            .format(arch=r["arch"], shape=r["shape"], mesh=r["mesh"],
                    c=rl["compute_s"], m=rl["memory_s"],
                    x=rl["collective_s"], bot=rl["bottleneck"][:4],
                    useful=min(rl["useful_ratio"], 99.0),
                    mfu=rl["mfu_bound"], arg=arg_gb, tmp=tmp_gb,
                    fit="Y" if r.get("fits_h100_80g") else "N"))


HEADER = ("| arch | shape | mesh | compute_s | memory_s | collective_s | "
          "bottleneck | useful | mfu_bound | state+temp GB/dev | fits |\n"
          "|---|---|---|---|---|---|---|---|---|---|---|")


def pick_hillclimb(rows: list[dict]) -> dict:
    single = [r for r in rows if r["mesh"] == "pod16x16"]
    train = [r for r in single if r["kind"] == "train"]
    worst = min(train, key=lambda r: r["roofline"]["mfu_bound"])
    coll = max(single, key=lambda r: (r["roofline"]["collective_s"]
                                      / max(r["roofline"]["achievable_step_s"],
                                            1e-12)))
    # most representative of the paper's technique: the lane-scalable dense
    # matmul-dominated training cell on the largest dense model
    rep = next(r for r in single
               if r["arch"] == "llama3-8b" and r["shape"] == "train_4k")
    return {"worst_mfu": worst, "most_collective": coll,
            "paper_representative": rep}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    rows = load_all(args.dir, args.tag)
    rows.sort(key=lambda r: (r["arch"], r["shape"], r["mesh"]))
    print(HEADER)
    for r in rows:
        print(fmt_row(r))
    for r in rows:
        if r.get("count_short"):
            print(f"count short (ROADMAP Queue C): {r['arch']} {r['shape']} "
                  f"{r['mesh']}: {'; '.join(r['count_short'])}")
    print()
    hc = pick_hillclimb(rows)
    for k, r in hc.items():
        rl = r["roofline"]
        mark = f" (count short: {'; '.join(r['count_short'])})" \
            if r.get("count_short") else ""
        print(f"hillclimb[{k}]: {r['arch']} {r['shape']} {r['mesh']} "
              f"bottleneck={rl['bottleneck']} step={rl['achievable_step_s']:.4g}s "
              f"mfu={rl['mfu_bound']:.3f}{mark}")


if __name__ == "__main__":
    main()
