"""Benchmark harness on the PyTorch port: the twin of ``benchmarks/run.py``.
One module per paper table/figure + the kernel micro-bench and the
multi-precision sweep, each the ``torch_*`` twin of the reference's.
Prints ``table,key=value,...`` CSV-ish lines; exits 1 if a module failed.

  PYTHONPATH=src python -m benchmarks.torch_run [--only fig5_matmul]
      [--device cuda]

``--device`` (default: the card; raises without one) is where
``kernel_bench`` and ``multiprecision`` run their kernels; the figure and
table twins are host code. Then the dry-run roofline summary: one
``dryrun_roofline`` row per report of the port's dry run
(``repro_torch.launch.dryrun``, read by ``launch/report.py``'s
``load_all`` from ``--dryrun-dir``, default ``experiments/dryrun_torch``).
"""
import argparse
import sys
import time


def _emit(table: str, row: dict) -> None:
    parts = [table] + [f"{k}={v}" for k, v in row.items()]
    print(",".join(parts), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dryrun-dir", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    from benchmarks import (torch_fig5_matmul, torch_fig6_kernels,
                            torch_kernel_bench, torch_multiprecision,
                            torch_table1_hwacha, torch_table3_efficiency)
    mods = {
        "fig5_matmul": lambda: torch_fig5_matmul.main(_emit),
        "fig6_kernels": lambda: torch_fig6_kernels.main(_emit),
        "table1_hwacha": lambda: torch_table1_hwacha.main(_emit),
        "table3_efficiency": lambda: torch_table3_efficiency.main(_emit),
        "kernel_bench": lambda: torch_kernel_bench.main(_emit, args.device),
        "multiprecision": lambda: torch_multiprecision.main(_emit,
                                                            args.device),
    }
    failures = 0
    for name, run in mods.items():
        if args.only and name != args.only:
            continue
        t0 = time.time()
        try:
            run()
            print(f"# {name} done in {time.time()-t0:.1f}s", flush=True)
        except Exception as e:  # noqa: BLE001
            failures += 1
            print(f"# {name} FAILED: {e}", flush=True)

    # dry-run roofline summary (if the dry run has written its reports)
    try:
        from repro_torch.launch.report import load_all
        rows = load_all(args.dryrun_dir)
        for r in rows:
            rl = r["roofline"]
            _emit("dryrun_roofline", {
                "arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"],
                "compute_s": round(rl["compute_s"], 5),
                "memory_s": round(rl["memory_s"], 5),
                "collective_s": round(rl["collective_s"], 5),
                "bottleneck": rl["bottleneck"],
                "mfu_bound": round(rl["mfu_bound"], 4),
                "useful_ratio": round(rl["useful_ratio"], 3),
            })
        if rows:
            print("# dryrun_roofline done", flush=True)
    except Exception as e:  # noqa: BLE001
        print(f"# dryrun_roofline skipped: {e}", flush=True)

    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
