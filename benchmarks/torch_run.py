"""Benchmark harness on the PyTorch port: the twin of ``benchmarks/run.py``.
One module per paper table/figure + the kernel micro-bench and the
multi-precision sweep, each the ``torch_*`` twin of the reference's.
Prints ``table,key=value,...`` CSV-ish lines; exits 1 if a module failed.

  PYTHONPATH=src python -m benchmarks.torch_run [--only fig5_matmul]
      [--device cuda]

``--device`` (default: the card; raises without one) is where
``kernel_bench`` and ``multiprecision`` run their kernels; the figure and
table twins are host code. The reference's dry-run roofline summary reads
the XLA dry-run farm's reports (``launch/report.py``), whose twin waits
for the XLA readers' slice (ROADMAP Queue A13b), so that section prints its
skip line.
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

    print("# dryrun_roofline skipped: the dry-run farm's reports "
          "(launch/report.py) read compiled XLA HLO over a device mesh; "
          "their twin, a FLOP/byte count of a torch step, waits for ROADMAP "
          "Queue A13b (the XLA readers)", flush=True)

    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
