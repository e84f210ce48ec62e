#!/usr/bin/env python
"""vlint on the PyTorch port: the twin of ``tools/vlint.py``.

Thin driver over ``repro_torch.core.analysis`` (see docs/isa.md, "Static
legality and hazard rules", for the normative code list), printing what
the reference CLI prints. Three modes, combinable; ``--demo`` is the
default when none is given:

  --demo        lint the program compositions built by
                examples/vector_engine_demo.py (and its twin
                examples/torch_vector_engine_demo.py), reconstructed here
                with the same builders and parameters, without importing
                the engines: the CLI stays torch-free and sub-second
  --grid N      generate and lint N differential programs per legal
                SEW x LMUL cell (the generator's lint-clean-by-
                construction contract, runnable standalone)
  --selftest    run the fault-injection registry
                (``repro_torch.testing.faults``): every lint rule is
                confirmed against the runtime in both directions

Exit status 1 on any E-class finding or failed selftest. W-class
findings are reported (``-q`` silences them) but never fail the run.

  PYTHONPATH=src python tools/torch_vlint.py --demo --grid 2 --selftest
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

try:
    from repro_torch.core import analysis, isa
except ImportError:                      # direct invocation, no PYTHONPATH
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.core import analysis, isa


def demo_programs(lanes: int = 4, n: int = 32):
    """The four compositions examples/vector_engine_demo.py executes,
    rebuilt with the same builders/parameters: (name, program, vlmax64,
    mem_words, sregs) tuples ready for ``analysis.lint_program``."""
    from repro_torch.configs.ara import AraConfig
    cfg = AraConfig(lanes=lanes)
    vl = min(32, cfg.vlmax_dp)
    entries = [
        ("matmul (Listing 1)",
         isa.matmul_program(n, 0, n * n, 2 * n * n, t=4,
                            vlmax=cfg.vlmax_dp),
         cfg.vlmax_dp, 3 * n * n, ()),
        ("masked argmax",
         [isa.VSETVL(vl, 32, 1), isa.VLD(4, 0)]
         + isa.argmax_program(4, vl, sd=0, huge_sreg=1),
         cfg.vlmax_dp, 4 * vl + 64, (1,)),     # sentinel staged by caller
        ("native reduction",
         [isa.VSETVL(vl, 64, 1), isa.VLD(5, 0), isa.VREDSUM(8, 5),
          isa.VEXT(1, 8, 0)],
         cfg.vlmax_dp, 4 * vl + 64, ()),
        ("slide+add reduction",
         [isa.VSETVL(vl, 64, 1), isa.VLD(5, 0)]
         + isa.slide_reduce_program(5, vl, sd=1),
         cfg.vlmax_dp, 4 * vl + 64, ()),
    ]
    return entries


def report(name: str, findings, quiet: bool) -> int:
    """Print one program's findings; return its E-class count."""
    errs = analysis.errors(findings)
    warns = analysis.warnings(findings)
    status = "FAIL" if errs else "ok"
    extra = f", {len(warns)} warning(s)" if warns else ""
    print(f"  [{status}] {name}: {len(errs)} error(s){extra}")
    shown = errs if quiet else errs + warns
    for f in shown:
        print(f"    {f}")
    return len(errs)


def run_demo(args) -> int:
    print("vlint --demo: examples/vector_engine_demo.py compositions")
    n_errs = 0
    for name, prog, vlmax64, mem_words, sregs in demo_programs():
        findings = analysis.lint_program(prog, vlmax64,
                                         mem_words=mem_words, sregs=sregs)
        n_errs += report(f"{name} ({len(prog)} insns)", findings,
                         args.quiet)
    return n_errs


def run_grid(args) -> int:
    import numpy as np
    from repro_torch.testing import differential as diff
    print(f"vlint --grid {args.grid}: random differential programs, "
          f"{len(diff.vtype_combos())} cells")
    n_errs = 0
    wtotals: dict = {}
    for sew, lmul in diff.vtype_combos():
        for seed in range(args.grid):
            prog, mem, _ = diff.random_program(
                np.random.RandomState(seed), sew, lmul)
            findings = analysis.lint_program(prog, diff.VLMAX64,
                                             mem_words=len(mem))
            errs = analysis.errors(findings)
            for f in findings:
                wtotals[f.code] = wtotals.get(f.code, 0) + 1
            if errs:
                n_errs += report(
                    f"sew={sew} lmul={isa.format_lmul(lmul)} seed={seed}",
                    findings, quiet=True)
    counts = ", ".join(f"{c}: {k}" for c, k in sorted(wtotals.items()))
    print(f"  {args.grid * len(diff.vtype_combos())} programs linted "
          f"({counts or 'no findings'})")
    print(f"  [{'FAIL' if n_errs else 'ok'}] E-class findings: {n_errs}")
    return n_errs


def run_selftest(args) -> int:
    from repro_torch.testing import faults
    print(f"vlint --selftest: {len(faults.REGISTRY)} fault classes, "
          f"bidirectional")
    failures = 0
    for fault in faults.REGISTRY:
        try:
            rep = faults.verify(fault)
        except AssertionError as e:
            failures += 1
            print(f"  [FAIL] {fault.name}: {e}")
            continue
        print(f"  [ok] {rep['name']} -> {rep['code']}"
              + (f"/{rep['rule']}" if rep["rule"] else "")
              + f" confirmed by {rep['confirm']}")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="vlint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--demo", action="store_true",
                    help="lint the engine-demo program compositions")
    ap.add_argument("--grid", type=int, metavar="N", default=0,
                    help="lint N random programs per legal grid cell")
    ap.add_argument("--selftest", action="store_true",
                    help="run the fault-injection registry")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="suppress W-class finding detail")
    args = ap.parse_args(argv)
    if not (args.demo or args.grid or args.selftest):
        args.demo = True

    bad = 0
    if args.demo:
        bad += run_demo(args)
    if args.grid:
        bad += run_grid(args)
    if args.selftest:
        bad += run_selftest(args)
    print(("vlint: FAIL" if bad else "vlint: clean")
          + f" ({bad} E-class finding(s)/failure(s))")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
