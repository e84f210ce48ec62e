"""Ara vector-engine demo on the PyTorch port: the twin of
``examples/vector_engine_demo.py``. It runs the paper's Listing-1 matmul on
the RVV-0.5 ISA through the port's ReferenceEngine, reports cycles from
the scoreboard vs the closed-form model vs Eq. (2), and the three execution
phases of Fig. 11; then the RVV 1.0 masking/reduction upgrade: a vectorized
argmax composed from compares, VMERGE and VREDMAX/VREDMIN, and the native
reduction's scoreboard cycles vs the retired O(log n) slide+add workaround.

  PYTHONPATH=src python examples/torch_vector_engine_demo.py \
      [--lanes 4 --n 32] [--device cpu]

The engine runs on the card by default (``--device cuda``) and exits
non-zero without one; ``--device cpu`` runs it on the CPU. The engine
stores float64 on either device.
"""
import argparse

import numpy as np

from repro_torch.configs.ara import AraConfig, NOMINAL_CLOCK_GHZ
from repro_torch.core import isa, perfmodel as pm
from repro_torch.core.vector_engine import ReferenceEngine, simulate_timing


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=4, choices=(2, 4, 8, 16))
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (default: cuda)")
    args = ap.parse_args()
    cfg = AraConfig(lanes=args.lanes)
    eng = ReferenceEngine(cfg, device=args.device)
    n = args.n

    rng = np.random.RandomState(0)
    A, B, C = rng.randn(n, n), rng.randn(n, n), rng.randn(n, n)
    mem = np.concatenate([A.ravel(), B.ravel(), C.ravel()])
    prog = isa.matmul_program(n, 0, n * n, 2 * n * n, t=4,
                              vlmax=cfg.vlmax_dp)
    print(f"Listing-1 matmul {n}x{n} on {cfg.lanes} lanes: "
          f"{len(prog)} instructions, VLMAX={cfg.vlmax_dp} DP elements")

    out, _ = eng.run(prog, mem)
    err = np.abs(out[2 * n * n:].reshape(n, n) - (A @ B + C)).max()
    print(f"semantics vs numpy: max err {err:.2e}")

    tr = simulate_timing(prog, cfg)
    cyc_model = pm.matmul_cycles(cfg, n)
    flops = 2 * n ** 3
    pi = cfg.peak_dp_flop_per_cycle
    print(f"scoreboard:  {tr.cycles:8.0f} cycles  "
          f"({flops/tr.cycles:.2f} FLOP/c, util {flops/tr.cycles/pi:.1%})")
    print(f"closed form: {cyc_model:8.0f} cycles  "
          f"({flops/cyc_model:.2f} FLOP/c, util {flops/cyc_model/pi:.1%})")
    print(f"Eq.(2) issue bound: {pm.matmul_issue_bound(cfg, n):.2f} FLOP/c; "
          f"roofline: {pm.matmul_roofline(cfg, n):.2f} FLOP/c")
    ghz = NOMINAL_CLOCK_GHZ[cfg.lanes]
    print(f"@ {ghz} GHz (Table III corner): "
          f"{flops/cyc_model*ghz:.2f} DP-GFLOPS")
    print("unit occupancy (Fig. 11 analogue):",
          {k: round(v, 0) for k, v in tr.unit_busy.items()})

    # --- masks + reductions (RVV 1.0 upgrade) ---------------------------
    vl = min(32, cfg.vlmax_dp)
    vals = rng.randn(vl)
    vals[vl // 3] = vals[2 * vl // 3] = vals.max() + 1.0   # tie
    mem2 = np.zeros(4 * vl + 64)
    mem2[:vl] = vals
    mem2[vl:2 * vl] = np.arange(vl, dtype=float)           # the iota
    amax = [isa.VSETVL(vl, 32, 1), isa.VLD(4, 0)] \
        + isa.argmax_program(4, vl, sd=0, huge_sreg=1)
    _, s = eng.run(amax, mem2, sregs={1: float(vl + 9)})
    print(f"\nmasked argmax (VREDMAX+VMFEQ+VMERGE+VREDMIN) over {vl} "
          f"elements: {int(s[0])} == numpy's {int(np.argmax(vals))} "
          f"(first-index tie rule)")

    red_native = [isa.VSETVL(vl, 64, 1), isa.VLD(5, 0), isa.VREDSUM(8, 5),
                  isa.VEXT(1, 8, 0)]
    red_slides = [isa.VSETVL(vl, 64, 1), isa.VLD(5, 0)] \
        + isa.slide_reduce_program(5, vl, sd=1)
    t_nat = simulate_timing(red_native, cfg)
    t_sld = simulate_timing(red_slides, cfg)
    print(f"sum-reduce of {vl} elements, scoreboard cycles: "
          f"native VREDSUM {t_nat.cycles:.0f} vs slide+add workaround "
          f"{t_sld.cycles:.0f} ({t_sld.cycles / t_nat.cycles:.1f}x; "
          f"model {pm.reduction_cycles(cfg, vl):.0f})")
    print(f"engine device: {args.device}")


if __name__ == "__main__":
    main()
