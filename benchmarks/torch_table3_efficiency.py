"""Table III — performance, power, efficiency per instance; model (cycle
model x nominal clock; linear power fit) vs published values.

The twin of ``benchmarks/table3_efficiency.py`` on the PyTorch port's copies of
``configs/ara.py`` and ``core/perfmodel.py`` (pure host, no device):

  PYTHONPATH=src python benchmarks/torch_table3_efficiency.py
"""
from repro_torch.configs.ara import (AraConfig, NOMINAL_CLOCK_GHZ, PAPER_TABLE3)
from repro_torch.core import perfmodel as pm


def rows():
    out = []
    for lanes in (2, 4, 8, 16):
        cfg = AraConfig(lanes=lanes)
        clock = NOMINAL_CLOCK_GHZ[lanes]
        paper = PAPER_TABLE3[lanes]
        perfs = {"matmul": pm.matmul_perf(cfg, 256),
                 "dconv": pm.dconv_perf(cfg),
                 "daxpy": pm.daxpy_perf(cfg, 256)}
        for i, (k, perf) in enumerate(perfs.items()):
            g = perf.gflops(clock)
            p_mw = pm.power_mw(k, lanes)
            out.append({
                "lanes": lanes, "kernel": k, "clock_ghz": clock,
                "model_gflops": round(g, 2), "paper_gflops": paper[i],
                "model_power_mw": round(p_mw, 1), "paper_power_mw": paper[3 + i],
                "model_eff_gflops_w": round(g / (p_mw / 1000), 1),
                "paper_eff_gflops_w": paper[6 + i],
            })
    return out


def main(emit):
    for r in rows():
        emit("table3_efficiency", r)


if __name__ == "__main__":
    main(lambda table, row: print(",".join(
        [table] + [f"{k}={v}" for k, v in row.items()]), flush=True))
