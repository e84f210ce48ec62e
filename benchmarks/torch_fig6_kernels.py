"""Fig. 6 — the three kernels (AXPY n=256, MATMUL 256x256, CONV GoogLeNet-1)
vs the roofline, per lane count; §V-B/§V-C published points included.

The twin of ``benchmarks/fig6_kernels.py`` on the PyTorch port's copies of
``configs/ara.py`` and ``core/perfmodel.py`` (pure host, no device):

  PYTHONPATH=src python benchmarks/torch_fig6_kernels.py
"""
from repro_torch.configs.ara import (AraConfig, PAPER_CONV_FLOP_PER_CYCLE,
                               PAPER_DAXPY_FLOP_PER_CYCLE)
from repro_torch.core import perfmodel as pm

INTENSITY = {"daxpy": 1.0 / 12.0, "matmul": 16.0, "conv": 34.9}


def rows():
    out = []
    for lanes in (2, 4, 8, 16):
        cfg = AraConfig(lanes=lanes)
        perfs = {
            "daxpy": pm.daxpy_perf(cfg, 256),
            "matmul": pm.matmul_perf(cfg, 256),
            "conv": pm.dconv_perf(cfg),
        }
        for k, perf in perfs.items():
            roof = min(cfg.peak_dp_flop_per_cycle,
                       cfg.mem_bytes_per_cycle * INTENSITY[k])
            paper = {"daxpy": PAPER_DAXPY_FLOP_PER_CYCLE,
                     "conv": PAPER_CONV_FLOP_PER_CYCLE,
                     "matmul": {}}[k].get(lanes, "")
            out.append({
                "kernel": k, "lanes": lanes,
                "intensity_flop_per_byte": round(INTENSITY[k], 4),
                "flop_per_cycle": round(perf.flop_per_cycle, 3),
                "roofline_bound": round(roof, 3),
                "fraction_of_roofline":
                    round(perf.flop_per_cycle / roof, 4),
                "paper_flop_per_cycle": paper,
            })
    return out


def main(emit):
    for r in rows():
        emit("fig6_kernels", r)


if __name__ == "__main__":
    main(lambda table, row: print(",".join(
        [table] + [f"{k}={v}" for k, v in row.items()]), flush=True))
