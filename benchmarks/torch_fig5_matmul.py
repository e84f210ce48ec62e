"""Fig. 5 — MATMUL performance vs problem size per lane count, with the
issue-rate boundary (Eq. 2/3). Emits CSV rows: model vs paper where known.

The twin of ``benchmarks/fig5_matmul.py`` on the PyTorch port's copies of
``configs/ara.py`` and ``core/perfmodel.py`` (pure host, no device):

  PYTHONPATH=src python benchmarks/torch_fig5_matmul.py
"""
from repro_torch.configs.ara import AraConfig, PAPER_MATMUL_UTIL, PAPER_MATMUL_UTIL_256
from repro_torch.core import perfmodel as pm


def rows():
    out = []
    for lanes in (2, 4, 8, 16):
        cfg = AraConfig(lanes=lanes)
        for n in (16, 32, 64, 128, 256):
            perf = pm.matmul_perf(cfg, n)
            paper = PAPER_MATMUL_UTIL.get((2 * lanes, n))
            if n == 256:
                paper = PAPER_MATMUL_UTIL_256.get(lanes)
            out.append({
                "lanes": lanes, "n": n,
                "flop_per_cycle": round(perf.flop_per_cycle, 3),
                "utilization": round(perf.utilization, 4),
                "issue_bound_flop_per_cycle":
                    round(pm.matmul_issue_bound(cfg, n), 3),
                "roofline_flop_per_cycle":
                    round(pm.matmul_roofline(cfg, n), 3),
                "paper_utilization": paper if paper is not None else "",
                "rel_err": round((perf.utilization - paper) / paper, 4)
                    if paper else "",
            })
    return out


def main(emit):
    for r in rows():
        emit("fig5_matmul", r)


if __name__ == "__main__":
    main(lambda table, row: print(",".join(
        [table] + [f"{k}={v}" for k, v in row.items()]), flush=True))
