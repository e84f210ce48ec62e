"""Table I — normalized matmul performance, Ara vs the Hwacha baseline
(public memory system, 128 bit/cycle — modeled per §V-D).

The twin of ``benchmarks/table1_hwacha.py`` on the PyTorch port's copies of
``configs/ara.py`` and ``core/perfmodel.py`` (pure host, no device):

  PYTHONPATH=src python benchmarks/torch_table1_hwacha.py
"""
from repro_torch.configs.ara import (AraConfig, PAPER_HWACHA_MATMUL_UTIL,
                               PAPER_MATMUL_UTIL)
from repro_torch.core import perfmodel as pm


def rows():
    out = []
    for pi in (8, 16, 32):
        lanes = pi // 2
        for n in (16, 32, 64, 128):
            ara = pm.matmul_perf(AraConfig(lanes=lanes), n).utilization
            hw = pm.hwacha_matmul_perf(lanes, n).utilization
            out.append({
                "peak_flop_per_cycle": pi, "n": n,
                "ara_utilization": round(ara, 4),
                "hwacha_utilization": round(hw, 4),
                "ara_over_hwacha": round(ara / hw, 3),
                "paper_ara": PAPER_MATMUL_UTIL.get((pi, n), ""),
                "paper_hwacha": PAPER_HWACHA_MATMUL_UTIL.get((pi, n), ""),
            })
    return out


def main(emit):
    for r in rows():
        emit("table1_hwacha", r)


if __name__ == "__main__":
    main(lambda table, row: print(",".join(
        [table] + [f"{k}={v}" for k, v in row.items()]), flush=True))
