"""The paper's own evaluation configuration (Table II).

Ara design-space parameters and the three benchmark kernels' sizes, used by
core/perfmodel.py and benchmarks/ to reproduce Fig. 5, Fig. 6, Table I and
Table III.
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction


@dataclasses.dataclass(frozen=True)
class AraConfig:
    lanes: int = 4                    # l in {2, 4, 8, 16}
    vrf_kib_per_lane: int = 16        # 16 KiB / lane
    banks_per_lane: int = 8
    bank_width_bits: int = 64
    memory_width_bits: int = 0        # 0 -> 32 * lanes (2 B/DP-FLOP)
    issue_interval_cycles: int = 5    # delta: one vector FMA every 5 cycles
    config_overhead_cycles: int = 24  # vsetvl + dispatch overhead (DAXPY: 96->120)
    freq_ghz: float = 1.04            # nominal clock, 16-lane instance (Table III)
    insn_queue_depth: int = 8         # main-sequencer parallel instructions

    @property
    def peak_dp_flop_per_cycle(self) -> int:
        # one FMA (2 FLOP) per lane per cycle, 64-bit datapath
        return 2 * self.lanes

    @property
    def mem_bytes_per_cycle(self) -> float:
        bits = self.memory_width_bits or 32 * self.lanes
        return bits / 8.0

    @property
    def vlmax_dp(self) -> int:
        """Max DP elements per vector register (VRF split over 32 regs)."""
        return self.vlmax(64)

    def vlmax(self, sew_bits: int = 64, lmul=1) -> int:
        """Max elements per vector operand at a given SEW and LMUL:
        registers are fixed-size byte slices of the VRF, so halving the
        element width doubles the element capacity (§III-E4), and an
        LMUL-register group holds LMUL× more (RVV 1.0 grouping).
        Fractional LMUL (mf2/mf4) floors exactly — a Fraction, never a
        float, so the RVV fractional-VLMAX floor is bit-precise."""
        total_bytes = self.lanes * self.vrf_kib_per_lane * 1024
        return int(total_bytes // 32 // (sew_bits // 8) * Fraction(lmul))

    def peak_flop_per_cycle(self, ew_bits: int = 64) -> int:
        """Multi-precision: the 64-bit datapath subdivides (64/ew) ways.
        Wired to core.precision.ARA_FLOP_PER_CYCLE_PER_LANE — the single
        source both the analytical model and the TPU kernels consult."""
        from repro_torch.core.precision import ARA_FLOP_PER_CYCLE_PER_LANE
        return self.lanes * ARA_FLOP_PER_CYCLE_PER_LANE[ew_bits]


# Nominal clock per instance (Table III)
NOMINAL_CLOCK_GHZ = {2: 1.25, 4: 1.25, 8: 1.17, 16: 1.04}
WORST_CASE_CLOCK_GHZ = {2: 0.92, 4: 0.93, 8: 0.87, 16: 0.78}

# Published measurements used to validate the perf model (see tests/).
PAPER_MATMUL_UTIL = {  # Table I "Ara" columns: (Pi, n) -> fraction of peak
    (8, 16): 0.495, (8, 32): 0.826, (8, 64): 0.896, (8, 128): 0.943,
    (16, 16): 0.254, (16, 32): 0.534, (16, 64): 0.775, (16, 128): 0.931,
    (32, 16): 0.128, (32, 32): 0.276, (32, 64): 0.456, (32, 128): 0.788,
}
PAPER_HWACHA_MATMUL_UTIL = {  # Table I "Hwacha" columns (n=32 row)
    (8, 32): 0.499, (16, 32): 0.356, (32, 32): 0.224,
}
PAPER_MATMUL_UTIL_256 = {2: 0.98, 16: 0.97}      # section V-A
PAPER_DAXPY_FLOP_PER_CYCLE = {2: 0.65, 16: 4.27}  # section V-B (n=256)
PAPER_CONV_FLOP_PER_CYCLE = {2: 3.73, 16: 26.7}   # section V-C
PAPER_TABLE3 = {
    # lanes: (matmul GFLOPS, dconv GFLOPS, daxpy GFLOPS,
    #         matmul mW, dconv mW, daxpy mW, eff matmul, eff dconv, eff daxpy)
    2:  (4.91, 4.66, 0.82, 138, 130, 68.2, 35.6, 35.8, 12.0),
    4:  (9.80, 9.22, 1.56, 259, 239, 113, 37.8, 38.6, 13.8),
    8:  (18.2, 16.9, 2.80, 456, 420, 183, 39.9, 40.2, 15.3),
    16: (32.4, 27.7, 4.44, 794, 676, 280, 40.8, 41.0, 15.9),
}
PAPER_AREA_KGE = {2: 2228, 4: 3434, 8: 5902, 16: 10735}
