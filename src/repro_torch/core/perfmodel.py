"""Ara cycle-level analytical performance model (the faithful reproduction).

Reproduces the paper's published measurements from first principles plus a
small number of calibrated micro-architectural constants:

DERIVED from the paper's architecture (not fitted):
  - peak = 2*lanes DP-FLOP/cycle (one FMA/lane/cycle, 64-bit datapath)
  - memory BW = 32*lanes bit/cycle  (2 B/DP-FLOP provisioning, §III-D)
  - issue interval delta = 5 cycles/vector-FMA (Appendix A pipeline diagram)
  - per-lane elements e = vl/lanes; VLMAX = lanes*64 DP elements (16 KiB/lane
    VRF over 32 regs); strip-mining loop per Fig. 9 with row tiles t=4
  - DAXPY: cycles = 6n/lanes + 24 — §V-B gives ideal 96 vs measured 120
    at n=256, l=16: the +24 is the paper's own configuration overhead

CALIBRATED (documented fits, validated in tests/benchmarks vs the paper):
  - L_MEM: fixed AXI burst startup per vector load/store row
  - DRAIN: pipeline refill between dependent blocks
  - conv: gamma1 (VLSU<->FPU banking-conflict share on concurrent loads),
    +1 cycle/vmadd sub-eight-bank occupancy penalty when e < 8 (§V-C)

The Hwacha comparator (Table I) is modeled as the paper describes the public
Hwacha: same vector pipeline but memory capped at 128 bit/cycle and a slower
effective issue path (fitted delta_hw), labeled clearly as a model.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.configs.ara import (AraConfig, NOMINAL_CLOCK_GHZ, PAPER_TABLE3)
from repro_torch.core.precision import ARA_FLOP_PER_CYCLE_PER_LANE

# calibrated constants (grid-fit to Table I + §V; rms error 5.4%, worst
# |err| 10.8%, marquee 256x256 points within 3% — see tests/test_perfmodel)
L_MEM = 15.0       # cycles: burst startup per vector load/store row
DRAIN = 8.0        # cycles: per-block pipeline drain/refill
VLD_ISSUE = 2.0    # cycles: B-row vld + pointer bump issue slots per column
C_MEM_LANE = 1.25  # cycles/lane: VLSU collection/arbitration per burst
C_COL_LANE = 1.25 / 8.0  # cycles/lane: per-column operand-queue bubble
CONV_GAMMA1 = 0.2  # banking-conflict share of concurrent VLSU traffic
CONV_SHORT_PEN = 0.5  # cycles/vmadd when a vector spans < 8 banks
STRIP_SETVL = 2.0  # cycles: vsetvl/dispatch serialization per extra strip
                   # (the rest of the loop body issues under the previous
                   # strip's memory time — chaining hides it)
RED_HOP = 2.0      # cycles per inter-lane reduction-tree hop (one SLDU
                   # ring stage per halving of the active lane set)
CLUSTER_HOP = 6.0  # cycles per inter-CLUSTER hop: one stage of the
                   # hierarchical interconnect (AraXL §IV analogue) —
                   # crossing a cluster boundary costs a few lane-hops'
                   # worth of arbitration + wiring latency, which is why
                   # all-to-one slide/reduction traffic kills weak
                   # scaling before the FPUs run out (docs/engine.md)


def tree_hops(n: int) -> int:
    """Depth of the identity-PADDED binary reduction tree over ``n``
    leaves: the engines fold a power-of-two window padded with the op
    identity (``staging.build_runner``, ``differential._tree_reduce``),
    so a non-power-of-two lane count pays exactly the next power of
    two's depth — lanes=6 costs the lanes=8 tree, because the padded
    slots still occupy fold stages. Computed in integer arithmetic
    (``(n-1).bit_length()``), never via float ``log2``: for ``n`` just
    above a power of two (e.g. ``2**49 + 1``) ``log2`` rounds DOWN to
    the power itself and ``ceil`` then miscounts the final hop, so the
    float spelling and the padded tree disagree exactly where the tree
    isn't full. Golden-pinned for pow2 lane counts (byte-identical to
    the old ``ceil(log2(lanes))``) with non-pow2 keys alongside."""
    n = int(n)
    if n <= 1:
        return 0
    return (n - 1).bit_length()


def _split_lanes(lanes: int, clusters: int) -> int:
    """lanes-per-cluster, validating the topology divides evenly."""
    if clusters < 1 or lanes % clusters:
        raise ValueError(
            f"lanes={lanes} not divisible into clusters={clusters}")
    return lanes // clusters


@dataclasses.dataclass(frozen=True)
class KernelPerf:
    name: str
    cycles: float
    flops: float
    lanes: int
    ew_bits: int = 64            # element width the kernel executed at
    lmul: int = 1                # register grouping the kernel ran with

    @property
    def flop_per_cycle(self) -> float:
        return self.flops / self.cycles

    @property
    def peak_flop_per_cycle(self) -> int:
        # per-precision peak: the 64-bit datapath subdivides (§III-E4);
        # single source shared with AraConfig.peak_flop_per_cycle
        return self.lanes * ARA_FLOP_PER_CYCLE_PER_LANE[self.ew_bits]

    @property
    def utilization(self) -> float:
        return self.flop_per_cycle / self.peak_flop_per_cycle

    def gflops(self, clock_ghz: float) -> float:
        return self.flop_per_cycle * clock_ghz


# ---------------------------------------------------------------------------
# MATMUL  (C <- A B + C, n x n, Fig. 9 / Listing 1 algorithm)
# ---------------------------------------------------------------------------


def matmul_cycles(cfg: AraConfig, n: int, t: int = 4,
                  issue_interval: float | None = None,
                  mem_bytes_per_cycle: float | None = None,
                  ew_bits: int = 64, lmul=1, clusters: int = 1) -> float:
    """Cycle model, multi-precision aware (§III-E4): at element width
    ``ew_bits`` the FPU retires 64/ew elements/lane/cycle, memory moves
    ew/8-byte elements, and VLMAX grows by 64/ew (fewer strip-mine trips).

    Register grouping (``lmul``) multiplies VLMAX again: each strip covers
    LMUL× more columns, so per-column issue slots amortize over longer FPU
    chains and the per-strip burst/drain/config overheads are paid fewer
    times — the §IV issue-interval amortization in closed form. The row
    tile is clamped to what the 32-register file can hold at this LMUL
    (t <= 32/lmul - 2, same rule as isa.matmul_program), so high LMUL
    also pays its real register-pressure cost: less B-row reuse. Net:
    grouping wins in the short-vector regime and over-grouping loses in
    the long-vector one — the Ara2 trade-off, and the scoreboard agrees.

    ``ew_bits=8`` is the integer lane (8 sub-words/lane/cycle); the
    formula charges the FMA rate — the closed form models the datapath
    split, while the scoreboard's VMUL+VADD spelling (no integer MACC,
    ``isa.imatmul_program``) honestly halves it. Fractional ``lmul``
    (mf2/mf4, exact Fractions) shrinks VLMAX — more strips, never fewer
    cycles: fractional grouping exists for mixed-width EMUL legality,
    not speed, and the golden table pins that honesty too.

    ``clusters`` (AraXL scale-out): the VLSU word collection happens
    per cluster — C_MEM_LANE scales with lanes/clusters, not total
    lanes — but every burst then crosses the hierarchical interconnect,
    ``CLUSTER_HOP * tree_hops(clusters)`` cycles per collection. The
    arithmetic is untouched (lanes stay identical compute units), so
    clustering trades the O(lanes) flat-crossbar arbitration for a
    log-depth interconnect term — the reason AraXL can wire 64 lanes
    at all. ``clusters=1`` reproduces the single-core model exactly.
    """
    from repro_torch.core.isa import NUM_VREGS, group_span
    t = max(1, min(t, NUM_VREGS // group_span(lmul) - 2))
    lanes = cfg.lanes
    lpc = _split_lanes(lanes, clusters)
    hop = CLUSTER_HOP * tree_hops(clusters)
    ways = 64 // ew_bits                     # datapath subdivision
    ebytes = ew_bits / 8.0
    delta = issue_interval if issue_interval is not None \
        else cfg.issue_interval_cycles
    bw = mem_bytes_per_cycle if mem_bytes_per_cycle is not None \
        else cfg.mem_bytes_per_cycle
    vlmax = cfg.vlmax(ew_bits, lmul)
    cycles = 0.0
    c = 0
    while c < n:
        vl = min(n - c, vlmax)
        e = vl / lanes                       # elements per lane
        row_mem = ebytes * vl / bw           # one row's bytes / BW
        n_blocks = math.ceil(n / t)
        per_block = 0.0
        # phase I + III: t C-row loads + t stores, burst startup each
        # (every burst crosses the inter-cluster interconnect once)
        per_block += 2 * t * (row_mem + L_MEM + hop)
        # phase II: n columns; per column one B-row vld (chained) and t vmadds
        issue_cycles = t * delta + VLD_ISSUE
        fpu_cycles = t * e / ways
        # B row streams under compute; VLSU word collection arbitrates
        # across the lanes of ONE cluster (§VI-C), then the burst walks
        # the log-depth inter-cluster stage
        mem_cycles = row_mem + C_MEM_LANE * lpc + hop
        per_col = max(issue_cycles, fpu_cycles, mem_cycles) \
            + C_COL_LANE * lanes
        per_block += n * per_col
        per_block += DRAIN
        cycles += n_blocks * per_block + cfg.config_overhead_cycles
        c += vl
    return cycles


def matmul_perf(cfg: AraConfig, n: int, ew_bits: int = 64, lmul=1,
                clusters: int = 1, **kw) -> KernelPerf:
    return KernelPerf("matmul",
                      matmul_cycles(cfg, n, ew_bits=ew_bits, lmul=lmul,
                                    clusters=clusters, **kw),
                      2.0 * n ** 3, cfg.lanes, ew_bits, lmul)


def matmul_issue_bound(cfg: AraConfig, n: int) -> float:
    """Eq. (2)/(3): omega <= Pi * tau/delta, tau = 2n/Pi (FLOP/cycle)."""
    pi = cfg.peak_dp_flop_per_cycle
    tau = 2.0 * n / pi
    return pi * min(1.0, tau / cfg.issue_interval_cycles)


def matmul_roofline(cfg: AraConfig, n: int, ew_bits: int = 64) -> float:
    """Classic roofline bound (FLOP/cycle): min(peak, beta * I).

    Eq. (1) generalized to element width: I = 2n^3 / (2 * ebytes * n^2)
    = n / (2 * ew/8) FLOP/B — narrower elements double the intensity AND
    the compute peak, so the machine-balance point is width-invariant.
    """
    intensity = n / (2.0 * (ew_bits / 8.0))   # Eq. (1); n/16 at ew=64
    return min(cfg.peak_flop_per_cycle(ew_bits),
               cfg.mem_bytes_per_cycle * intensity)


# ---------------------------------------------------------------------------
# DAXPY  (Y <- aX + Y, length n)
# ---------------------------------------------------------------------------


def daxpy_cycles(cfg: AraConfig, n: int, ew_bits: int = 64,
                 lmul=1) -> float:
    # memory-bound: 3 * ew/8 * n bytes over 4*lanes B/cycle (= 6n/lanes at
    # ew=64), plus the paper's measured 24-cycle config overhead (§V-B).
    # Each strip-mine trip beyond the first serializes on its vsetvl
    # (STRIP_SETVL); LMUL-grouped strips cover lmul*VLMAX elements, so
    # grouping trims exactly this term — the memory-bound kernel's share
    # of the §IV issue amortization.
    bytes_moved = 3.0 * (ew_bits / 8.0) * n
    n_strips = max(1, math.ceil(n / cfg.vlmax(ew_bits, lmul)))
    return bytes_moved / cfg.mem_bytes_per_cycle \
        + cfg.config_overhead_cycles \
        + (n_strips - 1) * STRIP_SETVL


def daxpy_perf(cfg: AraConfig, n: int, ew_bits: int = 64,
               lmul=1) -> KernelPerf:
    return KernelPerf("daxpy", daxpy_cycles(cfg, n, ew_bits, lmul), 2.0 * n,
                      cfg.lanes, ew_bits, lmul)


# ---------------------------------------------------------------------------
# REDUCTION  (s <- fold(X), length n — the native vred class, §III-C retired)
# ---------------------------------------------------------------------------


def reduction_cycles(cfg: AraConfig, n: int, ew_bits: int = 64,
                     lmul=1, clusters: int = 1) -> float:
    """Strip-mined VLD + vred loop: per strip, the load streams ew/8-byte
    elements over the memory port, then the SLDU folds e = vl/lanes
    local elements at the datapath's 64/ew rate and walks the inter-lane
    binary tree — ``RED_HOP * tree_hops(lanes)`` cycles of the PADDED
    pow2 tree (see :func:`tree_hops`), the reduction's irreducible
    serial tail (why wider machines win less here than on matmul: the
    tree term GROWS with lanes). Extra strips pay the vsetvl
    serialization like daxpy's; the accumulate-into-scalar dependency
    adds one DRAIN per strip boundary (the fold result is needed before
    the next strip's fold can retire).

    ``clusters`` splits the tree hierarchically (AraXL): the intra-
    cluster stage folds lanes/clusters lanes at ``RED_HOP`` per hop,
    then the inter-cluster stage folds the cluster partials at
    ``CLUSTER_HOP`` per hop — the all-to-one term that dominates weak
    scaling at high lane counts (``benchmarks/scaleout.py`` charts it).
    ``clusters=1`` is the flat single-core tree, unchanged.
    """
    lanes = cfg.lanes
    lpc = _split_lanes(lanes, clusters)
    ways = 64 // ew_bits
    ebytes = ew_bits / 8.0
    vlmax = cfg.vlmax(ew_bits, lmul)
    tree = RED_HOP * tree_hops(lpc) + CLUSTER_HOP * tree_hops(clusters)
    cycles = float(cfg.config_overhead_cycles)
    c = 0
    while c < n:
        vl = min(n - c, vlmax)
        e = vl / lanes
        cycles += ebytes * vl / cfg.mem_bytes_per_cycle + L_MEM
        cycles += e / ways + tree
        if c:
            cycles += STRIP_SETVL + DRAIN
        c += vl
    return cycles


def reduction_perf(cfg: AraConfig, n: int, ew_bits: int = 64,
                   lmul=1, clusters: int = 1) -> KernelPerf:
    return KernelPerf("reduction",
                      reduction_cycles(cfg, n, ew_bits, lmul, clusters),
                      float(n), cfg.lanes, ew_bits, lmul)


# ---------------------------------------------------------------------------
# DCONV  (GoogLeNet layer-1 tensor convolution, §IV/§V-C)
# ---------------------------------------------------------------------------


def dconv_cycles(cfg: AraConfig, out_ch: int = 64, in_ch: int = 3,
                 kh: int = 7, kw: int = 7, rows: int = 112,
                 cols: int = 112) -> float:
    lanes = cfg.lanes
    e = cols / lanes
    n_vmadd = in_ch * kh * kw                 # FMAs per output row (147)
    fpu = n_vmadd * max(cfg.issue_interval_cycles, e)
    # input rows streamed per output row: in_ch * kh vlds
    mem = in_ch * kh * (8.0 * cols / cfg.mem_bytes_per_cycle + L_MEM)
    per_row = max(fpu, mem) + CONV_GAMMA1 * mem
    if e < cfg.banks_per_lane:                # vector doesn't fill the banks
        per_row += CONV_SHORT_PEN * n_vmadd
    total_rows = out_ch * rows
    return total_rows * per_row + cfg.config_overhead_cycles


def dconv_perf(cfg: AraConfig, **kw) -> KernelPerf:
    flops = 2.0 * 64 * 3 * 7 * 7 * 112 * 112
    return KernelPerf("dconv", dconv_cycles(cfg, **kw), flops, cfg.lanes)


# ---------------------------------------------------------------------------
# Hwacha comparator (public memory system: 128 bit/cycle, §V-D)
# ---------------------------------------------------------------------------
# The paper attributes public-Hwacha's low utilization to its memory system
# (no banked L2; a coherence broadcast hub capping delivery at 128 bit/cycle,
# "starving the FMA units"). The three published points (Table I, n=32) fit
# a per-element delivery model almost exactly (<2%):
#     per-column cycles = H_FIXED + H_PER_ELEM * e,   e = vl/lanes
# i.e. the hub delivers operands at a fixed per-lane rate ~1/4.7 of Ara's
# banked VRF. Fitted constants, clearly a comparator model, not RTL.

H_FIXED = 18.3
H_PER_ELEM = 4.7


def hwacha_matmul_perf(lanes: int, n: int, t: int = 4) -> KernelPerf:
    vl = min(n, lanes * 64)
    e = vl / lanes
    row_mem = 8.0 * vl / 16.0            # 128 bit/cycle cap
    per_col = H_FIXED + H_PER_ELEM * e
    per_block = 2 * t * (row_mem + L_MEM) + n * per_col + DRAIN
    cycles = (math.ceil(n / t) * per_block + 24) * math.ceil(n / vl)
    return KernelPerf("hwacha-matmul", cycles, 2.0 * n ** 3, lanes)


# ---------------------------------------------------------------------------
# Power / efficiency model (Table III)
# ---------------------------------------------------------------------------

# linear fits P(l) = p0 + p1*l (mW) per kernel over the four instances
_POWER_POINTS = {k: [(l, PAPER_TABLE3[l][i]) for l in (2, 4, 8, 16)]
                 for i, k in ((3, "matmul"), (4, "dconv"), (5, "daxpy"))}


def _linfit(points):
    n = len(points)
    sx = sum(p[0] for p in points)
    sy = sum(p[1] for p in points)
    sxx = sum(p[0] ** 2 for p in points)
    sxy = sum(p[0] * p[1] for p in points)
    b = (n * sxy - sx * sy) / (n * sxx - sx * sx)
    a = (sy - b * sx) / n
    return a, b


POWER_FIT = {k: _linfit(v) for k, v in _POWER_POINTS.items()}


def power_mw(kernel: str, lanes: int) -> float:
    a, b = POWER_FIT[kernel]
    return a + b * lanes


def efficiency_gflops_per_w(kernel: str, lanes: int, n: int = 256) -> float:
    cfg = AraConfig(lanes=lanes)
    clock = NOMINAL_CLOCK_GHZ[lanes]
    if kernel == "matmul":
        perf = matmul_perf(cfg, n)
    elif kernel == "daxpy":
        perf = daxpy_perf(cfg, n)
    else:
        perf = dconv_perf(cfg)
    return perf.gflops(clock) / (power_mw(kernel, lanes) / 1000.0)
