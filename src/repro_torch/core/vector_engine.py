"""Ara vector engine on PyTorch: lane-parallel execution of core/isa.py
programs on one device, and the scoreboard.

The port of the reference package's ``core/vector_engine.py``:

- ``ReferenceEngine`` — the one-lane engine, a *staged interpreter*
  over ``core.staging``: a program is encoded once on the host into a
  structure-of-arrays instruction table (legality checked in the same
  pre-pass), and one runner per shape signature — cached in the LRU
  ``staging.TRACE_CACHE`` — executes it row by row on the engine's device.
  ``run_many`` executes a batch of programs in one call, each row's branch
  once per group of programs that take it. Results equal the reference's
  ``ReferenceEngine`` bit for bit (float32, float64, int32 storage) where
  no float operand or result is subnormal: XLA:CPU flushes those to zero,
  the port keeps IEEE's gradual underflow, as the numpy oracle does.
- ``LaneEngine`` — the same semantics with the vector registers
  partitioned over ``lanes`` (the paper's element-partitioned VRF,
  §III-E2): element ``i`` of a register lives on lane ``i % lanes``.
  Where the reference shards the lanes over a device mesh, one card
  holds them as a leading dimension of the register file. Arithmetic is
  lane-local; VSLIDE/VEXT and the reductions reconcile over the lanes
  (the SLDU), VST and the indexed/segment stores over memory (the VLSU)
  — the only all-lane units, exactly the paper's scalability argument.
  The runner counts those folds by unit (``cache.stats.folds``). The
  clustered ``ClusterEngine`` is in ``core/cluster.py``.
- ``simulate_timing`` — the event-driven scoreboard (issue interval,
  per-unit occupancy, chaining lag), pure host code copied from the
  reference; it cross-validates the closed-form ``core/perfmodel.py``.

The engine runs on the card unless the caller asks for the CPU
(``device="cpu"``); it never moves work to the CPU on its own.

Multi-precision (§III-E4): the engine honors VSETVL's SEW. Registers are
fixed-size byte slices, so VLMAX scales by 64/SEW; every arithmetic result
is rounded to the SEW-wide float format before it lands in the register
file (storage stays the engine dtype — value semantics, HW-width rounding).
Widening ops (VFWMUL/VFWMA) round once into the 2·SEW format. SEW=8 is the
integer lane; ``dtype=torch.int32`` makes the engine an exact fixed-point
machine. See the reference module and docs/isa.md for the normative model.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.ara import AraConfig
from repro_torch.core import isa, staging
from repro_torch.core.perfmodel import (C_MEM_LANE, CLUSTER_HOP, L_MEM,
                                        RED_HOP, tree_hops)
from repro_torch.core.precision import dtype_name, torch_dtype
from repro_torch.device import resolve_device

CHAIN_LAG = 4.0   # cycles: consumer starts this far behind producer (chaining)

MIN_SEW = min(isa.SEWS)
N_SREGS = 32      # fixed scalar register file


class _StagedEngine:
    """Shared runtime: encode → cached runner → batch.

    Subclasses pin ``kind``/``lanes``; everything else — encoding, padding,
    the signature, the cache lookup, the single run, the one host
    conversion at the boundary — lives here.
    """

    kind = "ref"
    lanes = 1
    clusters = 1
    mesh = None
    axis = None
    axes = None
    mesh_key = ()

    def __init__(self, cfg: AraConfig, vlmax: Optional[int] = None,
                 dtype=torch.float64,
                 cache: Optional[staging.TraceCache] = None,
                 lint: bool = False, device=None):
        self.cfg = cfg
        self.vlmax64 = vlmax or cfg.vlmax_dp
        self.dtype = torch_dtype(dtype)
        if self.dtype not in (torch.float64, torch.float32, torch.int32):
            raise ValueError(f"dtype {self.dtype} not supported: the "
                             "engine stores float64, float32 or int32")
        self.device = resolve_device(device)
        self.cache = cache if cache is not None else staging.TRACE_CACHE
        # opt-in encode-time static analysis (core/analysis.py): rejects
        # whole-program hazards (def-before-use, wide/v0 clobbers, static
        # OOB footprints) before anything reaches the device
        self.lint = lint

    # Back-compat alias: the 64-bit VLMAX the engine was sized for.
    @property
    def vlmax(self) -> int:
        return self.vlmax64

    def vlmax_for(self, sew: int, lmul=1) -> int:
        return isa.grouped_vlmax(self.vlmax64, sew, lmul)

    @property
    def _storage(self) -> np.dtype:
        """The storage dtype as numpy sees it (inputs and results)."""
        return np.dtype(dtype_name(self.dtype))

    def signature(self, window: int, mem_words: int, prog_len: int,
                  batch: int) -> staging.Signature:
        slots = self.vlmax_for(MIN_SEW) // self.lanes
        return staging.Signature(
            kind=self.kind, lanes=self.lanes, slots=slots, window=window,
            mem_words=mem_words, prog_len=prog_len, batch=batch,
            storage=dtype_name(self.dtype), mesh_key=self.mesh_key,
            clusters=self.clusters, device=str(self.device))

    def _window(self, rows) -> int:
        """Flat element window for a batch: sized to the batch's max vl
        (pow2-bucketed, lane-divisible) so short-vector programs don't pay
        for the SEW=16 × LMUL=8 worst case."""
        w = staging.bucket_pow2(int(rows["vl"].max(initial=1)), lo=8)
        w = min(w, self.vlmax_for(MIN_SEW, max(isa.LMULS)))
        return -(-w // self.lanes) * self.lanes

    def run_many(self, programs: Sequence, memories: Sequence,
                 sregs: Optional[Sequence[Optional[dict]]] = None,
                 window: Optional[int] = None):
        """Execute N programs in ONE runner call (one build per
        signature). Returns ``(mems, sregs)``: a list of per-program
        memory arrays (numpy, true sizes) and a list of scalar-register
        dicts — results stay on the device across the batch and convert
        to host numpy exactly once at this boundary.

        ``window`` sets a minimum flat element window: callers sweeping a
        vtype grid pass the grid-wide maximum so every cell lands on the
        SAME signature (one build for the whole sweep).
        """
        n = len(programs)
        if len(memories) != n:
            raise ValueError("run_many: len(programs) != len(memories)")
        sregs = list(sregs) if sregs is not None else [None] * n
        storage = self._storage

        if self.lint:
            from repro_torch.core import analysis
            for p, m in zip(programs, memories):
                analysis.assert_clean(p, self.vlmax64,
                                      mem_words=int(np.size(m)))

        rows = staging.pack_tables(
            [staging.encode_program(p, self.vlmax64) for p in programs])
        flats = [np.asarray(m, storage).ravel() for m in memories]
        sizes = np.array([f.shape[0] for f in flats], np.int32)
        words = staging.bucket_pow2(int(sizes.max()))
        mems = np.zeros((n, words), storage)
        for i, f in enumerate(flats):
            mems[i, :sizes[i]] = f
        s0 = np.zeros((n, N_SREGS), storage)
        for i, sr in enumerate(sregs):
            for k, val in (sr or {}).items():
                s0[i, k] = val

        w = self._window(rows)
        if window:
            w = max(w, -(-int(window) // self.lanes) * self.lanes)
        sig = self.signature(w, words, rows["op"].shape[1], n)
        fn = self.cache.get(sig, lambda: staging.build_runner(
            sig, self.cache.stats, mesh=self.mesh, axis=self.axis,
            axes=self.axes))
        # integer storage runs on exact int64 tensors (staging.Runner)
        work = torch.int64 if self.dtype == torch.int32 else self.dtype
        mem_out, s_out = fn(
            torch.from_numpy(mems).to(self.device, work),
            torch.from_numpy(s0).to(self.device, work),
            torch.from_numpy(sizes).to(self.device, torch.int64), rows)
        mem_out = mem_out.cpu().numpy().astype(storage, copy=False)
        s_out = s_out.cpu().numpy().astype(storage, copy=False)
        return ([mem_out[i, :sizes[i]] for i in range(n)],
                [{k: s_out[i, k] for k in range(N_SREGS)} for i in range(n)])

    def run(self, program, memory, sregs: Optional[dict] = None):
        mems, ss = self.run_many([program], [memory], [sregs])
        return mems[0], ss[0]


class ReferenceEngine(_StagedEngine):
    """Single-device staged engine (the lanes=1 degenerate layout)."""

    kind = "ref"


def make_lane_mesh(lanes: int, axis: str = "lanes") -> staging.Mesh:
    """The flat lane topology of a ``LaneEngine``: one axis of ``lanes``
    (the reference builds a device mesh; one card has no device per
    lane)."""
    return staging.Mesh((axis,), (int(lanes),))


class LaneEngine(_StagedEngine):
    """Same semantics, vector registers partitioned over lanes.

    Local layout: lane ``l`` holds elements l, l+lanes, l+2*lanes, ...
    (interleaved, barber's-pole equivalent), preserved across register
    groups. Memory and the scalar file are one copy per program (the
    reference replicates them on every device and keeps the copies equal
    through its folds); stores reconcile through the runner's lane folds,
    making the VLSU the single all-lane unit. ``mesh`` is a
    :class:`staging.Mesh` (``make_lane_mesh``) naming ``axis``.
    """

    kind = "lane"

    def __init__(self, cfg: AraConfig, mesh, axis: str = "lanes",
                 vlmax: Optional[int] = None, dtype=torch.float32,
                 cache: Optional[staging.TraceCache] = None,
                 lint: bool = False, device=None):
        self.mesh = mesh
        self.axis = axis
        # topology identity (axis names, sizes): a flat 4-lane mesh never
        # shares a runner with another topology of 4 lanes (a 2x2 grid)
        self.mesh_key = staging.mesh_fingerprint(mesh, (axis,))
        self.lanes = int(mesh.shape[axis])
        vlmax = vlmax or cfg.vlmax_dp
        super().__init__(cfg, (vlmax // self.lanes) * self.lanes,
                         dtype=dtype, cache=cache, lint=lint, device=device)


# ---------------------------------------------------------------------------
# Scoreboard timing simulation (no data movement)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TimingReport:
    cycles: float
    unit_busy: dict
    n_insns: int

    def flop_per_cycle(self, flops: float) -> float:
        return flops / self.cycles


ISSUE_COST = {  # Ariane dispatch slots per instruction (Appendix A)
    isa.VSETVL: 1, isa.VLD: 2, isa.VLDS: 2, isa.VGATHER: 2, isa.VST: 2,
    isa.VLSEG: 2, isa.VSSEG: 2, isa.VLUXEI: 2, isa.VSUXEI: 2,
    isa.VFMA: 1, isa.VFMA_VS: 1, isa.VFADD: 1, isa.VFMUL: 1, isa.VADD: 1,
    isa.VSUB: 1, isa.VMUL: 1, isa.VSADDU: 1, isa.VSADD: 1, isa.VSSUB: 1,
    isa.VSMUL: 1, isa.VFWMUL: 1, isa.VFWMA: 1, isa.VFNCVT: 1,
    isa.VINS: 1, isa.VEXT: 1, isa.VSLIDE: 1, isa.LDSCALAR: 3,
    isa.VMSEQ: 1, isa.VMSNE: 1, isa.VMSLT: 1, isa.VMSLE: 1,
    isa.VMFEQ: 1, isa.VMFLT: 1, isa.VMAND: 1, isa.VMOR: 1, isa.VMXOR: 1,
    isa.VMERGE: 1, isa.VREDSUM: 1, isa.VREDMAX: 1, isa.VREDMIN: 1,
    isa.VFWREDSUM: 1,
}

_WIDENING = (isa.VFWMUL, isa.VFWMA)
# integer/fixed-point class: the lane ALU, subdividing 64/SEW ways like
# the FPU — 8 int8 sub-words per lane per cycle is the §III-E4 claim's
# integer rung (and the TPU int8 394-TOPS analogue's Ara-side ruler)
_INT_ALU = (isa.VADD, isa.VSUB, isa.VMUL, isa.VSADDU, isa.VSADD,
            isa.VSSUB, isa.VSMUL)
_ELEMENT_GRANULAR = (isa.VLDS, isa.VGATHER, isa.VLUXEI, isa.VSUXEI)
_MEM_OPS = (isa.VLD, isa.VLDS, isa.VGATHER, isa.VST,
            isa.VLSEG, isa.VSSEG, isa.VLUXEI, isa.VSUXEI)
# the Mask Unit (Ara2's MASKU): compares, mask logicals and VMERGE run at
# the ALU's subdivided rate but on their own port, so predicated loops
# overlap mask generation with the predicated work itself
_MASK_UNIT = isa._MASK_WRITERS + (isa.VMERGE,)


def simulate_timing(program, cfg: AraConfig,
                    vlmax: Optional[int] = None,
                    clusters: int = 1) -> TimingReport:
    """Event-driven scoreboard estimate. ``clusters`` models the AraXL
    scale-out topology the ClusterEngine executes: VLSU collection
    arbitrates per cluster (C_MEM_LANE × lanes/clusters) and every
    burst, slide and reduction then crosses the hierarchical
    interconnect (CLUSTER_HOP per inter-cluster tree hop) — the same
    terms ``perfmodel.reduction_cycles``/``matmul_cycles`` charge in
    closed form, cross-validated in ``benchmarks/scaleout.py``."""
    lanes = cfg.lanes
    if clusters < 1 or lanes % clusters:
        raise ValueError(
            f"lanes={lanes} not divisible into clusters={clusters}")
    lpc = lanes // clusters
    xhop = CLUSTER_HOP * tree_hops(clusters)  # inter-cluster stage
    vlmax64 = vlmax or cfg.vlmax_dp
    bw = cfg.mem_bytes_per_cycle
    issue_t = 0.0
    unit_free = {"fpu": 0.0, "alu": 0.0, "sldu": 0.0, "vlsu": 0.0,
                 "scalar": 0.0, "mask": 0.0}
    busy = {k: 0.0 for k in unit_free}
    reg_start = {}          # vreg -> exec start (chaining reference)
    reg_end = {}
    sreg_end = {}

    cycles = 0.0
    n = 0
    # one host pre-pass resolves vtype and legality-checks every insn —
    # the same pre-pass the engines encode through (staging.resolve_vtype)
    for ins, vl, sew, lmul in staging.resolve_vtype(program, vlmax64):
        n += 1
        t = type(ins)
        issue_t += ISSUE_COST.get(t, 1)
        if t is isa.VSETVL:
            continue
        # one grouped instruction covers up to lmul * vlmax elements: the
        # per-element share of the issue slot shrinks by LMUL (§IV), which
        # is the whole point of register grouping
        e = max(vl / lanes, 1.0)
        # the 64-bit datapath subdivides 64/SEW ways (§III-E4): FPU and
        # SLDU retire ways elements/lane/cycle; widening ops produce
        # 2*SEW-wide results so they run at the wide width's rate
        ways = 64 // sew
        ways_w = max(ways // 2, 1)
        # (occupancy, latency): back-to-back bursts pipeline at occupancy
        # rate; startup/collection latency delays only dependants
        if t in _MEM_OPS:
            if t in _ELEMENT_GRANULAR:
                occ = float(vl)           # element-granular, no burst
            elif t in (isa.VLSEG, isa.VSSEG):
                occ = float(vl * ins.nf)  # field walk per element
            else:
                occ = (sew / 8.0) * vl / bw
            unit = "vlsu"
            lat = occ + L_MEM + C_MEM_LANE * lpc + xhop
        elif t is isa.LDSCALAR:
            unit, occ, lat = "scalar", 1.0, 2.0
        elif t in _INT_ALU:
            unit = "alu"
            occ = e / ways
            lat = occ + CHAIN_LAG
        elif t in _MASK_UNIT:
            unit = "mask"
            occ = e / ways
            lat = occ + CHAIN_LAG
        elif t in isa._REDUCTIONS:
            # local fold at the datapath rate + the PADDED binary tree
            # (perfmodel.tree_hops — integer, never float log2): RED_HOP
            # per intra-cluster hop, then CLUSTER_HOP per inter-cluster
            # hop — the serial tail that grows with lanes
            # (perfmodel.reduction_cycles charges the identical term;
            # golden-pinned)
            unit = "sldu"
            occ = e / ways + RED_HOP * tree_hops(lpc) + xhop
            lat = occ + CHAIN_LAG
        elif t in (isa.VINS, isa.VEXT, isa.VSLIDE):
            unit, occ = "sldu", e / ways + (lpc / 8.0) + xhop
            lat = occ
        else:
            unit = "fpu"
            occ = e / (ways_w if t in _WIDENING else ways)
            lat = occ + CHAIN_LAG
        reads, writes = isa.reg_groups(ins, lmul)
        dep_start = 0.0
        for base, span in reads:
            for r in range(base, base + span):
                if r in reg_start:
                    dep_start = max(dep_start, reg_start[r] + CHAIN_LAG)
        if t is isa.VINS or t is isa.VFMA_VS:
            sid = getattr(ins, "scalar", getattr(ins, "vs_scalar", None))
            if sid in sreg_end:
                dep_start = max(dep_start, sreg_end[sid])
        start = max(unit_free[unit], issue_t, dep_start)
        end = start + lat
        unit_free[unit] = start + occ
        busy[unit] += occ
        for base, span in writes:
            for r in range(base, base + span):
                reg_start[r] = start
                reg_end[r] = end
        if t is isa.LDSCALAR:
            sreg_end[ins.sd] = end
        if t is isa.VEXT:
            sreg_end[ins.sd] = end
        cycles = max(cycles, end)
    return TimingReport(cycles + cfg.config_overhead_cycles, busy, n)
