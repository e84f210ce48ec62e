"""Staged engine runtime on PyTorch: encode once, run a batch of ISA programs.

The port of the reference package's ``core/staging.py``. A program runs as
a table of instruction rows; what the reference compiles into one XLA
executable per shape *signature*, this module builds into one
:class:`Runner` per signature:

- :func:`resolve_vtype` — the host-side pre-pass. Walks a program once,
  legality-checks every instruction via ``isa.check_insn`` (both the engine
  and the scoreboard share it), and resolves the per-instruction vtype
  (vl, sew, lmul) that ``VSETVL`` establishes.
- :func:`encode_program` / :func:`pack_tables` — lower programs into a
  structure-of-arrays int32 instruction table (one row per instruction,
  ``VSETVL`` folded into every row's vl/vpr/lmul/sew), NOP-padded to a
  bucketed length. Copied from the reference, so both packages encode a
  program into the same table.
- :class:`Signature` — the static shape key of an encoded batch (engine
  kind, lanes, clusters, register slots, element window, padded memory
  words and program length, batch, storage dtype, lane topology, device).
- :class:`TraceCache` — an LRU of runners keyed by Signature, with
  hit/miss/build counters and the runners' cross-lane fold counts.
- :func:`build_runner` — builds the runner for one signature. It keeps its
  index tensors on the signature's device and runs the rows in order; the
  opcode of each row is known on the host (the encoded table is numpy), so
  each row dispatches there, once per group of programs that share the
  row's opcode and vtype, and the group's branch runs batched over those
  programs as a few tensor operations. Where the reference ``vmap``s every
  branch and selects one, this runs only the branches the batch takes. No
  value comes back to the host inside the row loop.

Lanes (the reference's ``shard_map`` over a lane mesh) are a leading
dimension of the register file on one device: lane ``l`` holds elements
``l, l + lanes, ...`` of every register group, memory and the scalar file
are one copy per program, and every exchange across lanes goes through
:meth:`Runner._fold`, the reference's ``psum``/``pmax`` (:class:`Mesh`
describes the lane topology; it has no devices).

Semantics are the reference's bit for bit (the tests hold the two packages
to tol=0). Where torch lacks the reference's primitive, the docstrings of
:func:`fma`, :func:`round_f64_to_f16` and :meth:`Runner._mstore` say what
stands in for it.
"""
from __future__ import annotations

import collections
import copy
import dataclasses

import numpy as np
import torch

from repro_torch.core import isa
from repro_torch.core.precision import dtype_for_sew, torch_dtype

NF_MAX = max(isa.LMULS)          # nf * lmul <= 8 caps fields at 8

# Opcode table: VGATHER and VLUXEI share semantics (and a branch); VSETVL
# has no row (the pre-pass folds it into every row's vl/vpr/lmul/sew).
# The integer/fixed-point class (vadd..vsmul) executes on an int32 view
# of the registers; the saturating four carry the sticky vxsat flag.
OPS = ("nop", "vld", "vlds", "vgather", "vlseg", "vst", "vsseg", "vsuxei",
       "vfma", "vfma_vs", "vfadd", "vfmul", "vfwmul", "vfwma", "vfncvt",
       "vadd", "vins", "vext", "vslide", "ldscalar",
       "vsub", "vmul", "vsaddu", "vsadd", "vssub", "vsmul",
       "vmseq", "vmsne", "vmslt", "vmsle", "vmfeq", "vmflt",
       "vmand", "vmor", "vmxor", "vmerge",
       "vredsum", "vredmax", "vredmin", "vfwredsum")
OP_ID = {name: i for i, name in enumerate(OPS)}

# Instruction-table columns (all int32):
#   op    opcode id                  rd   dest/store-source group base
#   ra    source group base (va / vs / vidx)
#   rb    second source group base (vb)
#   sd    scalar register id         imm  element address
#   aux   stride / slide amount / extract index / nf
#   vl    resolved vector length     vpr  per-register capacity at sew
#   lmul  registers per group (group_span: 1 for fractional LMUL)
#   sewi/wsewi  SEWS index of sew / 2*sew
#   vm    RVV mask bit: 1 unmasked (default), 0 masked by v0 — one more
#         int32 data column, so masking never perturbs the signature
FIELDS = ("op", "rd", "ra", "rb", "sd", "imm", "aux",
          "vl", "vpr", "lmul", "sewi", "wsewi", "vm")

_NOP_DEFAULTS = {"vpr": 1, "lmul": 1, "vm": 1}   # keep // and % well-defined

_OP_FOR = {
    isa.VLD: "vld", isa.VLDS: "vlds", isa.VGATHER: "vgather",
    isa.VLUXEI: "vgather", isa.VLSEG: "vlseg", isa.VST: "vst",
    isa.VSSEG: "vsseg", isa.VSUXEI: "vsuxei", isa.VFMA: "vfma",
    isa.VFMA_VS: "vfma_vs", isa.VFADD: "vfadd", isa.VFMUL: "vfmul",
    isa.VFWMUL: "vfwmul", isa.VFWMA: "vfwma", isa.VFNCVT: "vfncvt",
    isa.VADD: "vadd", isa.VSUB: "vsub", isa.VMUL: "vmul",
    isa.VSADDU: "vsaddu", isa.VSADD: "vsadd", isa.VSSUB: "vssub",
    isa.VSMUL: "vsmul", isa.VINS: "vins", isa.VEXT: "vext",
    isa.VSLIDE: "vslide", isa.LDSCALAR: "ldscalar",
    isa.VMSEQ: "vmseq", isa.VMSNE: "vmsne", isa.VMSLT: "vmslt",
    isa.VMSLE: "vmsle", isa.VMFEQ: "vmfeq", isa.VMFLT: "vmflt",
    isa.VMAND: "vmand", isa.VMOR: "vmor", isa.VMXOR: "vmxor",
    isa.VMERGE: "vmerge", isa.VREDSUM: "vredsum",
    isa.VREDMAX: "vredmax", isa.VREDMIN: "vredmin",
    isa.VFWREDSUM: "vfwredsum",
}


def bucket(n: int, step: int = 8) -> int:
    """Round ``n`` up to a multiple of ``step`` (minimum one bucket)."""
    return max(step, -(-n // step) * step)


def bucket_pow2(n: int, lo: int = 64) -> int:
    """Round ``n`` up to a power of two (memory padding granularity)."""
    w = lo
    while w < n:
        w *= 2
    return w


# ---------------------------------------------------------------------------
# host pre-pass: legality + vtype resolution (shared with the scoreboard)
# ---------------------------------------------------------------------------


def resolve_vtype(program, vlmax64: int, lint: bool = False,
                  mem_words=None):
    """Legality-check a program once and resolve its per-insn vtype.

    Returns ``[(ins, vl, sew, lmul), ...]`` with VSETVL rows carrying the
    vtype they establish. Raises ``isa.IllegalInstruction`` (a
    ValueError carrying code/mnemonic/vtype/index) on the first illegal
    instruction — on the host, before anything is built or executed;
    the engine and ``simulate_timing`` run this exact pre-pass.

    ``lint=True`` additionally runs the whole-program static analyzer
    (``core/analysis.py``) first and raises ``analysis.LintError`` on any
    E-class finding (def-before-use, wide-group clobber, v0 clobber,
    static OOB footprints when ``mem_words`` is given). The lint pass is
    pure host python — it never touches the runner cache or changes what
    a runner is built for.
    """
    if lint:
        from repro_torch.core import analysis
        analysis.assert_clean(program, vlmax64, mem_words=mem_words)
    out = []
    vl, sew, lmul = vlmax64, 64, 1
    for i, ins in enumerate(program):
        isa.check_insn(ins, sew, lmul, index=i)
        if type(ins) is isa.VSETVL:
            sew, lmul = ins.sew, ins.lmul
            vl = isa.vsetvl_grant(ins.vl, vlmax64, sew, lmul)
        out.append((ins, vl, sew, lmul))
    return out


def encode_program(program, vlmax64: int):
    """Lower a program to instruction-table rows (list of field dicts)."""
    rows = []
    for ins, vl, sew, lmul in resolve_vtype(program, vlmax64):
        t = type(ins)
        if t is isa.VSETVL:
            continue
        name = _OP_FOR.get(t)
        if name is None:
            raise ValueError(ins)
        r = dict.fromkeys(FIELDS, 0)
        r.update(op=OP_ID[name], vl=vl, vpr=vlmax64 * (64 // sew),
                 lmul=isa.group_span(lmul), sewi=isa.SEWS.index(sew),
                 wsewi=isa.SEWS.index(2 * sew) if 2 * sew in isa.SEWS else 0,
                 vm=getattr(ins, "vm", 1))
        if t in (isa.VLD, isa.VLDS, isa.VGATHER, isa.VLUXEI, isa.VLSEG):
            r["rd"], r["imm"] = ins.vd, ins.addr
            if t is isa.VLDS:
                r["aux"] = ins.stride
            elif t is isa.VLSEG:
                r["aux"] = ins.nf
            elif t is not isa.VLD:
                r["ra"] = ins.vidx
        elif t in (isa.VST, isa.VSSEG, isa.VSUXEI):
            r["rd"], r["imm"] = ins.vs, ins.addr
            if t is isa.VSSEG:
                r["aux"] = ins.nf
            elif t is isa.VSUXEI:
                r["ra"] = ins.vidx
        elif t in (isa.VFMA, isa.VFADD, isa.VFMUL, isa.VADD, isa.VSUB,
                   isa.VMUL, isa.VSADDU, isa.VSADD, isa.VSSUB, isa.VSMUL,
                   isa.VFWMUL, isa.VFWMA):
            r["rd"], r["ra"], r["rb"] = ins.vd, ins.va, ins.vb
        elif t is isa.VFMA_VS:
            r["rd"], r["sd"], r["rb"] = ins.vd, ins.vs_scalar, ins.vb
        elif t is isa.VFNCVT:
            r["rd"], r["ra"] = ins.vd, ins.vs
        elif t is isa.VINS:
            r["rd"], r["sd"] = ins.vd, ins.scalar
        elif t is isa.VEXT:
            r["sd"], r["ra"], r["aux"] = ins.sd, ins.vs, ins.idx
        elif t is isa.VSLIDE:
            r["rd"], r["ra"], r["aux"] = ins.vd, ins.vs, ins.amount
        elif t is isa.LDSCALAR:
            r["sd"], r["imm"] = ins.sd, ins.addr
        elif t in (isa.VMSEQ, isa.VMSNE, isa.VMSLT, isa.VMSLE, isa.VMFEQ,
                   isa.VMFLT, isa.VMAND, isa.VMOR, isa.VMXOR, isa.VMERGE):
            r["rd"], r["ra"], r["rb"] = ins.vd, ins.va, ins.vb
        elif t in isa._REDUCTIONS:
            r["rd"], r["ra"] = ins.vd, ins.vs
        rows.append(r)
    return rows


def pack_tables(tables, pad_to=None):
    """Stack per-program row lists into an (N, P) SoA batch, NOP-padded.

    ``P`` is bucketed so programs of nearby length share a signature.
    """
    p = pad_to or bucket(max([len(t) for t in tables] + [1]))
    out = {}
    for f in FIELDS:
        a = np.full((len(tables), p), _NOP_DEFAULTS.get(f, 0), np.int32)
        for i, rows in enumerate(tables):
            if rows:
                a[i, :len(rows)] = [r[f] for r in rows]
        out[f] = a
    return out


# ---------------------------------------------------------------------------
# runner cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A lane topology on one device: named axes and their sizes, in
    nesting order (``("lanes",)`` for the flat LaneEngine, ``("clusters",
    "lanes")`` for the ClusterEngine). It stands for the reference's
    ``jax.sharding.Mesh`` where the reference reads one: ``shape[axis]``
    and ``axis_names``. One card has no device per lane, so it holds no
    devices."""
    axis_names: tuple
    sizes: tuple

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes) \
                or len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"mesh axes {self.axis_names} and sizes "
                             f"{self.sizes} do not pair up")
        if any(int(n) < 1 for n in self.sizes):
            raise ValueError(f"mesh sizes {self.sizes} must be >= 1")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


def mesh_fingerprint(mesh, axes) -> tuple:
    """The topology identity of a mesh: per-axis (name, size) pairs in
    nesting order. The reference adds the device order, which one card
    does not have (the device is part of :class:`Signature`). A flat
    4-lane mesh, a 2x2 and a 4x1 clusters x lanes mesh give distinct
    fingerprints, so the cache never replays one's runner for another."""
    missing = [a for a in axes if a not in mesh.axis_names]
    if missing:
        raise ValueError(f"axes {missing} are not in the mesh's "
                         f"{tuple(mesh.axis_names)}")
    return tuple((a, int(mesh.shape[a])) for a in axes)


@dataclasses.dataclass(frozen=True)
class Signature:
    """Static shape key of an encoded batch — everything a runner is built
    for. Programs differing only in opcodes/operands/vtype share one."""
    kind: str            # "ref" | "lane" | "cluster"
    lanes: int           # TOTAL lanes across all clusters
    slots: int           # per-lane element slots per vector register
    window: int          # global flat element window (>= the batch max vl)
    mem_words: int       # padded memory words
    prog_len: int        # padded instruction rows
    batch: int
    storage: str         # canonical dtype name
    mesh_key: tuple = ()  # mesh_fingerprint(): axis names and sizes
    clusters: int = 1    # mesh nesting: lanes are grouped clusters-ways
    device: str = "cpu"  # where the runner keeps its tensors


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    compiles: int = 0    # runners built
    # cross-lane folds the runners made, by unit: "vlsu" (the stores),
    # "sldu" (slide, extract, reductions), "vxsat" (the sticky flag); and
    # the reductions over a mesh axis they took: one per fold over
    # "lanes", a second over "clusters" for the ClusterEngine
    folds: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    fold_stages: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    def snapshot(self) -> "CacheStats":
        return dataclasses.replace(self, folds=self.folds.copy(),
                                   fold_stages=self.fold_stages.copy())

    def reset(self):
        self.hits = self.misses = self.compiles = 0
        self.folds.clear()
        self.fold_stages.clear()


class TraceCache:
    """LRU cache of runners keyed by :class:`Signature`.

    One instance (module default :data:`TRACE_CACHE`) is shared by every
    engine. The port's contract: a signature the cache does not hold (never
    seen, cleared, or evicted as least recently used past ``maxsize``) is a
    miss and builds one runner (``stats.compiles`` counts the builds, so it
    equals ``stats.misses``); every other lookup is a hit and builds
    nothing. The device is part of the signature, so a CPU and a CUDA engine
    sized alike hold one runner each.
    """

    def __init__(self, maxsize: int = 64):
        self.maxsize = maxsize
        self.stats = CacheStats()
        self._fns = collections.OrderedDict()

    def __len__(self):
        return len(self._fns)

    def get(self, sig: Signature, builder):
        fn = self._fns.get(sig)
        if fn is not None:
            self.stats.hits += 1
            self._fns.move_to_end(sig)
            return fn
        self.stats.misses += 1
        fn = builder()
        self._fns[sig] = fn
        while len(self._fns) > self.maxsize:
            self._fns.popitem(last=False)
        return fn

    def clear(self):
        self._fns.clear()


TRACE_CACHE = TraceCache()


# ---------------------------------------------------------------------------
# integer / fixed-point arithmetic (exact int64 view of the registers)
# ---------------------------------------------------------------------------


def wrap_int(x, bits: int):
    """int64 tensor -> signed two's-complement ``bits``-wide value (int64).

    The reference wraps an int32 trace implicitly at 32 bits; values here
    are exact int64, so every wrap, 32 bits included, is explicit."""
    half = 1 << (bits - 1)
    return ((x + half) & ((1 << bits) - 1)) - half


def int_arith(kind: str, a, b, bits: int):
    """One integer/fixed-point op on int64 canonical values (int32 range).

    Returns ``(result int64, saturated bool)``, equal to the reference's
    ``staging.int_arith``: vadd/vsub/vmul wrap mod 2^bits; the saturating
    four clamp to the type extremes and flag. vxrm is fixed at rnu: VSMUL
    adds 2^(bits-2) before the arithmetic (bits-1)-shift — ties round up.
    Every intermediate is exact in int64 (the largest, VSMUL's lo·lo =
    2^62, fits), so the reference's 32-bit devices at SEW=32 — sign algebra
    for overflow, the uint32 view of vsaddu, vsmul's 64-bit product rebuilt
    from 16-bit partial products — become plain arithmetic and a clamp.
    Below SEW=32 the reference computes in plain int32, which wraps for
    operands outside the SEW range (a register written at another width);
    the same wrap is applied here.
    """
    s = min(bits, 32)                        # the SEW=64 branch never runs
    lo, hi = -(1 << (s - 1)), (1 << (s - 1)) - 1
    if kind == "vadd":
        return wrap_int(a + b, s), torch.zeros_like(a, dtype=torch.bool)
    if kind == "vsub":
        return wrap_int(a - b, s), torch.zeros_like(a, dtype=torch.bool)
    if kind == "vmul":
        return wrap_int(a * b, s), torch.zeros_like(a, dtype=torch.bool)
    if kind == "vsaddu":
        um = (1 << s) - 1
        r0 = (a & um) + (b & um)
        return wrap_int(r0.clamp(max=um), s), r0 > um
    if kind == "vsadd":
        r0 = a + b
    elif kind == "vssub":
        r0 = a - b
    else:                                    # vsmul, rnu rounding
        r0 = a * b + (1 << (s - 2))
    if s < 32:
        r0 = wrap_int(r0, 32)                # the reference's int32 wraps
    if kind == "vsmul":
        r0 = r0 >> (s - 1)
    r = r0.clamp(lo, hi)
    return r, r != r0


# opcode -> (kind, sets-vxsat) for the integer branch
INT_OPS = {"vadd": ("vadd", False), "vsub": ("vsub", False),
           "vmul": ("vmul", False), "vsaddu": ("vsaddu", True),
           "vsadd": ("vsadd", True), "vssub": ("vssub", True),
           "vsmul": ("vsmul", True)}


# ---------------------------------------------------------------------------
# float rounding: what torch lacks next to XLA
# ---------------------------------------------------------------------------

_SPLIT = 134217729.0       # 2^27 + 1: Veltkamp's splitter for float64
_HI26 = ~((1 << 27) - 1)   # float64 bits: keep the leading 26 significant
# scaled exponents below this lie under every bit of the larger term: such a
# term keeps only its sign, a sticky bit the rounding still sees
_STICKY = 150


def _two_sum(a, b):
    """Knuth's TwoSum: ``s = fl(a + b)`` and the exact error ``a + b - s``."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _round_to_odd(s, err):
    """float64 ``s = fl(x)`` with ``err = x - s`` exact -> ``x`` rounded to
    odd: an inexact result takes the neighbour, toward ``x``, whose last
    bit is 1. A later rounding to a format at least two bits narrower is
    then correct (a single rounding of ``x``). A NaN ``err`` (``s``
    infinite or NaN) leaves ``s`` as it is."""
    fix = (err.abs() > 0) & ((s.view(torch.int64) & 1) == 0)
    return torch.where(fix, torch.nextafter(s, err * float("inf")), s)


def _pow2(n):
    """``2.0 ** n`` as float64 for int64 ``n`` in the normal range."""
    return ((n + 1023) << 52).view(torch.float64)


def fma(a, b, c):
    """``a * b + c`` rounded once, to the dtype of ``c`` (float32/64): IEEE
    754's fusedMultiplyAdd, round to nearest even, over the whole range.

    XLA:CPU contracts the reference's ``a * b + c`` (VFMA, VFMA_VS, VFWMA)
    into one fused multiply-add, so the reference rounds once; torch has no
    fused operation with that guarantee on both devices (``addcmul`` may or
    may not contract, by build and device). This builds it from separately
    rounded operations, identical on CPU and CUDA:

    - float32: the product is exact in float64; the float64 sum is rounded
      to odd, then to float32.
    - float64: the operands are scaled by powers of two so that nothing
      overflows or underflows on the way. ``a`` and ``b`` become their
      mantissas in [1/2, 1) (``frexp``), whose product is exact as
      ``ph + pl`` (Dekker: ``mb`` split by Veltkamp, ``ma`` by masking).
      The product and ``c`` are scaled so the larger of them has exponent
      0; a smaller one more than :data:`_STICKY` binades down keeps only
      its sign. Boldo and Melquiond's ``uh = RN(th + RO(tl + pl))``, with
      ``(th, tl) = TwoSum(c, ph)``, is the sum rounded once, and ``ul``
      what it left out. Scaling back is exact, or rounds ``uh`` once onto
      the subnormal grid (or overflows) as the fused operation does;
      where ``uh`` lies on a midpoint of the subnormal grid, ``ul`` breaks
      the tie first (it cannot carry ``uh`` across one). Where ``a`` or
      ``b`` is zero or ``a``, ``b`` or ``c`` is not finite the result is
      the product of the mantissas plus ``c``, which gives the fused
      operation's zero signs, infinities and NaNs.
    """
    if c.dtype == torch.float32:
        s, err = _two_sum(a.double() * b.double(), c.double())
        return _round_to_odd(s, err).float()
    ma, ea = torch.frexp(a)
    mb, eb = torch.frexp(b)
    mc, ec = torch.frexp(c)
    ph = ma * mb                                        # |ph| in [1/4, 1)
    ah = (ma.view(torch.int64) & _HI26).view(torch.float64)
    al = ma - ah
    t = mb * _SPLIT
    bh = t - (t - mb)
    bl = mb - bh
    pl = ((ah * bh - ph) + ah * bl + al * bh) + al * bl   # ma*mb - ph
    e, ec = (ea + eb).long(), ec.long()
    k = torch.where(mc == 0, e, torch.maximum(e, ec))   # the larger term's
    sp = _pow2((e - k).clamp(min=-_STICKY))
    th, tl = _two_sum(mc * _pow2((ec - k).clamp(-_STICKY, 0)), ph * sp)
    uh, ul = _two_sum(th, _round_to_odd(*_two_sum(tl, pl * sp)))
    lim = _pow2((-1022 - k).clamp(-1000, 300))          # 2^-1022, scaled
    half = lim * 2.0 ** -53                     # half the subnormal spacing
    tie = (uh.abs() < lim) & (torch.fmod(uh, 2 * half).abs() == half) \
        & (ul != 0)
    r = torch.where(tie, uh + torch.copysign(half, ul), uh)
    # r * 2^k1 is exact; the second product is the one rounding left
    k1 = k.clamp(-600, 1000)
    w = torch.copysign(r * _pow2(k1) * _pow2((k - k1).clamp(-1022, 1023)),
                       uh)
    plain = ph + c
    return torch.where((ph != 0) & torch.isfinite(plain), w, plain)


def round_f64_to_f16(x):
    """float64 -> float16 in one rounding (returned as float16).

    torch converts float64 to float16 through float32 on the CPU, which
    rounds twice: 1 + 2^-11 + 2^-40 lands on 1.0, where numpy and the
    reference give 1.001. Rounding to float32 by round-to-odd first keeps
    the second rounding exact (24 >= 11 + 2 bits), on either device."""
    y = x.float()
    yd = y.double()
    away = (yd.abs() > x.abs()).to(torch.int32)      # RN went past x
    bits = y.view(torch.int32)
    odd = torch.where(yd != x, (bits - away) | 1, bits)
    return odd.view(torch.float32).half()


def _bits(x):
    return x.view(torch.int64 if x.dtype == torch.float64 else torch.int32)


def _ieee_max(a, b):
    """XLA's ``max``: NaN propagates and -0.0 < +0.0 (``torch.maximum``
    returns its first operand on a +-0 tie). Equal operands have equal
    bits but for the zeros, where AND keeps the sign only if both are
    -0.0."""
    tie = (_bits(a) & _bits(b)).view(a.dtype)
    return torch.where(a == b, tie, torch.maximum(a, b))


def _ieee_min(a, b):
    """XLA's ``min``: NaN propagates and -0.0 < +0.0 (OR of the bits on
    a tie)."""
    tie = (_bits(a) | _bits(b)).view(a.dtype)
    return torch.where(a == b, tie, torch.minimum(a, b))


# ---------------------------------------------------------------------------
# the staged interpreter: rows in order, one branch per opcode group
# ---------------------------------------------------------------------------

NREGS = isa.NUM_VREGS
SINK = NREGS                 # spare register row: only dropped writes land
# instruction-table columns the branches read as data, kept on the device
# (op, vm and the vtype columns select the branch and are read on the host)
DATA = ("rd", "ra", "rb", "sd", "imm", "aux", "vl", "lmul")
RD, RA, RB, SD, IMM, AUX, VL, LMUL = range(len(DATA))
_STORAGES = (torch.float64, torch.float32, torch.int32)


# a call's table holds, after the DATA columns, each program's batch index
# and its offsets into the flat register file, memory and scalar file
P_IDX, PV, PM, PS = range(len(DATA), len(DATA) + 4)
# a group shape that recurs this often in one call runs as a CUDA graph.
# On an H100 (chip_smoke.py phase vector_engine, "graph_break_even", two
# calls) a capture took 5.6 and 36.1 ms and a replay saved 0.41 and
# 0.53 ms against the eager branch: a capture paid from 14 and 69
# repeats; 128 stays above the spread between calls
GRAPH_MIN_REPEATS = 128


def _capture(fn):
    """A CUDA graph of the kernels ``fn`` launches; ``replay()`` runs them
    again. Nothing runs while it is captured."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def _drain(device):
    """Wait for the replays queued on ``device``'s stream, before their
    graphs are freed."""
    torch.cuda.current_stream(device).synchronize()


class _Call:
    """One runner call's state on the device, every tensor indexed flat
    (``take`` / ``index_put_``): the register file (batch, lanes, 33,
    slots), memory (batch, words), scalars (batch, 32), and the table (P,
    F + 4, batch): per row, the batch sorted by group, its :data:`DATA`
    columns, batch index and offsets (``P_IDX``, ``PV``, ``PM``, ``PS``);
    and the call's cross-lane folds by unit and by mesh axis."""

    def __init__(self, run, mems, svecs, sizes, order, rows):
        perm = order.T                                   # (P, batch)
        vstride = run.lanes * (NREGS + 1) * run.sig.slots
        cols = [np.take_along_axis(rows[f], order, axis=0).T for f in DATA]
        cols += [perm, perm * vstride, perm * mems.shape[1],
                 perm * svecs.shape[1]]
        self.table_np = np.ascontiguousarray(np.stack(cols, axis=1),
                                             dtype=np.int64)
        self.table = torch.from_numpy(self.table_np).to(run.device)
        self.sizes = sizes
        self.folds = collections.Counter()     # by unit
        self.stages = collections.Counter()    # by mesh axis
        self.state(torch.zeros(
            (mems.shape[0], run.lanes, NREGS + 1, run.sig.slots),
            dtype=run.dtype, device=run.device), mems, svecs)

    def state(self, v, mem, s):
        self.v, self.vf = v, v.view(-1)
        self.mem, self.memf = mem, mem.view(-1)
        self.s, self.sf = s, s.view(-1)

    def scratch(self) -> "_Call":
        """The same call on zeroed copies of the state (graph warm-up)."""
        other = copy.copy(self)
        other.folds = collections.Counter()
        other.stages = collections.Counter()
        other.state(torch.zeros_like(self.v), torch.zeros_like(self.mem),
                    torch.zeros_like(self.s))
        return other


class _Group:
    """The programs of a batch that share one row's opcode and vtype: the
    call ``c``, their table columns ``f`` (F + 4, G) — one row each of
    :data:`DATA`, then batch index and offsets — and the static part of
    the row decoded from the group ``key``."""

    __slots__ = ("c", "f", "sewi", "wsewi", "sew", "wsew", "vm", "vpr",
                 "rtab", "wtab", "sink", "nf", "ids", "_mask", "_act", "_pv")

    def __init__(self, run, c, f, key, nf):
        self.c, self.f, self.nf = c, f, nf
        self.sewi, self.wsewi = (key >> 6) & 3, (key >> 8) & 3
        self.sew, self.wsew = isa.SEWS[self.sewi], isa.SEWS[self.wsewi]
        self.vm, self.vpr = (key >> 10) & 1, key >> 11
        self.rtab, self.wtab, self.sink = run._layout(self.vpr)
        self.ids = run.ids
        self._mask = self._act = self._pv = None

    @property
    def p(self):
        """Batch index of each program, (G,)."""
        return self.f[P_IDX]

    @property
    def pv(self):
        """Register-file offset of each program, (G, 1)."""
        if self._pv is None:
            self._pv = self.f[PV].unsqueeze(1)
        return self._pv

    @property
    def pm(self):
        """Memory offset of each program, (G,)."""
        return self.f[PM]

    @property
    def ps(self):
        """Scalar-file offset of each program, (G,)."""
        return self.f[PS]

    @property
    def size(self):
        """True memory words of each program, (G, 1)."""
        return self.c.sizes.index_select(0, self.p).unsqueeze(1)

    @property
    def mask(self):
        """Body elements (global element id < vl), (G, window)."""
        if self._mask is None:
            self._mask = self.ids < self.f[VL].unsqueeze(1)
        return self._mask


class Runner:
    """The staged interpreter for one :class:`Signature` (one device).

    ``runner(mems, svecs, sizes, rows) -> (mems, svecs)``: ``mems`` (batch,
    mem_words) and ``svecs`` (batch, 32) are contiguous tensors on the
    runner's device, updated in place and returned; ``sizes`` (batch,)
    int64 true memory words; ``rows`` the packed numpy table of
    :func:`pack_tables`.

    Register file (batch, lanes, 33, slots), the reference's per-lane
    layout with the lane axis a leading dimension: lane ``l``'s local slot
    ``p`` of a group's window holds global element ``l + p * lanes``, at
    register ``r + p // spr``, slot ``p % spr`` (``spr = vpr // lanes``
    elements of a register per lane; one lane is the reference engine's
    identity layout). A group's window is read lane-major, lane ``l``'s
    ``window / lanes`` elements at positions ``l * window / lanes + p``,
    so a lane-local row (arithmetic, compares, logicals, VMERGE, loads,
    VINS) runs over the lanes as over more elements, each element under
    its global id (``ids``). Row 32 of each lane is a sink reached only by
    the writes the reference drops (outside the body, inactive, masked
    off), so every ``index_put_`` has distinct live indices and stays
    deterministic. The layout of a group's window is a table per register
    capacity ``vpr``, built once: a register read or write is one
    ``index_select`` of the table by base register, one offset add and one
    ``take`` / ``index_put_``. Integer storage runs on exact int64 tensors
    and wraps where the reference's int32 trace wraps; the result converts
    back to int32 at the engine's boundary.

    With more than one lane, the rows the reference reconciles across its
    mesh (the stores, VSUXEI, VEXT, VSLIDE, the reductions, the sticky
    vxsat) exchange through :meth:`_fold` alone: each lane fills a buffer
    of its own, as each of the reference's devices does, and the buffers
    reduce over the lane dimension. With one lane nothing is exchanged
    and those rows keep their direct forms.
    """

    def __init__(self, sig: Signature, stats: CacheStats):
        if sig.kind not in ("ref", "lane", "cluster") or sig.lanes < 1 \
                or sig.clusters < 1 or sig.lanes % sig.clusters \
                or (sig.kind == "ref" and sig.lanes != 1):
            raise ValueError(
                f"no runner for {sig.kind!r} with {sig.lanes} lanes in "
                f"{sig.clusters} clusters")
        if sig.window % sig.lanes:
            raise ValueError(f"window {sig.window} is not a multiple of "
                             f"{sig.lanes} lanes")
        storage = torch_dtype(sig.storage)
        if storage not in _STORAGES:
            raise ValueError(f"storage {sig.storage!r} not supported; "
                             f"use one of {[str(d) for d in _STORAGES]}")
        stats.compiles += 1
        self.sig, self.stats = sig, stats
        self.device = torch.device(sig.device)
        self.lanes, self.clusters = sig.lanes, sig.clusters
        # the ClusterEngine folds over its (clusters, lanes) mesh in two
        # stages, whatever its shape (a 1x4 grid too)
        self.staged = sig.kind == "cluster"
        self.int_storage = not storage.is_floating_point
        self.dtype = torch.int64 if self.int_storage else storage
        # largest int32 the storage represents exactly: f32's 24-bit
        # mantissa caps it below INT32_MAX, so float->int casts clip there
        # (a float->int32 cast out of range is undefined on CUDA)
        self.i32max = (2 ** 31 - 1) if (self.int_storage
                                        or storage.itemsize >= 8) \
            else 2 ** 31 - 128
        self.window = sig.window
        self.words = sig.mem_words
        self.red_p = 1 << max(sig.window - 1, 0).bit_length()
        self.e = torch.arange(sig.window, device=self.device)
        # global element id at each position of a lane-major window
        wl = sig.window // sig.lanes
        self.ids = self.e if sig.lanes == 1 \
            else self.e % wl * sig.lanes + self.e // wl
        self._layouts = {}
        self.graphs = self.device.type == "cuda"   # replay recurring rows

        def const(x):
            return torch.tensor(x, dtype=self.dtype, device=self.device)

        self.zero = const(0)
        if self.int_storage:
            self.max_ident = [const(-(1 << (min(b, 32) - 1)))
                              for b in isa.SEWS]
            self.min_ident = [const((1 << (min(b, 32) - 1)) - 1)
                              for b in isa.SEWS]
        else:
            inf = float("inf")
            self.max_ident = [const(x) for x in (-inf, -inf, -inf, -128.0)]
            self.min_ident = [const(x) for x in (inf, inf, inf, 127.0)]
        named = {k: self._int_op(*v) for k, v in INT_OPS.items()}
        branches = {
            "nop": None, "vld": self._vld, "vlds": self._vlds,
            "vgather": self._vgather, "vlseg": self._vlseg,
            "vst": self._vst, "vsseg": self._vsseg, "vsuxei": self._vsuxei,
            "vfma": self._vfma, "vfma_vs": self._vfma_vs,
            "vfadd": self._binary(torch.add), "vfmul": self._binary(torch.mul),
            "vfwmul": self._binary(torch.mul, wide=True),
            "vfwma": self._vfwma, "vfncvt": self._vfncvt,
            "vins": self._vins, "vext": self._vext, "vslide": self._vslide,
            "ldscalar": self._ldscalar,
            "vmseq": self._cmp(torch.eq, False),
            "vmsne": self._cmp(torch.ne, False),
            "vmslt": self._cmp(torch.lt, False),
            "vmsle": self._cmp(torch.le, False),
            "vmfeq": self._cmp(torch.eq, True),
            "vmflt": self._cmp(torch.lt, True),
            "vmand": self._logical(torch.logical_and),
            "vmor": self._logical(torch.logical_or),
            "vmxor": self._logical(torch.logical_xor),
            "vmerge": self._vmerge,
            "vredsum": self._red("sum"), "vredmax": self._red("max"),
            "vredmin": self._red("min"), "vfwredsum": self._red("sum", True),
            **named}
        self._branches = [branches[name] for name in OPS]

    # -- the host schedule ---------------------------------------------------

    @staticmethod
    def schedule(rows):
        """Group each row's programs by (opcode, sewi, wsewi, vm, vpr).

        Returns ``order`` (batch, P): per row, the batch sorted by group
        (stable), and ``groups``: one ``(row, start, end, key)`` per
        non-NOP group, in row order, ``start:end`` indexing ``order``'s
        column. ``key`` packs op (6 bits), sewi, wsewi (2 each), vm (1)
        and vpr above them."""
        key = (rows["op"].astype(np.int64)
               | rows["sewi"].astype(np.int64) << 6
               | rows["wsewi"].astype(np.int64) << 8
               | rows["vm"].astype(np.int64) << 10
               | rows["vpr"].astype(np.int64) << 11)
        batch, plen = key.shape
        order = np.argsort(key, axis=0, kind="stable")
        skey = np.take_along_axis(key, order, axis=0)
        first = np.ones(skey.shape, bool)
        first[1:] = skey[1:] != skey[:-1]
        row, start = np.nonzero(first.T)          # by row, then start
        flat = row * batch + start
        end = np.append(flat[1:], plen * batch) - row * batch
        gkey = skey[start, row]
        live = (gkey & 63) != OP_ID["nop"]
        groups = zip(row[live].tolist(), start[live].tolist(),
                     end[live].tolist(), gkey[live].tolist())
        return order, groups

    def __call__(self, mems, svecs, sizes, rows):
        order, groups = self.schedule(rows)
        c = _Call(self, mems, svecs, sizes, order, rows)
        seg = (OP_ID["vlseg"], OP_ID["vsseg"])
        groups = [(r, start, end, key, int(c.table_np[
            r, AUX, start:end].max()) if key & 63 in seg else 0)
            for r, start, end, key in groups]
        graphs = self._graphs(c, groups) if self.graphs else {}
        for r, start, end, key, nf in groups:
            replay = graphs.get((key, end - start, nf))
            if replay is None:
                self._branches[key & 63](_Group(
                    self, c, c.table[r, :, start:end], key, nf))
            else:
                replay[0].copy_(c.table[r, :, start:end])
                replay[1].replay()
                c.folds.update(replay[2])
                c.stages.update(replay[3])
        if graphs:
            _drain(self.device)      # the graphs go with this frame
        self.stats.folds.update(c.folds)
        self.stats.fold_stages.update(c.stages)
        return mems, svecs

    def _graphs(self, c, groups):
        """CUDA graphs of the group shapes — (key, programs, fields) — that
        recur at least :data:`GRAPH_MIN_REPEATS` times in this call, each
        captured once before the row loop on a static copy of its table
        columns, after a warm-up run on scratch state. A replay runs the
        same kernels on the same data as the eager branch, so the results
        are the same bits; each replay counts the folds its capture made."""
        counts = collections.Counter((key, end - start, nf)
                                     for _, start, end, key, nf in groups)
        sample = {}
        for r, start, end, key, nf in groups:
            shape = (key, end - start, nf)
            if counts[shape] >= GRAPH_MIN_REPEATS and shape not in sample:
                sample[shape] = c.table[r, :, start:end]
        graphs = {}
        scratch = c.scratch() if sample else None
        folds, stages = c.folds, c.stages
        for (key, n, nf), cols in sample.items():
            branch = self._branches[key & 63]
            static = cols.clone()
            branch(_Group(self, scratch, cols.clone(), key, nf))
            c.folds, c.stages = collections.Counter(), collections.Counter()
            graph = _capture(lambda b=branch, f=static, k=key, m=nf:
                             b(_Group(self, c, f, k, m)))
            graphs[(key, n, nf)] = (static, graph, c.folds, c.stages)
        c.folds, c.stages = folds, stages
        return graphs

    def _layout(self, vpr: int):
        """Flat register-file offsets of a lane-major window at ``vpr``
        elements per register, per base register (NREGS, window): for
        reads, clamped to v31 as the reference clamps (those elements lie
        past the group and are never used); for writes, clamped to the
        lane's sink row; and the sink itself. Built once per capacity."""
        lay = self._layouts.get(vpr)
        if lay is None:
            slots, lanes = self.sig.slots, self.lanes
            spr = max(vpr // lanes, 1)       # a register's slots per lane
            p, slot = self.e, self.e % spr   # the lane's local slot
            if lanes > 1:
                wl = self.window // lanes
                p = self.e % wl
                slot = p % spr + (self.e // wl) * ((NREGS + 1) * slots)
            reg = torch.arange(NREGS, device=self.device)[:, None] + p // spr
            lay = self._layouts[vpr] = (
                reg.clamp(max=NREGS - 1) * slots + slot,
                reg.clamp(max=SINK) * slots + slot, SINK * slots + slot)
        return lay

    # -- register file, masks, rounding --------------------------------------

    def _R(self, g, base):
        """Group ``base`` (per-program (G,) tensor, or 0 for v0) over the
        window, (G, window)."""
        if isinstance(base, int):
            idx = g.rtab[base] + g.pv
        else:
            idx = g.rtab.index_select(0, base).add_(g.pv)
        return g.c.vf.take(idx)

    def _W(self, g, base, vals, ok):
        """Write ``vals`` to group ``base`` where ``ok``; elsewhere the
        write goes to the sink row."""
        idx = torch.where(ok, g.wtab.index_select(0, base), g.sink)
        g.c.vf.index_put_((idx.add_(g.pv),), vals.to(self.dtype))

    def _act(self, g):
        """The active body: mask-undisturbed predication off the v0 group
        (element active iff nonzero) for vm=0 groups."""
        if g._act is None:
            g._act = g.mask if g.vm else g.mask & (self._R(g, 0) != 0)
        return g._act

    def _q(self, x, bits: int):
        """HW-width rounding: float storage rounds to the SEW float format
        (identity when at least the storage's width), except SEW=8 — the
        integer lane — which truncates and wraps to int8. Integer storage
        makes the engine an exact fixed-point machine: every width wraps."""
        if self.int_storage:
            return wrap_int(x, min(bits, 32))
        if bits == 8:
            return wrap_int(self._to_int(x), 8).to(self.dtype)
        dt = dtype_for_sew(bits)
        if dt.itemsize >= self.dtype.itemsize:
            return x
        if self.dtype == torch.float64 and dt == torch.float16:
            return round_f64_to_f16(x).double()
        return x.to(dt).to(self.dtype)

    def _to_int(self, x):
        """Storage value -> int32 two's-complement value (as int64): NaN
        pins to 0 and the value clips to the storage's exact int32 range
        before the cast."""
        if self.int_storage:
            return x
        return torch.nan_to_num(x, nan=0.0).clamp_(
            -(2.0 ** 31), float(self.i32max)).long()

    def _index(self, x):
        """A register read as an index: the reference's ``astype(int32)``,
        which saturates (NaN -> 0)."""
        if self.int_storage:
            return x
        return torch.nan_to_num(x.double(), nan=0.0).clamp_(
            -(2.0 ** 31), 2.0 ** 31 - 1).long()

    def _gidx(self, idx):
        """Memory address -> gather index as the reference's gather takes
        it: a negative address wraps once, then it clamps into the padded
        memory (one clamp to [-words, words) and a remainder do both)."""
        return idx.clamp(-self.words, self.words - 1).remainder_(self.words)

    def _load(self, g, idx):
        """Memory words at per-program addresses ``idx`` (G, n)."""
        return g.c.memf.take(self._gidx(idx).add_(g.pm.unsqueeze(1)))

    def _fma(self, a, b, c):
        if self.int_storage:
            return a * b + c            # exact in int64; _q wraps it
        return fma(a, b, c)

    # -- memory ---------------------------------------------------------------

    # -- exchanges across lanes -----------------------------------------------

    def _fold(self, g, unit, x, reduce="sum"):
        """The reference's ``allsum`` / ``allmax``: ``x`` (G, lanes, ...)
        reduced over its lane dimension — for the ClusterEngine within each
        cluster first, then across clusters, as the reference's nested
        ``psum``/``pmax``. Every fold is exact: at each position one lane
        holds the live value and the others the identity (a -0.0 comes
        out +0.0, as from the reference's ``psum``). Counted by ``unit``
        and by mesh axis in the runner's stats."""
        g.c.folds[unit] += 1
        g.c.stages["lanes"] += 1
        red = torch.sum if reduce == "sum" else torch.amax
        if self.staged:
            g.c.stages["clusters"] += 1
            x = red(x.unflatten(1, (self.clusters, -1)), 2)
        return red(x, 1)

    def _scatter(self, g, unit, n, idx, vals, fill=0, reduce="sum"):
        """The reference's ``all<reduce>(full(n, fill).at[idx].<reduce>(
        vals))`` for a lane-major window ``idx``, ``vals`` (G, window):
        each lane scatters its elements into a buffer of ``n`` of its own
        (``reduce`` "sum", "amax", or "set" at indices distinct within a
        lane) and the buffers fold over the lanes (:meth:`_fold`); with
        one lane, the one buffer (G, n)."""
        batch, lanes = idx.shape[0], self.lanes
        shape = (batch, n) if lanes == 1 else (batch, lanes, n)
        buf = torch.full(shape, fill, dtype=vals.dtype, device=self.device)
        if lanes > 1:
            idx, vals = idx.view(batch, lanes, -1), vals.view(batch, lanes, -1)
        dim = len(shape) - 1
        if reduce == "sum":
            buf.scatter_add_(dim, idx, vals)
        elif reduce == "amax":
            buf.scatter_reduce_(dim, idx, vals, "amax")
        else:
            buf.scatter_(dim, idx, vals)
        if lanes == 1:
            return buf
        return self._fold(g, unit, buf, "amax" if reduce == "amax" else "sum")

    # -- memory ---------------------------------------------------------------

    def _mstore(self, g, gidx, vals, ok):
        """VLSU collect, in the reference's form: each lane scatter-adds
        its valid contributions onto zeros and counts its writers per
        address, the sums and counts fold over the lanes, and an address
        with a writer takes the sum. Dead elements add a zero at index 0.
        On CUDA ``scatter_add_`` is atomic and its order unspecified; the
        sum is exact all the same, because every address has at most one
        live writer besides those zeros (x + 0 = x, and a -0.0 writer
        lands as +0.0 in any order, as in the reference). An index the
        reference's scatter drops (negative past one wrap) goes to a spare
        sink column."""
        words = self.words
        gi = torch.where(ok, gidx, 0)
        gi = torch.where(gi < -words, words, gi.remainder(words))
        upd = self._scatter(g, "vlsu", words + 1, gi,
                            torch.where(ok, vals, self.zero))
        cnt = self._scatter(g, "vlsu", words + 1, gi, ok.to(torch.int32))
        p = g.p
        g.c.mem.index_copy_(0, p, torch.where(
            cnt[:, :words] > 0, upd[:, :words], g.c.mem.index_select(0, p)))

    # inactive elements of a load read some in-range address: the masked
    # write drops them, as it drops the reference's reads of address 0

    def _vld(self, g):
        idx = g.f[IMM].unsqueeze(1) + self.ids
        act = self._act(g)
        self._W(g, g.f[RD], self._q(self._load(g, idx), g.sew), act)

    def _vlds(self, g):
        idx = g.f[IMM].unsqueeze(1) + g.f[AUX].unsqueeze(1) * self.ids
        act = self._act(g)
        self._W(g, g.f[RD], self._q(self._load(g, idx), g.sew), act)

    def _indexed(self, g):
        """VGATHER/VLUXEI/VSUXEI addresses: OOB indexed accesses are UB in
        HW; the model pins them to the *true* memory edges."""
        iv = self._index(self._R(g, g.f[RA]))
        gi = wrap_int(g.f[IMM].unsqueeze(1) + iv, 32)
        return torch.minimum(gi.clamp_(min=0), g.size - 1)

    def _vgather(self, g):
        gi = self._indexed(g).add_(g.pm.unsqueeze(1))
        self._W(g, g.f[RD], self._q(g.c.memf.take(gi), g.sew), self._act(g))

    def _vlseg(self, g):
        nf = g.f[AUX].unsqueeze(1)
        base = g.f[IMM].unsqueeze(1) + nf * self.ids
        for f in range(g.nf):
            self._W(g, g.f[RD] + f * g.f[LMUL],
                    self._q(self._load(g, base + f), g.sew),
                    g.mask & (f < nf))

    def _vst(self, g):
        gi = g.f[IMM].unsqueeze(1) + self.ids
        self._mstore(g, gi, self._R(g, g.f[RD]),
                     self._act(g) & (gi < g.size))

    def _vsseg(self, g):
        nf = g.f[AUX].unsqueeze(1)
        size = g.size
        for f in range(g.nf):
            gi = g.f[IMM].unsqueeze(1) + f + nf * self.ids
            ok = g.mask & (f < nf) & (gi < size)
            self._mstore(g, gi, self._R(g, g.f[RD] + f * g.f[LMUL]), ok)

    def _vsuxei(self, g):
        # highest element wins: each address's winning element id by a
        # max-scatter folded over the lanes, then only the winner
        # contributes
        act = self._act(g)
        gi = self._indexed(g)
        order = self._scatter(g, "vlsu", self.words, gi,
                              torch.where(act, self.ids, -1), -1, "amax")
        win = act & (order.gather(1, gi) == self.ids)
        contrib = self._scatter(g, "vlsu", self.words,
                                torch.where(win, gi, 0), torch.where(
                                    win, self._R(g, g.f[RD]), self.zero))
        p = g.p
        g.c.mem.index_copy_(0, p, torch.where(
            order >= 0, contrib, g.c.mem.index_select(0, p)))

    # -- arithmetic -----------------------------------------------------------

    def _vfma(self, g):
        res = self._fma(self._R(g, g.f[RA]), self._R(g, g.f[RB]),
                        self._R(g, g.f[RD]))
        self._W(g, g.f[RD], self._q(res, g.sew), self._act(g))

    def _vfma_vs(self, g):
        s = g.c.sf.take(g.ps + g.f[SD]).unsqueeze(1)
        res = self._fma(s, self._R(g, g.f[RB]), self._R(g, g.f[RD]))
        self._W(g, g.f[RD], self._q(res, g.sew), self._act(g))

    def _vfwma(self, g):
        res = self._fma(self._R(g, g.f[RA]), self._R(g, g.f[RB]),
                        self._R(g, g.f[RD]))
        self._W(g, g.f[RD], self._q(res, g.wsew), self._act(g))

    def _binary(self, fn, wide=False):
        def op(g):
            res = fn(self._R(g, g.f[RA]), self._R(g, g.f[RB]))
            self._W(g, g.f[RD], self._q(res, g.wsew if wide else g.sew),
                    self._act(g))
        return op

    def _vfncvt(self, g):
        self._W(g, g.f[RD], self._q(self._R(g, g.f[RA]), g.sew),
                self._act(g))

    def _int_op(self, kind, sticky):
        # integer/fixed-point branch: int view in, wrapped or saturated
        # result out; vxsat is scalar register VXSAT_SREG, per program
        def op(g):
            act = self._act(g)
            res, sat = int_arith(kind, self._to_int(self._R(g, g.f[RA])),
                                 self._to_int(self._R(g, g.f[RB])), g.sew)
            self._W(g, g.f[RD], res, act)
            if sticky:
                if self.lanes == 1:
                    flag = (act & sat).any(1).to(self.dtype)
                else:
                    flag = self._fold(g, "vxsat", (act & sat).view(
                        sat.shape[0], self.lanes, -1).any(2).to(self.dtype),
                        "amax")
                idx = g.ps + isa.VXSAT_SREG
                g.c.sf.index_put_(
                    (idx,), torch.maximum(g.c.sf.take(idx), flag))
        return op

    # -- slide unit and scalars -----------------------------------------------

    def _vins(self, g):
        vals = self._q(g.c.sf.take(g.ps + g.f[SD]), g.sew).unsqueeze(1)
        self._W(g, g.f[RD], vals, g.mask)

    def _vext(self, g):
        # the reference sums the one hit element with zeros: an extract of
        # -0.0 reads +0.0, so does this (+ 0); at-or-past vl it reads 0
        aux = g.f[AUX]
        if self.lanes > 1:
            hit = g.mask & (self.ids == aux.unsqueeze(1))
            val = torch.where(hit, self._R(g, g.f[RA]), self.zero)
            val = self._fold(g, "sldu", val.view(
                val.shape[0], self.lanes, -1).sum(2))
            g.c.sf.index_put_((g.ps + g.f[SD],), val)
            return
        ok = (aux >= 0) & (aux < g.f[VL])
        reg = (g.f[RA] + aux.div(g.vpr, rounding_mode="floor")).clamp_(
            0, NREGS - 1)
        idx = reg.mul_(self.sig.slots).add_(aux.remainder(g.vpr))
        val = g.c.vf.take(idx.add_(g.f[PV]))
        g.c.sf.index_put_((g.ps + g.f[SD],),
                          torch.where(ok, val, self.zero) + 0)

    def _vslide(self, g):
        # SLDU: the group materialised globally (each lane places its
        # elements at their global ids, folded over the lanes), then the
        # gather at i + amount. Tail-undisturbed (Ara2/RVV 1.0): body
        # elements whose source would come from at-or-past vl are NOT
        # written
        src = torch.where(g.mask, self._R(g, g.f[RA]), self.zero)
        if self.lanes > 1:
            src = self._scatter(g, "sldu", self.window,
                                self.ids.expand_as(src), src, reduce="set")
        shifted = self.ids + g.f[AUX].unsqueeze(1)
        tgt = shifted.clamp(0, self.window - 1)
        self._W(g, g.f[RD], src.gather(1, tgt),
                g.mask & (shifted < g.f[VL].unsqueeze(1)))

    def _ldscalar(self, g):
        val = g.c.memf.take(self._gidx(g.f[IMM]).add_(g.pm))
        g.c.sf.index_put_((g.ps + g.f[SD],), val)

    # -- masks and reductions -------------------------------------------------

    def _cmp(self, fn, fp):
        # mask-generating compares: exact 0/1 in mask layout,
        # mask-undisturbed where the compare is itself masked
        def op(g):
            a, b = self._R(g, g.f[RA]), self._R(g, g.f[RB])
            if not fp:
                a, b = self._to_int(a), self._to_int(b)
            self._W(g, g.f[RD], fn(a, b), self._act(g))
        return op

    def _logical(self, fn):
        def op(g):
            res = fn(self._R(g, g.f[RA]) != 0, self._R(g, g.f[RB]) != 0)
            self._W(g, g.f[RD], res, g.mask)
        return op

    def _vmerge(self, g):
        vals = torch.where(self._R(g, 0) != 0, self._R(g, g.f[RA]),
                           self._R(g, g.f[RB]))
        self._W(g, g.f[RD], vals, g.mask)

    def _red(self, kind, wide=False):
        # classless tree reduction: the ACTIVE body at its global ids, the
        # rest and the pow2 padding the op identity, folded in halves (lo
        # op hi): the summation order is the contract the oracle's
        # _tree_reduce mirrors. With lanes, each lane places its active
        # elements and counts them, folded over the lanes as the
        # reference's two psums; with one lane the placement is the
        # identity, so a select stands for it
        if kind == "sum":
            comb = torch.add
        elif self.int_storage:
            comb = torch.maximum if kind == "max" else torch.minimum
        else:
            comb = _ieee_max if kind == "max" else _ieee_min

        def op(g):
            ident = {"sum": self.zero, "max": self.max_ident[g.sewi],
                     "min": self.min_ident[g.sewi]}[kind]
            act = self._act(g)
            if self.lanes > 1:
                idx = self.ids.expand_as(act)
                vec = self._scatter(g, "sldu", self.red_p, idx, torch.where(
                    act, self._R(g, g.f[RA]), self.zero), reduce="set")
                cnt = self._scatter(g, "sldu", self.red_p, idx,
                                    act.to(torch.int32), reduce="set")
                vec = torch.where(cnt > 0, vec, ident)
            else:
                vec = torch.where(act, self._R(g, g.f[RA]), ident)
            if vec.shape[1] < self.red_p:
                vec = torch.cat([vec, ident.expand(
                    vec.shape[0], self.red_p - self.window)], 1)
            n = self.red_p
            while n > 1:
                n //= 2
                vec = comb(vec[:, :n], vec[:, n:2 * n])
            res = self._q(vec[:, 0], g.wsew if wide else g.sew)
            # scalar destination: element 0 only, nothing at vl=0
            reg = torch.where(g.f[VL] > 0, g.f[RD], SINK)
            idx = reg.mul_(self.sig.slots).add_(g.f[PV])
            g.c.vf.index_put_((idx,), res.to(self.dtype))
        return op


def build_runner(sig: Signature, stats: CacheStats, mesh=None,
                 axis: str = None, axes: tuple = None) -> Runner:
    """Build the one :class:`Runner` for ``sig``.

    The runner's topology is the signature's: ``kind`` "ref" (one lane),
    "lane" (``sig.lanes`` lanes, one fold over them) or "cluster" (the
    lanes in ``sig.clusters`` clusters, folded within a cluster, then
    across). ``mesh`` (a :class:`Mesh`), ``axis`` (the LaneEngine's lane
    axis) and ``axes`` (the ClusterEngine's (clusters, lanes) pair) name
    it as the reference's arguments do; given, they must agree with the
    signature, else ``ValueError`` (an axis the mesh lacks included). A
    mesh given alone names its axes itself; an axis or axes alone stand
    for a mesh of the signature's sizes."""
    if mesh is not None or axis is not None or axes is not None:
        if axis is not None and axes is not None:
            raise ValueError("build_runner: give axis (lanes) or axes "
                             "(clusters, lanes), not both")
        if axes is not None:
            names = tuple(axes)
        elif axis is not None:
            names = (axis,)
        else:
            names = tuple(mesh.axis_names)
        if len(names) not in (1, 2):
            raise ValueError(f"build_runner: a lane mesh has one or two "
                             f"axes, not {names}")
        if mesh is None:
            sizes = (sig.lanes,) if len(names) == 1 \
                else (sig.clusters, sig.lanes // sig.clusters)
            mesh = Mesh(names, sizes)
        key = mesh_fingerprint(mesh, names)
        sizes = [n for _, n in key]
        want = ("lane", sizes[0], 1) if len(names) == 1 \
            else ("cluster", sizes[0] * sizes[1], sizes[0])
        if (sig.kind, sig.lanes, sig.clusters) != want:
            raise ValueError(
                f"build_runner: mesh axes {key} do not describe a "
                f"{sig.kind!r} signature of {sig.lanes} lanes in "
                f"{sig.clusters} clusters")
    return Runner(sig, stats)
