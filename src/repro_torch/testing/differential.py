"""Cross-engine differential test harness (SEW × LMUL random programs).

The repo's correctness story for the vector model is differential: three
independent executors of core/isa.py — the jnp ``ReferenceEngine``, the
shard_map ``LaneEngine``, and the dead-simple numpy oracle here — must
agree on every legal program. This module packages the pieces so any test
(or CI job, or future engine) can run the contract:

- ``numpy_oracle``: an intentionally naive numpy executor (python loops
  where that is the clearest spelling, e.g. the scatter's
  highest-element-wins rule). It shares nothing with the engines except
  ``isa.check_insn``, which is the point.
- ``random_program``: legal-by-construction program generator over the
  full SEW × LMUL × op-set grid — alignment-aware register allocation,
  widening/narrowing only where EMUL permits, segment fields bounded by
  ``nf * lmul <= 8``. Out-of-bounds indexed accesses are deliberately
  *allowed*: clamp + highest-element-wins makes them deterministic, so
  the differential contract covers them too.
- ``run_cells``: the batched runner. Programs are generated per
  SEW × LMUL cell and driven through two *batch* executors —
  ``engine_batch`` wraps an engine's compile-once ``run_many`` (every
  cell shares ONE compiled signature via the grid-wide ``window``), and
  ``oracle_batch``/``per_program_batch`` wrap per-program executors —
  then compared program by program. This is what makes the full
  lane-pair grid cheap enough for tier-1: one XLA compile per engine
  for the whole sweep instead of one per program.
- ``run_pair``: the per-program spelling, kept for callers holding plain
  ``(program, memory, sregs) -> (mem, sregs)`` callables; it groups the
  same ``grid`` seed assignment into cells and delegates to
  ``run_cells``. On mismatch the failing (sew, lmul, seed) triple is
  written to ``$DIFFERENTIAL_SEED_FILE`` (if set — CI uploads it as an
  artifact) and the assertion names it, so any failure is reproducible
  from the log alone.

Programs fix one vtype up front (plus the generator may not re-vsetvl):
cross-vtype register reinterpretation is deliberately exercised by the
dedicated tests instead, where the expected layout is spelled out.
"""
from __future__ import annotations

import json
import os
from fractions import Fraction
from typing import Callable, Iterable, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import analysis, isa

# SEW -> the rounding format: float formats for the FPU widths, int8
# two's complement for the integer lane (no FP8 format exists)
SEW_NP = {64: np.float64, 32: np.float32, 16: np.float16, 8: np.int8}

# storage is f32 for the in-process pair; f16 rounding dominates its tol;
# SEW=8 cells are pure-integer and exact in any storage
TOL = {64: 1e-5, 32: 1e-5, 16: 1e-2, 8: 1e-6}

# oracle/program memory size (elements): the LOW half is the program's
# address space, the HIGH half is the register-dump region the generator
# epilogue stores every work group into at full VLMAX — so TAIL lanes
# land in compared memory and a tail-policy bug can never hide again.
# CONSTANT across cells so every cell of a sweep pads to the same
# mem_words — one signature, one XLA compile per engine for the grid
MEM_WORDS = 8192
INT_REGION = 256      # mem[:INT_REGION] holds small ints (index material)
VLMAX64 = 8           # default per-register 64-bit VLMAX for the grid

FP_POOL = ("vfma", "vfma_vs", "vfadd", "vfmul", "vfwmul", "vfwma",
           "vfncvt")
INT_POOL = ("vadd", "vsub", "vmul", "vsaddu", "vsadd", "vssub", "vsmul")
# mask-generating compares split by op class like the arithmetic pools
INT_CMP_POOL = ("vmseq", "vmsne", "vmslt", "vmsle")
FP_CMP_POOL = ("vmfeq", "vmflt")
MASK_POOL = ("vmand", "vmor", "vmxor", "vmerge")
RED_POOL = ("vredsum", "vredmax", "vredmin", "vfwredsum")

DEFAULT_OPS = FP_POOL + INT_POOL + INT_CMP_POOL + FP_CMP_POOL \
    + MASK_POOL + RED_POOL + (
        "vins", "vld", "vlds", "vgather", "vluxei", "vst", "vsuxei",
        "vlseg", "vsseg", "vslide", "vext", "ldscalar")


# ---------------------------------------------------------------------------
# numpy oracle
# ---------------------------------------------------------------------------


def _wrap_np(x, bits: int):
    """int -> signed two's-complement ``bits``-wide value, int64 math."""
    m = 1 << bits
    r = np.asarray(x).astype(np.int64) & (m - 1)
    return r - ((r & (m >> 1)) << 1)


def to_int_np(x, storage=np.float32):
    """Mirror of the engines' storage-float -> int32 canonicalization:
    NaN pins to 0, values clip to the largest storage-representable
    int32, then truncate toward zero. Int storage passes through."""
    if np.issubdtype(np.dtype(storage), np.integer):
        return np.asarray(x).astype(np.int64)
    hi = (2 ** 31 - 1) if np.dtype(storage).itemsize >= 8 else 2 ** 31 - 128
    a = np.asarray(x, np.float64)
    a = np.where(np.isnan(a), 0.0, a)
    return np.clip(a, -(2.0 ** 31), hi).astype(np.int64)


def quantize(x, bits: int, storage=np.float32):
    """The per-SEW register rounding rule, shared with targeted tests:
    float formats for SEW >= 16, int8 truncate-and-wrap for SEW=8, and
    pure integer wrap at every width when ``storage`` is an int dtype
    (the exact fixed-point machine the int8 property tests drive)."""
    if np.issubdtype(np.dtype(storage), np.integer):
        return _wrap_np(x, min(bits, 32)).astype(storage)
    if bits == 8:
        return _wrap_np(to_int_np(x, storage), 8).astype(storage)
    dt = np.dtype(SEW_NP[bits])
    if dt.itemsize >= np.dtype(storage).itemsize:
        return np.asarray(x, storage)
    return np.asarray(x).astype(dt).astype(storage)


def _int_bin_np(kind: str, a, b, sew: int):
    """Fixed-point/int op on int64 canonical values — an independent
    spelling of staging.int_arith (int64 throughout, no 32-bit tricks);
    returns (result int64, saturated bool)."""
    lo, hi = -(1 << (sew - 1)), (1 << (sew - 1)) - 1
    if kind in ("vadd", "vsub", "vmul"):
        r = {"vadd": a + b, "vsub": a - b, "vmul": a * b}[kind]
        return _wrap_np(r, sew), np.zeros(np.shape(a), bool)
    if kind == "vsaddu":
        m = (1 << sew) - 1
        r0 = (a & m) + (b & m)
        return _wrap_np(np.minimum(r0, m), sew), r0 > m
    if kind == "vsadd":
        r0 = a + b
    elif kind == "vssub":
        r0 = a - b
    else:                                    # vsmul, vxrm = rnu
        r0 = (a * b + (1 << (sew - 2))) >> (sew - 1)
    r = np.clip(r0, lo, hi)
    return r, r != r0


_INT_INSNS = {isa.VADD: "vadd", isa.VSUB: "vsub", isa.VMUL: "vmul",
              isa.VSADDU: "vsaddu", isa.VSADD: "vsadd",
              isa.VSSUB: "vssub", isa.VSMUL: "vsmul"}
_STICKY = ("vsaddu", "vsadd", "vssub", "vsmul")

_INT_CMP_NP = {isa.VMSEQ: np.equal, isa.VMSNE: np.not_equal,
               isa.VMSLT: np.less, isa.VMSLE: np.less_equal}
_FP_CMP_NP = {isa.VMFEQ: np.equal, isa.VMFLT: np.less}
_LOGICAL_NP = {isa.VMAND: np.logical_and, isa.VMOR: np.logical_or,
               isa.VMXOR: np.logical_xor}
_RED_KIND = {isa.VREDSUM: "sum", isa.VREDMAX: "max", isa.VREDMIN: "min",
             isa.VFWREDSUM: "wsum"}


def _tree_reduce(kind: str, vals, act, sew: int, storage):
    """The engines' fixed fold tree, mirrored independently in numpy.

    Active values land in a next-pow2(vl) window padded with the op
    identity, then halves fold: combine(vec[:n], vec[n:]). The fold is
    identity-invariant to the pow2 padding width, so this matches the
    engine's global-window tree bit for bit. Integer storage folds in
    int64 (mod-2^32 addition is a ring homomorphism, so the engine's
    int32 node wraps agree after the final quantize); float storage
    folds in the storage dtype with no per-node rounding, exactly like
    the staged step. The result is quantized at SEW (2*SEW for the
    widening sum) by the caller.
    """
    int_store = np.issubdtype(np.dtype(storage), np.integer)
    s = min(sew, 32)
    if kind in ("sum", "wsum"):
        ident = 0
    elif kind == "max":
        ident = -(1 << (s - 1)) if int_store \
            else (-128.0 if sew == 8 else -np.inf)
    else:
        ident = (1 << (s - 1)) - 1 if int_store \
            else (127.0 if sew == 8 else np.inf)
    vl = len(vals)
    p = 1 << max(vl - 1, 0).bit_length()
    vec = np.full(p, ident, np.int64 if int_store else storage)
    vec[:vl][act] = np.asarray(vals)[act]
    n = p
    while n > 1:
        n //= 2
        lo, hi = vec[:n], vec[n:2 * n]
        if kind == "max":
            vec = np.maximum(lo, hi)
        elif kind == "min":
            vec = np.minimum(lo, hi)
        else:
            vec = lo + hi
    return vec[0]


def numpy_oracle(program, memory, vlmax64: int, sregs: Optional[dict] = None,
                 storage=np.float32):
    """Independent executor of the ISA semantics; see module docstring."""
    mem = np.asarray(memory, storage).copy()
    n_elems = vlmax64 * (64 // min(isa.SEWS))
    v = np.zeros((isa.NUM_VREGS, n_elems), storage)
    s = dict(sregs or {})
    s.setdefault(isa.VXSAT_SREG, 0.0)        # the sticky vxsat shadow
    vl, sew, lmul = vlmax64, 64, 1

    def q(x, bits):
        return quantize(x, bits, storage)

    for insn_index, ins in enumerate(program):
        t = type(ins)
        isa.check_insn(ins, sew, lmul, index=insn_index)
        vpr = vlmax64 * (64 // sew)          # per-register capacity
        span = isa.group_span(lmul)

        def R(reg):
            if vl <= vpr:
                return v[reg, :vl]
            return np.concatenate(
                [v[reg + g, :vpr] for g in range(span)])[:vl]

        def W(reg, vals, ok=None):
            if ok is not None:               # mask-undisturbed write
                cur = np.array(R(reg), storage)
                cur[ok] = np.asarray(vals, storage)[ok]
                vals = cur
            if vl <= vpr:
                v[reg, :vl] = vals
                return
            for g in range(span):
                lo = g * vpr
                if lo >= vl:
                    break
                hi = min(vl, lo + vpr)
                v[reg + g, :hi - lo] = vals[lo:hi]

        def A(vm):
            """The active body: all of it when unmasked, else where the
            v0 group is nonzero (the value-model mask layout)."""
            if vm:
                return np.ones(vl, bool)
            return np.asarray(R(isa.MASK_REG)) != 0

        if t is isa.VSETVL:
            sew, lmul = ins.sew, ins.lmul
            vl = isa.vsetvl_grant(ins.vl, vlmax64, sew, lmul)
        elif t is isa.VLD:
            W(ins.vd, q(mem[ins.addr:ins.addr + vl], sew), A(ins.vm))
        elif t is isa.VLDS:
            idx = ins.addr + ins.stride * np.arange(vl)
            W(ins.vd, q(mem[idx], sew), A(ins.vm))
        elif t in (isa.VGATHER, isa.VLUXEI):
            idx = ins.addr + R(ins.vidx).astype(np.int32)
            idx = np.clip(idx, 0, mem.shape[0] - 1)
            W(ins.vd, q(mem[idx], sew), A(ins.vm))
        elif t is isa.VLSEG:
            base = ins.addr + ins.nf * np.arange(vl)
            for f in range(ins.nf):
                W(ins.vd + f * span, q(mem[base + f], sew))
        elif t is isa.VST:
            act = A(ins.vm)
            tgt = mem[ins.addr:ins.addr + vl]
            tgt[act] = np.asarray(R(ins.vs), storage)[act]
        elif t is isa.VSSEG:
            base = ins.addr + ins.nf * np.arange(vl)
            for f in range(ins.nf):
                mem[base + f] = R(ins.vs + f * span)
        elif t is isa.VSUXEI:
            act = A(ins.vm)
            idx = ins.addr + R(ins.vidx).astype(np.int32)
            idx = np.clip(idx, 0, mem.shape[0] - 1)
            vals = np.asarray(R(ins.vs), storage)
            for i in range(vl):              # element order: last one wins
                if act[i]:
                    mem[idx[i]] = vals[i]
        elif t is isa.VFMA:
            W(ins.vd, q(R(ins.va) * R(ins.vb) + R(ins.vd), sew),
              A(ins.vm))
        elif t is isa.VFMA_VS:
            W(ins.vd, q(storage(s[ins.vs_scalar]) * R(ins.vb) + R(ins.vd),
                        sew), A(ins.vm))
        elif t is isa.VFADD:
            W(ins.vd, q(R(ins.va) + R(ins.vb), sew), A(ins.vm))
        elif t is isa.VFMUL:
            W(ins.vd, q(R(ins.va) * R(ins.vb), sew), A(ins.vm))
        elif t is isa.VFWMUL:
            W(ins.vd, q(R(ins.va) * R(ins.vb), 2 * sew), A(ins.vm))
        elif t is isa.VFWMA:
            W(ins.vd, q(R(ins.va) * R(ins.vb) + R(ins.vd), 2 * sew),
              A(ins.vm))
        elif t is isa.VFNCVT:
            W(ins.vd, q(R(ins.vs), sew), A(ins.vm))
        elif t in _INT_INSNS:
            kind = _INT_INSNS[t]
            act = A(ins.vm)
            r, sat = _int_bin_np(kind, to_int_np(R(ins.va), storage),
                                 to_int_np(R(ins.vb), storage), sew)
            W(ins.vd, np.asarray(r).astype(storage), act)
            if kind in _STICKY and bool(np.any(sat & act)):
                s[isa.VXSAT_SREG] = max(float(s[isa.VXSAT_SREG]), 1.0)
        elif t in _INT_CMP_NP:
            res = _INT_CMP_NP[t](to_int_np(R(ins.va), storage),
                                 to_int_np(R(ins.vb), storage))
            W(ins.vd, res.astype(storage), A(ins.vm))
        elif t in _FP_CMP_NP:
            res = _FP_CMP_NP[t](np.asarray(R(ins.va)),
                                np.asarray(R(ins.vb)))
            W(ins.vd, res.astype(storage), A(ins.vm))
        elif t in _LOGICAL_NP:
            res = _LOGICAL_NP[t](np.asarray(R(ins.va)) != 0,
                                 np.asarray(R(ins.vb)) != 0)
            W(ins.vd, res.astype(storage))
        elif t is isa.VMERGE:
            sel = np.asarray(R(isa.MASK_REG)) != 0
            W(ins.vd, np.where(sel, np.asarray(R(ins.va), storage),
                               np.asarray(R(ins.vb), storage)))
        elif t in _RED_KIND:
            # scalar-dest fold: element 0 of ONE register, tail
            # undisturbed, nothing at all when vl == 0
            if vl > 0:
                kind = _RED_KIND[t]
                res = _tree_reduce(kind, R(ins.vs), A(ins.vm), sew,
                                   storage)
                v[ins.vd, 0] = quantize(
                    res, 2 * sew if kind == "wsum" else sew, storage)
        elif t is isa.VINS:
            W(ins.vd, q(np.full(vl, s[ins.scalar], storage), sew))
        elif t is isa.VEXT:
            # normative: an extract at-or-past vl (vl=0 included) reads 0
            s[ins.sd] = R(ins.vs)[ins.idx] if ins.idx < vl \
                else storage(0)
        elif t is isa.VSLIDE:
            # tail-undisturbed: only elements whose source sits below vl
            # are written; the rest of the body AND the tail keep their
            # old register values (Ara2/RVV 1.0 — the PR-6 bugfix)
            src = np.asarray(R(ins.vs), storage)
            out = np.array(R(ins.vd), storage)
            k = max(vl - ins.amount, 0)
            out[:k] = src[ins.amount:ins.amount + k]
            W(ins.vd, out)
        elif t is isa.LDSCALAR:
            s[ins.sd] = mem[ins.addr]
        else:
            raise ValueError(ins)
    return mem, s


# ---------------------------------------------------------------------------
# random program generator (legal by construction)
# ---------------------------------------------------------------------------


def random_program(r: np.random.RandomState, sew: int = 64, lmul=1,
                   n_ops: int = 14, vlmax64: int = VLMAX64,
                   ops: Sequence[str] = DEFAULT_OPS,
                   mem_words: Optional[int] = None):
    """Build (program, memory, sregs) legal at the given vtype.

    Register allocation is span-aligned: work groups are the aligned
    bases except the first (reserved for the v0 mask group) and the
    last, which holds the index vector for gathers/scatters (fractional
    LMUL has span 1, so every register is a base). Widening picks an
    EMUL-span-aligned destination whose reserved span avoids both
    sources; segment ops bound their field span by the file. The op pool
    respects the vtype's op classes: float ops and compares drop out at
    SEW=8 (no FP8), the integer/fixed-point class and compares drop out
    at SEW=64, and the widening float reduction needs a wider FP type —
    so SEW=8 cells are pure-integer and bitwise. SEW=8 memory is filled
    with ints for the same reason.

    Masking: v0 is seeded from a memory pattern (random 0/1, or the
    all-ones/all-zeros edges), maskable ops draw vm=0 half the time, and
    compare/logical destinations often target v0 so the live mask
    evolves mid-program. The program is **lint-clean by construction**
    (zero E-class ``core/analysis.py`` findings, asserted per program by
    ``run_cells``): a full-VLMAX prelude seeds EVERY work group, the
    index group and the v0 mask before the body's vtype takes effect, so
    no read window ever touches an undefined register even on the vl=0
    and over-ask edges; widening destinations track their live reserved
    spans and later destination picks avoid them (no wide-clobber); and
    segment-store bases are restricted to fully-seeded field spans. The
    AVL REQUEST (including the vl=0 and over-ask edges) rides the
    SECOND VSETVL — the one that ends the prelude; use
    :func:`avl_request` to recover it. Executors must apply
    ``isa.vsetvl_grant``. A dump epilogue re-vsetvls to the full vlmax
    and stores the v0 + work groups into the high half of memory so
    register TAILS (mask/tail-undisturbed leftovers) are part of the
    bit-exact memory comparison.
    """
    isa.check_vtype(sew, lmul)
    vlmax = isa.grouped_vlmax(vlmax64, sew, lmul)
    span = isa.group_span(lmul)
    wspan = isa.group_span(2 * Fraction(lmul))
    # AVL request edges: the program carries the REQUEST in its leading
    # VSETVL (vl=0 no-op that still grants, over-ask that caps at VLMAX)
    # and every engine must apply the same grant rule
    roll = r.rand()
    if roll < 0.06:
        req = 0
    elif roll < 0.12:
        req = vlmax + int(r.randint(1, 64))
    else:
        # bias toward multi-register vl so grouping is actually exercised
        req = int(r.randint(max(2, vlmax // 2), vlmax + 1))
    vl = isa.vsetvl_grant(req, vlmax64, sew, lmul)
    # memory: low half is program address space, high half is the
    # register-dump region the epilogue stores groups into (so register
    # TAILS are visible to the memory comparison, bit-exactly)
    mem_words = max(mem_words or MEM_WORDS, 16 * vlmax)
    dump_base = mem_words // 2
    int_region = min(INT_REGION, mem_words // 4)
    if sew == 8:
        mem = r.randint(-100, 100, mem_words).astype(float)
    else:
        mem = r.uniform(-1, 1, mem_words)
    mem[:int_region] = r.randint(0, 8, int_region)
    sregs = {0: float(np.float32(r.uniform(-2, 2)))}

    bases = list(range(0, isa.NUM_VREGS, span))
    idx_grp = bases[-1]                       # gather/scatter index vector
    work = bases[1:-1][:8]                    # bases[0] is the v0 group
    wide_bases = [b for b in range(wspan, isa.NUM_VREGS - wspan + 1,
                                   wspan)]

    # lint-cleanliness bookkeeping (register granularity, mirroring
    # core/analysis.py): the prelude below seeds v0, the index group and
    # every work group at FULL vlmax, so their whole spans are defined;
    # body writes can only extend this (segment fields, wide windows).
    # ``live`` maps a live wide group's base to its reserved span —
    # destination picks must avoid those registers (lint E103).
    defined = set(range(span)) | set(range(idx_grp, idx_grp + span))
    for b in work:
        defined.update(range(b, b + span))
    live: dict = {}

    def live_regs():
        return {x for b, ws in live.items() for x in range(b, b + ws)}

    vpr = vlmax64 * (64 // sew)               # per-register capacity

    def awin(sp: int) -> int:
        """analysis.py's access window: registers a vl-element access at
        the BODY vtype actually touches (0 when the body is vl=0 — the
        linter W202-skips those ops, so nothing needs tracking)."""
        return min(sp, -(-vl // vpr)) if vl else 0

    def reg():
        """Source pick: any work group (fully seeded by the prelude)."""
        return work[r.randint(len(work))]

    def dst(regs_needed: int = 0):
        """Destination pick: a work group avoiding every live wide
        group's reserved span (writing there is lint E103). ``None``
        when wide liveness has crowded out every candidate (the caller
        skips the op; padding keeps program length vtype-independent)."""
        lv = live_regs()
        need = regs_needed or span
        cands = [b for b in work if not (set(range(b, b + need)) & lv)]
        if not cands:
            return None
        return cands[r.randint(len(cands))]

    def mreg():
        """Mask-logical source: usually v0, sometimes a work group."""
        return isa.MASK_REG if r.rand() < 0.3 else reg()

    def mdst():
        """Mask-writer dest: v0 often (so later masked ops see it)."""
        if r.rand() < 0.4:
            return isa.MASK_REG
        return dst()

    def vm():
        """The vm operand: masked-by-v0 half the time."""
        return 0 if r.rand() < 0.5 else 1

    def wide_pair(rw: bool):
        """(wide dest, two sources outside its reserved span). An ``rw``
        accumulator (VFWMA) also READS its wide window, so that window
        must already be defined; either way the dest must not clobber a
        DIFFERENT live wide span (same-base redefinition is fine)."""
        lv = live_regs()
        for _ in range(32):
            d = wide_bases[r.randint(len(wide_bases))]
            dspan = set(range(d, d + wspan))
            if (dspan & lv) and d not in live:
                continue                 # overlaps another live group
            if rw and not set(range(d, d + awin(wspan))) <= defined:
                continue                 # accumulator window unseeded
            free = [b for b in work if b + span <= d or b >= d + wspan]
            if len(free) >= 1:
                return d, free[r.randint(len(free))], \
                    free[r.randint(len(free))]
        return None

    # seed the v0 mask group from a memory pattern: random 0/1 mostly,
    # with the all-ones / all-zeros edges each drawn often enough that
    # every cell exercises them across a handful of seeds
    mroll = r.rand()
    if mroll < 0.15:
        pat = np.ones(vlmax)
    elif mroll < 0.30:
        pat = np.zeros(vlmax)
    else:
        pat = r.randint(0, 2, vlmax).astype(float)
    mem[int_region:int_region + vlmax] = pat

    # prelude: seed EVERY work group, the index group and the v0 mask at
    # the FULL vlmax — whole spans defined — *before* the body's AVL
    # request takes effect, so no read window ever touches an undefined
    # register even on the vl=0 / over-ask edges (lint E102)
    prog = [isa.VSETVL(vlmax, sew, lmul), isa.VLD(idx_grp, 0),
            isa.VLD(isa.MASK_REG, int_region)]
    for vr in work:
        prog.append(isa.VLD(vr, int(r.randint(int_region,
                                              dump_base - vlmax))))
    prog.append(isa.VSETVL(req, sew, lmul))   # the body's AVL request
    pool = [op for op in ops]
    if sew not in isa.FP_SEWS:                # SEW=8: integer lane only
        pool = [op for op in pool if op not in FP_POOL
                and op not in FP_CMP_POOL]
    if sew not in isa.INT_SEWS:               # SEW=64: no int64 model
        pool = [op for op in pool if op not in INT_POOL
                and op not in INT_CMP_POOL]
    if sew == max(isa.SEWS) or 2 * Fraction(lmul) > max(isa.LMULS):
        pool = [op for op in pool
                if op not in ("vfwmul", "vfwma", "vfncvt")]
    if sew not in isa.FP_SEWS or sew == max(isa.SEWS):
        pool = [op for op in pool if op != "vfwredsum"]
    if 2 * Fraction(lmul) > max(isa.LMULS):   # no room for nf >= 2 fields
        pool = [op for op in pool if op not in ("vlseg", "vsseg")]

    int3 = {"vadd": isa.VADD, "vsub": isa.VSUB, "vmul": isa.VMUL,
            "vsaddu": isa.VSADDU, "vsadd": isa.VSADD,
            "vssub": isa.VSSUB, "vsmul": isa.VSMUL}
    int_cmp = {"vmseq": isa.VMSEQ, "vmsne": isa.VMSNE,
               "vmslt": isa.VMSLT, "vmsle": isa.VMSLE}
    fp_cmp = {"vmfeq": isa.VMFEQ, "vmflt": isa.VMFLT}
    logical = {"vmand": isa.VMAND, "vmor": isa.VMOR, "vmxor": isa.VMXOR}
    red = {"vredsum": isa.VREDSUM, "vredmax": isa.VREDMAX,
           "vredmin": isa.VREDMIN, "vfwredsum": isa.VFWREDSUM}
    for _ in range(n_ops):
        op = pool[r.randint(len(pool))]
        if op == "vfma":
            d = dst()
            if d is None:
                continue
            prog.append(isa.VFMA(d, reg(), reg(), vm=vm()))
        elif op == "vfma_vs":
            d = dst()
            if d is None:
                continue
            prog.append(isa.VFMA_VS(d, 0, reg(), vm=vm()))
        elif op == "vfadd":
            d = dst()
            if d is None:
                continue
            prog.append(isa.VFADD(d, reg(), reg(), vm=vm()))
        elif op == "vfmul":
            d = dst()
            if d is None:
                continue
            prog.append(isa.VFMUL(d, reg(), reg(), vm=vm()))
        elif op in int3:
            d = dst()
            if d is None:
                continue
            prog.append(int3[op](d, reg(), reg(), vm=vm()))
        elif op in int_cmp:
            d = mdst()
            if d is None:
                continue
            prog.append(int_cmp[op](d, reg(), reg(), vm=vm()))
        elif op in fp_cmp:
            d = mdst()
            if d is None:
                continue
            prog.append(fp_cmp[op](d, reg(), reg(), vm=vm()))
        elif op in logical:
            d = mdst()
            if d is None:
                continue
            prog.append(logical[op](d, mreg(), mreg()))
        elif op == "vmerge":
            d = dst()
            if d is None:
                continue
            prog.append(isa.VMERGE(d, reg(), reg()))
        elif op in red:
            d = dst(1)                    # scalar-dest fold: ONE register
            if d is None:
                continue
            prog.append(red[op](d, reg(), vm=vm()))
        elif op == "vins":
            d = dst()
            if d is None:
                continue
            prog.append(isa.VINS(d, 0))
        elif op == "vld":
            d = dst()
            if d is None:
                continue
            prog.append(isa.VLD(d, int(r.randint(0, dump_base - vl)),
                                vm=vm()))
        elif op == "vlds":
            d = dst()
            if d is None:
                continue
            stride = int(r.randint(1, 4))
            hi = dump_base - stride * max(vl - 1, 0) - 1
            prog.append(isa.VLDS(d, int(r.randint(0, hi)), stride,
                                 vm=vm()))
        elif op in ("vgather", "vluxei"):
            # index values are small ints (or clamped float garbage after
            # scatters hit the region) — both are deterministic
            d = dst()
            if d is None:
                continue
            cls = isa.VGATHER if op == "vgather" else isa.VLUXEI
            prog.append(cls(d, int(r.randint(0, dump_base - 8)),
                            idx_grp, vm=vm()))
        elif op == "vst":
            prog.append(isa.VST(reg(), int(r.randint(0, dump_base - vl)),
                                vm=vm()))
        elif op == "vsuxei":
            prog.append(isa.VSUXEI(reg(), int(r.randint(0, dump_base - 8)),
                                   idx_grp, vm=vm()))
        elif op in ("vlseg", "vsseg"):
            nf = int(r.randint(2, min(4, max(isa.LMULS) // Fraction(lmul))
                               + 1))
            lv = live_regs()
            if op == "vlseg":
                # load fields DEFINE registers but must not land in a
                # live wide group's reserved span (lint E103)
                cand = [b for b in work if b + nf * span <= idx_grp
                        and not (set(range(b, b + nf * span)) & lv)]
            else:
                # store fields READ registers: every field window must
                # already be defined (lint E102)
                cand = [b for b in work if b + nf * span <= idx_grp
                        and all(set(range(b + f * span,
                                          b + f * span + awin(span)))
                                <= defined for f in range(nf))]
            if not cand:
                continue
            vd = cand[r.randint(len(cand))]
            addr = int(r.randint(0, dump_base - nf * max(vl, 1)))
            cls = isa.VLSEG if op == "vlseg" else isa.VSSEG
            prog.append(cls(vd, addr, nf))
            if op == "vlseg" and vl:
                for f in range(nf):
                    defined.update(range(vd + f * span,
                                         vd + f * span + awin(span)))
        elif op == "vslide":
            d = dst()
            if d is None:
                continue
            prog.append(isa.VSLIDE(d, reg(),
                                   int(r.randint(0, max(vl, 1)))))
        elif op == "vext":
            prog.append(isa.VEXT(int(r.randint(1, 4)), reg(),
                                 int(r.randint(0, max(vl, 1)))))
        elif op == "ldscalar":
            prog.append(isa.LDSCALAR(0, int(r.randint(0, dump_base))))
        elif op == "vfwmul" or op == "vfwma":
            picked = wide_pair(rw=(op == "vfwma"))
            if picked is None:
                continue
            d, a, b = picked
            cls = isa.VFWMUL if op == "vfwmul" else isa.VFWMA
            prog.append(cls(d, a, b, vm=vm()))
            if vl:
                live[d] = wspan
                defined.update(range(d, d + awin(wspan)))
        elif op == "vfncvt":
            # source: a wide group whose read window is fully defined;
            # the narrow dest may alias its OWN source base (the linter
            # consumes the wide value before the write) but must avoid
            # every other live wide span
            srcs = [b for b in wide_bases
                    if set(range(b, b + awin(wspan))) <= defined]
            if not srcs:
                continue
            src = srcs[r.randint(len(srcs))]
            lv = {x for bb, ws in live.items() if bb != src
                  for x in range(bb, bb + ws)}
            cand = [b for b in work
                    if (b + span <= src or b >= src + wspan or b == src)
                    and not (set(range(b, b + span)) & lv)]
            if not cand:
                continue
            prog.append(isa.VFNCVT(cand[r.randint(len(cand))], src,
                                   vm=vm()))
            if vl:
                live.pop(src, None)       # wide value consumed
    # dump epilogue: re-vsetvl to the FULL vlmax and store the v0 group
    # plus the work groups into the high-half dump region, so tail lanes
    # (mask/tail-undisturbed leftovers) are compared bit-exactly
    prog.append(isa.VSETVL(vlmax, sew, lmul))
    for k, b in enumerate(([isa.MASK_REG] + work)[:dump_base // vlmax]
                          if vlmax else []):
        prog.append(isa.VST(b, dump_base + k * vlmax))
    # pad to a vtype-INDEPENDENT length (prelude 12 + n_ops + epilogue
    # 10 is the across-cells maximum): cells with fewer work groups or
    # skipped ops would otherwise land in a different packed prog_len
    # bucket and split the sweep's one-compile signature
    while len(prog) < n_ops + 22:
        prog.append(isa.LDSCALAR(2, 0))
    return isa.validate_program(prog), mem, sregs


def avl_request(prog) -> int:
    """The body's AVL REQUEST of a :func:`random_program` program.

    The prelude seeds registers at full VLMAX under a first VSETVL, so
    the request carrying the vl=0 / over-ask edges rides the SECOND one.
    """
    vsetvls = [ins for ins in prog if isinstance(ins, isa.VSETVL)]
    return vsetvls[1].vl


# ---------------------------------------------------------------------------
# differential runner
# ---------------------------------------------------------------------------


def vtype_combos(sews: Sequence[int] = isa.SEWS,
                 lmuls: Sequence = isa.LMULS):
    """The LEGAL (sew, lmul) cells of the grid: illegal vtypes — mf4 at
    SEW ∈ {64, 32}, mf2 at SEW=64 (SEW/LMUL > ELEN) — are skipped via
    the same ``isa.check_vtype`` every engine enforces."""
    return [(s, l) for s in sews for l in lmuls if isa.vtype_legal(s, l)]


def grid(n_programs: int, sews: Sequence[int] = isa.SEWS,
         lmuls: Sequence = isa.LMULS,
         seed0: int = 0) -> Iterable[Tuple[int, int, int]]:
    """(sew, lmul, seed) triples cycling the legal vtype grid, distinct
    seeds."""
    combos = vtype_combos(sews, lmuls)
    for i in range(n_programs):
        sew, lmul = combos[i % len(combos)]
        yield sew, lmul, seed0 + i


def cells(n_per_cell: int, sews: Sequence[int] = isa.SEWS,
          lmuls: Sequence = isa.LMULS,
          seed0: int = 0) -> Iterable[Tuple[int, int, list]]:
    """(sew, lmul, seeds) blocks — the same seed assignment ``grid``
    makes, grouped per cell so a whole cell batches through run_many."""
    combos = vtype_combos(sews, lmuls)
    for c, (sew, lmul) in enumerate(combos):
        yield sew, lmul, [seed0 + c + k * len(combos)
                          for k in range(n_per_cell)]


def grid_window(vlmax64: int = VLMAX64) -> int:
    """The grid-wide max vl: pass as run_many's ``window`` so every
    SEW × LMUL cell shares one compiled signature."""
    return vlmax64 * (64 // min(isa.SEWS)) * max(isa.LMULS)


# --- batch executor adapters -----------------------------------------------


def engine_batch(engine, window: Optional[int] = None):
    """Batch runner over an engine's compile-once ``run_many``.

    Defaults the flat window to the full-grid maximum, so sweeping the
    whole SEW × LMUL grid costs ONE XLA compile per engine.
    """
    win = window or engine.vlmax_for(min(isa.SEWS), max(isa.LMULS))

    def batch(progs, mems, sregs):
        return engine.run_many(progs, mems, sregs, window=win)
    return batch


def per_program_batch(fn: Callable):
    """Wrap a ``(program, memory, sregs) -> (mem, sregs)`` callable."""
    def batch(progs, mems, sregs):
        outs = [fn(p, m, s) for p, m, s in zip(progs, mems, sregs)]
        return [o[0] for o in outs], [o[1] for o in outs]
    return batch


def oracle_batch(vlmax64: int = VLMAX64, storage=np.float32):
    """Batch adapter for the (deliberately naive, per-program) oracle."""
    return per_program_batch(
        lambda p, m, s: numpy_oracle(p, m, vlmax64, sregs=s,
                                     storage=storage))


def record_failure(sew: int, lmul, seed,
                   path: Optional[str] = None) -> Optional[str]:
    """Persist a failing grid point for CI artifact upload.

    ``seed`` is one int for a program-level mismatch, or the cell's seed
    list when a whole batch failed and no single program can be blamed.
    ``lmul`` is recorded in its assembly spelling (``m2``/``mf4``) so
    the JSON stays serializable and the repro line parses it back.
    """
    path = path or os.environ.get("DIFFERENTIAL_SEED_FILE")
    if not path:
        return None
    one = seed if isinstance(seed, int) else f"<each of {seed}>"
    lm = isa.format_lmul(lmul)
    with open(path, "w") as f:
        json.dump({"sew": sew, "lmul": lm, "seed": seed,
                   "repro": "repro.testing.differential.random_program("
                            f"np.random.RandomState({one}), sew={sew}, "
                            f"lmul=isa.parse_lmul('{lm}'))"}, f, indent=2)
    return path


def run_cells(batch_a: Callable, batch_b: Callable, cell_iter,
              n_ops: int = 14, vlmax64: int = VLMAX64,
              tol: Optional[dict] = None, label: str = "differential",
              lint: bool = True):
    """Drive random programs, one batch per SEW × LMUL cell, through two
    batch executors and compare program by program.

    ``batch_a`` / ``batch_b``: (programs, memories, sregs_list) ->
    (memories_out, sregs_out). Compares memory to ``tol[sew]`` and scalar
    registers on the keys both report. Returns the number of programs
    checked; on mismatch the failing (sew, lmul, seed) triple is recorded
    and named in the assertion.

    ``lint`` (default on) enforces the generator's lint-clean-by-
    construction contract: every generated program must carry ZERO
    E-class ``core/analysis.py`` findings before it is executed — the
    differential grid and the static analyzer audit each other.
    W-class findings (dead writes, vl=0 bodies) are expected output of a
    random generator and are not gated.
    """
    tol = tol or TOL
    checked = 0
    for sew, lmul, seeds in cell_iter:
        seeds = list(seeds)
        progs, mems, srs = [], [], []
        for seed in seeds:
            p, m, s = random_program(np.random.RandomState(seed), sew,
                                     lmul, n_ops=n_ops, vlmax64=vlmax64)
            if lint:
                errs = analysis.errors(analysis.lint_program(
                    p, vlmax64, mem_words=len(m)))
                if errs:
                    where = record_failure(sew, lmul, seed)
                    note = f" (seed file: {where})" if where else ""
                    raise AssertionError(
                        f"{label}: generated program is not lint-clean "
                        f"at sew={sew} lmul={isa.format_lmul(lmul)} "
                        f"seed={seed}{note}:\n  "
                        + "\n  ".join(str(f) for f in errs))
            progs.append(p)
            mems.append(m)
            srs.append(s)
        try:
            mems_a, s_a = batch_a(progs, mems, [dict(s) for s in srs])
            mems_b, s_b = batch_b(progs, mems, [dict(s) for s in srs])
        except Exception as e:
            # a batch failure can't be pinned on one program: record the
            # whole cell's seed list so the CI artifact stays reproducing
            where = record_failure(sew, lmul,
                                   seeds[0] if len(seeds) == 1 else seeds)
            note = f" (seed file: {where})" if where else ""
            raise AssertionError(
                f"{label}: executor failed at sew={sew} "
                f"lmul={isa.format_lmul(lmul)} "
                f"seeds={seeds}{note}: {e}") from e
        for i, seed in enumerate(seeds):
            try:
                np.testing.assert_allclose(mems_a[i], mems_b[i],
                                           rtol=tol[sew], atol=tol[sew])
                for k in set(s_a[i]) & set(s_b[i]):
                    np.testing.assert_allclose(
                        float(s_a[i][k]), float(s_b[i][k]),
                        rtol=tol[sew], atol=tol[sew])
            except AssertionError as e:
                where = record_failure(sew, lmul, seed)
                note = f" (seed file: {where})" if where else ""
                raise AssertionError(
                    f"{label}: engines disagree at sew={sew} "
                    f"lmul={isa.format_lmul(lmul)} "
                    f"seed={seed}{note}: {e}") from e
            checked += 1
    return checked


def run_pair(run_a: Callable, run_b: Callable, n_programs: int,
             sews: Sequence[int] = isa.SEWS,
             lmuls: Sequence[int] = isa.LMULS, seed0: int = 0,
             n_ops: int = 14, vlmax64: int = VLMAX64,
             tol: Optional[dict] = None, label: str = "differential"):
    """Run ``n_programs`` random programs through two per-program
    executors: the ``grid`` seed assignment grouped into cells and
    delegated to :func:`run_cells`. Returns the number checked.
    """
    by_cell = {}
    for sew, lmul, seed in grid(n_programs, sews, lmuls, seed0):
        by_cell.setdefault((sew, lmul), []).append(seed)
    return run_cells(per_program_batch(run_a), per_program_batch(run_b),
                     [(s, l, seeds) for (s, l), seeds in by_cell.items()],
                     n_ops=n_ops, vlmax64=vlmax64, tol=tol, label=label)
