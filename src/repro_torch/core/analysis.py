"""vlint: whole-program static analysis for ``core/isa.py`` programs.

``isa.check_insn`` validates one instruction against a caller-supplied
vtype; Ara's sequencer — and Ara2's RVV 1.0 compliance work — reject a
much larger class of bugs *across* instructions: stale vtype after a
dropped VSETVL, register-group overlap at the effective EMUL, a mask
clobbered between its writer and its masked consumer. This module closes
that gap with an abstract interpreter that threads the ``vsetvl_grant``
vtype/vl lattice through the instruction stream exactly the way
``staging.resolve_vtype`` does, tracking register definedness, live wide
(2·SEW) groups, the v0 mask state, and static memory footprints.

Findings are coded and split into two classes:

**E-class** — the program will diverge from its author's intent, crash an
executor, or be rejected at resolve time:

- ``E101 illegal-insn`` — any ``check_insn``/``check_vtype`` rejection
  under the *threaded* vtype (the finding carries the structured rule id,
  e.g. ``class-gate``, ``widen-overlap``, ``v0-overlap``,
  ``negative-avl``).
- ``E102 def-before-use`` — a read window (the ``min(span, ceil(vl /
  vpr))`` registers an access actually touches) includes a register no
  instruction has written. Engines zero-initialize registers, so this
  executes deterministically — but it reads data the program never put
  there, which is how generator/user bugs become silent wrong answers.
- ``E103 wide-clobber`` — a write overlaps the reserved EMUL=2·LMUL span
  of a live wide group between its producer (VFWMUL/VFWMA) and its
  consumer. Clobbering the low half destroys the full-precision value in
  this value model; clobbering the high half diverges from real-RVV
  register layout.
- ``E104 v0-clobber`` — a non-mask write (arithmetic, slide, reduction
  scalar) lands in the v0 group between a mask definition and a masked
  (``vm=0``/VMERGE) consumer: the consumer's predicate is arithmetic
  garbage. Loads, VINS broadcasts and mask writers into v0 are the
  legitimate mask-(re)load idioms and clear the taint.
- ``E105 oob-footprint`` — a unit-stride/strided/segment/scalar access
  whose static footprint leaves ``[0, mem_words)``. Indexed ops
  (VGATHER/VLUXEI/VSUXEI) are exempt: their clamp contract makes OOB
  indices deterministic by design.

**W-class** — legal and deterministic, but almost certainly not what the
author meant:

- ``W201 dead-write`` — a register write fully overwritten before any
  read (end-of-program leftovers are observable output, never flagged).
- ``W202 vl0-noop`` — a vector instruction under ``vl == 0`` (a complete
  no-op by the ``vsetvl_grant`` contract).
- ``W203 redundant-vsetvl`` — a VSETVL whose grant reproduces the
  current ``(vl, sew, lmul)`` exactly.
- ``W204 unreachable-tail`` — VEXT of an element at-or-past ``vl``
  (reads the normative 0), or a VSLIDE whose amount is >= ``vl`` (writes
  nothing).

The differential harness and the linter audit each other (the tentpole
cross-check): every generated grid program must lint E-clean, and every
injected fault in ``repro.testing.faults`` must both be flagged here and
confirmed against the runtime (resolve-time raise, oracle crash, or
divergence from the un-mutated program). See docs/isa.md ("Static
legality and hazard rules") for the normative rule list with minimal
offending programs.
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Iterable, List, Optional, Sequence

from repro_torch.core import isa

E_ILLEGAL = "E101"
E_DEF_BEFORE_USE = "E102"
E_WIDE_CLOBBER = "E103"
E_V0_CLOBBER = "E104"
E_OOB = "E105"
W_DEAD_WRITE = "W201"
W_VL0 = "W202"
W_REDUNDANT_VSETVL = "W203"
W_UNREACHABLE_TAIL = "W204"

#: every code the analyzer can emit, in severity order
ALL_CODES = (E_ILLEGAL, E_DEF_BEFORE_USE, E_WIDE_CLOBBER, E_V0_CLOBBER,
             E_OOB, W_DEAD_WRITE, W_VL0, W_REDUNDANT_VSETVL,
             W_UNREACHABLE_TAIL)

_LOADS = (isa.VLD, isa.VLDS, isa.VGATHER, isa.VLUXEI, isa.VLSEG)
_WIDE_PRODUCERS = (isa.VFWMUL, isa.VFWMA)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One coded diagnostic, anchored to an instruction and its vtype."""

    code: str          # E101..E105 / W201..W204
    index: int         # position in the program
    mnemonic: str      # instruction class name
    message: str       # human-readable rule text
    sew: int           # vtype in effect at the instruction
    lmul: object       # int or Fraction; formatted as m*/mf*
    rule: str = ""     # structured sub-rule (E101 only): check_insn code

    @property
    def is_error(self) -> bool:
        return self.code.startswith("E")

    def __str__(self) -> str:
        tag = f"[{self.rule}] " if self.rule else ""
        return (f"{self.code} at insn {self.index} {self.mnemonic} "
                f"[e{self.sew}/{isa.format_lmul(self.lmul)}]: "
                f"{tag}{self.message}")


class LintError(ValueError):
    """E-class findings escalated to an exception (``assert_clean``)."""

    def __init__(self, findings: Sequence[Finding]):
        self.findings = list(findings)
        lines = "\n  ".join(str(f) for f in self.findings)
        super().__init__(
            f"{len(self.findings)} E-class lint finding(s):\n  {lines}")


def errors(findings: Iterable[Finding]) -> List[Finding]:
    return [f for f in findings if f.is_error]


def warnings(findings: Iterable[Finding]) -> List[Finding]:
    return [f for f in findings if not f.is_error]


def lint_program(program, vlmax64: int,
                 mem_words: Optional[int] = None,
                 defined: Sequence[int] = (),
                 sregs: Optional[Sequence[int]] = None) -> List[Finding]:
    """Abstractly interpret ``program`` and return every finding.

    - ``vlmax64``: the engine's per-register 64-bit VLMAX (the same value
      ``staging.resolve_vtype`` threads).
    - ``mem_words``: memory size in elements; ``None`` skips the E105
      footprint checks (callers that lint programs without a bound
      memory, e.g. ``resolve_vtype``'s opt-in pre-pass).
    - ``defined``: vector registers the caller guarantees are live on
      entry (program *fragments* like ``isa.argmax_program`` read
      caller-loaded groups).
    - ``sregs``: scalar registers live on entry; ``None`` disables
      scalar def-before-use tracking entirely (engines accept arbitrary
      sreg dicts, so the check is opt-in).
    """
    findings: List[Finding] = []
    vl, sew, lmul = vlmax64, 64, 1
    defined_regs = set(int(r) for r in defined)
    reported_undef: set = set()
    pending: dict = {}       # reg -> (writer index, elements covered)
    wide_live: dict = {}     # base -> (reserved wspan, producer index)
    v0_dirty: Optional[int] = None   # index of the clobbering write
    sreg_def = None if sregs is None else set(int(r) for r in sregs)

    def emit(code, i, ins, msg, rule=""):
        findings.append(Finding(code, i, type(ins).__name__, msg,
                                sew, lmul, rule))

    def oob(i, ins, lo, hi):
        """E105 on a static footprint [lo, hi) outside [0, mem_words)."""
        if mem_words is not None and (lo < 0 or hi > mem_words):
            emit(E_OOB, i, ins,
                 f"static footprint [{lo}, {hi}) exceeds memory "
                 f"[0, {mem_words})")

    for i, ins in enumerate(program):
        t = type(ins)
        try:
            isa.check_insn(ins, sew, lmul, index=i)
        except isa.IllegalInstruction as e:
            emit(E_ILLEGAL, i, ins, e.detail, rule=e.code)
            continue                     # state past an illegal insn is moot

        if t is isa.VSETVL:
            nvl = isa.vsetvl_grant(ins.vl, vlmax64, ins.sew, ins.lmul)
            if (nvl, ins.sew, ins.lmul) == (vl, sew, lmul):
                emit(W_REDUNDANT_VSETVL, i, ins,
                     f"grant reproduces the current vtype exactly "
                     f"(vl={vl}, e{sew}/{isa.format_lmul(lmul)})")
            vl, sew, lmul = nvl, ins.sew, ins.lmul
            continue

        if t is isa.LDSCALAR:            # scalar op: unaffected by vl
            oob(i, ins, ins.addr, ins.addr + 1)
            if sreg_def is not None:
                sreg_def.add(ins.sd)
            continue

        if vl == 0:                      # complete no-op by the grant rule
            emit(W_VL0, i, ins,
                 "vl=0: nothing read, nothing written (vsetvl_grant "
                 "no-op contract)")
            continue

        vpr = vlmax64 * (64 // sew)      # per-register element capacity
        span = isa.group_span(lmul)

        def window(base, sp):
            """Registers a vl-element access actually touches."""
            return range(base, base + min(sp, -(-vl // vpr)))

        reads, writes = isa.reg_groups(ins, lmul)
        cov = vl                         # elements each write covers
        unmasked = getattr(ins, "vm", 1) == 1

        # --- per-op read/write shaping -------------------------------
        if t is isa.VEXT:
            if ins.idx >= vl:
                emit(W_UNREACHABLE_TAIL, i, ins,
                     f"extract index {ins.idx} >= vl={vl} reads the "
                     f"normative 0, never an element")
                reads = []
            else:
                reads = [(ins.vs + ins.idx // vpr, 1)]
            if sreg_def is not None:
                sreg_def.add(ins.sd)
        elif t is isa.VSLIDE:
            if ins.amount >= vl:
                emit(W_UNREACHABLE_TAIL, i, ins,
                     f"slide amount {ins.amount} >= vl={vl} writes "
                     f"nothing (tail-undisturbed)")
                reads, writes = [], []
            else:
                cov = vl - ins.amount
        elif t in isa._REDUCTIONS:
            cov = 1                      # element 0 of one register

        # --- scalar-source definedness (opt-in) ----------------------
        if sreg_def is not None:
            sid = getattr(ins, "scalar", getattr(ins, "vs_scalar", None))
            if sid is not None and sid not in sreg_def:
                emit(E_DEF_BEFORE_USE, i, ins,
                     f"scalar register s{sid} read but never written")

        # --- reads: def-before-use, consumption ----------------------
        if (not unmasked or t is isa.VMERGE) and v0_dirty is not None:
            emit(E_V0_CLOBBER, i, ins,
                 f"masked consumer reads v0 clobbered by a non-mask "
                 f"write at insn {v0_dirty}")
            v0_dirty = None              # one report per clobber
        for base, sp in reads:
            undef = [r for r in window(base, sp)
                     if r not in defined_regs and r not in reported_undef]
            if undef:
                reported_undef.update(undef)
                regs = ", ".join(f"v{r}" for r in undef)
                emit(E_DEF_BEFORE_USE, i, ins,
                     f"read of {regs} (group v{base}, span {sp}) before "
                     f"any write")
            for r in window(base, sp):
                pending.pop(r, None)     # consumed: the write was live
        if t is isa.VFNCVT:
            wide_live.pop(ins.vs, None)  # narrowed: wide value consumed

        # --- static memory footprints --------------------------------
        if t in (isa.VLD, isa.VST):
            oob(i, ins, ins.addr, ins.addr + vl)
        elif t is isa.VLDS:
            lo = min(ins.addr, ins.addr + ins.stride * (vl - 1))
            hi = max(ins.addr, ins.addr + ins.stride * (vl - 1)) + 1
            oob(i, ins, lo, hi)
        elif t in (isa.VLSEG, isa.VSSEG):
            oob(i, ins, ins.addr, ins.addr + ins.nf * vl)

        # --- writes: wide-clobber, dead-write, define, v0 taint ------
        killed: dict = {}
        for base, sp in writes:
            for b, (ws, pidx) in list(wide_live.items()):
                if base < b + ws and b < base + sp:
                    if t in _WIDE_PRODUCERS and base == b:
                        continue         # redefinition of the same group
                    emit(E_WIDE_CLOBBER, i, ins,
                         f"write to v{base} (span {sp}) lands in the "
                         f"reserved 2*LMUL span v{b}..v{b + ws - 1} of "
                         f"the live wide group produced at insn {pidx}")
                    del wide_live[b]
            for g, r in enumerate(window(base, sp)):
                c = max(0, min(vpr, cov - g * vpr))
                if c == 0:
                    continue
                if unmasked and r in pending and c >= pending[r][1]:
                    killed[pending[r][0]] = pending[r]
                pending[r] = (i, c)
                defined_regs.add(r)
            # v0 mask taint: loads, VINS and mask writers are the
            # legitimate (re)definition idioms; anything else turns the
            # mask into arithmetic data
            if base < span and base + sp > isa.MASK_REG:
                if t in _LOADS or t is isa.VINS \
                        or t in isa._MASK_WRITERS:
                    v0_dirty = None
                else:
                    v0_dirty = i
        for widx, (_, c) in sorted(killed.items()):
            emit(W_DEAD_WRITE, i, ins,
                 f"fully overwrites the {c}-element write of insn "
                 f"{widx} before any read")
        if t in _WIDE_PRODUCERS:
            wspan = isa.group_span(2 * Fraction(lmul))
            wide_live[ins.vd] = (wspan, i)

    return findings


def assert_clean(program, vlmax64: int,
                 mem_words: Optional[int] = None,
                 defined: Sequence[int] = (),
                 sregs: Optional[Sequence[int]] = None) -> List[Finding]:
    """Lint and raise :class:`LintError` on any E-class finding.

    Returns the full finding list (W-class included) when clean, so
    callers can surface warnings without re-linting.
    """
    findings = lint_program(program, vlmax64, mem_words=mem_words,
                            defined=defined, sregs=sregs)
    errs = errors(findings)
    if errs:
        raise LintError(errs)
    return findings
