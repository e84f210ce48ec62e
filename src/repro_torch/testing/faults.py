"""Fault injection: the runtime half of the vlint cross-audit.

``core/analysis.py`` and the differential harness audit each other in
both directions. ``differential.run_cells`` covers one direction (every
generated grid program must lint E-clean); this module covers the other:
every lint rule is backed by a *minimal mutation* of a lint-clean
program, and :func:`verify` confirms each finding against the runtime —

- ``RAISE``: the faulty program is rejected by the threaded-vtype
  legality check itself (``isa.check_insn`` via the numpy oracle — the
  same check ``staging.resolve_vtype`` runs), with a structured
  :class:`isa.IllegalInstruction`.
- ``CRASH``: the faulty program crashes the naive numpy oracle (the
  static-OOB class: slice truncation turns into a shape error).
- ``DIVERGE``: both programs execute, but the mutated one produces
  different memory — the silent-wrong-answer class the linter exists
  for (def-before-use reads the engines' zero-init, a wide-clobber
  destroys the full-precision value, a v0 clobber flips activeness).
- ``NOOP``: the W-class mutations. They must *not* change behavior —
  a W finding that diverged would belong in the E class.

An E-finding the runtime tolerates (no raise, no crash, no divergence),
or a mutation the linter misses, fails :func:`verify` — which is exactly
the bidirectional contract ``tests/test_vlint.py`` and
``tools/vlint.py --selftest`` enforce.
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Callable, List, Tuple

import numpy as np

from repro_torch.core import analysis, isa
from repro_torch.testing import differential

VLMAX64 = 8                  # vpr = 16 at SEW=32 -> vl=8 stays 1 register
MEM_WORDS = 256
SEW, LMUL = 32, 1
VL = 8
MASK_AT = 16                 # base_memory's 1,0,1,0,... v0 pattern
DATA_AT = 24                 # third operand / undisturbed-lane seed

RAISE, CRASH, DIVERGE, NOOP = "raise", "crash", "diverge", "noop"


def base_memory() -> np.ndarray:
    """Deterministic, nowhere-zero data (so products/sums can't collide
    by accident) with an alternating 0/1 mask pattern at ``MASK_AT``."""
    mem = 1.0 + 0.01 * np.arange(MEM_WORDS)
    mem[MASK_AT:MASK_AT + VL] = [1, 0, 1, 0, 1, 0, 1, 0]
    return mem


@dataclasses.dataclass(frozen=True)
class Fault:
    """One mutation class: a lint-clean program and its minimal break."""

    name: str
    expected_code: str       # the analysis.* code the linter must emit
    confirm: str             # RAISE / CRASH / DIVERGE / NOOP
    build: Callable[[], Tuple[list, list]]   # -> (clean, faulty)
    expected_rule: str = ""  # E101 only: the check_insn sub-rule id
    note: str = ""


def _dropped_vsetvl():
    clean = [isa.VSETVL(VL, SEW, LMUL), isa.VLD(1, 0), isa.VLD(2, 8),
             isa.VADD(3, 1, 2), isa.VST(3, 64)]
    return clean, clean[1:]          # VADD now runs at the initial e64


def _illegal_vtype():
    clean = [isa.VSETVL(VL, SEW, LMUL), isa.VLD(1, 0), isa.VST(1, 64)]
    faulty = [isa.VSETVL(VL, 32, Fraction(1, 4))] + clean[1:]
    return clean, faulty             # SEW/LMUL = 128 > ELEN


def _negative_avl():
    clean = [isa.VSETVL(VL, SEW, LMUL), isa.VLD(1, 0), isa.VST(1, 64)]
    return clean, [isa.VSETVL(-1, SEW, LMUL)] + clean[1:]


def _widen_overlap():
    clean = [isa.VSETVL(VL, SEW, LMUL), isa.VLD(1, 0), isa.VLD(2, 8),
             isa.VFWMUL(4, 1, 2), isa.VFNCVT(6, 4), isa.VST(6, 64)]
    faulty = list(clean)
    faulty[3] = isa.VFWMUL(2, 1, 2)  # source v2 inside the wide span
    return clean, faulty


def _def_before_use():
    clean = [isa.VSETVL(VL, SEW, LMUL), isa.VLD(1, 0), isa.VLD(2, 8),
             isa.VFADD(3, 1, 2), isa.VST(3, 64)]
    return clean, clean[:2] + clean[3:]   # v2 read is now zero-init


def _wide_clobber():
    clean = [isa.VSETVL(VL, SEW, LMUL), isa.VLD(1, 0), isa.VLD(2, 8),
             isa.VFWMUL(4, 1, 2), isa.VFNCVT(6, 4), isa.VST(6, 64)]
    faulty = clean[:4] + [isa.VFADD(4, 1, 2)] + clean[4:]
    return clean, faulty             # sums replace the wide products


def _v0_clobber():
    clean = [isa.VSETVL(VL, SEW, LMUL), isa.VLD(1, 0), isa.VLD(2, 8),
             isa.VLD(3, DATA_AT), isa.VLD(isa.MASK_REG, MASK_AT),
             isa.VFADD(3, 1, 2, vm=0), isa.VST(3, 64)]
    faulty = clean[:5] + [isa.VFMUL(isa.MASK_REG, 1, 2)] + clean[5:]
    return clean, faulty             # nonzero products: all lanes active


def _oob_footprint():
    clean = [isa.VSETVL(VL, SEW, LMUL), isa.VLD(1, 0), isa.VST(1, 64)]
    faulty = list(clean)
    faulty[1] = isa.VLD(1, MEM_WORDS - VL // 2)   # [252, 260) past 256
    return clean, faulty


def _dead_write():
    clean = [isa.VSETVL(VL, SEW, LMUL), isa.VLD(1, 0), isa.VLD(2, 8),
             isa.VFADD(3, 1, 2), isa.VST(3, 64)]
    faulty = clean[:3] + [isa.VFMUL(3, 1, 2)] + clean[3:]
    return clean, faulty             # fully overwritten before any read


def _vl0_noop():
    clean = [isa.VSETVL(VL, SEW, LMUL), isa.VLD(1, 0), isa.VLD(2, 8),
             isa.VFADD(3, 1, 2), isa.VST(3, 64)]
    faulty = clean[:4] + [isa.VSETVL(0, SEW, LMUL), isa.VFADD(4, 1, 2),
                          isa.VSETVL(VL, SEW, LMUL)] + clean[4:]
    return clean, faulty             # the vl=0 body writes nothing


REGISTRY: Tuple[Fault, ...] = (
    Fault("dropped-vsetvl", analysis.E_ILLEGAL, RAISE, _dropped_vsetvl,
          expected_rule="class-gate",
          note="stale e64 vtype gates the integer op class"),
    Fault("illegal-vtype", analysis.E_ILLEGAL, RAISE, _illegal_vtype,
          expected_rule="elen",
          note="SEW/LMUL > ELEN rejected at the VSETVL itself"),
    Fault("negative-avl", analysis.E_ILLEGAL, RAISE, _negative_avl,
          expected_rule="negative-avl"),
    Fault("widen-overlap", analysis.E_ILLEGAL, RAISE, _widen_overlap,
          expected_rule="widen-overlap",
          note="source inside the destination's reserved 2*LMUL span"),
    Fault("def-before-use", analysis.E_DEF_BEFORE_USE, DIVERGE,
          _def_before_use,
          note="reads the engines' zero-init instead of loaded data"),
    Fault("wide-clobber", analysis.E_WIDE_CLOBBER, DIVERGE, _wide_clobber,
          note="the LOW half of the live wide value is overwritten"),
    Fault("v0-clobber", analysis.E_V0_CLOBBER, DIVERGE, _v0_clobber,
          note="mask becomes nonzero arithmetic data: activeness flips"),
    Fault("oob-footprint", analysis.E_OOB, CRASH, _oob_footprint,
          note="unit-stride slice truncates: the oracle shape-errors"),
    Fault("dead-write", analysis.W_DEAD_WRITE, NOOP, _dead_write),
    Fault("vl0-noop", analysis.W_VL0, NOOP, _vl0_noop),
)


def verify(fault: Fault, vlmax64: int = VLMAX64) -> dict:
    """Run one fault through the bidirectional contract; see module doc.

    Returns a report dict on success, raises ``AssertionError`` naming
    the broken direction otherwise.
    """
    clean, faulty = fault.build()
    mem = base_memory()
    cerrs = analysis.errors(
        analysis.lint_program(clean, vlmax64, mem_words=MEM_WORDS))
    if cerrs:
        raise AssertionError(
            f"{fault.name}: CLEAN program has E-findings: "
            + "; ".join(str(f) for f in cerrs))
    cmem, csr = differential.numpy_oracle(clean, mem.copy(), vlmax64)

    findings = analysis.lint_program(faulty, vlmax64, mem_words=MEM_WORDS)
    hits = [f for f in findings if f.code == fault.expected_code
            and (not fault.expected_rule or f.rule == fault.expected_rule)]
    if not hits:
        raise AssertionError(
            f"{fault.name}: linter missed the injected fault "
            f"(wanted {fault.expected_code}"
            + (f"/{fault.expected_rule}" if fault.expected_rule else "")
            + f", got {[str(f) for f in findings]})")

    if fault.confirm == RAISE:
        try:
            differential.numpy_oracle(faulty, mem.copy(), vlmax64)
        except isa.IllegalInstruction:
            pass
        else:
            raise AssertionError(
                f"{fault.name}: runtime tolerated an E-finding "
                f"(no IllegalInstruction)")
    elif fault.confirm == CRASH:
        try:
            differential.numpy_oracle(faulty, mem.copy(), vlmax64)
        except isa.IllegalInstruction as e:
            raise AssertionError(
                f"{fault.name}: expected an executor crash, got a "
                f"legality raise {e}") from e
        except Exception:
            pass
        else:
            raise AssertionError(
                f"{fault.name}: runtime tolerated the OOB footprint")
    else:
        fmem, fsr = differential.numpy_oracle(faulty, mem.copy(), vlmax64)
        same = np.array_equal(cmem, fmem) and all(
            float(csr[k]) == float(fsr[k]) for k in set(csr) & set(fsr))
        if fault.confirm == DIVERGE and same:
            raise AssertionError(
                f"{fault.name}: runtime tolerated an E-finding "
                f"(outputs identical to the clean program)")
        if fault.confirm == NOOP and not same:
            raise AssertionError(
                f"{fault.name}: a W-class mutation changed behavior — "
                f"it belongs in the E class")
    return {"name": fault.name, "code": fault.expected_code,
            "rule": fault.expected_rule, "confirm": fault.confirm,
            "findings": [str(f) for f in hits]}


def verify_all(vlmax64: int = VLMAX64) -> List[dict]:
    """The whole registry; tests and ``vlint --selftest`` share this."""
    return [verify(f, vlmax64) for f in REGISTRY]
