"""RVV-0.5-draft-style vector ISA (the subset Ara implements, §III).

Instructions are plain dataclasses; programs are lists. Semantics are
executed by core/vector_engine.py (single-device oracle or lane-sharded
shard_map engine); timing by the engine's scoreboard (cross-validates
core/perfmodel.py).

Functional-unit mapping follows Fig. 3b:
  FPU  — VFMA/VFADD/VFMUL/VFWMUL/VFWMA/VFNCVT  (64 bit/lane/cycle)
  ALU  — VADD/VSUB/VMUL + fixed-point VSADDU/VSADD/VSSUB/VSMUL
         (64 bit/lane/cycle, shares paths with SLDU)
  SLDU — VSLIDE/VINS/VEXT          (touches all lanes)
  VLSU — VLD/VST/VLDS/VGATHER      (single memory port, W = 32*lanes bit)

Multi-precision / SEW semantics (§III-E4)
-----------------------------------------
``VSETVL(vl, sew)`` sets both the vector length AND the selected element
width. SEW ∈ {64, 32, 16, 8} bit; the 64-bit lane datapath subdivides
into 64/SEW parallel sub-words (1×64 / 2×32 / 4×16 / 8×8), so peak
op/cycle — and the scoreboard's FPU/ALU occupancy — scale by 64/SEW.
VLMAX likewise scales: a vector register is a fixed number of BYTES (VRF
bytes / 32 regs), so it holds (64/SEW)× more elements at narrower
widths; the engines expose this via ``AraConfig.vlmax(sew)``.

Integer / fixed-point op class (SEW ∈ {32, 16, 8})
--------------------------------------------------
``VADD``/``VSUB``/``VMUL`` are two's-complement integer ops: results wrap
modulo 2^SEW (the RVV integer contract). The RVV fixed-point subset —
``VSADDU``/``VSADD``/``VSSUB`` (saturating add/sub) and ``VSMUL``
(fractional multiply: ``sat((a*b + 2^(SEW-2)) >> (SEW-1))``) — clamps to
the type extremes instead and sets the *sticky* ``vxsat`` flag, modeled
as scalar register ``VXSAT_SREG`` (31): once any element of any
saturating op clamps, it reads 1 for the rest of the program. ``vxrm``
is fixed at round-to-nearest-up (rnu, the RVV reset default): add half,
then floor — ties round toward +inf, so ``VSMUL(0x80, 0x80)`` at SEW=8
is the classic corner (product 2^14 rounds past the int8 maximum:
result 0x7F, vxsat set).

Integer ops are legal at SEW ∈ {32, 16, 8} and float ops at
SEW ∈ {64, 32, 16}: there is no FP8 format (Ara's FPU stops at f16),
and int64 values would not round-trip the engines' float storage, so
the model pins integer ELEN at 32 — a documented model deviation (see
docs/isa.md). Both rules live in ``check_insn`` like every other
legality rule.

Register grouping also comes in *fractional* flavors (RVV 1.0):
LMUL ∈ {mf4, mf2, 1, 2, 4, 8}, where ``mf2``/``mf4`` (exact
``Fraction(1, 2)``/``Fraction(1, 4)``) use half/quarter of one register
— VLMAX floors to ``lmul * vlmax(sew)`` and a fractional group still
reserves one whole architectural register (``group_span``). The vtype
is legal iff SEW/LMUL <= ELEN (=64): mf4 at SEW=64 or 32 is illegal,
mf2 at SEW=64 is illegal. Fractional LMUL exists for mixed-width loops
(int8 operands feeding int32 accumulators): the narrow operand groups
at EMUL = lmul * sew_narrow/sew_wide so the wide accumulator's LMUL
does not cap the narrow side (``stripmine.mixed_width_lmul``). Use
``parse_lmul("mf2")`` / ``format_lmul`` to convert the assembly
spelling; internally lmul is a signed power of two (``lmul_exp``).

Arithmetic executes at SEW precision: every result is rounded to the
SEW-wide float format (f64/f32/f16) before it lands in the register file,
and loads quantize memory values to SEW on the way in. Widening ops
(``VFWMUL``, ``VFWMA``) read SEW-wide sources and produce 2·SEW-wide
results with a single rounding — the RVV vfwmul/vfwmacc contract, and the
model for "multiply narrow, accumulate wide" mixed-precision kernels.
``VFNCVT`` narrows a 2·SEW-wide register back to SEW. Widening ops are
illegal at SEW=64 (2·SEW would exceed the 64-bit datapath, RVV's
ELEN limit) — the engines raise on such programs.

Register grouping / LMUL semantics (RVV 1.0, Ara2)
--------------------------------------------------
``VSETVL(vl, sew, lmul)`` additionally selects a register-group multiplier
LMUL ∈ {1, 2, 4, 8}: each vector operand names a *group* of LMUL
architectural registers, so VLMAX scales to ``lmul * vlmax(sew)`` and one
instruction keeps its functional unit busy for up to LMUL× longer — this
is what amortizes the 5-cycle issue interval on short-vector workloads
(§IV; the motivation for Ara2's RVV-1.0 upgrade). Legality, enforced by
``check_insn`` (shared by both engines, the scoreboard, and the test
oracle):

- group base registers must be LMUL-aligned (``reg % lmul == 0``);
- widening results have EMUL = 2·LMUL: the destination must be
  2·LMUL-aligned, must not overlap either narrow source group, and
  LMUL=8 widening is illegal (EMUL would exceed 8);
- narrowing (``VFNCVT``) reads a 2·LMUL-wide source; the destination may
  overlap it only in the lowest-numbered position (``vd == vs``);
- segment ops (``VLSEG``/``VSSEG``) touch ``nf`` consecutive groups
  (fields), requiring ``nf * lmul <= 8`` and the whole span in-bounds.

Storage note: this is a *value* model — wide (2·SEW) results are held in
the low LMUL registers of their 2·LMUL-reserved span at full precision;
EMUL affects legality and scoreboard occupancy, not byte layout.

Memory ops: ``VLSEG``/``VSSEG`` move ``nf``-field structures
(array-of-structs de/interleave: field f, element i at ``addr + i*nf +
f``). ``VLUXEI``/``VSUXEI`` are RVV 1.0 indexed-unordered load/store;
out-of-range indices clamp to the memory edges exactly like ``VGATHER``,
and colliding scatter indices resolve highest-element-index-wins — the
deterministic contract every engine and the oracle share.

Masking, compares, and reductions (RVV 1.0, Ara2/Spatz)
-------------------------------------------------------
Arithmetic and memory ops carry a ``vm`` operand (RVV encoding: ``vm=1``
unmasked — the default — ``vm=0`` masked by ``v0``). A masked op
executes only where the mask is *active* and leaves masked-off
destination elements **undisturbed** (mask-undisturbed, the policy Ara2
commits to); masked stores skip inactive addresses. Mask layout is the
value model's: element ``i`` of the ``v0`` register *group* (masks group
exactly like data operands — a documented deviation from RVV's
one-bit-per-element single-register layout, see docs/isa.md) is active
iff its value is nonzero. Compares — integer ``VMSEQ``/``VMSNE``/
``VMSLT``/``VMSLE`` (SEW <= 32) and float ``VMFEQ``/``VMFLT``
(SEW >= 16) — write exact 0/1 values in that layout; the mask logicals
``VMAND``/``VMOR``/``VMXOR`` combine activeness bits; ``VMERGE`` is the
always-masked select ``vd[i] = v0[i] ? va[i] : vb[i]``. The RVV
v0-overlap rule is enforced by ``check_insn``: a masked op's
destination group may not overlap the mask group — unless it writes
mask layout (compares, logicals) or a reduction's scalar result.

Reductions ``VREDSUM``/``VREDMAX``/``VREDMIN`` (any SEW) and the
widening ``VFWREDSUM`` (float, result at 2·SEW) fold the active body
of a source group into element 0 of a single destination register,
leaving every other destination element undisturbed (and writing
nothing at vl=0). The fold is a fixed binary tree over the
next-power-of-two element window with identity padding
(0 / -inf / +inf), so the result is bit-reproducible across every
engine, lane count, and the numpy oracle — the software spelling of the
paper's inter-lane reduction tree, and the retirement of the §III-C
``slide_reduce_program`` workaround. An all-inactive body yields the
identity (the model folds RVV's scalar-init operand into it).
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Optional

NUM_VREGS = 32
SEWS = (64, 32, 16, 8)           # supported selected element widths (bits)
FP_SEWS = (64, 32, 16)           # float formats (no FP8: the FPU stops at f16)
INT_SEWS = (32, 16, 8)           # integer sub-word widths (model ELEN_INT=32)
ELEN = 64                        # widest element the datapath moves
# register-group multipliers, smallest first; mf4/mf2 are the RVV 1.0
# fractional groupings (exact binary fractions, never floats in keys)
LMULS = (Fraction(1, 4), Fraction(1, 2), 1, 2, 4, 8)
VXSAT_SREG = 31                  # scalar reg shadowing the sticky vxsat CSR
MASK_REG = 0                     # v0: the one architectural mask register


class IllegalInstruction(ValueError):
    """Structured legality error — one diagnostic format for every
    rejection path: ``check_insn``, the engines' encode pre-pass
    (``staging.resolve_vtype``), the scoreboard, and the static analyzer
    (``core/analysis.py``, which wraps these as lint code E101).

    Attributes:
      code      short kebab-case rule id (``"negative-avl"``, ``"elen"``,
                ``"class-gate"``, ``"misaligned"``, ``"bounds"``,
                ``"emul"``, ``"nf-span"``, ``"widen-overlap"``,
                ``"narrow-overlap"``, ``"v0-overlap"``, ``"bad-sew"``,
                ``"bad-lmul"``)
      detail    the human-readable rule text (LMUL always spelled
                mf2/mf4/m1..m8, never a decimal)
      mnemonic  instruction class name, when known
      sew/lmul  the vtype in effect at the faulting instruction
      index     position in the program, when the caller threads it
    """

    def __init__(self, code: str, detail: str, *, mnemonic=None,
                 sew=None, lmul=None, index=None):
        super().__init__(detail)
        self.code = code
        self.detail = detail
        self.mnemonic = mnemonic
        self.sew = sew
        self.lmul = lmul
        self.index = index

    def with_context(self, *, mnemonic=None, sew=None, lmul=None,
                     index=None):
        """Fill in still-unknown fields (never overwrites) and return self
        — used by ``check_insn`` / ``resolve_vtype`` to thread the
        instruction index and vtype into errors raised deeper down."""
        if self.mnemonic is None:
            self.mnemonic = mnemonic
        if self.sew is None:
            self.sew = sew
        if self.lmul is None:
            self.lmul = lmul
        if self.index is None:
            self.index = index
        return self

    def __str__(self):
        where = "" if self.index is None else f" at insn {self.index}"
        who = "" if self.mnemonic is None else f" {self.mnemonic}"
        vt = ""
        if self.sew is not None:
            vt = f" [e{self.sew}/{format_lmul(self.lmul or 1)}]"
        return f"[{self.code}]{where}{who}{vt}: {self.detail}"


def parse_lmul(text):
    """Parse an LMUL spelling: ``"mf2"``/``"mf4"``/``"m2"``/``"2"``/2/0.5.

    Returns the canonical value — an ``int`` for integer groupings, an
    exact ``Fraction`` for fractional ones (floats 0.5/0.25 are exact
    binary fractions, so they normalize losslessly).
    """
    if isinstance(text, str):
        t = text.strip().lower()
        if t.startswith("mf"):
            f = Fraction(1, int(t[2:]))
        elif t.startswith("m"):
            f = Fraction(int(t[1:]))
        else:
            f = Fraction(t)
    else:
        f = Fraction(text)
    return f.numerator if f.denominator == 1 else f


def format_lmul(lmul) -> str:
    """RVV assembly spelling: m1/m2/m4/m8 and mf2/mf4 — never 0.5/0.25."""
    try:
        f = Fraction(lmul)
    except (TypeError, ValueError):
        return str(lmul)
    if f.numerator == 1 and f.denominator > 1:
        return f"mf{f.denominator}"
    if f.denominator == 1:
        return f"m{f.numerator}"
    return str(lmul)


def lmul_exp(lmul) -> int:
    """vtype encoding: LMUL as a signed power-of-two exponent (RVV vlmul
    field semantics): mf4 -> -2, mf2 -> -1, 1 -> 0, ... 8 -> 3."""
    f = Fraction(lmul)
    if f.numerator == 1 and f.denominator > 1:
        return 1 - f.denominator.bit_length()
    return f.numerator.bit_length() - 1


def lmul_from_exp(e: int):
    """Inverse of :func:`lmul_exp`."""
    return (1 << e) if e >= 0 else Fraction(1, 1 << -e)


def group_span(lmul) -> int:
    """Architectural registers a group occupies: LMUL when integer; ONE
    register (partially used) for fractional LMUL — RVV reserves the
    whole register even when EMUL < 1."""
    return max(1, int(Fraction(lmul)))


def grouped_vlmax(vlmax64: int, sew: int, lmul=1) -> int:
    """VLMAX at a vtype: the per-register 64-bit capacity times the
    datapath subdivision, scaled by the grouping — floored exactly for
    fractional LMUL (the RVV fractional-VLMAX floor)."""
    return int(vlmax64 * (64 // sew) * Fraction(lmul))


def vsetvl_grant(avl: int, vlmax64: int, sew: int, lmul=1) -> int:
    """The RVV ``vsetvl`` grant rule, explicit and single-sourced.

    An AVL request is *never* an error: the granted vl is
    ``min(avl, VLMAX(sew, lmul))``. The two edges the rule commits to:
    ``avl=0`` grants vl=0 — every subsequent data op is then a complete
    no-op (nothing read, nothing written, registers and memory
    undisturbed) while the vtype itself still takes effect — and any
    over-ask (``avl > VLMAX``, including absurd requests) grants exactly
    VLMAX. Negative AVL is rejected by ``check_insn`` (it is a program
    bug, not a length request). Both engines, the scoreboard and the
    numpy oracle resolve VSETVL through this one function.
    """
    return min(int(avl), grouped_vlmax(vlmax64, sew, lmul))


@dataclasses.dataclass(frozen=True)
class Insn:
    unit = "none"


@dataclasses.dataclass(frozen=True)
class VSETVL(Insn):
    vl: int                      # requested vector length (AVL)
    sew: int = 64                # selected element width (bits)
    lmul: int = 1                # register group multiplier
    unit = "seq"


@dataclasses.dataclass(frozen=True)
class VLD(Insn):                 # unit-stride load
    vd: int
    addr: int                    # element offset into memory
    vm: int = 1
    unit = "vlsu"


@dataclasses.dataclass(frozen=True)
class VLDS(Insn):                # constant-stride load
    vd: int
    addr: int
    stride: int
    vm: int = 1
    unit = "vlsu"


@dataclasses.dataclass(frozen=True)
class VGATHER(Insn):             # indexed load: vd[i] = mem[addr + vidx[i]]
    vd: int
    addr: int
    vidx: int
    vm: int = 1
    unit = "vlsu"


@dataclasses.dataclass(frozen=True)
class VST(Insn):
    vs: int
    addr: int
    vm: int = 1
    unit = "vlsu"


@dataclasses.dataclass(frozen=True)
class VLSEG(Insn):               # segment load: field f of element i is at
    vd: int                      #   mem[addr + i*nf + f]; lands in group
    addr: int                    #   vd + f*lmul (AoS -> nf register groups)
    nf: int = 2
    unit = "vlsu"


@dataclasses.dataclass(frozen=True)
class VSSEG(Insn):               # segment store: interleaves nf groups back
    vs: int
    addr: int
    nf: int = 2
    unit = "vlsu"


@dataclasses.dataclass(frozen=True)
class VLUXEI(Insn):              # indexed-unordered load (RVV 1.0 vluxei):
    vd: int                      #   vd[i] = mem[clamp(addr + vidx[i])]
    addr: int
    vidx: int
    vm: int = 1
    unit = "vlsu"


@dataclasses.dataclass(frozen=True)
class VSUXEI(Insn):              # indexed-unordered store (scatter):
    vs: int                      #   mem[clamp(addr + vidx[i])] = vs[i];
    addr: int                    #   collisions: highest element index wins
    vidx: int
    vm: int = 1
    unit = "vlsu"


@dataclasses.dataclass(frozen=True)
class VFMA(Insn):                # vd <- va * vb + vd
    vd: int
    va: int
    vb: int
    vm: int = 1
    unit = "fpu"


@dataclasses.dataclass(frozen=True)
class VFMA_VS(Insn):             # vd <- scalar(vs_scalar) * vb + vd
    vd: int
    vs_scalar: int               # scalar register id
    vb: int
    vm: int = 1
    unit = "fpu"


@dataclasses.dataclass(frozen=True)
class VFADD(Insn):
    vd: int
    va: int
    vb: int
    vm: int = 1
    unit = "fpu"


@dataclasses.dataclass(frozen=True)
class VFMUL(Insn):
    vd: int
    va: int
    vb: int
    vm: int = 1
    unit = "fpu"


@dataclasses.dataclass(frozen=True)
class VFWMUL(Insn):              # widening: vd(2*sew) <- va(sew) * vb(sew)
    vd: int
    va: int
    vb: int
    vm: int = 1
    unit = "fpu"


@dataclasses.dataclass(frozen=True)
class VFWMA(Insn):               # widening FMA: vd(2*sew) += va(sew)*vb(sew)
    vd: int
    va: int
    vb: int
    vm: int = 1
    unit = "fpu"


@dataclasses.dataclass(frozen=True)
class VFNCVT(Insn):              # narrowing convert: vd(sew) <- vs(2*sew)
    vd: int
    vs: int
    vm: int = 1
    unit = "fpu"


@dataclasses.dataclass(frozen=True)
class VADD(Insn):                # integer add, wraps mod 2^SEW
    vd: int
    va: int
    vb: int
    vm: int = 1
    unit = "alu"


@dataclasses.dataclass(frozen=True)
class VSUB(Insn):                # integer subtract, wraps mod 2^SEW
    vd: int
    va: int
    vb: int
    vm: int = 1
    unit = "alu"


@dataclasses.dataclass(frozen=True)
class VMUL(Insn):                # integer multiply, wraps mod 2^SEW
    vd: int
    va: int
    vb: int
    vm: int = 1
    unit = "alu"


@dataclasses.dataclass(frozen=True)
class VSADDU(Insn):              # saturating unsigned add (fixed-point)
    vd: int
    va: int
    vb: int
    vm: int = 1
    unit = "alu"


@dataclasses.dataclass(frozen=True)
class VSADD(Insn):               # saturating signed add
    vd: int
    va: int
    vb: int
    vm: int = 1
    unit = "alu"


@dataclasses.dataclass(frozen=True)
class VSSUB(Insn):               # saturating signed subtract
    vd: int
    va: int
    vb: int
    vm: int = 1
    unit = "alu"


@dataclasses.dataclass(frozen=True)
class VSMUL(Insn):               # fractional multiply: sat((a*b + rnd) >> SEW-1)
    vd: int                      # vxrm fixed at rnu; saturation sets vxsat
    va: int
    vb: int
    vm: int = 1
    unit = "alu"


@dataclasses.dataclass(frozen=True)
class VINS(Insn):                # broadcast scalar into vector register
    vd: int
    scalar: int                  # scalar register id
    unit = "sldu"


@dataclasses.dataclass(frozen=True)
class VEXT(Insn):                # extract element vd[idx] -> scalar reg
    sd: int
    vs: int
    idx: int
    unit = "sldu"


@dataclasses.dataclass(frozen=True)
class VSLIDE(Insn):              # vd[i] <- vs[i + amount]  (slide-down)
    vd: int
    vs: int
    amount: int
    unit = "sldu"


@dataclasses.dataclass(frozen=True)
class VMSEQ(Insn):               # mask compare: vd[i] <- va[i] == vb[i]
    vd: int                      # writes exact 0/1 (mask layout); integer
    va: int                      # class, compares SEW-wide int views
    vb: int
    vm: int = 1
    unit = "mask"


@dataclasses.dataclass(frozen=True)
class VMSNE(Insn):               # mask compare: vd[i] <- va[i] != vb[i]
    vd: int
    va: int
    vb: int
    vm: int = 1
    unit = "mask"


@dataclasses.dataclass(frozen=True)
class VMSLT(Insn):               # mask compare: vd[i] <- va[i] < vb[i]
    vd: int                      # (signed, two's complement)
    va: int
    vb: int
    vm: int = 1
    unit = "mask"


@dataclasses.dataclass(frozen=True)
class VMSLE(Insn):               # mask compare: vd[i] <- va[i] <= vb[i]
    vd: int
    va: int
    vb: int
    vm: int = 1
    unit = "mask"


@dataclasses.dataclass(frozen=True)
class VMFEQ(Insn):               # float mask compare: vd[i] <- va[i] == vb[i]
    vd: int
    va: int
    vb: int
    vm: int = 1
    unit = "mask"


@dataclasses.dataclass(frozen=True)
class VMFLT(Insn):               # float mask compare: vd[i] <- va[i] < vb[i]
    vd: int
    va: int
    vb: int
    vm: int = 1
    unit = "mask"


@dataclasses.dataclass(frozen=True)
class VMAND(Insn):               # mask logical: vd[i] <- act(va[i]) & act(vb[i])
    vd: int                      # activeness = nonzero; writes exact 0/1
    va: int
    vb: int
    unit = "mask"


@dataclasses.dataclass(frozen=True)
class VMOR(Insn):                # mask logical: vd[i] <- act(va[i]) | act(vb[i])
    vd: int
    va: int
    vb: int
    unit = "mask"


@dataclasses.dataclass(frozen=True)
class VMXOR(Insn):               # mask logical: vd[i] <- act(va[i]) ^ act(vb[i])
    vd: int
    va: int
    vb: int
    unit = "mask"


@dataclasses.dataclass(frozen=True)
class VMERGE(Insn):              # always-masked select:
    vd: int                      #   vd[i] <- act(v0[i]) ? va[i] : vb[i]
    va: int
    vb: int
    unit = "mask"


@dataclasses.dataclass(frozen=True)
class VREDSUM(Insn):             # vd[0] <- treesum(active body of vs)
    vd: int                      # fixed binary tree, identity padding 0;
    vs: int                      # tail of vd (elements >= 1) undisturbed
    vm: int = 1
    unit = "sldu"


@dataclasses.dataclass(frozen=True)
class VREDMAX(Insn):             # vd[0] <- max over active body (identity -inf
    vd: int                      # / int min)
    vs: int
    vm: int = 1
    unit = "sldu"


@dataclasses.dataclass(frozen=True)
class VREDMIN(Insn):             # vd[0] <- min over active body (identity +inf
    vd: int                      # / int max)
    vs: int
    vm: int = 1
    unit = "sldu"


@dataclasses.dataclass(frozen=True)
class VFWREDSUM(Insn):           # widening float reduction: vd[0] at 2*SEW
    vd: int                      # (single rounding per tree node at 2*SEW)
    vs: int
    vm: int = 1
    unit = "sldu"


@dataclasses.dataclass(frozen=True)
class LDSCALAR(Insn):            # Ariane-side scalar load feeding VINS
    sd: int
    addr: int
    unit = "scalar"


# ---------------------------------------------------------------------------
# Operand legality (register grouping rules) — single source of truth for
# both engines, the timing scoreboard and the differential test oracle.
# ---------------------------------------------------------------------------

# vector operand table: insn -> ((attr, wide?, mode), ...); mode is one of
# "r" (read), "w" (write), "rw" (read-modify-write accumulators).
_VOPS = {
    VLD: (("vd", False, "w"),),
    VLDS: (("vd", False, "w"),),
    VGATHER: (("vd", False, "w"), ("vidx", False, "r")),
    VLUXEI: (("vd", False, "w"), ("vidx", False, "r")),
    VSUXEI: (("vs", False, "r"), ("vidx", False, "r")),
    VST: (("vs", False, "r"),),
    VFMA: (("vd", False, "rw"), ("va", False, "r"), ("vb", False, "r")),
    VFMA_VS: (("vd", False, "rw"), ("vb", False, "r")),
    VFADD: (("vd", False, "w"), ("va", False, "r"), ("vb", False, "r")),
    VFMUL: (("vd", False, "w"), ("va", False, "r"), ("vb", False, "r")),
    VADD: (("vd", False, "w"), ("va", False, "r"), ("vb", False, "r")),
    VSUB: (("vd", False, "w"), ("va", False, "r"), ("vb", False, "r")),
    VMUL: (("vd", False, "w"), ("va", False, "r"), ("vb", False, "r")),
    VSADDU: (("vd", False, "w"), ("va", False, "r"), ("vb", False, "r")),
    VSADD: (("vd", False, "w"), ("va", False, "r"), ("vb", False, "r")),
    VSSUB: (("vd", False, "w"), ("va", False, "r"), ("vb", False, "r")),
    VSMUL: (("vd", False, "w"), ("va", False, "r"), ("vb", False, "r")),
    VFWMUL: (("vd", True, "w"), ("va", False, "r"), ("vb", False, "r")),
    VFWMA: (("vd", True, "rw"), ("va", False, "r"), ("vb", False, "r")),
    VFNCVT: (("vd", False, "w"), ("vs", True, "r")),
    VINS: (("vd", False, "w"),),
    VEXT: (("vs", False, "r"),),
    VSLIDE: (("vd", False, "w"), ("vs", False, "r")),
    VMSEQ: (("vd", False, "w"), ("va", False, "r"), ("vb", False, "r")),
    VMSNE: (("vd", False, "w"), ("va", False, "r"), ("vb", False, "r")),
    VMSLT: (("vd", False, "w"), ("va", False, "r"), ("vb", False, "r")),
    VMSLE: (("vd", False, "w"), ("va", False, "r"), ("vb", False, "r")),
    VMFEQ: (("vd", False, "w"), ("va", False, "r"), ("vb", False, "r")),
    VMFLT: (("vd", False, "w"), ("va", False, "r"), ("vb", False, "r")),
    VMAND: (("vd", False, "w"), ("va", False, "r"), ("vb", False, "r")),
    VMOR: (("vd", False, "w"), ("va", False, "r"), ("vb", False, "r")),
    VMXOR: (("vd", False, "w"), ("va", False, "r"), ("vb", False, "r")),
    VMERGE: (("vd", False, "w"), ("va", False, "r"), ("vb", False, "r")),
    # reductions read a full source group but write ONE register's
    # element 0 — the scalar-destination span is patched in reg_groups
    VREDSUM: (("vd", False, "w"), ("vs", False, "r")),
    VREDMAX: (("vd", False, "w"), ("vs", False, "r")),
    VREDMIN: (("vd", False, "w"), ("vs", False, "r")),
    VFWREDSUM: (("vd", False, "w"), ("vs", False, "r")),
}

_WIDENING_OPS = (VFWMUL, VFWMA)
_FP_OPS = (VFMA, VFMA_VS, VFADD, VFMUL, VFWMUL, VFWMA, VFNCVT)
_INT_OPS = (VADD, VSUB, VMUL, VSADDU, VSADD, VSSUB, VSMUL)
_SAT_OPS = (VSADDU, VSADD, VSSUB, VSMUL)
_INT_CMP = (VMSEQ, VMSNE, VMSLT, VMSLE)
_FP_CMP = (VMFEQ, VMFLT)
_MASK_LOGICAL = (VMAND, VMOR, VMXOR)
# ops whose destination IS a mask (exempt from the v0-overlap rule)
_MASK_WRITERS = _INT_CMP + _FP_CMP + _MASK_LOGICAL
_REDUCTIONS = (VREDSUM, VREDMAX, VREDMIN, VFWREDSUM)


def check_vtype(sew: int, lmul=1):
    if sew not in SEWS:
        raise IllegalInstruction("bad-sew", f"unsupported SEW {sew}")
    if lmul not in LMULS:
        raise IllegalInstruction(
            "bad-lmul", f"unsupported LMUL {format_lmul(lmul)}")
    if Fraction(sew) / Fraction(lmul) > ELEN:
        raise IllegalInstruction(
            "elen",
            f"SEW={sew} at LMUL={format_lmul(lmul)} illegal: "
            f"SEW/LMUL exceeds ELEN={ELEN}")


def vtype_legal(sew: int, lmul=1) -> bool:
    """Non-raising spelling of :func:`check_vtype` for grid builders."""
    try:
        check_vtype(sew, lmul)
    except ValueError:
        return False
    return True


def legal_vtypes(sews=SEWS, lmuls=LMULS):
    """Every legal (sew, lmul) cell of the grid, in grid order."""
    return tuple((s, l) for s in sews for l in lmuls if vtype_legal(s, l))


def _check_group(base: int, span: int, what: str):
    if base % span:
        raise IllegalInstruction(
            "misaligned",
            f"{what}: register v{base} not aligned to group span {span}")
    if base < 0 or base + span > NUM_VREGS:
        raise IllegalInstruction(
            "bounds",
            f"{what}: group v{base}..v{base + span - 1} exceeds the "
            f"{NUM_VREGS}-register file")


def reg_groups(ins, lmul=1):
    """Vector register groups an instruction touches at the current vtype.

    Returns ``(reads, writes)``: lists of ``(base, span)`` pairs, spans in
    architectural registers (wide operands span ``group_span(2*lmul)`` —
    the EMUL rule; fractional groups reserve one whole register).
    Segment ops expand to one group per field.
    """
    t = type(ins)
    span = group_span(lmul)
    wspan = group_span(2 * Fraction(lmul))
    reads, writes = [], []
    if t is VLSEG:
        writes += [(ins.vd + f * span, span) for f in range(ins.nf)]
    elif t is VSSEG:
        reads += [(ins.vs + f * span, span) for f in range(ins.nf)]
    else:
        for attr, wide, mode in _VOPS.get(t, ()):
            grp = (getattr(ins, attr), wspan if wide else span)
            if "r" in mode:
                reads.append(grp)
            if "w" in mode:
                writes.append(grp)
    if t in _REDUCTIONS:
        # scalar destination: element 0 of ONE register, tail undisturbed
        writes = [(ins.vd, 1)]
    if getattr(ins, "vm", 1) == 0 or t is VMERGE:
        reads.append((MASK_REG, span))   # implicit v0 mask-group read
    return reads, writes


def _overlaps(a, b):
    return a[0] < b[0] + b[1] and b[0] < a[0] + a[1]


def check_insn(ins, sew: int, lmul=1, index=None):
    """Raise :class:`IllegalInstruction` (a ValueError) if ``ins`` is
    illegal at the current vtype.

    Encodes the RVV 1.0 rules the module docstring describes: group
    alignment, the widening EMUL=2*LMUL reservation and its source-overlap
    prohibition (EMUL stays a *product* — 2·mf4 = mf2, 2·mf2 = m1 — so
    fractional widening reserves one register), the narrowing lowest-part
    overlap exception, the segment-op ``nf * lmul <= 8`` span limit, and
    the op-class SEW gates: float ops need a float format (SEW >= 16),
    integer/fixed-point ops an exactly-representable width (SEW <= 32).

    ``index`` (optional) is the instruction's position in its program;
    callers that walk whole programs thread it so every rejection carries
    ``(code, mnemonic, sew, lmul, index)`` — the same diagnostic shape
    lint findings use.
    """
    try:
        _check_insn(ins, sew, lmul)
    except IllegalInstruction as e:
        raise e.with_context(mnemonic=type(ins).__name__, sew=sew,
                             lmul=lmul, index=index) from None


def _check_insn(ins, sew: int, lmul=1):
    t = type(ins)
    name = t.__name__
    if t is VSETVL:
        if ins.vl < 0:
            raise IllegalInstruction(
                "negative-avl", f"VSETVL: negative AVL {ins.vl}")
        check_vtype(ins.sew, ins.lmul)
        return
    span = group_span(lmul)
    wspan = group_span(2 * Fraction(lmul))
    if t in _INT_CMP and sew not in INT_SEWS:
        raise IllegalInstruction(
            "class-gate",
            f"{name} illegal at SEW={sew} (integer compares share the "
            f"integer class gate: SEW in {INT_SEWS})")
    if t in _FP_CMP and sew not in FP_SEWS:
        raise IllegalInstruction(
            "class-gate",
            f"{name} illegal at SEW={sew} (float compares need a float "
            f"format: SEW in {FP_SEWS})")
    if t is VFWREDSUM:
        if sew not in FP_SEWS:
            raise IllegalInstruction(
                "class-gate",
                f"VFWREDSUM illegal at SEW={sew} (float reduction needs a "
                f"float format)")
        if sew == max(SEWS):
            raise IllegalInstruction(
                "elen",
                f"VFWREDSUM illegal at SEW={sew} (2*SEW exceeds ELEN=64)")
    if t in _FP_OPS and sew not in FP_SEWS:
        raise IllegalInstruction(
            "class-gate",
            f"{name} illegal at SEW={sew} (no FP8 format: float ops need "
            f"SEW in {FP_SEWS})")
    if t in _INT_OPS and sew not in INT_SEWS:
        raise IllegalInstruction(
            "class-gate",
            f"{name} illegal at SEW={sew} (integer ops model int8/16/32 "
            f"sub-words; int64 would not round-trip the engines' float "
            f"storage)")
    if t in _WIDENING_OPS or t is VFNCVT:
        if sew == max(SEWS):
            raise IllegalInstruction(
                "elen",
                f"{name} illegal at SEW={sew} (2*SEW exceeds ELEN=64)")
        if 2 * Fraction(lmul) > max(LMULS):
            raise IllegalInstruction(
                "emul",
                f"{name} illegal at LMUL={format_lmul(lmul)} "
                f"(EMUL=2*LMUL exceeds {max(LMULS)})")
    if t in (VLSEG, VSSEG):
        if ins.nf < 1 or ins.nf * Fraction(lmul) > max(LMULS):
            raise IllegalInstruction(
                "nf-span",
                f"{name}: nf={ins.nf} illegal at LMUL={format_lmul(lmul)} "
                f"(need 1 <= nf*lmul <= {max(LMULS)})")
    reads, writes = reg_groups(ins, lmul)
    for base, sp in reads + writes:
        _check_group(base, sp, name)
    if t in _WIDENING_OPS:
        dst = (ins.vd, wspan)
        for src in ((ins.va, span), (ins.vb, span)):
            if _overlaps(dst, src):
                raise IllegalInstruction(
                    "widen-overlap",
                    f"{name}: wide destination v{ins.vd} (span {wspan}) "
                    f"overlaps narrow source v{src[0]}")
    if t is VFNCVT:
        dst, src = (ins.vd, span), (ins.vs, wspan)
        if _overlaps(dst, src) and ins.vd != ins.vs:
            raise IllegalInstruction(
                "narrow-overlap",
                f"VFNCVT: destination v{ins.vd} overlaps wide source "
                f"v{ins.vs} outside the lowest-numbered position")
    if (getattr(ins, "vm", 1) == 0 or t is VMERGE) \
            and t not in _MASK_WRITERS and t not in _REDUCTIONS:
        mask_grp = (MASK_REG, span)
        for base, sp in writes:
            if _overlaps((base, sp), mask_grp):
                raise IllegalInstruction(
                    "v0-overlap",
                    f"{name}: masked destination v{base} overlaps the v0 "
                    f"mask group (RVV 1.0 v0-overlap rule: only mask "
                    f"writers and reduction scalars may)")


def validate_program(program):
    """Statically check a whole program; returns it unchanged if legal."""
    sew, lmul = max(SEWS), 1
    for i, ins in enumerate(program):
        check_insn(ins, sew, lmul, index=i)
        if type(ins) is VSETVL:
            sew, lmul = ins.sew, ins.lmul
    return program


# ---------------------------------------------------------------------------
# Program builders for the paper's kernels
# ---------------------------------------------------------------------------


def daxpy_program(n: int, x_addr: int, y_addr: int, alpha_sreg: int = 0,
                  vlmax: Optional[int] = None, sew: int = 64,
                  lmul=1):
    """Y <- alpha*X + Y, strip-mined (Fig. 9 style).

    ``vlmax`` is the per-register VLMAX at ``sew``; grouping multiplies the
    strip length by ``lmul`` (fewer trips, longer chains — fractional LMUL
    shrinks it, the honest cost of sub-register groups). Registers are
    picked span-aligned: x in v[span], y in v[2*span], alpha in v[3*span].
    """
    span = group_span(lmul)
    vlmax = max(1, int((vlmax or n) * Fraction(lmul)))
    vx, vy, va = span, 2 * span, 3 * span
    prog = []
    c = 0
    while c < n:
        vl = min(n - c, vlmax)
        prog += [VSETVL(vl, sew, lmul),
                 VLD(vx, x_addr + c),
                 VLD(vy, y_addr + c),
                 VINS(va, alpha_sreg),
                 VFMA(vy, va, vx),           # y += alpha * x
                 VST(vy, y_addr + c)]
        c += vl
    return prog


def matmul_program(n: int, a_addr: int, b_addr: int, c_addr: int,
                   t: int = 4, vlmax: Optional[int] = None, sew: int = 64,
                   lmul=1):
    """Listing 1: C <- A B + C, row-major, tiles of t rows, strip-mined.

    With grouping the strip covers ``lmul * vlmax`` columns per VSETVL and
    every VLD/VFMA names an LMUL-register group, so the per-column issue
    cost is amortized over LMUL× more elements. The row-tile height t is
    clamped so the B row, the broadcast group and t accumulator groups fit
    the 32-register file: t <= 32/span - 2 (the register-pressure cost of
    grouping — B-row reuse shrinks as LMUL grows, Ara2's trade-off).
    """
    span = group_span(lmul)
    vlmax = max(1, int((vlmax or n) * Fraction(lmul)))
    t = max(1, min(t, NUM_VREGS // span - 2))
    vb, vbc, vc0 = 0, span, 2 * span          # B row, broadcast, C tiles
    prog = []
    col = 0
    while col < n:
        vl = min(n - col, vlmax)
        prog.append(VSETVL(vl, sew, lmul))
        for r0 in range(0, n, t):
            rows = min(t, n - r0)
            for j in range(rows):            # phase I
                prog.append(VLD(vc0 + j * span, c_addr + (r0 + j) * n + col))
            for i in range(n):               # phase II
                prog.append(VLD(vb, b_addr + i * n + col))
                for j in range(rows):
                    prog.append(LDSCALAR(1, a_addr + (r0 + j) * n + i))
                    prog.append(VINS(vbc, 1))
                    prog.append(VFMA_VS(vc0 + j * span, 1, vb))
            for j in range(rows):            # phase III
                prog.append(VST(vc0 + j * span, c_addr + (r0 + j) * n + col))
        col += vl
    return prog


def imatmul_program(n: int, a_addr: int, b_addr: int, c_addr: int,
                    t: int = 4, vlmax: Optional[int] = None, lmul=1,
                    sew: int = 8):
    """Integer (SEW=8) Listing-1 analogue: C <- A B + C mod 2^SEW.

    The op subset has no integer MACC, so every accumulation is a VMUL
    into a temp group plus a VADD — two ALU slots where the float kernel
    spends one FMA. The scoreboard therefore lands the int8 speedup near
    4× of the 64-bit baseline rather than the raw 8× datapath split; the
    honest cost of the missing vmacc (benchmarks/multiprecision.py
    records both numbers).
    """
    span = group_span(lmul)
    vlmax = max(1, int((vlmax or n) * Fraction(lmul)))
    t = max(1, min(t, NUM_VREGS // span - 3))
    vb, vbc, vt, vc0 = 0, span, 2 * span, 3 * span
    prog = []
    col = 0
    while col < n:
        vl = min(n - col, vlmax)
        prog.append(VSETVL(vl, sew, lmul))
        for r0 in range(0, n, t):
            rows = min(t, n - r0)
            for j in range(rows):            # phase I
                prog.append(VLD(vc0 + j * span, c_addr + (r0 + j) * n + col))
            for i in range(n):               # phase II
                prog.append(VLD(vb, b_addr + i * n + col))
                for j in range(rows):
                    prog.append(LDSCALAR(1, a_addr + (r0 + j) * n + i))
                    prog.append(VINS(vbc, 1))
                    prog.append(VMUL(vt, vbc, vb))
                    prog.append(VADD(vc0 + j * span, vc0 + j * span, vt))
            for j in range(rows):            # phase III
                prog.append(VST(vc0 + j * span, c_addr + (r0 + j) * n + col))
        col += vl
    return prog


def slide_reduce_program(vs: int, vl: int, sd: int = 0):
    """O(log n) sum-reduction via slides + adds (§III-C: no native vred).

    Retained as the historical workaround that the native reduction class
    (``VREDSUM`` et al.) retires — the engine demo compares the two
    spellings' scoreboard cycles. Requires power-of-two ``vl``: VSLIDE is
    tail-undisturbed, so slid-in body positions keep stale values, and
    only at power-of-two ``vl`` does the add tree rooted at element 0
    never read one (the j-th partial at round k sits at j <= vl - 2^k).
    """
    prog = []
    shift = 1
    tmp = (vs + 1) % NUM_VREGS
    while shift < vl:
        prog.append(VSLIDE(tmp, vs, shift))
        prog.append(VFADD(vs, vs, tmp))
        shift *= 2
    prog.append(VEXT(sd, vs, 0))
    return prog


def argmax_program(vs: int, iota_addr: int, sd: int = 0,
                   huge_sreg: int = 1, t0: int = 8, t1: int = 12,
                   fp: bool = True):
    """First-index argmax of group ``vs`` via masks + reductions.

    The §III-C retirement demo: VREDMAX finds the max, a compare marks
    every tied element in ``v0``, VMERGE swaps inactive *indices* for a
    huge sentinel, and VREDMIN picks the lowest tied index — numpy's
    argmax tie rule — landing it in scalar register ``sd``.

    The caller stages the iota ``0, 1, .., vl-1`` at ``iota_addr`` and a
    sentinel ``>= vl`` in scalar register ``huge_sreg``. ``t0``/``t1``
    are scratch groups (must not be ``v0`` or overlap ``vs``); ``fp``
    selects VMFEQ vs VMSEQ for the tie compare.
    """
    cmp = VMFEQ if fp else VMSEQ
    return [
        VREDMAX(t0, vs),           # t0[0] <- max of the body
        VEXT(sd, t0, 0),
        VINS(t0, sd),              # broadcast the max
        cmp(MASK_REG, vs, t0),     # v0 <- (vs == max): the tie mask
        VLD(t1, iota_addr),        # element indices
        VINS(t0, huge_sreg),       # broadcast the sentinel
        VMERGE(t1, t1, t0),        # tied -> index, others -> sentinel
        VREDMIN(t0, t1),
        VEXT(sd, t0, 0),           # sd <- first tied index
    ]
