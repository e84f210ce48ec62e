"""setvl-style strip-mining arithmetic.

The paper's strip-mined loop (Fig. 9, line 3: ``vl = min(n - c, VLMAX)``)
lets one binary run on any lane count. ``strip_lengths`` / ``lmul_tile``
are the RVV 1.0 LMUL generalization of that loop — register grouping
multiplies VLMAX, so each strip (and each kernel block) covers LMUL× more
elements per dispatched step. The kernel wrappers consult ``lmul_tile`` to
resolve their block arguments exactly as the reference does.

Pure host arithmetic (no tensors). The gradient-accumulation and
step-fusion helpers of the reference module belong to the training slice.
"""
from __future__ import annotations

from fractions import Fraction


def strip_lengths(n: int, vlmax: int, lmul=1):
    """Fig. 9 line 3 with grouping: the vl of each strip-mine trip.

    ``vlmax`` is the per-register VLMAX at the current SEW; an LMUL-
    register group covers ``lmul * vlmax`` elements per trip, so the list
    shrinks by up to LMUL×. Fractional LMUL (mf2/mf4) shortens the strip
    instead (floored, min 1).
    """
    step = max(1, int(vlmax * Fraction(lmul)))
    out = []
    c = 0
    while c < n:
        out.append(min(n - c, step))
        c += out[-1]
    return out


def lmul_tile(n: int, base: int, lmul=1, cap: int | None = None):
    """Pick a block edge for an LMUL-grouped kernel: the largest divisor
    of ``n`` no bigger than ``min(base * lmul, n, cap)``. Fractional lmul
    narrows the block (exact floor)."""
    limit = max(1, min(int(base * Fraction(lmul)), n,
                       cap if cap is not None else n))
    for b in range(limit, 0, -1):
        if n % b == 0:
            return b
    return 1


def mixed_width_lmul(lmul_wide, sew_wide: int, sew_narrow: int):
    """EMUL the *narrow* operand of a mixed-width loop groups at.

    RVV's EMUL product rule: a loop whose wide accumulator (``sew_wide``,
    ``lmul_wide``) feeds from narrow operands keeps element counts equal
    by grouping the narrow side at ``lmul * sew_narrow / sew_wide`` —
    int8 operands under an int32 LMUL=1 accumulator group at mf4.
    Returns an int when the product is whole, else an exact Fraction.
    """
    f = Fraction(lmul_wide) * Fraction(sew_narrow, sew_wide)
    return f.numerator if f.denominator == 1 else f
