"""setvl-style strip-mining arithmetic.

The paper's strip-mined loop (Fig. 9, line 3: ``vl = min(n - c, VLMAX)``)
lets one binary run on any lane count. ``strip_lengths`` / ``lmul_tile``
are the RVV 1.0 LMUL generalization of that loop — register grouping
multiplies VLMAX, so each strip (and each kernel block) covers LMUL× more
elements per dispatched step. The kernel wrappers consult ``lmul_tile`` to
resolve their block arguments exactly as the reference does.

The loops of the reference module (its ``lax.scan``s) are Python loops
here:

- ``stripmined_grads``: gradient accumulation — the global batch is streamed
  in strips so activation memory is bounded by the strip, not the batch;
- ``stripmine_map``: a strip loop over a leading axis;
- ``fuse_steps``: k sequential steps behind one call (the reference's one
  dispatch; eager PyTorch launches each step's kernels regardless).
"""
from __future__ import annotations

from fractions import Fraction

import torch


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


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = tree[sorted(tree)[0]]
    return tree


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _cat(ys):
    if isinstance(ys[0], dict):
        return {k: _cat([y[k] for y in ys]) for k in ys[0]}
    return torch.cat(ys)


def stripmine_map(fn, xs, strip: int):
    """Apply ``fn`` over leading-axis strips of ``xs`` (a dict of tensors
    or a tensor); concatenate the results."""
    n = _first_leaf(xs).shape[0]
    if n % strip:
        raise ValueError(f"stripmine_map: {n} rows are not a multiple of "
                         f"the strip {strip}")
    return _cat([fn(_map(lambda a: a[i:i + strip], xs))
                 for i in range(0, n, strip)])


def stripmined_grads(loss_fn, params, batch, n_strips: int):
    """Gradient accumulation. ``loss_fn(params, microbatch) -> (loss,
    metrics)``. Returns ``((loss, metrics), grads)`` averaged over strips,
    summed in strip order as the reference's scan does."""
    from repro_torch.models.layers import value_and_grad
    b = _first_leaf(batch).shape[0]
    if b % n_strips:
        raise ValueError(f"stripmined_grads: batch {b} is not a multiple of "
                         f"{n_strips} strips")
    mb = b // n_strips
    grad_fn = value_and_grad(loss_fn)
    loss = metrics = grads = None
    for i in range(n_strips):
        micro = _map(lambda a: a[i * mb:(i + 1) * mb], batch)
        (l_i, m_i), g_i = grad_fn(params, micro)
        if grads is None:
            loss, metrics, grads = l_i, m_i, g_i
            continue
        loss = loss + l_i
        metrics = {k: metrics[k] + m_i[k] for k in metrics}
        grads = _add_(grads, g_i)
    k = float(n_strips)
    return ((loss / k, {key: m / k for key, m in metrics.items()}),
            _map(lambda g: g / k, grads))


def _add_(acc, new):
    """acc += new leaf by leaf, in place (the sum needs no second tree)."""
    if isinstance(acc, dict):
        return {k: _add_(acc[k], new[k]) for k in acc}
    return acc.add_(new)


def fuse_steps(step_fn, k: int):
    """Fuse ``k`` sequential (state, batch_i) steps behind one call.

    step_fn: (state, batch) -> (state, metrics). Returns a function
    (state, stacked_batch) -> (state, stacked_metrics) that walks the
    stacked batch's leading axis (of length k) in order."""
    def fused(state, stacked_batch):
        n = _first_leaf(stacked_batch).shape[0]
        metrics = []
        for i in range(n):
            state, m = step_fn(state, _map(lambda a: a[i], stacked_batch))
            metrics.append(m)
        return state, _stack(metrics)
    return fused
