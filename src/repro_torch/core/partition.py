"""A mesh layout's spec: the port's copy of ``jax.sharding.PartitionSpec``
and the reading of one of its entries. A leaf module: ``core/compat.py``
(which re-exports both) and ``core/step_analysis.py`` read it."""
from __future__ import annotations


class PartitionSpec(tuple):
    """The port's copy of ``jax.sharding.PartitionSpec``: a tuple, one
    entry per dimension (``None``, a mesh axis name, or a tuple of names;
    a one-name tuple is that name, as the reference's normalizes it);
    dimensions past its length are replicated."""

    def __new__(cls, *parts):
        parts = tuple(tuple(p) if isinstance(p, (tuple, list)) else p
                      for p in parts)
        return super().__new__(cls, tuple(
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in parts))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


def entry_axes(entry) -> tuple:
    """The mesh axes of one spec entry (None, a name or a tuple)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)
