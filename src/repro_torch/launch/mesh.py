"""Production mesh construction (the reference's shapes) + elastic remesh.

A mesh here is ``core.staging.Mesh``: named axes and their sizes. One card
holds every device of it as a leading tensor dimension (``core/compat.py``),
so none of these functions needs devices to exist: ``elastic_mesh(300,
model=16)`` gives 18 x 16 on any machine.
"""
from __future__ import annotations

from repro_torch.core.staging import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_mesh(data: int, model: int, pod: int = 1) -> Mesh:
    """``("data", "model")``, or ``("pod", "data", "model")`` for pod > 1."""
    if pod > 1:
        return Mesh(("pod", "data", "model"), (pod, data, model))
    return Mesh(("data", "model"), (data, model))


def elastic_mesh(n_available: int, model: int = 16):
    """Largest (data, model) mesh buildable from ``n_available`` devices.

    Keeps the lane (model) axis fixed — lanes hold param shards and must stay
    intact — and shrinks the data axis, mirroring how Ara keeps lanes and
    varies the problem strip. Fewer devices than one lane group give one
    data row of all of them. Returns (mesh, data_size).
    """
    data = max(n_available // model, 1)
    if data * model > n_available:
        model = n_available
        data = 1
    return make_mesh(data, model), data
