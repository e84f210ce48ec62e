"""Production mesh construction (the reference's shapes) + elastic remesh,
and the mesh of processes.

A mesh here is ``core.staging.Mesh``: named axes and their sizes. One card
holds every device of it as a leading tensor dimension (``core/compat.py``),
so none of these functions needs devices to exist: ``elastic_mesh(300,
model=16)`` gives 18 x 16 on any machine. :func:`make_process_mesh` builds
the other route: one process a device, on ``torch.distributed``.
"""
from __future__ import annotations

import datetime
import itertools
import os
from typing import Optional

import torch

from repro_torch.core.compat import ProcessMesh
from repro_torch.core.staging import Mesh

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
# the backends a caller may name for each device kind: gloo takes CUDA
# tensors for all_reduce, broadcast and all_gather (tools/
# torch_gloo_cuda_probe.py), which lets ranks share one card, where NCCL
# refuses two ranks on one device
NAMED_BACKENDS = {"cuda": ("nccl", "gloo"), "cpu": ("gloo",)}


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_mesh(data: int, model: int, pod: int = 1) -> Mesh:
    """``("data", "model")``, or ``("pod", "data", "model")`` for pod > 1."""
    if pod > 1:
        return Mesh(("pod", "data", "model"), (pod, data, model))
    return Mesh(("data", "model"), (data, model))


def make_process_mesh(data: int, model: int, *, device: str = "cuda",
                      init_method: Optional[str] = None,
                      rank: Optional[int] = None,
                      world_size: Optional[int] = None,
                      timeout_s: float = 600.0,
                      backend: Optional[str] = None) -> ProcessMesh:
    """The ``("data", "model")`` mesh of ``data * model`` processes, this one
    at its rank's row-major coordinates, as ``make_mesh`` lays out devices.

    It joins the default process group, or checks the one already joined:
    from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``), or from ``init_method`` with ``rank`` and
    ``world_size``. The backend follows ``device``: NCCL for "cuda" (the
    rank's card is the device's index if it names one, else
    ``LOCAL_RANK``, else its rank), gloo for "cpu"; a missing backend
    raises, nothing falls back to another. ``backend`` names one instead:
    only "gloo" with a "cuda" device differs from the rule (ranks that
    share a card; a collective gloo lacks on CUDA tensors raises where it
    is called). A world of another size than ``data * model`` raises
    ``ValueError``. Every rank
    builds the same groups, in the same order: one over each axis and one
    over each pair of axes (the world itself for the pair of all)."""
    import torch.distributed as dist

    kind = torch.device(device).type
    if kind not in BACKENDS:
        raise ValueError(f"make_process_mesh: no process route for device "
                         f"{device!r} (cuda or cpu)")
    if backend is None:
        backend = BACKENDS[kind]
    elif backend not in NAMED_BACKENDS[kind]:
        raise ValueError(f"make_process_mesh: backend {backend!r} for "
                         f"device {device!r}: one of "
                         f"{NAMED_BACKENDS[kind]}")
    if not dist.is_available() or not getattr(
            dist, f"is_{backend}_available")():
        raise RuntimeError(f"make_process_mesh: device {device!r} needs the "
                           f"{backend} backend, which this torch lacks")
    if dist.is_initialized():
        world, me = dist.get_world_size(), dist.get_rank()
        if dist.get_backend() != backend:
            raise RuntimeError(
                f"make_process_mesh: the process group runs "
                f"{dist.get_backend()}, device {device!r} needs {backend}")
    elif init_method is None:
        if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
            raise RuntimeError("make_process_mesh: not under torchrun (no "
                               "RANK / WORLD_SIZE); pass init_method, rank "
                               "and world_size")
        world, me = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        if rank is None or world_size is None:
            raise ValueError("make_process_mesh: init_method needs rank and "
                             "world_size")
        world, me = int(world_size), int(rank)
    if world != data * model:
        raise ValueError(f"make_process_mesh: a ({data}, {model}) mesh "
                         f"needs {data * model} processes, the world has "
                         f"{world}")
    if kind == "cuda":
        local = torch.device(device).index
        if local is None:
            local = int(os.environ.get("LOCAL_RANK", me))
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    else:
        dev = torch.device("cpu")
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method or "env://", rank=me,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))

    names, sizes = ("data", "model"), (data, model)
    mesh = ProcessMesh(names, sizes, me, dev, {})
    for r in range(1, len(names) + 1):
        for sub in itertools.combinations(range(len(names)), r):
            others = [d for d in range(len(names)) if d not in sub]
            for fixed in itertools.product(*(range(sizes[d])
                                             for d in others)):
                ranks = [x for x in range(world)
                         if all(mesh.coords_of(x)[d] == c
                                for d, c in zip(others, fixed))]
                group = None if len(ranks) == 1 else \
                    dist.group.WORLD if len(ranks) == world else \
                    dist.new_group(ranks)
                if me in ranks:
                    mesh.groups[frozenset(names[d] for d in sub)] = (group,
                                                                    ranks)
    return mesh


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
