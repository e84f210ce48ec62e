"""ClusterEngine: hierarchical clusters x lanes scale-out (AraXL/Spatz) on
one device.

The port of the reference package's ``core/cluster.py``. AraXL scales
Ara's identical lanes to 64 by grouping them into *clusters* behind a
hierarchical interconnect. This module reproduces that topology rung:

- :func:`make_cluster_mesh` describes the 2-D ``(clusters, lanes)``
  topology (outer axis = cluster id, inner axis = lane-in-cluster) as a
  :class:`staging.Mesh`. The reference builds a device mesh over
  ``clusters * lanes_per_cluster`` devices; one card holds every lane, so
  this checks the shape alone and never counts devices.
- :class:`ClusterEngine` runs the *unchanged* staged step of
  ``core/staging.py`` per lane — a lane's global index is ``cluster *
  lanes_per_cluster + lane_in_cluster`` — with the lanes a leading
  dimension of the register file. Every all-lane reconciliation (VLSU
  scatter counts, SLDU slide/extract/reduction gathers, the sticky vxsat
  flag) folds **intra-cluster first, then across clusters**, as the
  reference's nested ``psum``/``pmax``. Per-lane contributions are
  disjoint, so the two-stage fold is bit-identical to the flat one: a
  ClusterEngine at any (clusters, lanes/cluster) shape matches the
  ReferenceEngine bit for bit.

The timing side of the hierarchy lives in ``core/perfmodel.py`` and
``vector_engine.simulate_timing(clusters=)``;
``benchmarks/torch_scaleout.py`` sweeps both against each other from 4 to
64 total lanes.

Cache identity: the signature carries ``clusters`` and the topology's
fingerprint (axis names and sizes), so a 2x2 cluster grid, a 4x1 grid
and a flat 4-lane mesh — equal total lanes — never share a runner.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.configs.ara import AraConfig
from repro_torch.core import staging
from repro_torch.core.vector_engine import _StagedEngine

CLUSTER_AXES = ("clusters", "lanes")


def make_cluster_mesh(clusters: int, lanes_per_cluster: int,
                      axes: Sequence[str] = CLUSTER_AXES) -> staging.Mesh:
    """A (clusters, lanes_per_cluster) topology, cluster ``c`` owning the
    lanes [c*lpc, (c+1)*lpc). Raises ``ValueError`` unless both sizes are
    at least 1."""
    if int(clusters) < 1 or int(lanes_per_cluster) < 1:
        raise ValueError(f"cluster mesh {clusters}x{lanes_per_cluster}: "
                         "both sizes must be >= 1")
    return staging.Mesh(tuple(axes), (int(clusters), int(lanes_per_cluster)))


class ClusterEngine(_StagedEngine):
    """Nested clusters x lanes-per-cluster staged engine.

    Same ISA semantics as ReferenceEngine/LaneEngine (differentially
    tested bit-exact); the topology only changes *where* elements live and
    how reconciliation folds. Construct either from an explicit 2-D mesh
    (``mesh=``, axis names in ``axes``) or from a ``(clusters,
    lanes_per_cluster)`` shape.
    """

    kind = "cluster"

    def __init__(self, cfg: AraConfig, clusters: int = 2,
                 lanes_per_cluster: int = 2, mesh=None,
                 axes: Sequence[str] = CLUSTER_AXES,
                 vlmax: Optional[int] = None, dtype=torch.float32,
                 cache: Optional[staging.TraceCache] = None,
                 lint: bool = False, device=None):
        if mesh is None:
            mesh = make_cluster_mesh(clusters, lanes_per_cluster, axes=axes)
        self.mesh = mesh
        self.axes = tuple(axes)
        self.mesh_key = staging.mesh_fingerprint(mesh, self.axes)
        self.clusters = int(mesh.shape[self.axes[0]])
        self.lanes_per_cluster = int(mesh.shape[self.axes[1]])
        self.lanes = self.clusters * self.lanes_per_cluster
        vlmax = vlmax or cfg.vlmax_dp
        super().__init__(cfg, (vlmax // self.lanes) * self.lanes,
                         dtype=dtype, cache=cache, lint=lint, device=device)

    @property
    def topology(self):
        return (self.clusters, self.lanes_per_cluster)
