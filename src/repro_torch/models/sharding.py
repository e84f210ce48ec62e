"""Logical-axis -> mesh-axis policy (the lane-assignment rules).

The ``model`` axis is Ara's lane axis. Rules keep chained ops lane-local
(Megatron column->row pairing), shard experts over lanes when they divide
(expert parallelism), and optionally FSDP-shard the non-lane dim of params
over ``data``. The rules are the reference's; the mesh is the port's
``core.staging.Mesh`` (named axes and sizes, held as tensor dimensions on
one device by ``core/compat.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.core.compat import PartitionSpec, entry_axes
from repro_torch.models.layers import Rules, tree_map


@dataclasses.dataclass(frozen=True)
class MeshCtx:
    """Runtime mesh context threaded through forwards (None = single
    device)."""
    mesh: Optional[object]
    batch_axes: tuple = ("data",)
    model_axis: str = "model"

    @property
    def axis_sizes(self) -> dict:
        if self.mesh is None:
            return {}
        return dict(self.mesh.shape)

    @property
    def n_lanes(self) -> int:
        return self.axis_sizes.get(self.model_axis, 1)


def make_rules(cfg: ArchConfig, ctx: MeshCtx) -> Rules:
    model = ctx.model_axis
    # ZeRO-3/FSDP: shard the non-lane param dim over every batch axis
    # (pod included on multi-pod: 671B params cannot pod-replicate)
    fsdp_axis = tuple(a for a in ctx.batch_axes if a in ctx.axis_sizes) \
        if cfg.fsdp else None
    fsdp_axis = fsdp_axis or None
    mapping = (
        ("vocab", model),
        ("heads", model),
        ("kv_heads", model),
        ("head_dim", None),
        ("ffn", model),
        ("embed", fsdp_axis),
        ("embed2", fsdp_axis),      # second d_model dim (e.g. wo out)
        ("q_lora", fsdp_axis),
        ("kv_lora", fsdp_axis),
        ("experts", model if cfg.moe.expert_parallel else None),
        ("experts_ffn", model if not cfg.moe.expert_parallel else None),
        ("d_inner", model),         # ssm inner dim
        ("ssm_state", None),
        ("layers", None),
        ("batch", tuple(ctx.batch_axes)),
        ("seq", None),
        ("kv_seq", None),           # set to model for seq-sharded KV caches
    )
    mesh_shape = tuple(ctx.axis_sizes.items())
    return Rules(mapping=mapping, mesh_shape=mesh_shape)


def kv_cache_rules(cfg: ArchConfig, ctx: MeshCtx) -> Rules:
    """Decode caches: shard KV heads over lanes when they divide, else shard
    the sequence dim (sequence-parallel cache)."""
    model = ctx.model_axis
    lanes = ctx.n_lanes
    heads_shardable = cfg.n_kv_heads % max(lanes, 1) == 0 and not cfg.use_mla
    mapping = (
        ("batch", tuple(ctx.batch_axes)),
        ("kv_heads", model if heads_shardable else None),
        ("kv_seq", None if heads_shardable else model),
        ("head_dim", None),
        ("kv_lora", None),
        ("layers", None),
        ("groups", None),
        ("d_inner", model),
        ("ssm_state", None),
        ("heads", model),
        ("embed", None),
        ("seq", None),
    )
    return Rules(mapping=mapping, mesh_shape=tuple(ctx.axis_sizes.items()))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, as the reference's ``jax.sharding.NamedSharding``.
    One card holds every leaf whole, so it places nothing: it gives the
    shard shape each device of the mesh would hold."""
    mesh: object
    spec: PartitionSpec

    def shard_shape(self, global_shape) -> tuple:
        """Each device's shard of a leaf of ``global_shape``; raises the
        reference's ``ValueError`` where a sharded dimension does not
        divide by its mesh axes."""
        global_shape = tuple(global_shape)
        if len(self.spec) > len(global_shape):
            raise ValueError(f"{self} has more entries than the "
                             f"{len(global_shape)} dimensions of "
                             f"{global_shape}")
        sizes = dict(self.mesh.shape)
        out = list(global_shape)
        for dim, entry in enumerate(self.spec):
            n = math.prod(sizes[a] for a in entry_axes(entry))
            if global_shape[dim] % n:
                raise ValueError(
                    f"One of device_put args was given the sharding of "
                    f"{self}, which implies that the global size of its "
                    f"dimension {dim} should be divisible by {n}, but it is "
                    f"equal to {global_shape[dim]} (full shape: "
                    f"{global_shape})")
            out[dim] = global_shape[dim] // n
        return tuple(out)


def named_sharding_tree(spec_tree, mesh):
    return tree_map(lambda s: NamedSharding(mesh, s), spec_tree)
