"""Three-term H100 roofline of a counted torch step, the twin of the
reference's ``core/roofline.py`` (its terms and fields, on the port's
count and the H100's rates):

    compute    = FLOPs_per_device / PEAKS_FLOPS[compute dtype]
    memory     = bytes_per_device / PEAK_BYTES_PER_S
    collective = collective_bytes_per_device / LINK_BYTES_PER_S

Terms are seconds per step for one device; the dominant term is the
bottleneck. ``build`` takes a :class:`core.step_analysis.StepStats` (the
count of a torch step, usually on ``meta`` tensors) where the reference
takes compiled HLO text. The compute peak is the one of the step's compute
dtype (``core/precision.py``: bf16 989 TFLOP/s, float32 67 on the CUDA
cores), where the reference always takes its bf16 peak. MODEL_FLOPS =
6*N*D (6*N_active*D for MoE) measures how much of the counted compute is
"useful" (remat and dispatch waste show up here).

``LINK_BYTES_PER_S`` is one H100's NVLink 4 rate in one direction: 900
GB/s bidirectional in NVIDIA's H100 SXM data sheet, 450 GB/s each way.
Every device of a mesh is taken to reach every other at that rate, as in
one NVLink domain; crossing a node's boundary (InfiniBand between hosts) is
not modelled.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.precision import PEAK_BYTES_PER_S, PEAKS_FLOPS
from repro_torch.core.step_analysis import StepStats

LINK_BYTES_PER_S = 450e9      # NVLink 4, one direction (900 GB/s both)


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops_per_dev: float     # the counted step's (the reference's name)
    hlo_bytes_per_dev: float
    coll_bytes_per_dev: float
    model_flops_total: float
    useful_ratio: float          # MODEL_FLOPS / (counted FLOPs * n_dev)
    bottleneck: str
    achievable_step_s: float     # max of the three terms
    mfu_bound: float             # model_flops / (n_dev*peak*achievable_step)
    detail: dict

    def row(self) -> dict:
        return dataclasses.asdict(self)


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """6*N*D for train; 2*N*D for a forward-only prefill; per-new-token
    2*N_active for decode."""
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens
    # decode: one new token per sequence
    return 2.0 * n_active * shape.global_batch


def peak_flops(cfg: ArchConfig) -> float:
    """The H100's peak for the config's compute dtype."""
    if cfg.compute_dtype not in PEAKS_FLOPS:
        raise ValueError(f"no H100 peak for compute dtype "
                         f"{cfg.compute_dtype!r}; known: "
                         f"{sorted(PEAKS_FLOPS)}")
    return PEAKS_FLOPS[cfg.compute_dtype]


def build(cfg: ArchConfig, shape: ShapeConfig, mesh_name: str,
          n_devices: int, stats: StepStats) -> Roofline:
    peak = peak_flops(cfg)
    mf = model_flops(cfg, shape)
    compute_s = stats.flops / peak
    memory_s = stats.bytes_accessed / PEAK_BYTES_PER_S
    collective_s = stats.collective_bytes / LINK_BYTES_PER_S
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    achievable = max(terms.values())
    total_flops = stats.flops * n_devices
    useful = mf / total_flops if total_flops else 0.0
    mfu = mf / (n_devices * peak * achievable) if achievable > 0 else 0.0
    return Roofline(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, n_devices=n_devices,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        hlo_flops_per_dev=stats.flops, hlo_bytes_per_dev=stats.bytes_accessed,
        coll_bytes_per_dev=stats.collective_bytes,
        model_flops_total=mf, useful_ratio=useful, bottleneck=bottleneck,
        achievable_step_s=achievable, mfu_bound=mfu, detail=stats.as_dict())
