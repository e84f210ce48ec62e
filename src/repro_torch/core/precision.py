"""Multi-precision policy (paper §III-E4 -> Hopper).

Ara subdivides its 64-bit lane datapath: 1x64 / 2x32 / 4x16 / 8x8 per cycle
— throughput doubles per precision halving. The H100 analogue: the tensor
cores run bf16/fp16 at twice the TF32 rate and int8 at twice the bf16 rate.
This module is the single source for per-precision peaks (roofline
denominators) and the cast policy used by models (params fp32 master,
compute dtype configurable, fp32 accumulation — matching the kernels).
The Ara side reads ``ARA_FLOP_PER_CYCLE_PER_LANE``: the analytical model
(``core/perfmodel.py``) and ``configs/ara.py`` take their per-precision
peaks from it.
"""
from __future__ import annotations

import dataclasses

import torch

# NVIDIA H100 SXM per-card peaks, dense (no sparsity), at the full 700 W
# power limit — NVIDIA's H100 data sheet. "float32" is the CUDA-core FMA
# rate (no tensor cores): true fp32 products, which is what the port's
# fp32 paths compute. "tf32" is listed for completeness; the port never
# enables it.
PEAKS_FLOPS = {
    "float32": 67e12,
    "tf32": 495e12,
    "bfloat16": 989e12,
    "float16": 989e12,
    "int8": 1979e12,
}
# Device memory rate of the same part (80 GB HBM3), bytes/s.
PEAK_BYTES_PER_S = 3.35e12

# Ara's per-precision peak (FLOP/cycle/lane), the paper's datapath split.
# SINGLE SOURCE for the multi-precision speedup claim: AraConfig
# .peak_flop_per_cycle, perfmodel's per-ew utilization, and the kernel
# benchmarks' predicted speedups all consult this table.
ARA_FLOP_PER_CYCLE_PER_LANE = {64: 2, 32: 4, 16: 8, 8: 16}

# SEW (bits) <-> dtype name used by the vector engines. SEW=8 is the
# integer lane (no FP8 format): int8 two's complement.
SEW_TO_DTYPE = {64: "float64", 32: "float32", 16: "float16", 8: "int8"}
DTYPE_TO_SEW = {"float64": 64, "float32": 32, "float16": 16,
                "bfloat16": 16, "int8": 8}

_TORCH_DTYPES = {
    "float64": torch.float64, "float32": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "int32": torch.int32, "int64": torch.int64,
}


def torch_dtype(dtype) -> torch.dtype:
    """A ``torch.dtype`` from a dtype or its name ("bfloat16", ...)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _TORCH_DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"unknown dtype {dtype!r}; known: "
                         f"{sorted(_TORCH_DTYPES)}") from None


def dtype_name(dtype) -> str:
    """The name ("bfloat16", ...) of a dtype or dtype name."""
    return str(torch_dtype(dtype)).replace("torch.", "")


def dtype_for_sew(sew: int) -> torch.dtype:
    """Element dtype the engines execute at for a given SEW."""
    return torch_dtype(SEW_TO_DTYPE[sew])


def sew_for_dtype(dtype) -> int:
    """Datapath element width (bits) a dtype occupies on Ara's lanes."""
    return DTYPE_TO_SEW[dtype_name(dtype)]


def ara_speedup_vs_dp(sew: int) -> float:
    """Paper §III-E4 prediction: throughput gain vs the 64-bit datapath."""
    return (ARA_FLOP_PER_CYCLE_PER_LANE[sew]
            / ARA_FLOP_PER_CYCLE_PER_LANE[64])


def issue_amortization(vl: int, lanes: int, sew: int = 64, lmul: int = 1,
                       issue_interval: float = 5.0) -> float:
    """§IV in closed form: FPU-busy cycles of one grouped vector FMA per
    issue slot it consumes. >= 1 means the 5-cycle issue interval is fully
    hidden; register grouping multiplies the numerator by LMUL, which is
    why Ara2 adds it for short-vector workloads."""
    chain = (lmul * vl / lanes) / (64 // sew)   # busy cycles per insn
    return chain / issue_interval


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    accum_dtype: str = "float32"
    cache_dtype: str = "bfloat16"
    lmul: int = 1                # register grouping the Ara analogue uses;
                                 # kernels validate block shapes with it
    attn_bq: int = 128           # blockwise-attention q/kv block shapes
    attn_bk: int = 128

    def peak_flops(self) -> float:
        return PEAKS_FLOPS[self.compute_dtype]

    @property
    def sew(self) -> int:
        """Ara element width equivalent of the compute dtype."""
        return sew_for_dtype(self.compute_dtype)

    def ara_peak_flop_per_cycle(self, lanes: int) -> int:
        """Ara-side peak at this policy's compute width."""
        return lanes * ARA_FLOP_PER_CYCLE_PER_LANE[self.sew]

    def ara_speedup(self) -> float:
        return ara_speedup_vs_dp(self.sew)

    def issue_amortization(self, vl: int, lanes: int,
                           issue_interval: float = 5.0) -> float:
        """Chain length per issue slot at this policy's SEW and LMUL."""
        return issue_amortization(vl, lanes, self.sew, self.lmul,
                                  issue_interval)

    def cast_params(self, tree):
        """Floating leaves of a dict-of-tensors tree at the compute dtype."""
        return cast_tree(tree, self.compute_dtype)


def cast_tree(tree, dtype):
    """Cast every floating leaf of a nested dict of tensors to ``dtype``
    (leaves already there are returned as they are, not copied)."""
    dt = torch_dtype(dtype)
    if isinstance(tree, dict):
        return {k: cast_tree(v, dt) for k, v in tree.items()}
    return tree.to(dt) if tree.is_floating_point() else tree


def bytes_per_element(dtype) -> int:
    return torch_dtype(dtype).itemsize


def speedup_vs_fp32(dtype: str) -> float:
    """Peak rate of ``dtype`` over float32's, from this module's H100
    table: bf16 reads 989/67 (the tensor cores against the CUDA cores'
    true fp32), where the reference's TPU table gives 2.0."""
    return PEAKS_FLOPS[dtype] / PEAKS_FLOPS["float32"]
