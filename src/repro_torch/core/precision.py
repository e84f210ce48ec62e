"""Multi-precision policy (paper §III-E4 -> Hopper).

Ara subdivides its 64-bit lane datapath: 1x64 / 2x32 / 4x16 / 8x8 per cycle
— throughput doubles per precision halving. The H100 analogue: the tensor
cores run bf16/fp16 at twice the TF32 rate and int8 at twice the bf16 rate.
This module is the single source for per-precision peaks (roofline
denominators) and the cast policy used by models (params fp32 master,
compute dtype configurable, fp32 accumulation — matching the kernels).
The Ara-side arithmetic of the reference module (FLOP per cycle per lane,
issue amortization) arrives with the vector engines and the performance
model that use it.
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
