"""Architecture config registry: ``get_config("<arch-id>")`` / ``--arch``."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig, ShapeConfig, SHAPES, reduced  # noqa: F401

_MODULES = {
    "starcoder2-3b": "starcoder2_3b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "llama3-8b": "llama3_8b",
    "stablelm-1.6b": "stablelm_1_6b",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "xlstm-1.3b": "xlstm_1_3b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "zamba2-7b": "zamba2_7b",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def all_configs() -> dict[str, ArchConfig]:
    return {name: get_config(name) for name in ARCH_NAMES}


def cells() -> list[tuple[str, str]]:
    """All runnable (arch, shape) dry-run cells (40 total; long_500k only
    for sub-quadratic archs per the assignment rule)."""
    out = []
    for name in ARCH_NAMES:
        cfg = get_config(name)
        for sname, shape in SHAPES.items():
            if cfg.supports_shape(shape):
                out.append((name, sname))
    return out
