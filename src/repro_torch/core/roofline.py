"""Model FLOPs of a (config, shape) cell: MODEL_FLOPS = 6*N*D for a train
step (6*N_active*D for MoE), 2*N*D for a prefill, 2*N_active a new token
in decode.

Only ``model_flops`` is ported here. The reference module's three-term
roofline (``Roofline``, ``build``) reads compiled XLA HLO of a dry run over
a device mesh; its twin, a FLOP and byte count of a torch step with an
H100 roofline, is the XLA readers' slice (ROADMAP Queue A13b).
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, ShapeConfig


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
