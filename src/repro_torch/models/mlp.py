"""Dense FFN blocks (gated-SiLU / GELU)."""
from __future__ import annotations

from repro_torch.models.layers import P, activation_fn


def mlp_template(d_model: int, d_ff: int, activation: str) -> dict:
    t = {
        "w_up": P((d_model, d_ff), ("embed", "ffn"), "fan_in"),
        "w_down": P((d_ff, d_model), ("ffn", "embed2"), "fan_in"),
    }
    if activation == "silu":
        t["w_gate"] = P((d_model, d_ff), ("embed", "ffn"), "fan_in")
    return t


def mlp(p: dict, x, activation: str, tp=None):
    """x (B,S,d). Weights are cast to x's dtype at use (no copy when they
    already have it). ``tp`` (``models.sharding.TensorParallel``): ``p``
    holds the rank's ffn columns of ``w_up``/``w_gate`` and rows of
    ``w_down``; Megatron's ``copy_to`` at each column-split product's
    input, ``reduce_from`` after ``w_down``."""
    act = activation_fn(activation)
    into = (lambda t: t) if tp is None else tp.copy
    up = into(x) @ p["w_up"].to(x.dtype)
    if "w_gate" in p:
        h = act(into(x) @ p["w_gate"].to(x.dtype)) * up
    else:
        h = act(up)
    out = h @ p["w_down"].to(x.dtype)
    return out if tp is None else tp.reduce(out)
