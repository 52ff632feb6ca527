"""Serving numerics (the port's part of ``repro.serve.steps``). The
reference's ``build_serve_step`` / ``build_prefill_step`` are mesh and
sharding builders; the port serves on one card and has no counterpart
yet."""
from __future__ import annotations

from dataclasses import replace

from repro_torch.configs.base import LMConfig


def serve_config(cfg: LMConfig) -> LMConfig:
    """Serving numerics: bf16 params, no remat. The reference also makes
    MoE dropless; the port has no MoE yet, and its config carries no
    capacity factor."""
    return replace(cfg, param_dtype="bfloat16", remat="none")
