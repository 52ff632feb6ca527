"""Serving numerics (the port's part of ``repro.serve.steps``). The
reference's ``build_serve_step`` / ``build_prefill_step`` are mesh and
sharding builders; the port serves on one card and has no counterpart
yet."""
from __future__ import annotations

from dataclasses import replace

from repro_torch.configs.base import LMConfig


def serve_config(cfg: LMConfig) -> LMConfig:
    """Serving numerics: bf16 params, no remat, dropless MoE.

    ``capacity_factor = E / K`` makes an expert's capacity cover the worst
    routing (every token to one expert), so serving never drops a token and
    a request's output does not depend on what shares its batch."""
    kw = dict(param_dtype="bfloat16", remat="none")
    if cfg.n_experts:
        kw["capacity_factor"] = cfg.n_experts / max(cfg.top_k, 1)
    return replace(cfg, **kw)
