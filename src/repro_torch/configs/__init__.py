"""LM architecture registry: ``get_config("<arch-id>")`` → LMConfig.

Arch ids use the reference's dashes; module files use underscores. The
port serves the ``dense``, ``ssm``, ``moe`` and ``hybrid`` families (and
trains ``dense`` and ``ssm``); the two cross-attention architectures of
the reference's registry raise ``NotImplementedError``.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import LMConfig, smoke_variant  # noqa: F401

# the architectures the port carries, by arch id, in the reference's order
ARCHS: dict[str, str] = {
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "gemma-7b": "gemma_7b",
    "qwen3-32b": "qwen3_32b",
    "internlm2-1.8b": "internlm2_1_8b",
    "mamba2-780m": "mamba2_780m",
    "zamba2-7b": "zamba2_7b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "grok-1-314b": "grok_1_314b",
}
# the reference's other architectures, by family: both need cross-attention
# (``cross_attention``, ``project_q``; enc-dec also ``models/encdec.py``),
# the next slice of ROADMAP.md queue 1, item 3
LATER: dict[str, str] = {
    "llama-3.2-vision-90b": "vlm",
    "seamless-m4t-large-v2": "enc-dec",
}


def get_config(arch: str) -> LMConfig:
    if arch in LATER:
        raise NotImplementedError(
            f"{arch} (family {LATER[arch]}) is not ported yet: its "
            f"cross-attention comes with the next slice of ROADMAP.md, "
            f"queue 1, item 3")
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}").CONFIG


def list_archs() -> list[str]:
    """The reference's ten arch ids, in its order (the last two are not
    ported yet)."""
    return list(ARCHS) + list(LATER)
