"""LM architecture registry: ``get_config("<arch-id>")`` → LMConfig.

Arch ids use the reference's dashes; module files use underscores. The
port serves every family of the reference's registry: ``dense``, ``ssm``,
``moe``, ``hybrid`` and ``vlm`` through ``models/lm.py``, the enc-dec
``audio`` family through ``models/encdec.py``, and trains them all.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import LMConfig, smoke_variant  # noqa: F401

# the reference's architectures, by arch id, in its order
ARCHS: dict[str, str] = {
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "gemma-7b": "gemma_7b",
    "qwen3-32b": "qwen3_32b",
    "internlm2-1.8b": "internlm2_1_8b",
    "mamba2-780m": "mamba2_780m",
    "zamba2-7b": "zamba2_7b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "grok-1-314b": "grok_1_314b",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
}


def get_config(arch: str) -> LMConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}").CONFIG


def list_archs() -> list[str]:
    """The reference's ten arch ids, in its order."""
    return list(ARCHS)
