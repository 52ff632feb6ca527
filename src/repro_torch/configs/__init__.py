"""LM architecture registry: ``get_config("<arch-id>")`` → LMConfig.

Arch ids use the reference's dashes; module files use underscores. The
port serves the ``dense`` and ``ssm`` families so far; the other
architectures of the reference's registry raise ``NotImplementedError``.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import LMConfig, smoke_variant  # noqa: F401

# the two architectures the port carries, by arch id
ARCHS: dict[str, str] = {
    "internlm2-1.8b": "internlm2_1_8b",
    "mamba2-780m": "mamba2_780m",
}
# the reference's other architectures, each with the ROADMAP item that
# brings its family to the port
LATER: dict[str, str] = {
    "phi4-mini-3.8b": "dense",
    "gemma-7b": "dense",
    "qwen3-32b": "dense",
    "zamba2-7b": "hybrid",
    "granite-moe-1b-a400m": "moe",
    "grok-1-314b": "moe",
    "llama-3.2-vision-90b": "vlm",
    "seamless-m4t-large-v2": "enc-dec",
}


def get_config(arch: str) -> LMConfig:
    if arch in LATER:
        raise NotImplementedError(
            f"{arch} (family {LATER[arch]}) is not ported yet: ROADMAP.md, "
            f"queue 1, 'the remaining LM families'")
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: "
                       f"{sorted(ARCHS) + sorted(LATER)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}").CONFIG
