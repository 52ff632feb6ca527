"""PyTorch/CUDA port of the P²M reproduction (the JAX package ``repro``
stays the reference). Same module layout as ``repro``; the Pallas TPU
kernels become hand-written CUDA kernels for Hopper under ``csrc/``.

Every entry point that takes ``device`` runs on ``cuda`` unless the caller
passes ``device="cpu"``; without a GPU it raises instead of falling back.
"""
