"""LM architecture and shape configuration (the port's copy of
``repro.configs.base``).

Logical fields carry the published numbers; the ``phys_*`` properties are
the TP-padded shapes actually allocated (heads and vocab padded to a
multiple of the model-axis size, Megatron/vLLM practice). The padding is
kept exactly as in the reference: the parameter shapes, and so the weights
carried across from it, depend on it. ``tp_multiple=1`` (smoke configs)
keeps physical == logical. ``remat`` is read by the training path
(``models/lm._maybe_remat``).

The reference's sharding knobs (``weight_sharding``, ``zero1``) and
``moe_impl`` are left out: nothing the port runs reads them (the
reference's own ``moe_apply`` never reads ``moe_impl``). They come back
with the slices that do. ``capacity_factor`` is read by ``nn/moe.capacity``
and ``serve/steps.serve_config``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class LMConfig:
    name: str
    family: str                    # dense | ssm | hybrid | moe | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    act: str = "silu"              # silu → SwiGLU, gelu → GeGLU
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- SSM (mamba2 / zamba2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    # --- hybrid (zamba2): one shared attention block every k SSM blocks ---
    attn_every: int = 0
    # --- VLM: cross-attention to image tokens every k layers ---
    cross_every: int = 0
    n_image_tokens: int = 0
    vision_dim: int = 0
    # --- audio/enc-dec ---
    encoder_layers: int = 0        # >0 → encoder-decoder (n_layers = decoder)
    # --- physical/TP ---
    tp_multiple: int = 16          # pad heads/vocab for this model-axis size
    vocab_pad_multiple: int = 2048
    # --- numerics ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "full"            # full | dots | none
    attn_chunk: int = 1024         # online-softmax KV chunk

    # ---------------- derived physical shapes ----------------
    @property
    def phys_vocab(self) -> int:
        m = max(self.vocab_pad_multiple, self.tp_multiple)
        return round_up(self.vocab_size, m)

    @property
    def phys_heads(self) -> int:
        return round_up(self.n_heads, self.tp_multiple)

    @property
    def phys_kv_heads(self) -> int:
        if self.n_kv_heads >= self.tp_multiple:
            assert self.n_kv_heads % self.tp_multiple == 0, self.name
            return self.n_kv_heads
        # replicate kv heads up to the TP degree (vLLM/Megatron practice)
        return round_up(self.tp_multiple, self.n_kv_heads)

    @property
    def q_per_kv(self) -> int:
        assert self.phys_heads % self.phys_kv_heads == 0, self.name
        return self.phys_heads // self.phys_kv_heads

    # ---------------- SSM derived ----------------
    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim

    # ---------------- structure ----------------
    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}

# Families with sub-quadratic context handling run long_500k; pure
# full-attention archs skip it.
_SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def shape_applicable(cfg: LMConfig, shape: str) -> tuple[bool, str]:
    if shape == "long_500k" and cfg.family not in _SUBQUADRATIC_FAMILIES:
        return False, "pure full-attention arch — long_500k skipped per spec"
    return True, ""


def smoke_variant(cfg: LMConfig) -> LMConfig:
    """Tiny same-family config for CPU smoke tests (no TP padding)."""
    kw = dict(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, tp_multiple=1, vocab_pad_multiple=8,
        n_image_tokens=8 if cfg.cross_every else 0,
        vision_dim=32 if cfg.cross_every else 0,
        cross_every=2 if cfg.cross_every else 0,
        encoder_layers=2 if cfg.encoder_layers else 0,
        attn_every=2 if cfg.attn_every else 0,
        n_experts=4 if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.n_experts else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        remat="none", attn_chunk=64,
    )
    return replace(cfg, **kw)
