"""phi4-mini-3.8b — dense, RoPE SwiGLU GQA [arXiv:2412.08905; hf].

NOTE (TP padding): 24 q-heads and 8 kv-heads are not divisible by the 16-way
model axis; physical layout pads q→32 heads (the 8 padded heads drawn
like the others, as the reference's init draws them) and replicates kv→16
(vLLM/Megatron practice). Logical numbers below are the published ones.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    act="silu",
    rope_theta=10000.0,
    tie_embeddings=True,
)
