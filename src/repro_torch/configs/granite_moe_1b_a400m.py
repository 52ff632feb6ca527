"""granite-moe-1b-a400m — 32 experts top-8, d_ff=512 per expert
[hf:ibm-granite/granite-3.0-1b-a400m-base]. Vocab 49155 pads to 51200.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    n_experts=32,
    top_k=8,
    capacity_factor=1.25,
    tie_embeddings=True,
)
