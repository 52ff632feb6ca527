"""grok-1-314b — 8 experts top-2 MoE [hf:xai-org/grok-1].

The reference shards it 2D (``weight_sharding="2d"``: 314B parameters do
not fit one device); the port has no sharding knob yet and serves it on
one card at a cut depth.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    n_experts=8,
    top_k=2,
    capacity_factor=1.25,
)
