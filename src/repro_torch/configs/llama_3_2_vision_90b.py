"""llama-3.2-vision-90b — decoder LM with cross-attention image layers
[hf:meta-llama/Llama-3.2-11B-Vision family].

100 layers = 20 groups of (4 self-attention + 1 cross-attention). The
vision front end is a stub: the model consumes precomputed patch
embeddings [B, 1601, 1280] (ViT-H grid + CLS), which the cross-attention
K/V projections read directly. kv=8 replicates to 16 for the model axis.
Weights 2D-sharded (``weight_sharding="2d"``: 88.8 G parameters are
177.6 GB in bf16); one card serves it at a cut depth.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    act="silu",
    rope_theta=500000.0,
    cross_every=5,
    n_image_tokens=1601,
    vision_dim=1280,
    weight_sharding="2d",
)
