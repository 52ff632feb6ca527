"""gemma-7b — dense, GeGLU, head_dim=256 [arXiv:2403.08295; hf]."""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    act="gelu",
    rope_theta=10000.0,
    tie_embeddings=True,
)
