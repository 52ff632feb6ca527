"""internlm2-1.8b — dense GQA [arXiv:2403.17297; hf]."""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="internlm2-1.8b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92544,
    act="silu",
    rope_theta=1000000.0,
)
