"""mamba2-780m — attention-free SSM, SSD algorithm [arXiv:2405.21060].

d_inner = 2*1536 = 3072, ssm_head_dim 64 → 48 SSD heads, state N=128.
attention fields are placeholders (family="ssm" never builds attention).
Vocab 50280 pads to 51200 for the 16-way model axis (Megatron practice).
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=1, n_kv_heads=1, head_dim=64,   # unused (attention-free)
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    tie_embeddings=True,
)
