"""zamba2-7b — hybrid: Mamba-2 stack + ONE shared attention block applied
periodically [arXiv:2411.15242].

81 Mamba-2 blocks grouped 9×9; after each group of 9 the single shared
attention+MLP block runs (Zamba2 shares transformer-block weights across
invocations; the per-invocation LoRA deltas are omitted, as in the
reference).
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    attn_every=9,
)
