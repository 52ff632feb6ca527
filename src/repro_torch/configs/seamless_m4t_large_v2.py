"""seamless-m4t-large-v2 — encoder-decoder multimodal backbone
[arXiv:2308.11596; hf]. The audio front end is a stub: the encoder
consumes precomputed frame embeddings [B, S_enc, 1024]. 24 encoder + 24
decoder layers; vocab 256206 pads to 258048 for the 16-way model axis.
Served through ``models/encdec.py``.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,            # decoder layers
    encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    act="gelu",
    tie_embeddings=True,
)
