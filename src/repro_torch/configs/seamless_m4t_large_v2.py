"""seamless-m4t-large-v2 [audio enc-dec, arXiv:2308.11596].

24L d_model=1024 16H (GQA kv=16 == MHA) d_ff=8192 vocab=256206.
Transformer backbone only: the speech frontend (mel + conv) is the stubbed
modality frontend — input_specs supplies frame embeddings (B, S_src, 1024).
24 encoder + 24 decoder layers; head_dim = 1024/16 = 64.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,
    encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv=16,
    d_ff=8192,
    vocab=256206,
    head_dim=64,
    activation="gelu",
    frontend="audio",
    source="arXiv:2308.11596",
    accum_steps=4,
    q_chunk=512,
)
