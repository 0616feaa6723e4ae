"""yi-34b [dense llama-arch, arXiv:2403.04652].

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
head_dim = 7168/56 = 128.  Full attention -> long_500k skipped.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv=8,
    d_ff=20480,
    vocab=64000,
    head_dim=128,
    activation="silu_glu",
    tie_embeddings=False,
    source="arXiv:2403.04652",
    accum_steps=16,
    q_chunk=512,
)
