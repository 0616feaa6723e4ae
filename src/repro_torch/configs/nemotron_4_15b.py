"""nemotron-4-15b [dense, arXiv:2402.16819].

32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000, squared-ReLU MLP.
head_dim = 6144/48 = 128.  Full attention -> long_500k skipped (DESIGN.md §4).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv=8,
    d_ff=24576,
    vocab=256000,
    head_dim=128,
    activation="sq_relu",
    tie_embeddings=False,
    source="arXiv:2402.16819",
    accum_steps=8,
    q_chunk=512,
)
