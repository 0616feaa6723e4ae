"""chatglm3-6b [dense, arXiv:2406.12793].

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024, 2d RoPE (rotary on
half the head dims -> rope_fraction = 0.5).  head_dim = 128.
Full attention -> long_500k skipped.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv=2,
    d_ff=13696,
    vocab=65024,
    head_dim=128,
    rope_fraction=0.5,
    activation="silu_glu",
    source="arXiv:2406.12793",
    accum_steps=8,
)
