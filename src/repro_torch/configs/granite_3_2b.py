"""granite-3-2b [dense, hf:ibm-granite/granite-3.0-2b-base].

40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155.
head_dim = 2048/32 = 64.  Full attention -> long_500k skipped.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv=8,
    d_ff=8192,
    vocab=49155,
    head_dim=64,
    activation="silu_glu",
    source="hf:ibm-granite/granite-3.0-2b-base",
    accum_steps=4,
)
