"""granite-moe-1b-a400m [moe, hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8) d_ff=512 vocab=49155, MoE 32 experts top-8.
head_dim = 64.  Full attention -> long_500k skipped.
"""

from repro_torch.configs.base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv=8,
    d_ff=512,
    vocab=49155,
    head_dim=64,
    moe=MoECfg(n_experts=32, top_k=8),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    accum_steps=2,
)
