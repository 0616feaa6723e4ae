"""recurrentgemma-2b [hybrid, arXiv:2402.19427].

26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000.
RG-LRU + local attention in the Griffin 1:2 pattern
(rglru, rglru, attn repeating); local window 2048; head_dim 256.
Sub-quadratic -> long_500k decode runs (LRU state + ring window cache).
"""

from repro_torch.configs.base import ArchConfig, HybridCfg

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv=1,
    d_ff=7680,
    vocab=256000,
    head_dim=256,
    activation="gelu",
    hybrid=HybridCfg(pattern=("rglru", "rglru", "attn"), local_window=2048),
    source="arXiv:2402.19427",
    accum_steps=4,
)
