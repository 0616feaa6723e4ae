"""mixtral-8x22b [moe, arXiv:2401.04088].

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, 8 experts top-2,
sliding-window attention (4096).  SWA -> long_500k decode runs with a ring
KV cache.  head_dim = 128.
"""

from repro_torch.configs.base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv=8,
    d_ff=16384,
    vocab=32768,
    head_dim=128,
    window=4096,
    moe=MoECfg(n_experts=8, top_k=2),
    tie_embeddings=False,
    source="arXiv:2401.04088",
    accum_steps=16,
    q_chunk=512,
)
