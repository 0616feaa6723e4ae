"""mamba2-2.7b [ssm, arXiv:2405.21060].

64L d_model=2560 attention-free (SSD), vocab=50280, ssm_state=128.
d_inner = 2*2560 = 5120, head_dim 64 -> 80 SSD heads.  Sub-quadratic:
long_500k decode runs (O(1) recurrent state).
"""

from repro_torch.configs.base import ArchConfig, SSMCfg

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv=0,
    d_ff=0,
    vocab=50280,
    ssm=SSMCfg(d_state=128, head_dim=64, expand=2, chunk=128),
    source="arXiv:2405.21060",
    accum_steps=8,
)
