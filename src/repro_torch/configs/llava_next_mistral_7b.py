"""llava-next-mistral-7b [vlm, hf:llava-hf/llava-v1.6-mistral-7b-hf].

Mistral-7B language backbone: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, sliding window 4096; head_dim 128.  The vision encoder +
projector is the stubbed modality frontend: input_specs supplies anyres patch
embeddings (B, n_img=576, d_model-compatible) that the learned img_proj maps
into the token stream.  SWA -> long_500k decode runs.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_ff=14336,
    vocab=32000,
    head_dim=128,
    window=4096,
    activation="silu_glu",
    frontend="vision",
    n_frontend_tokens=576,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    accum_steps=8,
    q_chunk=512,
)
