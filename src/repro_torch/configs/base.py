"""Unified architecture config for the model zoo (a copy of
``repro.configs.base``, field for field, so the two packages' configs compare
equal).

Every architecture gets one `src/repro_torch/configs/<id>.py` exporting
`CONFIG` (the exact published configuration, source cited) built on this
dataclass.  `reduced()` produces the CPU-smoke-test variant (2 layers,
d_model <= 512, <= 4 experts) of the same family.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    """Mamba2 / SSD block dimensions."""

    d_state: int = 128
    head_dim: int = 64
    expand: int = 2  # d_inner = expand * d_model
    chunk: int = 128  # SSD chunk length
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class HybridCfg:
    """RecurrentGemma-style pattern: `pattern[i % len(pattern)]` per layer."""

    pattern: Sequence[str] = ("rglru", "rglru", "attn")  # 1:2 attn:recurrent
    lru_width: int | None = None  # default d_model
    local_window: int = 2048


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    activation: str = "silu_glu"  # silu_glu | sq_relu | gelu
    rope_fraction: float = 1.0  # chatglm "2d rope": rotary on half the dims
    window: int | None = None  # sliding-window attention (mixtral/mistral)
    moe: MoECfg | None = None
    ssm: SSMCfg | None = None
    hybrid: HybridCfg | None = None
    encoder_layers: int = 0  # > 0 => encoder-decoder
    frontend: str | None = None  # "audio" | "vision" (stubbed per carve-out)
    n_frontend_tokens: int = 576  # VLM: image patch tokens prepended
    tie_embeddings: bool = True
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    source: str = ""  # citation
    # runtime knobs (per-arch dry-run tuning, not architecture)
    accum_steps: int = 1  # gradient-accumulation microbatches in train_step
    q_chunk: int = 512  # attention query-chunk size (online softmax)
    unroll_layers: bool = False  # unroll the layer scan (dry-run cost accuracy:
    # XLA cost_analysis does not multiply FLOPs/collectives by while-loop trip
    # counts, so the roofline pass compiles with unrolled layers)
    remat_policy: str = "full"  # full | dots | none — per-layer checkpoint
    # policy ("dots" saves matmul outputs: less recompute, more memory)
    moe_dense_decode: bool = False  # decode-time MoE: compute all experts
    # densely and mask (no dispatch scatter/all-to-all); E/top_k x more FLOPs
    # on a tiny token count in exchange for removing the dispatch collectives
    serve_params_dtype: str = "float32"  # decode-time param storage; bfloat16
    # halves the per-layer FSDP weight all-gather bytes (compute is bf16 anyway)
    serve_sharding: str = "fsdp"  # fsdp | tp2d — decode-time param sharding.
    # fsdp reuses the training layout (weights sharded over data+model ->
    # per-layer weight all-gathers at decode); tp2d shards feature dims over
    # BOTH axes so decode psums small activations instead (EXPERIMENTS §Perf)

    @property
    def attn_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv * self.head_dim

    @property
    def d_inner(self) -> int:
        return (self.ssm.expand * self.d_model) if self.ssm else 0

    @property
    def sublquadratic(self) -> bool:
        """True if long_500k decode is supported (SSM/hybrid/SWA)."""
        return self.family in ("ssm", "hybrid") or self.window is not None

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family/topology, tiny dims."""
        changes: dict = dict(
            n_layers=2,
            d_model=min(self.d_model, 128),
            n_heads=min(self.n_heads, 4),
            n_kv=min(self.n_kv, 2),
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            head_dim=32,
            window=min(self.window, 64) if self.window else None,
            encoder_layers=2 if self.encoder_layers else 0,
            n_frontend_tokens=16 if self.frontend else 0,
            accum_steps=1,
            q_chunk=32,
        )
        if self.moe:
            changes["moe"] = MoECfg(
                n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2),
                capacity_factor=self.moe.capacity_factor,
            )
        if self.ssm:
            changes["ssm"] = SSMCfg(d_state=16, head_dim=16, expand=2, chunk=16)
        if self.hybrid:
            changes["hybrid"] = HybridCfg(
                pattern=self.hybrid.pattern, lru_width=None, local_window=32
            )
        return dataclasses.replace(self, **changes)
