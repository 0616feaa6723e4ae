from repro_torch.compressors.core import (
    FP_BITS,
    IDX_BITS,
    Compressor,
    get_compressor,
    identity,
    message_bits,
    topk,
)

__all__ = [
    "FP_BITS",
    "IDX_BITS",
    "Compressor",
    "get_compressor",
    "identity",
    "message_bits",
    "topk",
]
