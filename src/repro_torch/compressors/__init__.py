from repro_torch.compressors.core import (
    FP_BITS,
    IDX_BITS,
    Compressor,
    get_compressor,
    identity,
    message_bits,
    randseqk,
    topk,
    toplek,
)

__all__ = [
    "FP_BITS",
    "IDX_BITS",
    "Compressor",
    "get_compressor",
    "identity",
    "message_bits",
    "randseqk",
    "topk",
    "toplek",
]
