from repro_torch.compressors.core import (
    FP_BITS,
    IDX_BITS,
    NATURAL_BITS,
    Compressor,
    get_compressor,
    identity,
    message_bits,
    natural,
    randk,
    randseqk,
    topk,
    toplek,
)

__all__ = [
    "FP_BITS",
    "IDX_BITS",
    "NATURAL_BITS",
    "Compressor",
    "get_compressor",
    "identity",
    "message_bits",
    "natural",
    "randk",
    "randseqk",
    "topk",
    "toplek",
]
