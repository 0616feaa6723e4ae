"""FedNL matrix compressors on packed upper-triangle vectors, batched over clients.

Port of ``repro.compressors.core`` for the compressors that draw no random
numbers: TopK (keep the k largest-magnitude entries; contractive with
delta = k/T) and Identity.  RandK, RandSeqK, TopLEK and Natural need the
PRNG question settled first (ROADMAP) and raise ``NotImplementedError``.

``Compressor.compress(u)`` takes u (n_clients, T) and returns
``(u_hat, sent_elems)``: the dense decompressed result and, per client, the
number of scalar payload entries a real transfer would carry.
:func:`message_bits` prices those in the paper's Section-7 encodings.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

FP_BITS = 64  # the paper runs FP64 end to end
IDX_BITS = 32  # fixed-width 32-bit indices

_NOT_PORTED = {
    "randk": "ROADMAP A6 (after the PRNG decision, A4)",
    "randseqk": "ROADMAP B3 (next slice, with the PRNG decision)",
    "toplek": "ROADMAP B4 (next slice, with the PRNG decision)",
    "natural": "ROADMAP A6 (after the PRNG decision, A4)",
}


def topk(u: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Deterministic TopK by magnitude, through the selection kernel."""
    from repro_torch.kernels import ops as kops  # kernels import compressors.select

    return kops.select_topk(u, k)


def identity(u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    sent = torch.full(u.shape[:-1], u.shape[-1], dtype=torch.int32, device=u.device)
    return u, sent


@dataclasses.dataclass(frozen=True)
class Compressor:
    """A configured compressor: ``compress(u) -> (u_hat, sent_elems)``."""

    name: str
    compress: Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]]
    alpha: float  # recommended Hessian learning rate for FedNL
    delta: float  # contraction parameter
    bits_per_elem: int  # payload bits per sent element
    header_bits: int  # per-message constant
    k: int = 0


def get_compressor(name: str, t: int, k: int = 0) -> Compressor:
    """Build a compressor for packed-triu length ``t`` with sparsity budget ``k``."""
    if name == "topk":
        if not 0 < k <= t:
            raise ValueError(f"topk needs 0 < k <= T, got k={k}, T={t}")
        return Compressor("topk", lambda u: topk(u, k), alpha=1.0, delta=k / t,
                          bits_per_elem=FP_BITS + IDX_BITS, header_bits=0, k=k)
    if name == "identity":
        return Compressor("identity", identity, alpha=1.0, delta=1.0,
                          bits_per_elem=FP_BITS, header_bits=0)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"compressor {name!r} is not ported yet: {_NOT_PORTED[name]}"
        )
    raise KeyError(f"unknown compressor {name!r}; have ['identity', 'topk']")


def message_bits(c: Compressor, sent_elems: torch.Tensor) -> torch.Tensor:
    """Wire bits of one compressed Hessian message (Section 7), int64, exact."""
    return sent_elems.to(torch.int64) * c.bits_per_elem + c.header_bits
