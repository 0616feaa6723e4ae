"""Uplink bit accounting (port of ``repro.api.accounting``).

  payload  Section-7 Hessian payload bits (``message_bits``); the FedNL-PP
           uplink also carries the (d + 1) FP64 ``dl || dg`` section
           (``pp_message_bits``)
  wire     full framed uplink bits incl. the protocol header (``frame_bits``
           / ``pp_frame_bits``)

Both map per-client ``sent_elems`` to int64 bits, exactly.
:func:`sharded_uplink_bits` models what the sharded backend's collective
moves.
"""

from __future__ import annotations

from typing import Callable

from repro_torch.comm.wire import frame_bits, pp_frame_bits, pp_message_bits
from repro_torch.compressors.core import FP_BITS, IDX_BITS, Compressor, message_bits

ACCOUNTINGS = ("payload", "wire")

SHARDED_AGGREGATES = ("dense_psum", "sparse_allgather")


def sharded_uplink_bits(aggregate: str, t: int, k: int, n_clients: int) -> int:
    """Per-round uplink bits of the sharded round's collective, a closed-form
    model: ``dense_psum`` all-reduces the whole packed upper triangle (T
    FP64 words a client), ``sparse_allgather`` gathers each client's k
    ``(int32 idx, FP64 val)`` pairs.  The round itself reports the
    compressor's payload and wire bits, as the reference's does."""
    if aggregate == "dense_psum":
        per_client = t * FP_BITS
    elif aggregate == "sparse_allgather":
        per_client = k * (FP_BITS + IDX_BITS)
    else:
        raise ValueError(
            f"unknown aggregate {aggregate!r}; use {' | '.join(SHARDED_AGGREGATES)}"
        )
    return per_client * n_clients


def payload_bits_fn(comp: Compressor, d: int, pp: bool = False) -> Callable:
    """Section-7 payload bits per uplink message (PP adds the dl/dg section)."""
    if pp:
        return lambda s_e: pp_message_bits(comp, s_e, d)
    return lambda s_e: message_bits(comp, s_e)


def wire_bits_fn(comp: Compressor, d: int, pp: bool = False) -> Callable:
    """Full framed uplink bits per message (protocol header + padding)."""
    if pp:
        return lambda s_e: pp_frame_bits(comp, s_e, d)
    return lambda s_e: frame_bits(comp, s_e, d)


def make_bits_fn(comp: Compressor, d: int, accounting: str, pp: bool = False) -> Callable:
    """The per-message bit model ``accounting`` ("payload" | "wire") selects."""
    if accounting == "payload":
        return payload_bits_fn(comp, d, pp)
    if accounting == "wire":
        return wire_bits_fn(comp, d, pp)
    raise ValueError(f"unknown accounting {accounting!r}; use {' | '.join(ACCOUNTINGS)}")
