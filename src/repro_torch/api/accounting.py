"""Uplink bit accounting (port of ``repro.api.accounting``).

  payload  Section-7 Hessian payload bits (``message_bits``); the FedNL-PP
           uplink also carries the (d + 1) FP64 ``dl || dg`` section
           (``pp_message_bits``)
  wire     full framed uplink bits incl. the protocol header (``frame_bits``
           / ``pp_frame_bits``)

Both map per-client ``sent_elems`` to int64 bits, exactly.
"""

from __future__ import annotations

from typing import Callable

from repro_torch.comm.wire import frame_bits, pp_frame_bits, pp_message_bits
from repro_torch.compressors.core import Compressor, message_bits

ACCOUNTINGS = ("payload", "wire")


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
