"""Uplink bit accounting (port of ``repro.api.accounting``, non-PP part).

  payload  Section-7 Hessian payload bits (``message_bits``)
  wire     full framed uplink bits incl. the protocol header (``frame_bits``)

Both map per-client ``sent_elems`` to int64 bits, exactly.
"""

from __future__ import annotations

from typing import Callable

from repro_torch.comm.wire import frame_bits
from repro_torch.compressors.core import Compressor, message_bits

ACCOUNTINGS = ("payload", "wire")


def payload_bits_fn(comp: Compressor, d: int) -> Callable:
    """Section-7 payload bits per uplink message."""
    return lambda s_e: message_bits(comp, s_e)


def wire_bits_fn(comp: Compressor, d: int) -> Callable:
    """Full framed uplink bits per message (protocol header + padding)."""
    return lambda s_e: frame_bits(comp, s_e, d)
