"""Closed-form size of one client uplink frame (port of ``repro.comm.wire.frame_bits``).

The rest of the wire stack (codecs, protocol, transports) is not ported yet
(ROADMAP A11); the bit model is, because the round's ``accounting="wire"``
reports it.
"""

from __future__ import annotations

import torch

from repro_torch.compressors.core import Compressor

# struct.calcsize of the protocol header (repro/comm/protocol.py: HEADER_FMT)
HEADER_SIZE = 32


def frame_bits(comp: Compressor, sent_elems: torch.Tensor, d: int) -> torch.Tensor:
    """Wire bits of one full client uplink frame, int64, exact: protocol
    header + grad (d FP64) + l + f (FP64 each) + the byte-padded Hessian
    payload."""
    pb = sent_elems.to(torch.int64) * int(comp.bits_per_elem) + int(comp.header_bits)
    payload_bytes = (pb + 7) // 8
    return 8 * (payload_bytes + HEADER_SIZE + (d + 2) * 8)
