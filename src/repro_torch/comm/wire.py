"""Closed-form sizes of the client uplink messages (port of the bit models
of ``repro.comm.wire``: ``frame_bits``, ``pp_message_bits``, ``pp_frame_bits``).

The rest of the wire stack (codecs, protocol, transports) is not ported yet
(ROADMAP A11); the bit models are, because the rounds' ``sent_bits`` report
them.
"""

from __future__ import annotations

import torch

from repro_torch.compressors.core import FP_BITS, Compressor, message_bits

# struct.calcsize of the protocol header (repro/comm/protocol.py: HEADER_FMT)
HEADER_SIZE = 32


def _payload_bytes(comp: Compressor, sent_elems: torch.Tensor) -> torch.Tensor:
    pb = sent_elems.to(torch.int64) * int(comp.bits_per_elem) + int(comp.header_bits)
    return (pb + 7) // 8


def frame_bits(comp: Compressor, sent_elems: torch.Tensor, d: int) -> torch.Tensor:
    """Wire bits of one full client uplink frame, int64, exact: protocol
    header + grad (d FP64) + l + f (FP64 each) + the byte-padded Hessian
    payload."""
    return 8 * (_payload_bytes(comp, sent_elems) + HEADER_SIZE + (d + 2) * 8)


def pp_message_bits(comp: Compressor, sent_elems: torch.Tensor, d: int) -> torch.Tensor:
    """Payload bits of one FedNL-PP uplink triple ``encode(S_i) || dl_i ||
    dg_i``, int64, exact: the Section-7 Hessian bits plus the (d + 1) FP64
    delta section."""
    return message_bits(comp, sent_elems) + (d + 1) * FP_BITS


def pp_frame_bits(comp: Compressor, sent_elems: torch.Tensor, d: int) -> torch.Tensor:
    """Wire bits of one full framed PP_UPDATE, int64, exact: protocol header
    + byte-padded Hessian payload + the dl/dg section."""
    return 8 * (_payload_bytes(comp, sent_elems) + HEADER_SIZE + (d + 1) * 8)
