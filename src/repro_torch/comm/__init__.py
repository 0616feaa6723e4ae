"""repro_torch.comm — the wire formats and the star transport for FedNL
(port of ``repro.comm``).

    wire.py       the Section-7 byte codecs, exact-bit parity with
                  message_bits; the PP payload bit models
    protocol.py   frame header and uplink payload layouts
    transport.py  loopback and TCP connections; FaultSpec injection
    star.py       the full-participation master and client workers
    star_pp.py    the partial-participation (FedNL-PP) master and clients
    topology.py   trees of stars, bounded-staleness async aggregation,
                  elastic membership
    cost.py       the bandwidth/latency cost model of the star exchange

``star``, ``star_pp``, ``topology`` and ``transport`` are imported as
submodules (``from repro_torch.comm.star import run_loopback``).
"""

from repro_torch.comm.cost import DEFAULT_COST, CommCostModel
from repro_torch.comm.wire import (
    COMPRESSOR_IDS,
    EncodedMessage,
    WireCodec,
    frame_bits,
    make_codec,
    payload_bits,
    pp_frame_bits,
    pp_message_bits,
)

__all__ = [
    "CommCostModel",
    "DEFAULT_COST",
    "COMPRESSOR_IDS",
    "EncodedMessage",
    "WireCodec",
    "frame_bits",
    "make_codec",
    "payload_bits",
    "pp_frame_bits",
    "pp_message_bits",
]
