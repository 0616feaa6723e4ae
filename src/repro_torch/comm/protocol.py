"""Message framing of the FedNL star protocol (port of ``repro.comm.protocol``).

Every message is one frame: a fixed 32-byte little-endian header followed by
``payload_len`` payload bytes, the reference's byte for byte, so that a
master of either package talks to clients of the other.

    offset  size  field
    0       4     magic  b"FNL1" (protocol version folded into the magic)
    4       1     msg type (MsgType)
    5       1     compressor id (wire.COMPRESSOR_IDS)
    6       1     dtype tag (0 = float64; the only FedNL dtype)
    7       1     flags (reserved, 0)
    8       4     round index
    12      4     client id
    16      4     sent_elems (payload elements of the Hessian section)
    20      8     payload_bits (exact Section-7 bit count of the Hessian section)
    28      4     payload_len (bytes that follow)

Frames of the flat star:

    HELLO     client -> master on connect; identifies ``client id``.  No payload.
    INIT      master -> clients: x0 (d FP64).  Clients reply INIT_ACK.
    INIT_ACK  client -> master: packed initial Hessian H_i^0 (T FP64); FedNL-PP
              H_i^0 || l_i^0 || g_i^0 (:func:`pack_pp_state`).
    ROUND     master -> clients: the iterate x (d FP64).
    UPLINK    client -> master: grad (d FP64) || l || f_i || encoded Hessian.
    STOP      master -> clients: end of run.  No payload.
    SELECT    master -> one sampled client (FedNL-PP): u32 slot || u32 tau || x.
    PP_UPDATE client -> master: encode(S_i) || dl_i || dg_i (d FP64).
    DROP      client -> master: a fault-injected dropout of one SELECT.

Frames of the tree of stars (``repro_torch.comm.topology``):

    AGG       aggregator -> parent: one combined uplink for its subtree
              (:func:`pack_agg_entries` for combine="exact", the leaf
              sections verbatim; :func:`pack_agg_hsum` /
              :func:`pack_agg_roundsum` for combine="sum", dense partial sums).
    SUBTREE   the coverage handshake: the combine mode and the leaf ids a
              subtree is expected to own, and, in the ack, those it owns.

Every ``MsgType`` value of the reference is here, so the ids stay stable;
the gateway's frames (SUBMIT .. GW_ERR) and the METRICS verb carry the
payloads of ``repro_torch.gateway.protocol``.  Payload
vectors are numpy float64 arrays on the host: the frames are the
serialisation boundary.  With a live ``repro_torch.obs`` recorder every frame
sent and received is counted, with its bytes, by frame type.
"""

from __future__ import annotations

import dataclasses
import enum
import struct

import numpy as np

from repro_torch.obs import core as _obs

MAGIC = b"FNL1"
HEADER_FMT = "<4sBBBBIIIQI"
HEADER_SIZE = struct.calcsize(HEADER_FMT)

DTYPE_F64 = 0


class MsgType(enum.IntEnum):
    HELLO = 1
    INIT = 2
    INIT_ACK = 3
    ROUND = 4
    UPLINK = 5
    STOP = 6
    # partial participation (FedNL-PP)
    SELECT = 7
    PP_UPDATE = 8
    DROP = 9
    # hierarchical topology
    AGG = 10
    SUBTREE = 11
    # gateway RPC
    SUBMIT = 12
    STATUS = 13
    STREAM = 14
    EVICT = 15
    CANCEL = 16
    RESULT = 17
    RECORD = 18
    STREAM_END = 19
    GW_OK = 20
    GW_ERR = 21
    # observability
    METRICS = 22


@dataclasses.dataclass(frozen=True)
class Frame:
    type: MsgType
    round: int = 0
    client: int = 0
    comp_id: int = 0
    dtype: int = DTYPE_F64
    sent_elems: int = 0
    payload_bits: int = 0
    payload: bytes = b""

    @property
    def wire_bytes(self) -> int:
        return HEADER_SIZE + len(self.payload)


def pack_frame(frame: Frame) -> bytes:
    header = struct.pack(
        HEADER_FMT, MAGIC, int(frame.type), frame.comp_id, frame.dtype, 0, frame.round,
        frame.client, frame.sent_elems, frame.payload_bits, len(frame.payload),
    )
    return header + frame.payload


def unpack_header(header: bytes) -> tuple[Frame, int]:
    """Parse a header; returns the (payload-less) Frame and the payload length."""
    magic, mtype, comp_id, dtype, _flags, rnd, client, sent, pbits, plen = struct.unpack(
        HEADER_FMT, header
    )
    if magic != MAGIC:
        raise ValueError(f"bad magic {magic!r}; protocol mismatch")
    frame = Frame(
        type=MsgType(mtype), round=rnd, client=client, comp_id=comp_id, dtype=dtype,
        sent_elems=sent, payload_bits=pbits,
    )
    return frame, plen


def send_frame(conn, frame: Frame) -> int:
    """Write one frame to a transport connection; returns bytes sent."""
    data = pack_frame(frame)
    conn.send(data)
    rec = _obs.CURRENT
    if rec.enabled:
        rec.add("comm.frames.sent", type=frame.type.name)
        rec.add("comm.bytes.sent", len(data), type=frame.type.name)
    return len(data)


def recv_frame(conn) -> Frame:
    """Read exactly one frame from a transport connection."""
    frame, plen = unpack_header(conn.recv_exact(HEADER_SIZE))
    payload = conn.recv_exact(plen) if plen else b""
    rec = _obs.CURRENT
    if rec.enabled:
        rec.add("comm.frames.recv", type=frame.type.name)
        rec.add("comm.bytes.recv", HEADER_SIZE + plen, type=frame.type.name)
    return dataclasses.replace(frame, payload=payload)


# ---------------------------------------------------------------------------
# payloads
# ---------------------------------------------------------------------------


def pack_vector(x) -> bytes:
    """A float64 vector (numpy, or a tensor on any device) as raw LE bytes."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype="<f8").tobytes()


def unpack_vector(data: bytes) -> np.ndarray:
    return np.frombuffer(data, dtype="<f8").copy()


def pack_uplink(grad, l, f, enc) -> bytes:
    """grad (d FP64) || l || f_i || encoded Hessian message."""
    return pack_vector(grad) + struct.pack("<dd", float(l), float(f)) + enc.data


def unpack_uplink(payload: bytes, d: int):
    """Inverse of pack_uplink -> (grad, l, f, hessian_payload_bytes)."""
    grad = unpack_vector(payload[: 8 * d])
    l, f = struct.unpack("<dd", payload[8 * d : 8 * d + 16])
    return grad, l, f, payload[8 * d + 16 :]


def pack_select(slot: int, tau: int, x) -> bytes:
    """SELECT: the client's slot in this round's sample, tau, the iterate."""
    return struct.pack("<II", slot, tau) + pack_vector(x)


def unpack_select(payload: bytes) -> tuple[int, int, np.ndarray]:
    slot, tau = struct.unpack("<II", payload[:8])
    return slot, tau, unpack_vector(payload[8:])


def pack_pp_state(h, l, g) -> bytes:
    """PP INIT_ACK: H_i^0 (T FP64) || l_i^0 (FP64) || g_i^0 (d FP64)."""
    return pack_vector(h) + struct.pack("<d", float(l)) + pack_vector(g)


def unpack_pp_state(payload: bytes, d: int):
    """Inverse of pack_pp_state -> (h, l, g)."""
    t_bytes = len(payload) - 8 - 8 * d
    h = unpack_vector(payload[:t_bytes])
    (l,) = struct.unpack("<d", payload[t_bytes : t_bytes + 8])
    return h, l, unpack_vector(payload[t_bytes + 8 :])


def pack_pp_update(enc, dl, dg) -> bytes:
    """Algorithm-3 uplink triple: encode(S_i) || dl_i || dg_i (d FP64)."""
    return enc.data + struct.pack("<d", float(dl)) + pack_vector(dg)


def unpack_pp_update(payload: bytes, d: int):
    """Inverse of pack_pp_update -> (hessian_payload_bytes, dl, dg)."""
    tail = 8 * (d + 1)
    (dl,) = struct.unpack("<d", payload[-tail : -tail + 8])
    dg = unpack_vector(payload[len(payload) - 8 * d :])
    return payload[:-tail], dl, dg


# ---------------------------------------------------------------------------
# tree-of-stars payloads (repro_torch.comm.topology)
# ---------------------------------------------------------------------------

# one leaf's uplink section inside an exact-combine AGG payload:
# (client id, sent_elems, payload_bits, original frame wire bytes, payload)
_AGG_ENTRY_FMT = "<IIQII"
_AGG_ENTRY_SIZE = struct.calcsize(_AGG_ENTRY_FMT)


def pack_agg_entries(entries) -> bytes:
    """combine="exact" AGG payload: the subtree's leaf uplink sections,
    verbatim.  ``entries`` are ``(client, sent_elems, payload_bits,
    frame_bytes, payload)`` tuples; ``frame_bytes`` keeps each leaf frame's
    size, so that the root's measured accounting is the flat star's.  A
    sub-aggregator's entries concatenate in: the payload does not depend on
    the depth."""
    out = [struct.pack("<I", len(entries))]
    for client, sent_elems, payload_bits, frame_bytes, payload in entries:
        out.append(struct.pack(_AGG_ENTRY_FMT, client, sent_elems, payload_bits, frame_bytes,
                               len(payload)))
        out.append(payload)
    return b"".join(out)


def unpack_agg_entries(payload: bytes) -> list[tuple]:
    """Inverse of pack_agg_entries -> list of entry tuples."""
    (n,) = struct.unpack("<I", payload[:4])
    off = 4
    entries = []
    for _ in range(n):
        client, sent, pbits, fbytes, plen = struct.unpack(
            _AGG_ENTRY_FMT, payload[off : off + _AGG_ENTRY_SIZE])
        off += _AGG_ENTRY_SIZE
        entries.append((client, sent, pbits, fbytes, payload[off : off + plen]))
        off += plen
    if off != len(payload):
        raise ValueError(f"AGG payload has {len(payload) - off} trailing bytes after {n} entries")
    return entries


def pack_agg_hsum(count: int, h_sum) -> bytes:
    """combine="sum" INIT AGG payload: the subtree's leaf count and the dense
    sum of its packed initial Hessians (T FP64)."""
    return struct.pack("<I", count) + pack_vector(h_sum)


def unpack_agg_hsum(payload: bytes) -> tuple[int, np.ndarray]:
    (count,) = struct.unpack("<I", payload[:4])
    return count, unpack_vector(payload[4:])


_AGG_SUM_FMT = "<IIQQQdd"
_AGG_SUM_SIZE = struct.calcsize(_AGG_SUM_FMT)


def pack_agg_roundsum(count: int, d: int, abits: int, pbits: int, fbytes: int,
                      l_sum, f_sum, grad_sum, s_sum) -> bytes:
    """combine="sum" round AGG payload: the subtree's leaf count, its summed
    bit counters (analytic, measured payload, frame bytes), the l and f sums,
    the grad sum (d FP64) and the decoded corrections' sum (T FP64)."""
    return (struct.pack(_AGG_SUM_FMT, count, d, abits, pbits, fbytes, float(l_sum), float(f_sum))
            + pack_vector(grad_sum) + pack_vector(s_sum))


def unpack_agg_roundsum(payload: bytes):
    """Inverse of pack_agg_roundsum -> (count, abits, pbits, fbytes, l_sum,
    f_sum, grad_sum, s_sum)."""
    count, d, abits, pbits, fbytes, l_sum, f_sum = struct.unpack(
        _AGG_SUM_FMT, payload[:_AGG_SUM_SIZE])
    grad_sum = unpack_vector(payload[_AGG_SUM_SIZE : _AGG_SUM_SIZE + 8 * d])
    s_sum = unpack_vector(payload[_AGG_SUM_SIZE + 8 * d :])
    return count, abits, pbits, fbytes, l_sum, f_sum, grad_sum, s_sum


def pack_subtree(combine_id: int, leaf_ids) -> bytes:
    """SUBTREE payload: the combine mode (0 exact, 1 sum) and the leaf client
    ids (those expected downstream; in the ack, those owned)."""
    ids = sorted(int(i) for i in leaf_ids)
    return struct.pack("<BI", combine_id, len(ids)) + struct.pack(f"<{len(ids)}I", *ids)


def unpack_subtree(payload: bytes) -> tuple[int, tuple]:
    combine_id, n = struct.unpack("<BI", payload[:5])
    return combine_id, struct.unpack(f"<{n}I", payload[5 : 5 + 4 * n])
