"""Section-7 wire codecs of compressed packed-triu FedNL messages (port of
``repro.comm.wire``).

Each client's compressed Hessian correction ``S_i = C(D_i - H_i)`` travels in
a compressor-specific byte encoding (paper Section 7), the reference's byte
for byte, whose exact bit count is the analytic ``message_bits`` model:

  identity   T x FP64 raw values.                       bits = 64 T
  topk       k x u32 index || k x FP64 value.           bits = 96 k
  randk      8-byte PRG key || k x FP64 value.          bits = 64 + 64 k
             The receiver replays the PRG (f32 uniforms, then the k largest)
             to rebuild the index set: indices never travel.
  randseqk   u32 start index s || k x FP64 value.       bits = 32 + 64 k
  toplek     u32 kept count k' || k' x u32 || k' x FP64. bits = 32 + 96 k'
  natural    T x 12-bit (sign || 11-bit biased exponent), bit-packed.
                                                        bits = 12 T
             Natural's values are exactly ``sign * 2^p * (8/9)``, so only
             sign and exponent travel; exponents below FP64-normal encode as
             zero.

Indices come in the reference's order (``lax.top_k``'s: rank key
descending, lowest index first on ties); the sets come from the selection
kernels' index forms (``compressors.core``'s sparse forms), so on the card
an encode runs the compressor's kernel on a one-row batch.  Decoding gives
the client's dense compressed vector bit for bit, on the codec's device;
RandK's decode replays the PRG there (the threefry kernel and TopK by keys).
Natural's bit packing is numpy, as in the reference.  The codecs are the
serialisation boundary: every encode copies its payload to the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.comm.protocol import HEADER_SIZE
from repro_torch.compressors.core import (
    FP_BITS,
    IDX_BITS,
    NATURAL_BITS,
    Compressor,
    message_bits,
    randk_indices,
    randk_sparse,
    randseqk_sparse,
    scatter_add_sparse,
    topk_sparse,
    toplek_sparse,
    upload_draws,
)

# stable on-the-wire compressor ids (protocol header ``comp_id`` field)
COMPRESSOR_IDS = {
    "identity": 0,
    "topk": 1,
    "randk": 2,
    "randseqk": 3,
    "toplek": 4,
    "natural": 5,
}
COMPRESSOR_NAMES = {v: k for k, v in COMPRESSOR_IDS.items()}

NATURAL_SCALE = 8.0 / 9.0  # protocol constant: the registry's Natural is the scaled form
_EXP_BIAS = 1023  # FP64 exponent bias; code 0 means value == 0.0


@dataclasses.dataclass(frozen=True)
class EncodedMessage:
    """One compressed Hessian message as it travels: ``bits`` is the exact
    Section-7 bit count, ``len(data) == ceil(bits / 8)``."""

    data: bytes
    bits: int
    sent_elems: int


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _f64_bytes(a) -> bytes:
    return np.asarray(a, dtype="<f8").tobytes()


def _u32_bytes(a) -> bytes:
    return np.asarray(a, dtype="<u4").tobytes()


def _u32_from(data: bytes) -> np.ndarray:
    return np.frombuffer(data, dtype="<u4").copy()


def _f64_from(data: bytes) -> np.ndarray:
    return np.frombuffer(data, dtype="<f8").copy()


def _key_bytes(key: np.ndarray) -> bytes:
    key = np.asarray(key)
    if key.size != 2:
        raise ValueError(f"expected a 64-bit PRNG key, got shape {key.shape}")
    return key.astype("<u4").tobytes()


class WireCodec:
    """``encode(key, u) -> EncodedMessage``; ``decode(data, sent_elems) ->``
    the dense (T,) float64 tensor on ``device``.

    ``encode`` takes the uncompressed packed-triu vector u (T,) on any device
    and the client's round key (2,) uint32 (None for compressors that draw
    nothing), and compresses and serialises in one step, so that
    ``decode(encode(key, u))`` is the client's compressed vector.
    """

    def __init__(self, comp: Compressor, t: int, device: torch.device | str = "cpu"):
        self.comp = comp
        self.t = t
        self.device = torch.device(device)

    @property
    def name(self) -> str:
        return self.comp.name

    @property
    def comp_id(self) -> int:
        return COMPRESSOR_IDS[self.comp.name]

    def encode(self, key: np.ndarray | None, u: torch.Tensor) -> EncodedMessage:
        raise NotImplementedError

    def decode(self, data: bytes, sent_elems: int) -> torch.Tensor:
        raise NotImplementedError

    def _scatter(self, idx: np.ndarray, vals: np.ndarray) -> torch.Tensor:
        return scatter_add_sparse(
            upload_draws(idx.astype(np.int64), self.device), upload_draws(vals, self.device),
            self.t,
        )


class IdentityCodec(WireCodec):
    def encode(self, key, u):
        return EncodedMessage(_f64_bytes(_host(u)), self.t * FP_BITS, self.t)

    def decode(self, data, sent_elems):
        return upload_draws(_f64_from(data), self.device)


class TopKCodec(WireCodec):
    def encode(self, key, u):
        k = self.comp.k
        idx, vals, _ = topk_sparse(u[None], k)
        data = _u32_bytes(_host(idx[0])) + _f64_bytes(_host(vals[0]))
        return EncodedMessage(data, k * (IDX_BITS + FP_BITS), k)

    def decode(self, data, sent_elems):
        k = sent_elems
        return self._scatter(_u32_from(data[: 4 * k]), _f64_from(data[4 * k :]))


class RandKCodec(WireCodec):
    """Values + the 8-byte PRG key; the receiver replays the PRG for the
    index set."""

    def encode(self, key, u):
        k = self.comp.k
        _, vals, _ = randk_sparse(np.asarray(key, dtype=np.uint32)[None], u[None], k)
        data = _key_bytes(key) + _f64_bytes(_host(vals[0]))
        return EncodedMessage(data, FP_BITS + k * FP_BITS, k)

    def decode(self, data, sent_elems):
        k = sent_elems
        key = np.frombuffer(data[:8], dtype="<u4").astype(np.uint32)
        idx = randk_indices(key[None], self.t, self.comp.k, self.device)[0]
        vals = upload_draws(_f64_from(data[8 : 8 + 8 * k]), self.device)
        return scatter_add_sparse(idx, vals, self.t)


class RandSeqKCodec(WireCodec):
    """Contiguous window: one u32 start index + k values (Appendix C)."""

    def encode(self, key, u):
        k = self.comp.k
        idx, vals, _ = randseqk_sparse(np.asarray(key, dtype=np.uint32)[None], u[None], k)
        s = int(idx[0, 0])
        data = _u32_bytes([s]) + _f64_bytes(_host(vals[0]))
        return EncodedMessage(data, IDX_BITS + k * FP_BITS, k)

    def decode(self, data, sent_elems):
        k = sent_elems
        s = int(_u32_from(data[:4])[0])
        return self._scatter((s + np.arange(k)) % self.t, _f64_from(data[4 : 4 + 8 * k]))


class TopLEKCodec(WireCodec):
    """Adaptive payload: u32 kept-count header + the kept (idx, val) pairs."""

    def encode(self, key, u):
        idx, vals, kept = toplek_sparse(np.asarray(key, dtype=np.uint32)[None], u[None],
                                        self.comp.k)
        kept = int(kept[0])
        data = (_u32_bytes([kept]) + _u32_bytes(_host(idx[0, :kept]))
                + _f64_bytes(_host(vals[0, :kept])))
        return EncodedMessage(data, IDX_BITS + kept * (IDX_BITS + FP_BITS), kept)

    def decode(self, data, sent_elems):
        kept = int(_u32_from(data[:4])[0])
        if kept != sent_elems:
            raise ValueError(f"toplek header kept={kept} != sent_elems={sent_elems}")
        return self._scatter(_u32_from(data[4 : 4 + 4 * kept]), _f64_from(data[4 + 4 * kept :]))


class NaturalCodec(WireCodec):
    """Bit-packed sign + 11-bit exponent per entry (12 bits, paper Section 7).

    The scaled Natural compressor gives exactly ``sign * 2^p * NATURAL_SCALE``
    (the power-of-two multiply is exact in FP64), so frexp recovers p, and
    the decoder replays the same multiplies: a bit-exact round trip."""

    def encode(self, key, u):
        u_hat, _ = self.comp.compress(np.asarray(key, dtype=np.uint32)[None], u[None])
        u_np = _host(u_hat[0]).astype(np.float64)
        _, se = np.frexp(NATURAL_SCALE)  # NATURAL_SCALE = sm * 2^se, sm in [.5, 1)
        _, ex = np.frexp(np.abs(u_np))
        p = ex - se  # |u| = 2^p * NATURAL_SCALE
        biased = np.clip(p + _EXP_BIAS, 0, 2046)
        codes = np.where(u_np == 0.0, 0, biased).astype(np.uint16)
        codes |= (np.signbit(u_np) & (u_np != 0.0)).astype(np.uint16) << 11
        # pack T x 12 bits, most significant first
        be = codes[:, None].view(np.uint8).reshape(-1, 2)[:, ::-1]  # big-endian pairs
        bits16 = np.unpackbits(be, axis=1)  # (T, 16)
        data = np.packbits(bits16[:, 4:].reshape(-1)).tobytes()
        return EncodedMessage(data, self.t * NATURAL_BITS, self.t)

    def decode(self, data, sent_elems):
        t = self.t
        if sent_elems != t:
            raise ValueError(f"natural sends all T={t} entries, got {sent_elems}")
        flat = np.unpackbits(np.frombuffer(data, dtype=np.uint8))[: 12 * t]
        bits16 = np.zeros((t, 16), dtype=np.uint8)
        bits16[:, 4:] = flat.reshape(t, 12)
        pairs = np.packbits(bits16, axis=1)  # (T, 2) big-endian
        codes = (pairs[:, 0].astype(np.uint16) << 8) | pairs[:, 1]
        biased = (codes & 0x7FF).astype(np.int64)
        sign = np.where(codes >> 11 & 1, -1.0, 1.0)
        pow2 = np.ldexp(np.ones(t), biased - _EXP_BIAS)
        # the compressor's float sequence: (sign * 2^p) * (8/9)
        vals = np.where(biased == 0, 0.0, sign * pow2) * NATURAL_SCALE
        return upload_draws(vals, self.device)


_CODECS = {
    "identity": IdentityCodec,
    "topk": TopKCodec,
    "randk": RandKCodec,
    "randseqk": RandSeqKCodec,
    "toplek": TopLEKCodec,
    "natural": NaturalCodec,
}


def make_codec(comp: Compressor, t: int, device: torch.device | str = "cpu") -> WireCodec:
    """Wire codec for a configured compressor on packed-triu length ``t``,
    decoding onto ``device``."""
    if comp.name not in _CODECS:
        raise KeyError(f"no wire codec for compressor {comp.name!r}")
    return _CODECS[comp.name](comp, t, device)


def payload_bits(comp: Compressor, sent_elems) -> int:
    """Exact wire bits of a Hessian payload: the analytic ``message_bits``."""
    return int(message_bits(comp, torch.as_tensor(sent_elems)))


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
