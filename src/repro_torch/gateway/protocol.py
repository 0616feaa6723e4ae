"""Gateway RPC payload codecs + async frame I/O (port of
``repro.gateway.protocol``; every payload is the reference's byte for byte,
so a client of either package talks to a gateway of the other).

Frames reuse the 32-byte FNL1 header from :mod:`repro_torch.comm.protocol`
(MsgType.SUBMIT .. GW_ERR, METRICS); this module defines what goes *inside*
them.  Every payload follows the FNLS1 idiom: a little-endian u32 length, a
canonical JSON header (sorted keys, hex-exact floats where bits matter),
then zero or more raw ``<f8`` array blobs whose shapes the header lists.
Nothing numeric ever round-trips through decimal truncation:

* spec hyper-parameters ride :mod:`repro_torch.api.specwire` (Python float
  repr is shortest-round-trip, so JSON is exact for them);
* RoundRecord floats use ``float.hex()`` via the session codecs;
* iterates (``RoundRecord.x``, ``RunReport.x``) ship as raw f64 blobs.

So a record decoded on the far side of a socket compares equal, hex digit
for hex digit, to the record the engine produced.

Strictness mirrors specwire: unknown top-level payload keys and unknown
``options`` fields are rejected loudly, naming the dotted field.
"""

from __future__ import annotations

import dataclasses
import json
import struct
from typing import Any

import numpy as np

from repro_torch.api.report import RoundRecord, RunReport
from repro_torch.api.session import _record_from_jsonable, _record_to_jsonable, spec_to_dict
from repro_torch.api.specwire import SPEC_WIRE_VERSION, decode_spec_dict
from repro_torch.comm.protocol import HEADER_SIZE, Frame, MsgType, pack_frame, unpack_header
from repro_torch.serve_fednl.scheduler import SubmitOptions

# ---------------------------------------------------------------------------
# JSON-header + f8-blob container (the FNLS1 idiom, frame-sized)
# ---------------------------------------------------------------------------


def _pack(header: dict, blobs: list[np.ndarray] | None = None) -> bytes:
    blobs = blobs or []
    header = dict(header)
    header["blobs"] = [list(np.asarray(b).shape) for b in blobs]
    hj = json.dumps(header, sort_keys=True, separators=(",", ":")).encode()
    out = [struct.pack("<I", len(hj)), hj]
    out += [np.ascontiguousarray(b, dtype="<f8").tobytes() for b in blobs]
    return b"".join(out)


def _unpack(payload: bytes) -> tuple[dict, list[np.ndarray]]:
    (hlen,) = struct.unpack("<I", payload[:4])
    header = json.loads(payload[4 : 4 + hlen].decode())
    off = 4 + hlen
    blobs = []
    for shape in header.pop("blobs", []):
        n = int(np.prod(shape)) if shape else 1
        arr = np.frombuffer(payload[off : off + 8 * n], dtype="<f8").copy()
        blobs.append(arr.reshape(shape))
        off += 8 * n
    if off != len(payload):
        raise ValueError(f"gateway payload has {len(payload) - off} trailing bytes")
    return header, blobs


# ---------------------------------------------------------------------------
# SUBMIT
# ---------------------------------------------------------------------------

_SUBMIT_KEYS = {"spec_wire_version", "spec", "options", "until", "tenant_id"}
_OPTION_FIELDS = {f.name for f in dataclasses.fields(SubmitOptions)}


def pack_submit(
    spec,
    until=None,
    tenant_id: str | None = None,
    options: SubmitOptions | None = None,
) -> bytes:
    """SUBMIT payload: versioned spec + scheduling choices.

    ``until`` crosses the wire only in its data forms -- None, an int round
    budget, or a float tolerance (a StopPolicy with a predicate closure
    cannot be serialized; resolve it client-side to rounds/tol first).
    """
    if until is not None and not isinstance(until, (int, float)):
        raise TypeError(
            "until must be None, an int round budget, or a float tol to "
            f"cross the wire; got {type(until).__name__} (predicate stop "
            "policies are client-local closures)"
        )
    header: dict[str, Any] = {
        "spec_wire_version": SPEC_WIRE_VERSION,
        "spec": spec_to_dict(spec),
        "until": until,
        "tenant_id": tenant_id,
        "options": None if options is None else dataclasses.asdict(options),
    }
    return _pack(header)


def unpack_submit(payload: bytes):
    """-> (spec, until, tenant_id, SubmitOptions | None); strict (module
    docstring) -- raises ValueError naming the offending field."""
    header, _ = _unpack(payload)
    extra = sorted(set(header) - _SUBMIT_KEYS)
    if extra:
        raise ValueError(
            f"SUBMIT payload has unknown field(s): {', '.join(extra)} "
            f"(known fields: {', '.join(sorted(_SUBMIT_KEYS))})"
        )
    spec = decode_spec_dict({k: header[k] for k in ("spec_wire_version", "spec") if k in header})
    until = header.get("until")
    if until is not None and not isinstance(until, (int, float)):
        raise ValueError(
            f"until: must be null, an int round budget, or a float tol; got {type(until).__name__}"
        )
    tenant_id = header.get("tenant_id")
    if tenant_id is not None and not isinstance(tenant_id, str):
        raise ValueError(f"tenant_id: must be null or a string, got {type(tenant_id).__name__}")
    opts_d = header.get("options")
    options = None
    if opts_d is not None:
        if not isinstance(opts_d, dict):
            raise ValueError(f"options: must be null or an object, got {type(opts_d).__name__}")
        unknown = sorted(set(opts_d) - _OPTION_FIELDS)
        if unknown:
            named = ", ".join(f"options.{u}" for u in unknown)
            raise ValueError(
                f"SUBMIT payload has unknown field(s): {named} (known "
                f"options fields: {', '.join(sorted(_OPTION_FIELDS))})"
            )
        options = SubmitOptions(**opts_d)
    return spec, until, tenant_id, options


# ---------------------------------------------------------------------------
# RECORD / STREAM_END
# ---------------------------------------------------------------------------


def pack_record(tenant_id: str, index: int, rec: RoundRecord) -> Frame:
    """One streamed RoundRecord as a RECORD frame (round in the header,
    hex-exact floats in the JSON, any PP iterate as a raw f64 blob)."""
    header = {"tenant_id": tenant_id, "index": index, "record": _record_to_jsonable(rec)}
    blobs = [np.asarray(rec.x)] if rec.x is not None else []
    return Frame(type=MsgType.RECORD, round=int(rec.round), payload=_pack(header, blobs))


def unpack_record(payload: bytes) -> tuple[str, int, RoundRecord]:
    """-> (tenant_id, stream index, RoundRecord) -- bit-exact floats."""
    header, blobs = _unpack(payload)
    d = header["record"]
    x = blobs[0] if d.get("has_x") else None
    return header["tenant_id"], int(header["index"]), _record_from_jsonable(d, x)


def pack_stream_end(tenant_id: str, drops: int, status: str, error: str | None = None) -> Frame:
    """STREAM_END: terminal status + the counted-drops notice of the
    bounded observer queue (``drops`` records were skipped because this
    observer consumed too slowly; the engine never waited for it)."""
    return Frame(
        type=MsgType.STREAM_END,
        payload=_pack(
            {"tenant_id": tenant_id, "drops": int(drops), "status": status, "error": error}
        ),
    )


def unpack_stream_end(payload: bytes) -> dict:
    header, _ = _unpack(payload)
    return header


# ---------------------------------------------------------------------------
# RESULT (full RunReport across the wire)
# ---------------------------------------------------------------------------


def pack_report(report: RunReport) -> bytes:
    """Serialize a RunReport: spec via specwire, records via the session
    hex-float codec, the final iterate + any per-record PP iterates as raw
    f64 blobs.  ``final_grad_norm_fn`` (a closure over problem arrays) does
    not cross the wire; full-participation reports recover the diagnostic
    from their last record, PP callers re-evaluate locally if needed."""
    rec_js = [_record_to_jsonable(r) for r in report.records]
    blobs = [np.asarray(report.x)]
    blobs += [np.asarray(r.x) for r in report.records if r.x is not None]
    header = {
        "spec_wire_version": SPEC_WIRE_VERSION,
        "spec": spec_to_dict(report.spec),
        "algorithm": report.algorithm,
        "backend": report.backend,
        "rounds": int(report.rounds),
        "wall_time_s": float(report.wall_time_s).hex(),
        "init_time_s": float(report.init_time_s).hex(),
        "extras": report.extras,
        "records": rec_js,
    }
    return _pack(header, blobs)


def unpack_report(payload: bytes) -> RunReport:
    header, blobs = _unpack(payload)
    spec = decode_spec_dict(
        {"spec_wire_version": header["spec_wire_version"], "spec": header["spec"]}
    )
    x, rest = blobs[0], blobs[1:]
    records = []
    it = iter(rest)
    for d in header["records"]:
        rx = next(it) if d.get("has_x") else None
        records.append(_record_from_jsonable(d, rx))
    return RunReport(
        spec=spec,
        algorithm=header["algorithm"],
        backend=header["backend"],
        x=x,
        records=records,
        rounds=int(header["rounds"]),
        wall_time_s=float.fromhex(header["wall_time_s"]),
        init_time_s=float.fromhex(header["init_time_s"]),
        extras=dict(header["extras"]),
    )


# ---------------------------------------------------------------------------
# small JSON frames (requests, acks, errors)
# ---------------------------------------------------------------------------


def pack_json(mtype: MsgType, obj: dict) -> Frame:
    return Frame(type=mtype, payload=_pack(obj))


def unpack_json(payload: bytes) -> dict:
    header, _ = _unpack(payload)
    return header


def error_frame(exc: BaseException) -> Frame:
    """GW_ERR naming the offending field where the message makes it
    derivable (specwire / SubmitOptions / SUBMIT validation errors all
    embed dotted field names)."""
    # KeyError's str() wraps the message in quotes; unwrap it
    msg = str(exc.args[0]) if isinstance(exc, KeyError) and exc.args else str(exc)
    field = None
    if "unknown field(s): " in msg:
        field = msg.split("unknown field(s): ", 1)[1].split(",")[0].split(" ")[0].rstrip(",")
    elif ": " in msg:
        head = msg.split(": ", 1)[0]
        if head and " " not in head and head.replace(".", "").replace("_", "").replace(
            "[", ""
        ).replace("]", "").isalnum():
            field = head
    return pack_json(MsgType.GW_ERR, {"error": msg, "field": field, "kind": type(exc).__name__})


class GatewayError(RuntimeError):
    """Client-side surface of a GW_ERR reply (``field`` names the offending
    submission field when the server could derive it)."""

    def __init__(self, message: str, field: str | None = None, kind: str | None = None):
        super().__init__(message)
        self.field = field
        self.kind = kind


# ---------------------------------------------------------------------------
# async frame I/O (the gateway server side; sync peers use
# repro_torch.comm.protocol.send_frame/recv_frame over a transport Connection)
# ---------------------------------------------------------------------------


async def read_frame_async(reader) -> Frame:
    """Read one frame from an :class:`asyncio.StreamReader`."""
    header = await reader.readexactly(HEADER_SIZE)
    frame, plen = unpack_header(header)
    payload = await reader.readexactly(plen) if plen else b""
    return dataclasses.replace(frame, payload=payload)


async def write_frame_async(writer, frame: Frame) -> None:
    """Write one frame to an :class:`asyncio.StreamWriter` and drain it --
    backpressure lands on the *caller's* coroutine only, never the engine
    tick loop (which writes to bounded in-memory queues instead)."""
    writer.write(pack_frame(frame))
    await writer.drain()
