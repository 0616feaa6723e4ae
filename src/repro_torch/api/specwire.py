"""Versioned wire serialization of :class:`~repro_torch.api.spec.ExperimentSpec`
(port of ``repro.api.specwire``; the bytes are the reference's).

The gateway RPC layer (``repro_torch.gateway``) ships specs between
processes that may run different builds of this repo, or either package, so
the encoding is explicit about its version and *loud* about anything it
does not understand: an unknown field anywhere in the payload -- top level
or nested (``data``, ``compressor``, ``fault``, ``topology``,
``membership``) -- is rejected with an error naming the exact dotted field,
never silently dropped.  Silently ignoring a field would run an experiment
the submitter did not describe.

Encoding: canonical JSON (sorted keys, no whitespace) of
``{"spec_wire_version": 1, "spec": spec_to_dict(spec)}``.  Python floats
round-trip exactly through ``json`` (repr is shortest-round-trip), so every
float hyper-parameter is bit-identical after decode.

``decode_spec`` is strict in both directions of version skew: a payload
with a *newer* version is refused (fields this build cannot validate), and
a payload with unknown fields under the current version is refused
field-by-field.
"""

from __future__ import annotations

import dataclasses
import json

from repro_torch.api.spec import ExperimentSpec

SPEC_WIRE_VERSION = 1

_VERSION_KEY = "spec_wire_version"


def _known_fields(cls) -> set[str]:
    return {f.name for f in dataclasses.fields(cls)}


def _reject_unknown(d: dict, cls, prefix: str) -> None:
    """Raise ValueError naming every key of ``d`` that is not a field of the
    dataclass ``cls`` (dotted with ``prefix`` for nested payload sections)."""
    if not isinstance(d, dict):
        raise ValueError(
            f"spec wire payload: {prefix or 'spec'} must be an object, got {type(d).__name__}"
        )
    unknown = sorted(set(d) - _known_fields(cls))
    if unknown:
        named = ", ".join(f"{prefix}{u}" for u in unknown)
        raise ValueError(
            f"spec wire payload has unknown field(s): {named} (this build "
            f"speaks spec_wire_version {SPEC_WIRE_VERSION}; known "
            f"{prefix or 'spec.'}fields: "
            f"{', '.join(sorted(_known_fields(cls)))})"
        )


def encode_spec(spec: ExperimentSpec) -> bytes:
    """Serialize ``spec`` for the wire (canonical versioned JSON bytes)."""
    from repro_torch.api.session import spec_to_dict

    if not isinstance(spec, ExperimentSpec):
        raise TypeError(f"encode_spec takes an ExperimentSpec, got {type(spec).__name__}")
    payload = {_VERSION_KEY: SPEC_WIRE_VERSION, "spec": spec_to_dict(spec)}
    return json.dumps(payload, sort_keys=True, separators=(",", ":")).encode()


def decode_spec_dict(payload: dict) -> ExperimentSpec:
    """Decode an already-parsed wire payload dict (see :func:`decode_spec`)."""
    from repro_torch.api.session import spec_from_dict
    from repro_torch.api.spec import CompressorSpec, DataSpec
    from repro_torch.comm.transport import FaultSpec

    if not isinstance(payload, dict) or _VERSION_KEY not in payload:
        raise ValueError(
            f"spec wire payload missing {_VERSION_KEY!r} (not a "
            "repro_torch.api.specwire encoding?)"
        )
    version = payload[_VERSION_KEY]
    if version != SPEC_WIRE_VERSION:
        raise ValueError(
            f"spec wire payload is version {version!r}; this build speaks "
            f"version {SPEC_WIRE_VERSION} only (a newer encoding may carry "
            "fields this build cannot validate — upgrade, don't guess)"
        )
    extra = sorted(set(payload) - {_VERSION_KEY, "spec"})
    if extra:
        raise ValueError(f"spec wire payload has unknown top-level key(s): {', '.join(extra)}")
    d = payload.get("spec")
    _reject_unknown(d, ExperimentSpec, "")
    if "data" in d:
        _reject_unknown(d["data"], DataSpec, "data.")
    if "compressor" in d:
        _reject_unknown(d["compressor"], CompressorSpec, "compressor.")
    if d.get("fault") is not None:
        _reject_unknown(d["fault"], FaultSpec, "fault.")
    if d.get("topology") is not None or d.get("membership") is not None:
        from repro_torch.comm.topology import MembershipEvent, MembershipSpec, TopologySpec

        if d.get("topology") is not None:
            _reject_unknown(d["topology"], TopologySpec, "topology.")
        if d.get("membership") is not None:
            _reject_unknown(d["membership"], MembershipSpec, "membership.")
            for i, ev in enumerate(d["membership"].get("events", ())):
                _reject_unknown(ev, MembershipEvent, f"membership.events[{i}].")
    # spec_from_dict rebuilds nested dataclasses; ExperimentSpec.__post_init__
    # then re-runs the full field validation exactly as a local construction
    return spec_from_dict(d)


def decode_spec(data: bytes) -> ExperimentSpec:
    """Inverse of :func:`encode_spec`; rejects unknown versions and unknown
    fields loudly (module docstring)."""
    try:
        payload = json.loads(data.decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise ValueError(f"spec wire payload is not valid JSON: {exc}") from exc
    return decode_spec_dict(payload)
