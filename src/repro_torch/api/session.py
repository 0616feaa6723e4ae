"""Incremental execution sessions: open_session(spec) -> step/observe/save/resume
(port of ``repro.api.session``).

``solve(spec)`` is the run-to-completion form; a :class:`Session` advances
one chunk of rounds at a time:

    s = open_session(spec)                  # on the card; device="cpu" here
    s.on_round(lambda rec: print(rec.round, rec.grad_norm))
    s.step(5)
    s.save("run.fnlsess")
    report = s.run()                        # the rest, under spec.rounds/tol
    s.close()

    s2 = open_session(spec, restore="run.fnlsess")
    report2 = s2.run()                      # bit-identical to the run above

Numerics contract: ``step(k)`` then ``step(m)`` is bit-identical to
``step(k + m)`` and to ``solve()``, and save -> restore mid-run is
bit-identical to an uninterrupted run (on one device: a checkpoint written
on the card and resumed on the CPU runs the CPU's plain kernels).

Checkpoint format ``FNLS1``, the reference's byte for byte, so that each
package reads the other's files: magic ``FNLSESS1``, a u64 header length, a
sorted-key JSON header (spec, round, backend meta, per-round records with
floats as ``float.hex`` strings, array manifest), then the raw
little-endian array blobs in manifest order.  Deterministic: save -> load
-> save is the identity on bytes.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
from typing import Any, Callable

import numpy as np

from repro_torch.api.report import RoundRecord, RunReport, RunReportBuilder
from repro_torch.api.spec import CompressorSpec, DataSpec, ExperimentSpec
from repro_torch.obs import core as _obs

_MAGIC = b"FNLSESS1"
_VERSION = 1

# record fields that hold floats / ints / tuples, for the hex-exact encoding
_REC_FLOAT = ("grad_norm", "f", "l")
_REC_INT = ("round", "sent_elems", "sent_bits", "sent_bits_payload",
            "sent_bits_wire", "ls_steps")
_REC_TUPLE = ("participants", "dropped")


# ---------------------------------------------------------------------------
# stop policies
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StopPolicy:
    """When :meth:`Session.run` stops, beyond the round budget.

    ``max_rounds`` caps the TOTAL round count (None -> ``spec.rounds``);
    ``tol`` stops once a round's grad norm drops below it (full
    participation only); ``predicate`` is a ``RoundRecord -> bool`` test,
    stopping on the first True.  The stopping round is always included.
    """

    max_rounds: int | None = None
    tol: float | None = None
    predicate: Callable[[RoundRecord], bool] | None = None

    @property
    def streaming(self) -> bool:
        """True when stopping needs a look at each round's record."""
        return self.tol is not None or self.predicate is not None

    def hit(self, rec: RoundRecord) -> bool:
        """True when ``rec`` meets the tol or the predicate."""
        if self.tol is not None and rec.grad_norm is not None and rec.grad_norm < self.tol:
            return True
        return self.predicate is not None and bool(self.predicate(rec))


def resolve_policy(until, spec: ExperimentSpec) -> StopPolicy:
    """A ``run(until=...)`` argument as a :class:`StopPolicy` under
    ``spec``'s defaults."""
    if until is None:
        return StopPolicy(max_rounds=spec.rounds, tol=spec.tol if spec.tol > 0.0 else None)
    if isinstance(until, StopPolicy):
        if until.max_rounds is None:
            return dataclasses.replace(until, max_rounds=spec.rounds)
        return until
    if isinstance(until, bool):
        raise TypeError("until must be None | int | float | StopPolicy")
    if isinstance(until, int):
        return StopPolicy(max_rounds=until)
    if isinstance(until, float):
        return StopPolicy(max_rounds=spec.rounds, tol=until)
    raise TypeError(
        f"until must be None | int (max total rounds) | float (grad tol) | "
        f"StopPolicy, got {type(until).__name__}"
    )


# ---------------------------------------------------------------------------
# SessionState + the FNLS1 checkpoint format
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SessionState:
    """Everything needed to resume a run bit for bit: the spec, the round
    index, the backend's state (``meta`` scalars + ``arrays``) and the
    records so far."""

    spec: ExperimentSpec
    algorithm: str
    backend: str
    round: int
    meta: dict[str, Any]
    arrays: dict[str, np.ndarray]
    records: tuple[RoundRecord, ...]
    version: int = _VERSION


def spec_to_dict(spec: ExperimentSpec) -> dict:
    """JSON-able projection of a spec, the reference's field for field."""
    return dataclasses.asdict(spec)


def spec_from_dict(d: dict) -> ExperimentSpec:
    """Rebuild an ExperimentSpec from :func:`spec_to_dict` output (the
    reference's too), its ``fault``, ``topology`` and ``membership``
    included."""
    from repro_torch.comm.topology import MembershipEvent, MembershipSpec, TopologySpec
    from repro_torch.comm.transport import FaultSpec

    d = dict(d)
    data = dict(d.pop("data"))
    if data.get("shape") is not None:
        data["shape"] = tuple(data["shape"])
    comp = dict(d.pop("compressor"))
    fault = d.pop("fault")
    topo = d.pop("topology", None)
    mem = d.pop("membership", None)
    topology = membership = None
    if topo is not None:
        topo = dict(topo)
        if topo.get("edges") is not None:
            topo["edges"] = tuple(tuple(g) for g in topo["edges"])
        topology = TopologySpec(**topo)
    if mem is not None:
        membership = MembershipSpec(
            events=tuple(MembershipEvent(**dict(e)) for e in dict(mem)["events"]))
    return ExperimentSpec(
        data=DataSpec(**data),
        compressor=CompressorSpec(**comp),
        fault=FaultSpec(**fault) if fault is not None else None,
        topology=topology,
        membership=membership,
        **d,
    )


def _hexf(v) -> str | None:
    return None if v is None else float(v).hex()


def _unhexf(v) -> float | None:
    return None if v is None else float.fromhex(v)


def _record_to_jsonable(rec: RoundRecord) -> dict:
    out: dict[str, Any] = {}
    for f in _REC_FLOAT:
        out[f] = _hexf(getattr(rec, f))
    for f in _REC_INT:
        v = getattr(rec, f)
        out[f] = None if v is None else int(v)
    for f in _REC_TUPLE:
        v = getattr(rec, f)
        out[f] = None if v is None else [int(i) for i in v]
    out["has_x"] = rec.x is not None
    return out


def _record_from_jsonable(d: dict, x: np.ndarray | None) -> RoundRecord:
    kw: dict[str, Any] = {"x": x}
    for f in _REC_FLOAT:
        kw[f] = _unhexf(d[f])
    for f in _REC_INT:
        kw[f] = d[f] if d[f] is None else int(d[f])
    for f in _REC_TUPLE:
        kw[f] = None if d[f] is None else tuple(d[f])
    return RoundRecord(**kw)


def save_state(state: SessionState, path) -> pathlib.Path:
    """Write the FNLS1 checkpoint, atomically: ``path`` holds either its
    previous content or the whole new file.  Identical SessionStates give
    identical bytes (sorted JSON keys, hex-exact floats, raw little-endian
    blobs)."""
    arrays = dict(state.arrays)
    # the per-round PP models ride as one stacked array, not JSON floats
    xs = [r.x for r in state.records if r.x is not None]
    if xs:
        if len(xs) != len(state.records):
            raise ValueError("records mix x-carrying and x-less rounds")
        arrays["__records_x__"] = np.stack([np.asarray(x) for x in xs])
    manifest = {}
    blobs = []
    for name in sorted(arrays):
        # reshape after ascontiguousarray: it promotes 0-d arrays to 1-d
        arr = np.asarray(arrays[name])
        arr = np.ascontiguousarray(arr).reshape(arr.shape)
        if arr.dtype.byteorder == ">":
            arr = arr.astype(arr.dtype.newbyteorder("<"))
        manifest[name] = {"dtype": arr.dtype.str, "shape": list(arr.shape)}
        blobs.append(arr.tobytes())
    header = {
        "version": state.version,
        "format": "FNLS1",
        "algorithm": state.algorithm,
        "backend": state.backend,
        "round": int(state.round),
        "spec": spec_to_dict(state.spec),
        "meta": state.meta,
        "records": [_record_to_jsonable(r) for r in state.records],
        "arrays": manifest,
    }
    hdr = json.dumps(header, sort_keys=True, separators=(",", ":")).encode()
    path = pathlib.Path(path)
    # atomic: the bytes go to a hidden temporary file in the same directory
    # (no ``*.fnlsess`` glob matches it), reach the disk, and only then take
    # the final name; a process killed mid-write leaves the previous file
    # whole and no file under this name
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    try:
        with open(tmp, "wb") as f:
            _write_fnls1(f, hdr, blobs)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    return path


def _write_fnls1(f, hdr: bytes, blobs: list[bytes]) -> None:
    """The FNLS1 byte stream: magic, header length, header, array blobs."""
    f.write(_MAGIC)
    f.write(len(hdr).to_bytes(8, "little"))
    f.write(hdr)
    for blob in blobs:
        f.write(blob)


def load_state(path) -> SessionState:
    """Read an FNLS1 checkpoint (the port's or the reference's)."""
    raw = pathlib.Path(path).read_bytes()
    if raw[: len(_MAGIC)] != _MAGIC:
        raise ValueError(
            f"{path}: not a FedNL session checkpoint (bad magic "
            f"{raw[:len(_MAGIC)]!r}; expected {_MAGIC!r})"
        )
    n = int.from_bytes(raw[8:16], "little")
    header = json.loads(raw[16 : 16 + n].decode())
    if header.get("version") != _VERSION:
        raise ValueError(
            f"{path}: checkpoint version {header.get('version')} not "
            f"supported (this build reads version {_VERSION})"
        )
    off = 16 + n
    arrays: dict[str, np.ndarray] = {}
    for name in sorted(header["arrays"]):
        info = header["arrays"][name]
        dt = np.dtype(info["dtype"])
        count = int(np.prod(info["shape"], dtype=np.int64)) if info["shape"] else 1
        nbytes = dt.itemsize * count
        arrays[name] = np.frombuffer(raw[off : off + nbytes], dtype=dt).reshape(info["shape"]).copy()
        off += nbytes
    rec_x = arrays.pop("__records_x__", None)
    records = tuple(
        _record_from_jsonable(d, rec_x[i] if d["has_x"] else None)
        for i, d in enumerate(header["records"])
    )
    return SessionState(
        spec=spec_from_dict(header["spec"]),
        algorithm=header["algorithm"],
        backend=header["backend"],
        round=int(header["round"]),
        meta=header["meta"],
        arrays=arrays,
        records=records,
        version=int(header["version"]),
    )


# ---------------------------------------------------------------------------
# Session
# ---------------------------------------------------------------------------


class Session:
    """One live run at round granularity, created by :func:`open_session`;
    drives a backend's :class:`repro_torch.api.registry.SessionHandle`."""

    def __init__(self, spec, algo, backend, handle, records=()):
        self.spec = spec
        self._algo = algo
        self._backend = backend
        self._handle = handle
        self._builder = RunReportBuilder(spec, algo.name, backend.name)
        self._builder.extend(list(records))
        self._observers: list[Callable[[RoundRecord], None]] = []
        self._closed = False

    @property
    def round(self) -> int:
        """Rounds executed so far (a checkpoint's rounds included)."""
        return self._handle.round

    @property
    def records(self) -> tuple[RoundRecord, ...]:
        return tuple(self._builder.records)

    @property
    def state(self) -> SessionState:
        """A frozen, serializable snapshot of the run (:func:`save_state`)."""
        meta, arrays = self._handle.snapshot()
        return SessionState(
            spec=self.spec,
            algorithm=self._algo.name,
            backend=self._backend.name,
            round=self.round,
            meta=meta,
            arrays=arrays,
            records=self.records,
        )

    def on_round(self, fn: Callable[[RoundRecord], None]):
        """Register an observer given every record, in round order.  Returns
        ``fn``, so it can be a decorator."""
        self._observers.append(fn)
        return fn

    def step(self, n: int = 1) -> list[RoundRecord]:
        """Advance exactly ``n`` rounds (``spec.rounds`` caps :meth:`run`,
        not this) and return their records; ``step(k); step(m)`` is
        bit-identical to ``step(k + m)``."""
        if self._closed:
            raise RuntimeError("session is closed")
        if n < 0:
            raise ValueError(f"step count must be >= 0, got {n}")
        if n == 0:
            return []
        rec = _obs.CURRENT
        t0 = _obs.now()
        recs = self._handle.step_rounds(n)
        if rec.enabled:
            # one step_rounds call is one device -> host sync of its records
            rec.observe("session.step.s", _obs.now() - t0, backend=self.spec.backend)
            rec.add("session.rounds", len(recs), backend=self.spec.backend)
            rec.add("session.host_syncs", backend=self.spec.backend)
        self._builder.extend(recs)
        for rec in recs:
            for fn in self._observers:
                fn(rec)
        return recs

    def run(self, until=None) -> RunReport:
        """Advance under a stop policy and report the run so far.

        ``until``: None (the spec's rounds/tol: what ``solve()`` does), an
        int (max TOTAL rounds), a float (grad-norm tol) or a
        :class:`StopPolicy`.  Each call continues from the current round.
        """
        policy = resolve_policy(until, self.spec)
        if policy.tol is not None and self._algo.kind == "pp":
            raise ValueError(
                "tol-based stopping is undefined for partial participation "
                "(the server never sees the global gradient); use max_rounds "
                "or a predicate on the records instead"
            )
        target = policy.max_rounds
        if not policy.streaming and not self._observers:
            # nothing reads a round before the end: one chunk, one host sync
            self.step(max(0, target - self.round))
            return self.report()
        while self.round < target:
            recs = self.step(1)
            if not recs:
                break
            if policy.hit(recs[0]):
                break
        return self.report()

    def report(self, spec=None) -> RunReport:
        """The cumulative :class:`RunReport` so far (the session can keep
        stepping afterwards)."""
        tail = self._handle.finalize()
        return self._builder.build(
            x=tail["x"],
            wall_time_s=self._handle.wall_time_s,
            init_time_s=self._handle.init_time_s,
            final_grad_norm_fn=tail.get("final_grad_norm_fn"),
            extras=tail.get("extras"),
            spec=spec,
        )

    def save(self, path) -> pathlib.Path:
        """Write the current state to ``path`` (FNLS1);
        ``open_session(spec, restore=path)`` resumes it bit for bit."""
        return save_state(self.state, path)

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._handle.close()

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# open_session
# ---------------------------------------------------------------------------


def open_session(
    spec: ExperimentSpec,
    z=None,
    x0=None,
    restore: str | pathlib.Path | SessionState | None = None,
    device=None,
) -> Session:
    """Open an incremental run of ``spec``, the Session form of ``solve``.

    ``z`` / ``x0`` / ``device`` as in :func:`repro_torch.api.solve`
    (``device=None``: the card; raises without one).  ``restore`` resumes
    a checkpoint (a path written by :meth:`Session.save`, by either package,
    or a :class:`SessionState`); the spec must describe the same experiment
    (only rounds / tol / host may differ).
    """
    from repro_torch.api.facade import check_spec
    from repro_torch.api.registry import get_algorithm, get_backend
    from repro_torch.device import resolve_device

    device = resolve_device(device)
    state = None
    if restore is not None:
        state = restore if isinstance(restore, SessionState) else load_state(restore)
        spec.check_restore_from(state.spec)
        if x0 is not None:
            raise ValueError(
                "x0 cannot be combined with restore: the checkpoint already "
                "fixes the trajectory (x0 only applies to fresh runs)"
            )
    algo = get_algorithm(spec.algorithm)
    backend = get_backend(spec.backend)
    check_spec(spec, algo, backend, z=z, x0=x0)
    if not backend.supports_sessions:
        raise ValueError(
            f"backend {spec.backend!r} does not support sessions (no "
            "Backend.open); run it to completion with solve(spec) instead"
        )
    if z is None and backend.needs_problem:
        z = spec.data.build()
    handle = backend.open(spec, algo, z, x0, restore=state, device=device)
    return Session(spec, algo, backend, handle, records=state.records if state is not None else ())
