"""The port's declarative API (port of ``repro.api``): one frozen
``ExperimentSpec``, ``solve(spec)`` returning a ``RunReport``, sessions
(``open_session``: step, observe, save and resume FNLS1 checkpoints that both
packages read), sweeps (``spec.grid(...)``, ``solve_many``), and registries
that make algorithms, backends and compressors pluggable.  Everything runs
on the card unless ``device="cpu"`` is asked for.

``TopologySpec``, ``MembershipSpec`` and ``MembershipEvent`` are lazy
attributes (``repro_torch.comm.topology``); ``encode_spec``/``decode_spec``
are the versioned wire form of a spec (``repro_torch.api.specwire``), as the
gateway ships it.
"""

from repro_torch.api.accounting import ACCOUNTINGS, make_bits_fn, payload_bits_fn, wire_bits_fn
from repro_torch.api.facade import solve, solve_many
from repro_torch.api.registry import (
    Algorithm,
    Backend,
    SessionHandle,
    get_algorithm,
    get_backend,
    list_algorithms,
    list_backends,
    register_algorithm,
    register_backend,
    register_compressor,
)
from repro_torch.api.report import RoundRecord, RunReport, RunReportBuilder, SweepReport
from repro_torch.api.session import (
    Session,
    SessionState,
    StopPolicy,
    load_state,
    open_session,
    save_state,
)
from repro_torch.api.spec import CompressorSpec, DataSpec, ExperimentSpec
from repro_torch.api.specwire import SPEC_WIRE_VERSION, decode_spec, encode_spec
from repro_torch.api.sweep import SweepSpec
from repro_torch.comm.transport import FaultSpec

# TopologySpec / MembershipSpec / MembershipEvent are lazy module attributes:
# repro_torch.comm.topology pulls the star stack, and `import repro_torch.api`
# stays cheap for spec-only users
_TOPOLOGY_EXPORTS = ("TopologySpec", "MembershipSpec", "MembershipEvent")


def __getattr__(name: str):
    if name in _TOPOLOGY_EXPORTS:
        from repro_torch.comm import topology

        return getattr(topology, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "MembershipEvent",
    "MembershipSpec",
    "TopologySpec",
    "ACCOUNTINGS",
    "SPEC_WIRE_VERSION",
    "Algorithm",
    "Backend",
    "CompressorSpec",
    "DataSpec",
    "ExperimentSpec",
    "FaultSpec",
    "RoundRecord",
    "RunReport",
    "RunReportBuilder",
    "Session",
    "SessionHandle",
    "SessionState",
    "StopPolicy",
    "SweepReport",
    "SweepSpec",
    "load_state",
    "open_session",
    "save_state",
    "decode_spec",
    "encode_spec",
    "get_algorithm",
    "get_backend",
    "list_algorithms",
    "list_backends",
    "make_bits_fn",
    "payload_bits_fn",
    "wire_bits_fn",
    "register_algorithm",
    "register_backend",
    "register_compressor",
    "solve",
    "solve_many",
]
