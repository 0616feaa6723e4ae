"""The port's declarative API: ``solve(ExperimentSpec(...))``."""

from repro_torch.api.facade import solve
from repro_torch.api.report import RoundRecord, RunReport
from repro_torch.api.spec import CompressorSpec, DataSpec, ExperimentSpec

__all__ = [
    "solve",
    "RoundRecord",
    "RunReport",
    "CompressorSpec",
    "DataSpec",
    "ExperimentSpec",
]
