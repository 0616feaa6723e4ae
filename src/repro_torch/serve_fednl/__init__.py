"""repro_torch.serve_fednl -- the multi-tenant FedNL serving engine (port of
``repro.serve_fednl``).

Not to be confused with :mod:`repro_torch.serving`, the LM *token* serving
engine.  This package batches whole **optimization sessions**: many
concurrent experiments multiplexed through one :class:`FedNLServer`, each
advanced one round per tick through the shared batched round of its group,
spilled to FNLS1 checkpoints under memory pressure, on the card unless
``device="cpu"`` is asked for.

    from repro_torch.serve_fednl import FedNLServer, ServeConfig

    with FedNLServer(ServeConfig(max_resident=16)) as server:
        handles = [server.submit(spec) for spec in specs]
        server.serve_until_idle()
        reports = [h.result() for h in handles]
"""

from repro_torch.serve_fednl.engine import FedNLServer, ServeConfig, serve_all
from repro_torch.serve_fednl.scheduler import (
    DEFAULT_PRIORITIES,
    DEFAULT_PRIORITY,
    FairShareQueue,
    SubmitOptions,
    serve_group_key,
    serve_lane,
)
from repro_torch.serve_fednl.tenant import TenantHandle

__all__ = [
    "DEFAULT_PRIORITIES",
    "DEFAULT_PRIORITY",
    "FairShareQueue",
    "FedNLServer",
    "ServeConfig",
    "SubmitOptions",
    "TenantHandle",
    "serve_all",
    "serve_group_key",
    "serve_lane",
]
