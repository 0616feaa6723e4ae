"""Built-in execution backends and algorithm registrations (port of
``repro.api.backends``).

The port runs one backend, ``local``: the single-process simulation of
``repro_torch.core``, on the card or the CPU, exposed at round granularity
through ``Backend.open() -> SessionHandle``.  ``solve()`` is the open -> run
-> close composition of the same handle, so the streaming path is the batch
path.  The handle keeps the runner's sequence (``core/runner.py``): init,
one warm-up round outside the clock (it builds and loads the kernels), then
the rounds, whose metrics stay on the device until a chunk of rounds ends.

``sharded`` (ROADMAP A13), ``star-loopback`` and ``star-tcp`` (A11) are
registered with the reference's capability flags, so ``list_backends()`` is
the reference's, and refused by ``check_spec`` before anything runs.

Capability matrix (``Backend.supports``), as in the reference:

  backend        fednl  fednl-ls  fednl-pp
  local            x       x         x
  sharded          x       -         -     (not ported: A13)
  star-loopback    x       -         x     (not ported: A11)
  star-tcp         x       -         x     (not ported: A11)
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.api.registry import (
    Algorithm,
    Backend,
    SessionHandle,
    register_algorithm,
    register_backend,
)
from repro_torch.api.report import RoundRecord
from repro_torch.core.fednl import fednl_init, make_fednl_round, state_from_numpy, state_to_numpy
from repro_torch.core.fednl_batch import make_fednl_batch_round, make_fednl_ls_batch_round
from repro_torch.core.fednl_ls import make_fednl_ls_round
from repro_torch.core.fednl_pp import fednl_pp_init, make_fednl_pp_round, server_model
from repro_torch.core.runner import RoundLoop, eval_full, metric_columns
from repro_torch.device import device_name, resolve_device

# ---------------------------------------------------------------------------
# built-in algorithms (Algorithms 1-3 of the paper)
# ---------------------------------------------------------------------------

FEDNL = register_algorithm(
    Algorithm(
        name="fednl",
        kind="full",
        init=fednl_init,
        make_round=lambda z, cfg, tau=None: make_fednl_round(z, cfg),
        make_batch_round=make_fednl_batch_round,
    )
)

FEDNL_LS = register_algorithm(
    Algorithm(
        name="fednl-ls",
        kind="full",
        line_search=True,
        init=fednl_init,
        make_round=lambda z, cfg, tau=None: make_fednl_ls_round(z, cfg),
        make_batch_round=make_fednl_ls_batch_round,
    )
)

FEDNL_PP = register_algorithm(
    Algorithm(
        name="fednl-pp",
        kind="pp",
        init=fednl_pp_init,
        make_round=make_fednl_pp_round,
    )
)


# ---------------------------------------------------------------------------
# state/record helpers
# ---------------------------------------------------------------------------


def state_arrays(state, prefix: str = "state.") -> dict[str, np.ndarray]:
    """Algorithm state -> checkpoint arrays, as the reference names and
    types them (``repro.api.backends.state_arrays``)."""
    return state_to_numpy(state, prefix=prefix)


def restored_state(state0, restore, device, prefix: str = "state."):
    """Rebuild a state of ``state0``'s type from checkpoint arrays on
    ``device`` (``state0``, a freshly initialized state, is the template)."""
    missing = [f for f in state0._fields if prefix + f not in restore.arrays]
    if missing:
        raise ValueError(
            f"checkpoint is missing state arrays {missing} for backend "
            f"{restore.backend!r} (truncated or foreign checkpoint?)"
        )
    return state_from_numpy(restore.arrays, device, prefix=prefix, state_type=type(state0))


def _opt_int(value) -> int | None:
    return None if value is None else int(value)


def full_round_record(r: int, m: dict) -> RoundRecord:
    """One full-participation round's metrics (host values by name) ->
    RoundRecord.  Shared by the local handle and the sweep engine: the
    host-side float()/int() is part of the parity surface."""
    return RoundRecord(
        round=r,
        grad_norm=float(m["grad_norm"]),
        f=float(m["f"]),
        l=float(m["l"]),
        sent_elems=int(m["sent_elems"]),
        sent_bits=int(m["sent_bits"]),
        sent_bits_payload=int(m["sent_bits_payload"]),
        sent_bits_wire=int(m["sent_bits_wire"]),
        ls_steps=_opt_int(m.get("ls_steps")),
    )


def pp_round_record(r: int, m: dict) -> RoundRecord:
    """One FedNL-PP round's metrics (host values by name) -> RoundRecord."""
    return RoundRecord(
        round=r,
        l=float(m["l"]),
        sent_elems=int(m["sent_elems"]),
        sent_bits=int(m["sent_bits"]),
        sent_bits_payload=int(m["sent_bits_payload"]),
        sent_bits_wire=int(m["sent_bits_wire"]),
        x=np.asarray(m["x"]),
        participants=tuple(int(i) for i in np.asarray(m["idx"])),
        dropped=(),
    )


def metric_rows(metrics: list) -> list[dict]:
    """Per-round metrics tuples -> host rows, one copy per column."""
    cols = metric_columns(metrics)
    return [{name: col[i] for name, col in cols.items()} for i in range(len(metrics))]


# ---------------------------------------------------------------------------
# local: the single-process simulation
# ---------------------------------------------------------------------------


class _LocalSessionHandle(SessionHandle):
    """Round-granular form of the runner's loop (``core.runner.RoundLoop``):
    init -> warm-up round -> rounds.  ``step_rounds(n)`` runs one chunk
    whose metrics stay on the device until it ends: one host sync a chunk
    (FedNL-LS adds its line search's)."""

    def __init__(self, spec, algo: Algorithm, z, x0, restore=None, device=None):
        self._algo = algo
        self._cfg = cfg = spec.fednl_config()
        device = resolve_device(device)
        self.round = int(restore.round) if restore is not None else 0
        self._tau = spec.tau_for(z.shape[0]) if algo.kind == "pp" else None

        def start(zd):
            state = algo.init(zd, cfg, x0=x0, seed=spec.seed)
            if restore is not None:
                state = restored_state(state, restore, device)
            return state, algo.make_round(zd, cfg, self._tau)

        self._loop = RoundLoop(z, device, start)

    @property
    def init_time_s(self) -> float:
        return self._loop.init_time_s

    @property
    def wall_time_s(self) -> float:
        return self._loop.wall_time_s

    def step_rounds(self, n: int) -> list[RoundRecord]:
        metrics = self._loop.step(n)
        r0 = self.round
        self.round += n
        record = full_round_record if self._algo.kind == "full" else pp_round_record
        return [record(r0 + i, m) for i, m in enumerate(metric_rows(metrics))]

    def snapshot(self) -> tuple[dict, dict[str, np.ndarray]]:
        return {"kind": self._algo.kind}, state_arrays(self._loop.state)

    def finalize(self) -> dict:
        extras = {"device": device_name(self._loop.device)}
        if self._algo.kind == "full":
            return {"x": self._loop.state.x.cpu().numpy(), "extras": extras}
        # the deployable model: Algorithm 3, line 4 on the current invariants
        z, lam = self._loop.z, self._cfg.lam
        x_final = server_model(self._loop.state, z.shape[-1])

        def grad_norm_fn() -> float:
            return float(torch.linalg.vector_norm(eval_full(z, x_final, lam)[1]))

        return {
            "x": x_final.cpu().numpy(),
            "final_grad_norm_fn": grad_norm_fn,
            "extras": {**extras, "tau": self._tau},
        }


class LocalBackend(Backend):
    name = "local"
    supports_x0 = True
    supports_sessions = True

    def open(self, spec, algo: Algorithm, z, x0, restore=None, device=None) -> SessionHandle:
        return _LocalSessionHandle(spec, algo, z, x0, restore=restore, device=device)


# ---------------------------------------------------------------------------
# registered, not ported: the reference's flags, refused by check_spec
# ---------------------------------------------------------------------------


class _NotPortedBackend(Backend):
    supports_sessions = True

    def __init__(self, name: str, item: str, algos: tuple, **flags):
        self.name = name
        self.not_ported = item
        self._algos = algos
        for flag, value in flags.items():
            setattr(self, flag, value)

    def supports(self, algo: Algorithm) -> bool:
        # identity, not name: a re-registered custom "fednl" is not the
        # protocol these backends speak
        return any(algo is a for a in self._algos)

    def open(self, spec, algo: Algorithm, z, x0, restore=None, device=None) -> SessionHandle:
        raise NotImplementedError(
            f"backend {self.name!r} is not ported (ROADMAP {self.not_ported})"
        )


# bound instances: the sweep engine checks identity against LOCAL_BACKEND
# (an overwritten "local" registration must not be batched around)
LOCAL_BACKEND = register_backend(LocalBackend())
SHARDED_BACKEND = register_backend(_NotPortedBackend("sharded", "A13", (FEDNL,)))
STAR_LOOPBACK_BACKEND = register_backend(_NotPortedBackend(
    "star-loopback", "A11", (FEDNL, FEDNL_PP),
    supports_faults=True, supports_topology=True,
))
STAR_TCP_BACKEND = register_backend(_NotPortedBackend(
    "star-tcp", "A11", (FEDNL, FEDNL_PP),
    needs_problem=False, supports_faults=True, supports_topology=True,
))

