"""Built-in execution backends and algorithm registrations (port of
``repro.api.backends``).

Every backend is exposed at round granularity through ``Backend.open() ->
SessionHandle``; ``solve()`` is the open -> run -> close composition of the
same handle, so the streaming path is the batch path.

  local          the single-process simulation of ``repro_torch.core``, on
                 the card or the CPU.  The handle keeps the runner's sequence
                 (``core/runner.py``): init, one warm-up round outside the
                 clock (it builds and loads the kernels), then the rounds,
                 whose metrics stay on the device until a chunk ends.
  star-loopback  the wire protocol (encode -> frame -> decode) over
                 in-process loopback connections (``repro_torch.comm``).
  star-tcp       a master and one process per client over TCP localhost
                 (``repro_torch.launch.multiproc``); the workers rebuild their
                 shards from ``spec.data``.
  sharded        the clients sharded across ranks over ``torch.distributed``
                 (``repro_torch.distributed``): a world of one in this
                 process (NCCL on the card, gloo on the CPU), or ``devices``
                 spawned ranks; ``aggregate`` picks the collective.

A star session restored from a checkpoint rebuilds its clients by replaying
the recorded broadcasts through the protocol (no client state is saved); the
master's own state comes from the checkpoint.

Capability matrix (``Backend.supports``), as in the reference:

  backend        fednl  fednl-ls  fednl-pp
  local            x       x         x
  sharded          x       -         -
  star-loopback    x       -         x
  star-tcp         x       -         x
"""

from __future__ import annotations

import dataclasses
import time

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
from repro_torch.core.fednl import (
    FedNLState,
    fednl_init,
    make_fednl_round,
    state_from_numpy,
    state_to_numpy,
)
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


def _check_restore_arrays(fields, restore, prefix: str = "state.") -> None:
    missing = [f for f in fields if prefix + f not in restore.arrays]
    if missing:
        raise ValueError(
            f"checkpoint is missing state arrays {missing} for backend "
            f"{restore.backend!r} (truncated or foreign checkpoint?)"
        )


def restored_state(state0, restore, device, prefix: str = "state."):
    """Rebuild a state of ``state0``'s type from checkpoint arrays on
    ``device`` (``state0``, a freshly initialized state, is the template)."""
    _check_restore_arrays(state0._fields, restore, prefix)
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
    return _rows_of(metric_columns(metrics), len(metrics))


def _rows_of(cols: dict, n: int) -> list[dict]:
    """Host columns by name -> ``n`` rows."""
    return [{name: col[i] for name, col in cols.items()} for i in range(n)]


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
# star backends: the wire protocol (loopback connections / TCP processes)
# ---------------------------------------------------------------------------


class _StarFullSessionHandle(SessionHandle):
    """A full-participation star master held open at round granularity: the
    flat star, a tree of stars, the async or the elastic master.

    ``restore`` resumes from a checkpoint: the master's own state (x, H) is
    read back, and the fresh clients (and aggregators) rebuild theirs by
    replaying the checkpoint's broadcast history through the protocol, each
    master's ``replay_round``: the flat star and the tree read the replayed
    uplinks without decoding them; the async master replays its assignments
    and arrival tables, the elastic one its events and mirrors.  ``closer``
    releases the transport (the TCP cluster or process tree)."""

    def __init__(self, spec, master, restore=None, closer=None):
        self._spec = spec
        self._master = master
        self._closer = closer
        self._measured_pbits: list[int] = []
        self._frame_bytes: list[int] = []
        self.round = 0
        self.wall_time_s = 0.0
        t0 = time.perf_counter()
        master.init_handshake()
        if restore is not None:
            for r, x_b in enumerate(restore.arrays["x_hist"]):
                master.replay_round(r, x_b)
            dev = master.device
            master.x = torch.as_tensor(restore.arrays["x"], dtype=torch.float64).to(dev)
            master.h_global = torch.as_tensor(restore.arrays["h_global"], dtype=torch.float64).to(dev)
            self._measured_pbits = [int(b) for b in restore.arrays["measured_payload_bits"]]
            self._frame_bytes = [int(b) for b in restore.arrays["measured_frame_bytes"]]
            self.round = int(restore.round)
        self.init_time_s = time.perf_counter() - t0

    def step_rounds(self, n: int) -> list[RoundRecord]:
        recs = []
        t1 = time.perf_counter()
        for i in range(n):
            r = self.round + i
            m = self._master.step_round(r)
            self._measured_pbits.append(m["measured_payload_bits"])
            self._frame_bytes.append(m["measured_frame_bytes"])
            wire_bits = 8 * m["measured_frame_bytes"]
            parts = m.get("participants")
            recs.append(RoundRecord(
                round=r,
                grad_norm=m["grad_norm"],
                f=m["f"],
                sent_bits=m["sent_bits"] if self._spec.accounting == "payload" else wire_bits,
                sent_bits_payload=m["sent_bits"],
                sent_bits_wire=wire_bits,
                # the async and elastic masters report who contributed or was
                # active; the plain star and the tree report no one (all clients)
                participants=tuple(int(i) for i in parts) if parts is not None else None,
            ))
        self.wall_time_s += time.perf_counter() - t1
        self.round += n
        return recs

    def snapshot(self) -> tuple[dict, dict[str, np.ndarray]]:
        m = self._master
        return {"kind": "full"}, {
            "x": m.x.cpu().numpy(),
            "h_global": m.h_global.cpu().numpy(),
            "x_hist": (np.stack(m.x_hist) if m.x_hist
                       else np.zeros((0, m.d), dtype=np.float64)),
            "measured_payload_bits": np.asarray(self._measured_pbits, np.int64),
            "measured_frame_bytes": np.asarray(self._frame_bytes, np.int64),
        }

    def finalize(self) -> dict:
        return {
            "x": self._master.x.cpu().numpy(),
            "extras": {
                "device": device_name(self._master.device),
                "measured_payload_bits": np.asarray(self._measured_pbits, np.int64),
                "measured_frame_bytes": np.asarray(self._frame_bytes, np.int64),
            },
        }

    def close(self) -> None:
        self._master.stop()
        if self._closer is not None:
            self._closer()
            self._closer = None


class _StarPPSessionHandle(SessionHandle):
    """A FedNL-PP star master held open at round granularity.

    Restore replays the checkpoint's per-round models as SELECT traffic (the
    same key spine and fault draws, resampled replacements included), which
    rebuilds the sampled clients' (H_i, l_i, g_i), then reads the master's
    invariants back."""

    def __init__(self, spec, master, tau: int, z_fn, restore=None, closer=None):
        self._spec = spec
        self._master = master
        self._tau = tau
        self._z_fn = z_fn
        self._closer = closer
        self._measured_pbits: list[int] = []
        self._frame_bytes: list[int] = []
        self.round = 0
        self.wall_time_s = 0.0
        t0 = time.perf_counter()
        master._init_handshake()
        if restore is not None:
            # every PP record carries its x: the broadcast history
            for r, rec in enumerate(restore.records):
                master.replay_round(r, rec.x)
            dev = master.device
            for name in ("h_global", "l_global", "g_global"):
                setattr(master, name,
                        torch.as_tensor(restore.arrays[name], dtype=torch.float64).to(dev))
            master.key = np.asarray(restore.arrays["key"], dtype=np.uint32)
            self._measured_pbits = [int(b) for b in restore.arrays["measured_payload_bits"]]
            self._frame_bytes = [int(b) for b in restore.arrays["measured_frame_bytes"]]
            self.round = int(restore.round)
        self.init_time_s = time.perf_counter() - t0

    def step_rounds(self, n: int) -> list[RoundRecord]:
        recs = []
        t1 = time.perf_counter()
        for i in range(n):
            r = self.round + i
            m = self._master.step_round(r)
            self._measured_pbits.append(m["measured_payload_bits"])
            self._frame_bytes.append(m["measured_frame_bytes"])
            wire_bits = 8 * m["measured_frame_bytes"]
            recs.append(RoundRecord(
                round=r,
                l=m["l"],
                sent_bits=m["sent_bits"] if self._spec.accounting == "payload" else wire_bits,
                sent_bits_payload=m["sent_bits"],
                sent_bits_wire=wire_bits,
                x=m["x"],
                participants=tuple(m["participants"]),
                dropped=tuple(m["dropped"]),
            ))
        self.wall_time_s += time.perf_counter() - t1
        self.round += n
        return recs

    def snapshot(self) -> tuple[dict, dict[str, np.ndarray]]:
        m = self._master
        return {"kind": "pp"}, {
            "h_global": m.h_global.cpu().numpy(),
            "l_global": m.l_global.cpu().numpy(),
            "g_global": m.g_global.cpu().numpy(),
            "key": np.asarray(m.key, dtype=np.uint32),
            "measured_payload_bits": np.asarray(self._measured_pbits, np.int64),
            "measured_frame_bytes": np.asarray(self._frame_bytes, np.int64),
        }

    def finalize(self) -> dict:
        device = self._master.device
        x_final = self._master._solve_x()
        z_fn, lam = self._z_fn, self._spec.lam

        def grad_norm_fn() -> float:
            # the master never holds the data (star-tcp): built only if read
            z = torch.as_tensor(z_fn(), dtype=torch.float64).to(device)
            return float(torch.linalg.vector_norm(eval_full(z, x_final, lam)[1]))

        return {
            "x": x_final.cpu().numpy(),
            "final_grad_norm_fn": grad_norm_fn,
            "extras": {
                "device": device_name(device),
                "tau": self._tau,
                "measured_payload_bits": np.asarray(self._measured_pbits, np.int64),
                "measured_frame_bytes": np.asarray(self._frame_bytes, np.int64),
            },
        }

    def close(self) -> None:
        self._master.stop()
        if self._closer is not None:
            self._closer()
            self._closer = None


class StarLoopbackBackend(Backend):
    """The whole wire protocol (encode -> frame -> decode) over in-process
    loopback connections: deterministic, no sockets."""

    name = "star-loopback"
    supports_faults = True
    supports_sessions = True
    supports_topology = True

    def supports(self, algo: Algorithm) -> bool:
        # identity, not name: the wire loops speak the built-in protocols
        # only; a re-registered custom "fednl" is refused
        return algo is FEDNL or algo is FEDNL_PP

    def open(self, spec, algo: Algorithm, z, x0, restore=None, device=None) -> SessionHandle:
        n_clients, _, d = z.shape
        cfg = spec.fednl_config()
        device = resolve_device(device)
        if algo.kind == "pp":
            from repro_torch.comm.star_pp import StarPPMaster, make_pp_loopback_clients

            tau = spec.tau_for(n_clients)
            conns, drive = make_pp_loopback_clients(z, cfg, seed=spec.seed, fault=spec.fault,
                                                    device=device)
            master = StarPPMaster(conns, d, cfg, tau, seed=spec.seed,
                                  on_dropout=spec.on_dropout, drive=drive, device=device)
            return _StarPPSessionHandle(spec, master, tau, lambda: z, restore=restore)
        from repro_torch.comm.topology import open_loopback_master

        master = open_loopback_master(z, cfg, topology=spec.topology,
                                      membership=spec.membership, seed=spec.seed,
                                      device=device)
        return _StarFullSessionHandle(spec, master, restore=restore)


class StarTCPBackend(Backend):
    """A master and one OS process per client over TCP localhost
    (``repro_torch.launch.multiproc``).  The workers rebuild their shards
    from ``spec.data``, so only seeded synthetic data runs here."""

    name = "star-tcp"
    needs_problem = False
    supports_faults = True
    supports_sessions = True
    supports_topology = True

    def supports(self, algo: Algorithm) -> bool:
        return algo is FEDNL or algo is FEDNL_PP

    def open(self, spec, algo: Algorithm, z, x0, restore=None, device=None) -> SessionHandle:
        if spec.data.libsvm is not None:
            raise ValueError(
                "star-tcp workers rebuild synthetic data from spec.data.seed; "
                "libsvm problems can only run on local/star-loopback"
            )
        from repro_torch.comm.topology import make_master
        from repro_torch.launch.multiproc import ClientCluster, TreeClientCluster

        device = resolve_device(device)
        cfg = spec.fednl_config()
        pp = algo.kind == "pp"
        topo = spec.topology
        if topo is not None and topo.kind == "tree":
            # a process tree: one aggregator process per root subtree, which
            # spawns (and tears down, leaves first) its own children
            cluster = TreeClientCluster(
                spec.data.dataset, spec.data.shape, spec.seed, topo, host=spec.host,
                data_seed=spec.data.seed, cfg=cfg, device=str(device),
            )
        else:
            cluster = ClientCluster(
                spec.data.dataset, spec.data.shape, spec.seed, host=spec.host, pp=pp,
                fault_dict=dataclasses.asdict(spec.fault) if spec.fault is not None else None,
                data_seed=spec.data.seed, cfg=cfg, device=str(device),
            )
        try:
            if pp:
                from repro_torch.comm.star_pp import StarPPMaster

                tau = spec.tau_for(cluster.n_clients)
                master = StarPPMaster(cluster.conns, cluster.d, cfg, tau, seed=spec.seed,
                                      on_dropout=spec.on_dropout, device=device)
                return _StarPPSessionHandle(spec, master, tau, spec.data.build,
                                            restore=restore, closer=cluster.close)
            master = make_master(cluster.conns, cluster.d, cfg, topology=topo,
                                 membership=spec.membership, n_clients=cluster.n_clients,
                                 device=device)
            return _StarFullSessionHandle(spec, master, restore=restore, closer=cluster.close)
        except BaseException:
            cluster.close()
            raise


# ---------------------------------------------------------------------------
# sharded: clients sharded across ranks (repro_torch.distributed)
# ---------------------------------------------------------------------------


class _ShardedSessionHandle(SessionHandle):
    """The sharded round at round granularity.  A world of one is this
    process (rank 0 of a default group of one: NCCL on the card, gloo on
    the CPU); ``devices > 1`` spawns that many ranks, driven over pipes
    (``repro_torch.distributed.ShardedWorld``).  Each steps the local
    handle's loop: init, a warm-up round outside the clock, chunks with one
    host sync each.  A snapshot gathers ``h_local`` to rank 0, so the FNLS1
    arrays are the reference's; a restore gives each rank its block."""

    def __init__(self, spec, algo: Algorithm, z, x0, restore=None, device=None):
        from repro_torch.compressors import get_compressor
        from repro_torch.distributed import ShardedWorld, ShardRunner, world_of_one, world_size_for
        from repro_torch.distributed.fednl_shard import check_shardable
        from repro_torch.linalg import triu_size

        self._spec = spec
        self._device = device = resolve_device(device)
        cfg = spec.fednl_config()
        n_clients, _, d = z.shape
        self._n_dev = n_dev = world_size_for(spec.devices, device)
        check_shardable(n_clients, n_dev, get_compressor(cfg.compressor, triu_size(d), cfg.k_for(d)),
                        spec.aggregate)
        arrays = None
        if restore is not None:
            _check_restore_arrays(FedNLState._fields, restore)
            arrays = restore.arrays
        self.round = int(restore.round) if restore is not None else 0
        self.wall_time_s = 0.0
        if n_dev == 1:
            world_of_one(device)
            self._shards = ShardRunner(z, cfg, seed=spec.seed, aggregate=spec.aggregate,
                                       device=device, restore=arrays)
        else:
            self._shards = ShardedWorld(z, cfg, n_dev, device.type, seed=spec.seed,
                                        aggregate=spec.aggregate, restore=arrays)
        self.init_time_s = self._shards.init_time_s

    def step_rounds(self, n: int) -> list[RoundRecord]:
        t1 = time.perf_counter()
        cols = self._shards.step(n)
        self.wall_time_s += time.perf_counter() - t1
        r0 = self.round
        self.round += n
        return [full_round_record(r0 + i, row) for i, row in enumerate(_rows_of(cols, n))]

    def snapshot(self) -> tuple[dict, dict[str, np.ndarray]]:
        return {"kind": "full"}, self._shards.snapshot()

    def finalize(self) -> dict:
        return {
            "x": self._shards.x(),
            "extras": {"devices": self._n_dev, "aggregate": self._spec.aggregate,
                       "device": device_name(self._device)},
        }

    def close(self) -> None:
        self._shards.close()


class ShardedBackend(Backend):
    name = "sharded"
    supports_sessions = True

    def supports(self, algo: Algorithm) -> bool:
        # identity, not name: this backend drives make_sharded_fednl_round
        # itself, so a re-registered custom "fednl" would silently run the
        # built-in algorithm instead of its own round
        return algo is FEDNL  # no sharded LS/PP round builder, as in the reference

    def open(self, spec, algo: Algorithm, z, x0, restore=None, device=None) -> SessionHandle:
        return _ShardedSessionHandle(spec, algo, z, x0, restore=restore, device=device)


# bound instances: the sweep engine checks identity against LOCAL_BACKEND
# (an overwritten "local" registration must not be batched around)
LOCAL_BACKEND = register_backend(LocalBackend())
SHARDED_BACKEND = register_backend(ShardedBackend())
STAR_LOOPBACK_BACKEND = register_backend(StarLoopbackBackend())
STAR_TCP_BACKEND = register_backend(StarTCPBackend())

