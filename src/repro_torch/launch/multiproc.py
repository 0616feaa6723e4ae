"""Multi-process FedNL / FedNL-PP over TCP localhost: a master and n client
processes (port of ``repro.launch.multiproc``).

    PYTHONPATH=src python -m repro_torch.launch.multiproc \\
        --dataset tiny --compressor randk --rounds 10 --check --device cpu

    # partial participation (Algorithm 3), 3 of 8 clients a round, 20%
    # fault-injected dropout handled by the survivors' partial sums:
    PYTHONPATH=src python -m repro_torch.launch.multiproc \\
        --algo fednl-pp --tau 3 --drop-prob 0.2 --rounds 30 --device cpu

The master binds a localhost socket, spawns one process per client (the
``spawn`` context: a fork after CUDA's initialisation breaks) and runs the
star event loop of ``repro_torch.comm.star`` or ``comm.star_pp``.  A tree of
stars (``TopologySpec(kind="tree")``) runs as a process tree instead
(:class:`TreeClientCluster`): one aggregator process per root subtree, each
binding its own listener and spawning its leaves and sub-aggregators, torn
down leaves first.  Every
client rebuilds the seeded synthetic dataset and keeps only its shard: no
training data crosses the wire.  Clients compute on ``device`` (a string,
``cuda`` by default); on the card the parent builds the kernels before it
spawns, so the children load the built libraries and never run nvcc.

``--check`` solves the same spec on the ``local`` backend and prints the
largest deviation of the iterate and of the grad norms.
"""

from __future__ import annotations

import argparse
import dataclasses
import multiprocessing as mp
import os
import threading

from repro_torch.core.fednl import FedNLConfig


def _client_entry(
    client_id: int,
    n_clients: int,
    dataset: str,
    shape,
    cfg_dict: dict,
    seed: int,
    host: str,
    port: int,
    pp: bool,
    fault_dict: dict | None,
    data_seed: int | None,
    device: str,
) -> None:
    """Client process: build the shard, dial the master, serve rounds."""
    from repro_torch.api.spec import DataSpec
    from repro_torch.comm.transport import connect_to_master

    z = DataSpec(dataset=dataset or "tiny", shape=shape,
                 seed=seed if data_seed is None else data_seed).build()
    conn = connect_to_master(host, port, client_id)
    cfg = FedNLConfig(**cfg_dict)
    if pp:
        from repro_torch.comm.star_pp import StarPPClient
        from repro_torch.comm.transport import FaultSpec

        fault = FaultSpec(**fault_dict) if fault_dict else None
        client = StarPPClient(client_id, n_clients, z[client_id], cfg, conn, seed=seed,
                              fault=fault, device=device)
    else:
        from repro_torch.comm.star import StarClient

        client = StarClient(client_id, n_clients, z[client_id], cfg, conn, seed=seed,
                            device=device)
    client.run()


def _aggregator_entry(
    agg_id: int,
    subtree,
    n_clients: int,
    d: int,
    dataset: str,
    shape,
    cfg_dict: dict,
    seed: int,
    parent_host: str,
    parent_port: int,
    combine: str,
    data_seed: int | None,
    device: str,
) -> None:
    """Aggregator process: bind a listener for the subtree, spawn its
    children (leaf client processes and nested aggregators), dial the
    parent, serve AGG rounds on ``device``.

    Teardown runs leaves first: the subtree's connections are closed and its
    processes joined BEFORE this node closes its own listener and parent
    connection, so the root's ``ClientCluster.close()`` never leaves a
    grandchild behind.  A child that exited with another code than 0 makes
    this process fail too, so the root sees it in its exit codes.
    """
    from repro_torch.comm.topology import build_aggregator
    from repro_torch.comm.transport import TCPMaster, connect_to_master

    subtree = tuple(subtree)
    listener = TCPMaster(len(subtree), host=parent_host)
    procs: list = []
    children: dict = {}
    parent_conn = None
    try:
        agg_children = set()
        to_spawn = []
        for pos, node in enumerate(subtree):
            if isinstance(node, (tuple, list)):
                agg_children.add(pos)
                # not daemonic: a daemonic process may not spawn children,
                # and a nested aggregator spawns its subtree
                to_spawn.append((_aggregator_entry,
                                 (pos, tuple(node), n_clients, d, dataset, shape, cfg_dict, seed,
                                  parent_host, listener.port, combine, data_seed, device),
                                 False))
            else:
                to_spawn.append((_client_entry,
                                 (int(node), n_clients, dataset, shape, cfg_dict, seed,
                                  parent_host, listener.port, False, None, data_seed, device),
                                 True))
        procs = _spawn_procs(to_spawn)
        children = listener.accept_clients(alive=lambda: all(p.is_alive() for p in procs))
        parent_conn = connect_to_master(parent_host, parent_port, agg_id)
        node = build_aggregator(agg_id, parent_conn, children, d, FedNLConfig(**cfg_dict),
                                combine=combine, agg_children=agg_children, device=device)
        node.run()
    finally:
        # children first: their connections closed and processes joined
        # before this node's own sockets go away
        for conn in children.values():
            conn.close()
        for p in procs:
            p.join(timeout=60)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        listener.close()
        if parent_conn is not None:
            parent_conn.close()
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        raise RuntimeError(f"aggregator {agg_id}: children exited with {codes}")


# serializes the PYTHONPATH mutate-spawn-restore window across threads
# (solve_many runs star-tcp specs from a pool of threads)
_SPAWN_ENV_LOCK = threading.Lock()


def _spawn_procs(targets) -> list:
    """Start one spawn-context process per ``(target, args, daemon)`` triple,
    with ``src/`` on the children's PYTHONPATH."""
    ctx = mp.get_context("spawn")
    src_dir = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    procs: list = []
    with _SPAWN_ENV_LOCK:
        old_pp = os.environ.get("PYTHONPATH")
        os.environ["PYTHONPATH"] = src_dir + (os.pathsep + old_pp if old_pp else "")
        try:
            for target, args, daemon in targets:
                p = ctx.Process(target=target, args=args, daemon=daemon)
                p.start()
                procs.append(p)
        finally:
            if old_pp is None:
                os.environ.pop("PYTHONPATH", None)
            else:
                os.environ["PYTHONPATH"] = old_pp
    return procs


# every cluster created and not yet closed, so that a serving engine (or a
# test) can show that no process fleet leaked; its own lock, because clusters
# are created and closed from pool threads
_LIVE_CLUSTERS: "set[ClientCluster]" = set()
_LIVE_LOCK = threading.Lock()


def _build_kernels_for(device: str) -> None:
    """On the card, build the kernels before spawning, so that the children
    load the built libraries and never run nvcc."""
    if device.startswith("cuda"):
        from repro_torch.kernels import build

        build.build_all()


class ClientCluster:
    """A live fleet of TCP client processes around one bound master socket.

    The star-tcp session backend holds it open across ``step()`` calls; a
    restored session spawns a fresh one (client state is rebuilt by protocol
    replay, never saved).

    Lifecycle under shared use: a cluster is reference-counted.
    ``acquire()`` adds a holder, ``release()`` drops one and tears the fleet
    down when the last lets go, and ``close()`` is an idempotent forced
    teardown that any holder may call: it closes the connections, joins the
    processes within ``join_timeout`` seconds, terminates what is still
    alive, and unbinds.  ``live_count()`` / ``close_all()`` read and sweep the
    registry of clusters not yet closed.
    """

    def __init__(
        self,
        dataset: str,
        shape,
        seed: int,
        host: str = "127.0.0.1",
        pp: bool = False,
        fault_dict: dict | None = None,
        data_seed: int | None = None,
        cfg: FedNLConfig | None = None,
        device: str = "cuda",
        accept_timeout: float = 120.0,
    ):
        from repro_torch.api.spec import DataSpec
        from repro_torch.comm.transport import TCPMaster

        # dims only: the master never holds the training data
        d, n_clients, _ = DataSpec(dataset=dataset or "tiny", shape=shape,
                                   seed=seed if data_seed is None else data_seed).dims()
        self.d = d
        self.n_clients = n_clients
        self.device = str(device)
        _build_kernels_for(self.device)
        self._master = TCPMaster(n_clients, host=host)
        self._init_lifecycle()
        cfg_dict = dataclasses.asdict(cfg) if cfg is not None else {}
        self.procs: list = []
        self.conns: dict = {}
        try:
            self.procs = _spawn_procs([
                (_client_entry,
                 (i, n_clients, dataset, shape, cfg_dict, seed, host, self._master.port, pp,
                  fault_dict, data_seed, self.device),
                 True)
                for i in range(n_clients)
            ])
            self.conns = self._master.accept_clients(
                timeout=accept_timeout, alive=lambda: all(p.is_alive() for p in self.procs))
        except BaseException:
            self.close(join_timeout=5)
            raise

    def _init_lifecycle(self) -> None:
        """The reference count and the registry entry, shared with the tree
        cluster (registered only once the master socket is bound, so that a
        failed bind leaves no entry)."""
        self._refs = 1  # the creator holds the first reference
        self._closed = False
        self._lifecycle_lock = threading.Lock()
        with _LIVE_LOCK:
            _LIVE_CLUSTERS.add(self)

    def acquire(self) -> "ClientCluster":
        """Register another holder of this (open) cluster."""
        with self._lifecycle_lock:
            if self._closed:
                raise RuntimeError("cannot acquire a closed ClientCluster")
            self._refs += 1
        return self

    def release(self, join_timeout: float = 60) -> None:
        """Drop one holder; the last release tears the fleet down."""
        with self._lifecycle_lock:
            self._refs = max(0, self._refs - 1)
            last = self._refs == 0
        if last:
            self.close(join_timeout=join_timeout)

    def close(self, join_timeout: float = 60) -> None:
        """Close the connections, join (then terminate) the workers, unbind.
        Idempotent, whatever the reference count."""
        with self._lifecycle_lock:
            if self._closed:
                return
            self._closed = True
            self._refs = 0
        with _LIVE_LOCK:
            _LIVE_CLUSTERS.discard(self)
        for conn in self.conns.values():
            conn.close()
        for p in self.procs:
            p.join(timeout=join_timeout)
        for p in self.procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        self._master.close()

    @property
    def closed(self) -> bool:
        return self._closed

    def exit_codes(self) -> list:
        """The child processes' exit codes (None while one runs)."""
        return [p.exitcode for p in self.procs]

    @classmethod
    def live_count(cls) -> int:
        """Clusters created and not yet closed (the leak probe)."""
        with _LIVE_LOCK:
            return len(_LIVE_CLUSTERS)

    @classmethod
    def close_all(cls, join_timeout: float = 10) -> int:
        """Force-close every live cluster; returns how many were closed."""
        with _LIVE_LOCK:
            stragglers = list(_LIVE_CLUSTERS)
        for c in stragglers:
            c.close(join_timeout=join_timeout)
        return len(stragglers)


class TreeClientCluster(ClientCluster):
    """A live process tree for a tree of stars (``repro_torch.comm.topology``).

    The root binds one listener; each of its children is an aggregator
    process (``_aggregator_entry``) that owns a subtree and spawns its leaf
    client processes and any deeper aggregators.  ``conns`` are keyed by
    root-subtree index (the node ids a TreeMaster expects), not client ids.
    It shares :class:`ClientCluster`'s reference count and registry, so
    ``live_count()`` / ``close_all()`` cover process trees too; teardown runs
    leaves first, each aggregator releasing its children before it closes
    its own sockets, and only then does :meth:`close` join the aggregators.
    """

    def __init__(
        self,
        dataset: str,
        shape,
        seed: int,
        topology,
        host: str = "127.0.0.1",
        data_seed: int | None = None,
        cfg: FedNLConfig | None = None,
        device: str = "cuda",
        accept_timeout: float = 120.0,
    ):
        from repro_torch.api.spec import DataSpec
        from repro_torch.comm.transport import TCPMaster

        d, n_clients, _ = DataSpec(dataset=dataset or "tiny", shape=shape,
                                   seed=seed if data_seed is None else data_seed).dims()
        self.d = d
        self.n_clients = n_clients
        self.device = str(device)
        _build_kernels_for(self.device)
        tree = topology.resolve(n_clients)
        self._master = TCPMaster(len(tree), host=host)
        self._init_lifecycle()
        cfg_dict = dataclasses.asdict(cfg) if cfg is not None else {}
        self.procs: list = []
        self.conns: dict = {}
        try:
            self.procs = _spawn_procs([
                (_aggregator_entry,
                 (i, subtree, n_clients, d, dataset, shape, cfg_dict, seed, host,
                  self._master.port, topology.combine, data_seed, self.device),
                 # aggregators spawn their own children: not daemonic
                 False)
                for i, subtree in enumerate(tree)
            ])
            self.conns = self._master.accept_clients(
                timeout=accept_timeout, alive=lambda: all(p.is_alive() for p in self.procs))
        except BaseException:
            self.close(join_timeout=5)
            raise


def _run_with_clients(cfg, dataset, shape, seed, host, master_fn, pp=False, fault_dict=None,
                      data_seed=None, device="cuda"):
    """Bind, spawn one process per client, run ``master_fn(conns, d)``, join."""
    cluster = ClientCluster(dataset, shape, seed, host=host, pp=pp, fault_dict=fault_dict,
                            data_seed=data_seed, cfg=cfg, device=device)
    try:
        return master_fn(cluster.conns, cluster.d)
    finally:
        cluster.close()


def run_multiproc(
    cfg: FedNLConfig,
    dataset: str = "tiny",
    shape: tuple[int, int, int] | None = None,
    rounds: int = 100,
    tol: float = 0.0,
    seed: int = 0,
    host: str = "127.0.0.1",
    data_seed: int | None = None,
    device: str = "cuda",
):
    """Spawn client processes, run the master loop on ``device``, join.
    Returns the master's :class:`repro_torch.comm.star.StarRunResult`."""
    from repro_torch.comm.star import run_star_master

    def master_fn(conns, d):
        return run_star_master(conns, d, cfg, rounds=rounds, tol=tol, device=device)

    return _run_with_clients(cfg, dataset, shape, seed, host, master_fn, data_seed=data_seed,
                             device=device)


def run_multiproc_pp(
    cfg: FedNLConfig,
    tau: int,
    dataset: str = "tiny",
    shape: tuple[int, int, int] | None = None,
    rounds: int = 100,
    seed: int = 0,
    host: str = "127.0.0.1",
    on_dropout: str = "partial",
    fault=None,
    data_seed: int | None = None,
    device: str = "cuda",
):
    """FedNL-PP over TCP localhost: tau of n clients a round, optional fault
    injection (``fault``: a :class:`repro_torch.comm.transport.FaultSpec`).
    Returns the master's :class:`repro_torch.comm.star_pp.StarPPRunResult`."""
    from repro_torch.comm.star_pp import StarPPMaster

    def master_fn(conns, d):
        return StarPPMaster(conns, d, cfg, tau, seed=seed, on_dropout=on_dropout,
                            device=device).run(rounds)

    return _run_with_clients(
        cfg, dataset, shape, seed, host, master_fn, pp=True,
        fault_dict=dataclasses.asdict(fault) if fault is not None else None,
        data_seed=data_seed, device=device,
    )


def main(argv=None) -> None:
    """CLI: one ExperimentSpec solved on star-tcp and, with --check, the same
    spec on the local backend."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--algo", default="fednl", choices=["fednl", "fednl-pp"])
    ap.add_argument("--dataset", default="tiny")
    ap.add_argument("--compressor", default="topk")
    ap.add_argument("--k-multiplier", type=float, default=8.0)
    ap.add_argument("--option", default="B", choices=["A", "B"])
    ap.add_argument("--lam", type=float, default=1e-3)
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--tol", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--check", action="store_true",
                    help="compare against the same spec on the local backend")
    ap.add_argument("--tau", type=int, default=0, help="PP: sampled clients per round (default n//2)")
    ap.add_argument("--on-dropout", default="partial", choices=["partial", "resample"])
    ap.add_argument("--drop-prob", type=float, default=0.0)
    ap.add_argument("--straggler-prob", type=float, default=0.0)
    ap.add_argument("--straggler-delay", type=float, default=0.05)
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch.api import CompressorSpec, DataSpec, ExperimentSpec, FaultSpec, solve

    pp = args.algo == "fednl-pp"
    fault = None
    if pp and (args.drop_prob > 0 or args.straggler_prob > 0):
        fault = FaultSpec(drop_prob=args.drop_prob, straggler_prob=args.straggler_prob,
                          straggler_delay_s=args.straggler_delay, seed=args.seed)
    spec = ExperimentSpec(
        lam=args.lam,
        data=DataSpec(dataset=args.dataset, seed=args.seed),
        algorithm=args.algo,
        compressor=CompressorSpec(args.compressor, args.k_multiplier),
        option=args.option,
        mu=args.lam,
        tau=args.tau if (pp and args.tau > 0) else None,
        on_dropout=args.on_dropout,
        fault=fault,
        backend="star-tcp",
        rounds=args.rounds,
        tol=args.tol,
        seed=args.seed,
    )
    rep = solve(spec, device=args.device)
    if rep.rounds == 0:
        print("rounds=0 (nothing to run; INIT/STOP handshake only)")
        return
    print(rep.summary())
    frame_kb = rep.extras["measured_frame_bytes"].sum() / 1e3
    bits_match = (rep.extras["measured_payload_bits"] == rep.sent_bits_payload).all()
    print(f"uplink: measured {frame_kb:.1f} kB framed, payload bits "
          f"measured=={'analytic' if bits_match else 'MISMATCH'}")
    if pp:
        parts = sum(len(p) for p in rep.participants)
        drops = sum(len(d) for d in rep.dropped)
        print(f"tau={rep.extras['tau']} contributions={parts} drops={drops}")
    if not args.check:
        return
    if pp:
        print(f"||grad(x_final)||={rep.final_grad_norm:.3e}")
    if pp and fault is not None:
        print("--check skipped: a faulted PP run parts from the fault-free local run by design")
        return
    ref = solve(spec.replace(backend="local", fault=None), device=args.device)
    if pp:
        dx = float(np.max(np.abs(rep.x_hist - ref.x_hist)))
        print(f"vs local PP: max|x_tcp - x_local|={dx:.3e}")
    else:
        r = min(rep.rounds, ref.rounds)
        dx = float(np.max(np.abs(rep.x - ref.x)))
        dg = float(np.max(np.abs(rep.grad_norms[:r] - ref.grad_norms[:r])))
        print(f"vs local: max|x_tcp - x_local|={dx:.3e} "
              f"max|gn_tcp - gn_local|={dg:.3e} (paper target <= 1e-8)")


if __name__ == "__main__":
    main()
