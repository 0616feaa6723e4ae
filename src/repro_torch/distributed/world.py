"""The process groups of the sharded backend.

A world of one (``devices == 1``) is the caller's own process: rank 0 of a
default group set up once per process (:func:`world_of_one`) and reused by
every later in-process sharded run, on the card or the CPU.  Its
collectives are real ``torch.distributed`` calls: NCCL on the card, gloo
on the CPU (``"cpu:gloo,cuda:nccl"`` where NCCL is built in, ``"gloo"``
where it is not).

A larger world (:class:`ShardedWorld`) is ``devices`` rank processes,
spawned (a fork after CUDA's initialisation breaks), each owning
``cuda:r`` (NCCL) or the CPU (gloo).  They meet through a ``TCPStore`` on
127.0.0.1 that the caller hosts, and the caller drives them over pipes:
step n rounds, snapshot, x, close (the interface of the in-process
``fednl_shard.ShardRunner``).  Rank 0 answers with the round metrics and
the gathered state.  A world is reference-counted and registered, as
``launch.multiproc``'s client clusters are: ``close()`` (or the last
``release()``) stops every rank, and ``live_count()`` shows that none leaked.

Nothing here falls back: a failed ``init_process_group`` raises, the card
without NCCL raises, more ranks than cards raises, and nothing runs on the
CPU unless the caller asked for it.
"""

from __future__ import annotations

import multiprocessing as mp
import threading
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

_INIT_LOCK = threading.Lock()


def world_size_for(devices: int | None, device: torch.device) -> int:
    """The world a sharded run asks for: ``devices``, or every card (one
    CPU) when None.  More ranks than the card's machine has cards raises."""
    if device.type == "cuda":
        have = torch.cuda.device_count()
        n = have if devices is None else int(devices)
        if n > have:
            raise ValueError(
                f"devices={n} asks for more ranks than this machine has CUDA devices ({have})"
            )
    else:
        n = 1 if devices is None else int(devices)
    if n < 1:
        raise ValueError(f"devices must be >= 1, got {n}")
    return n


def _check_backend(device: torch.device) -> None:
    if device.type == "cuda" and not dist.is_nccl_available():
        raise RuntimeError("the sharded backend on the card needs NCCL; this torch has none")


def world_of_one(device: torch.device) -> None:
    """Make the caller's process rank 0 of a default group of one, once per
    process; a later call reuses it.  Raises if the process already belongs
    to a larger world, or to one that cannot reach ``device``."""
    _check_backend(device)
    with _INIT_LOCK:
        if not dist.is_initialized():
            backend = "cpu:gloo,cuda:nccl" if dist.is_nccl_available() else "gloo"
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    if dist.get_world_size() != 1:
        raise RuntimeError(
            f"this process is rank {dist.get_rank()} of a world of {dist.get_world_size()}; "
            "an in-process sharded run needs a world of one"
        )
    if device.type == "cuda" and "nccl" not in str(dist.get_backend()):
        raise RuntimeError(f"the default group ({dist.get_backend()}) has no NCCL for the card")


def _rank_main(rank: int, n_ranks: int, port: int, device_type: str, cfg, seed: int,
               aggregate: str, z: np.ndarray, restore, conn) -> None:
    """A rank process: join the world, build its ShardRunner, then serve
    the caller's commands until "close"."""
    try:
        if device_type == "cuda":
            device = torch.device("cuda", rank)
            torch.cuda.set_device(device)
        else:
            device = torch.device("cpu")
            torch.set_num_threads(1)  # n_ranks processes share the host's cores
        _check_backend(device)
        store = dist.TCPStore("127.0.0.1", port, is_master=False)
        backend = "nccl" if device_type == "cuda" else "gloo"
        dist.init_process_group(backend, store=store, rank=rank, world_size=n_ranks)
        from repro_torch.distributed.fednl_shard import ShardRunner

        runner = ShardRunner(z, cfg, seed=seed, aggregate=aggregate, device=device,
                             restore=restore)
        del z, restore
        conn.send(("ok", None))
        while True:
            cmd, arg = conn.recv()
            if cmd == "close":
                break
            if cmd == "step":
                out = runner.step(arg)
            elif cmd == "snapshot":
                out = runner.snapshot()
            else:  # "x"
                out = runner.x()
            conn.send(("ok", out if rank == 0 else None))
    except BaseException:
        try:
            conn.send(("error", traceback.format_exc()))
        except (OSError, ValueError):
            pass
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        conn.close()


# every world created and not yet closed (the leak probe); its own lock,
# because sessions open and close from pool threads
_LIVE_WORLDS: "set[ShardedWorld]" = set()
_LIVE_LOCK = threading.Lock()


class ShardedWorld:
    """``n_ranks`` spawned rank processes running one sharded FedNL run on
    ``z`` (n_clients, n_i, d): rank r owns clients [r n / R, (r + 1) n / R)
    on ``cuda:r`` or the CPU.  ``restore``: FNLS1 state arrays of the run.

    Lifecycle, as ``launch.multiproc.ClientCluster``'s: the creator holds
    one reference, ``acquire()`` adds one, ``release()`` drops one and the
    last closes; ``close()`` is an idempotent forced teardown (ask every
    rank to stop, join within ``join_timeout``, terminate what is alive)."""

    def __init__(self, z, cfg, n_ranks: int, device_type: str, *, seed: int, aggregate: str,
                 restore: dict | None = None):
        from repro_torch.launch.multiproc import _build_kernels_for, _spawn_procs

        t0 = time.perf_counter()
        self.n_ranks = n_ranks
        z = np.asarray(z.cpu() if isinstance(z, torch.Tensor) else z, dtype=np.float64)
        n_loc = z.shape[0] // n_ranks
        _build_kernels_for(device_type)  # the ranks load the built libraries
        self._store = dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False)
        self._refs, self._closed = 1, False
        self._lifecycle_lock = threading.Lock()
        with _LIVE_LOCK:
            _LIVE_WORLDS.add(self)
        self.conns: list = []
        self.procs: list = []
        try:
            pipes = [mp.get_context("spawn").Pipe() for _ in range(n_ranks)]
            self.conns = [parent for parent, _ in pipes]
            self.procs = _spawn_procs([
                (_rank_main,
                 (r, n_ranks, self._store.port, device_type, cfg, seed, aggregate,
                  z[r * n_loc:(r + 1) * n_loc], restore, child),
                 True)
                for r, (_, child) in enumerate(pipes)
            ])
            for _, child in pipes:
                child.close()
            self._collect()  # every rank built its state and ran its warm-up round
        except BaseException:
            self.close(join_timeout=5)
            raise
        self.init_time_s = time.perf_counter() - t0

    def _collect(self):
        """Every rank's reply to the last command; rank 0's value.  A rank
        that reports an error, or dies without a reply, raises."""
        replies: dict[int, object] = {}
        while len(replies) < self.n_ranks:
            for r, (conn, proc) in enumerate(zip(self.conns, self.procs)):
                if r in replies:
                    continue
                if conn.poll(0.05):
                    try:
                        status, value = conn.recv()
                    except EOFError:
                        status, value = "error", "the rank closed its pipe"
                    if status != "ok":
                        raise RuntimeError(f"sharded rank {r} of {self.n_ranks} failed:\n{value}")
                    replies[r] = value
                elif not proc.is_alive():
                    raise RuntimeError(
                        f"sharded rank {r} of {self.n_ranks} exited ({proc.exitcode}) "
                        "without a reply"
                    )
        return replies[0]

    def call(self, cmd: str, arg=None):
        """Send ``cmd`` to every rank; rank 0's answer."""
        if self._closed:
            raise RuntimeError("the sharded world is closed")
        for conn in self.conns:
            conn.send((cmd, arg))
        return self._collect()

    # ShardRunner's interface, answered by rank 0
    def step(self, n: int) -> dict[str, np.ndarray]:
        return self.call("step", n)

    def snapshot(self) -> dict[str, np.ndarray]:
        return self.call("snapshot")

    def x(self) -> np.ndarray:
        return self.call("x")

    def acquire(self) -> "ShardedWorld":
        with self._lifecycle_lock:
            if self._closed:
                raise RuntimeError("cannot acquire a closed ShardedWorld")
            self._refs += 1
        return self

    def release(self, join_timeout: float = 60) -> None:
        with self._lifecycle_lock:
            self._refs = max(0, self._refs - 1)
            last = self._refs == 0
        if last:
            self.close(join_timeout=join_timeout)

    def close(self, join_timeout: float = 60) -> None:
        """Stop every rank (join, then terminate); idempotent."""
        with self._lifecycle_lock:
            if self._closed:
                return
            self._closed = True
            self._refs = 0
        with _LIVE_LOCK:
            _LIVE_WORLDS.discard(self)
        for conn in self.conns:
            try:
                conn.send(("close", None))
            except (OSError, ValueError):
                pass
        for p in self.procs:
            p.join(timeout=join_timeout)
        for p in self.procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        for conn in self.conns:
            conn.close()
        self._store = None

    def exit_codes(self) -> list:
        return [p.exitcode for p in self.procs]

    @classmethod
    def live_count(cls) -> int:
        """Worlds created and not yet closed (the leak probe)."""
        with _LIVE_LOCK:
            return len(_LIVE_WORLDS)
