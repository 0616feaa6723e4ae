"""Roofline terms of a step of the port (port of ``repro.roofline``).

Per step:

    compute term    = product flops / peak flop/s
    memory term     = bytes moved / HBM bytes/s
    collective term = collective result bytes / link bytes/s

The reference reads its flops and bytes from XLA's ``cost_analysis()`` of a
compiled module and its collective bytes from the module's text.  The port
has no compiled module: :func:`step_cost` runs the step once, on ``meta``
or CPU tensors, and counts what its plain PyTorch program does.  The count
is of the work, not of an implementation: the hand-written kernels
(attention, SYRK, the selections) are ctypes calls that no PyTorch counter
sees, so a step on the card is never counted; the plain versions that the
same step runs on the CPU or on meta stand for them.

Where the counts differ from XLA's:

* flops are the products only (``FlopCounterMode``'s formulas: ``mm``,
  ``bmm``, ``addmm``, convolutions, SDPA); XLA also counts elementwise
  flops (~5% of a reduced dense prefill);
* bytes are each aten op's inputs and outputs, each read or written once:
  the eager program's unfused traffic, which is what the port's eager code
  moves (less what the L2 cache serves).  XLA's count is after fusion;
* the port's loop over layers is a Python loop, so nothing is rolled: the
  counts are those of the reference's ``unroll_layers=True`` modules.

On a mesh (DTensor arguments) the counts are per rank, as the reference's
of an SPMD module: the ops each rank runs on its local shards (this
process's rank), and the collectives that DTensor issues between them
(``_c10d_functional``), by the same five kinds.  The global op that
DTensor dispatches, and the shape propagation it runs under a fake mode,
are not counted.

Ceilings: :data:`H100_SXM` and :data:`H100_SXM_FP64` are NVIDIA's
datasheet ceilings of the card; :func:`measure_machine` measures a device's
own (the card's, or the CPU's).  :func:`analyze` takes one of them: it has
no default machine.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any

import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

@dataclasses.dataclass(frozen=True)
class Machine:
    """Roofline ceilings of one device: peak flop/s, HBM bytes/s, and the
    link bytes/s of one direction (0: no interconnect term)."""

    name: str
    peak_flops: float  # flop / s
    hbm_bw: float  # bytes / s
    ici_bw: float  # bytes / s / link (0 -> no interconnect term)


# NVIDIA's H100 SXM5 80GB datasheet ceilings at its 700 W limit: dense bf16
# tensor cores, HBM3, NVLink 4 per direction (900 GB/s both ways)
H100_SXM = Machine("h100-sxm-datasheet-bf16", 989.4e12, 3.35e12, 450e9)
# ... the same card's FP64 tensor cores, the ceiling of FedNL's f64 round
H100_SXM_FP64 = Machine("h100-sxm-datasheet-fp64", 66.9e12, 3.35e12, 450e9)


def measure_machine(device: str | torch.device, *, n: int = 8192,
                    dtype: torch.dtype = torch.bfloat16, reps: int = 5) -> Machine:
    """Measured ceilings of ``device``: peak = the best (n, n) @ (n, n) rate
    in ``dtype`` over ``reps`` products, bandwidth = the best copy of a
    buffer of 2 n**2 elements (bytes read + bytes written over the time).
    On a card the times are CUDA events after a warm-up; on the CPU the
    host clock."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((n, n), generator=gen, dtype=torch.float32, device=dev).to(dtype)
    src = torch.randn((2, n, n), generator=gen, dtype=torch.float32, device=dev).to(dtype)
    dst = torch.empty_like(src)

    def best_s(fn) -> float:
        fn()  # warm-up
        best = math.inf
        for _ in range(reps):
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                best = min(best, start.elapsed_time(end) / 1e3)
            else:
                t0 = time.perf_counter()
                fn()
                best = min(best, time.perf_counter() - t0)
        return best

    peak = 2.0 * n**3 / best_s(lambda: a @ a)
    bw = 2.0 * src.numel() * src.element_size() / best_s(lambda: dst.copy_(src))
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return Machine(f"{name}-measured-{str(dtype).removeprefix('torch.')}", peak, bw, 0.0)


# ---------------------------------------------------------------------------
# counting a step
# ---------------------------------------------------------------------------

_COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# c10d's ops, as ``torch.distributed`` dispatches them, by the reference's
# kind; each op's first argument holds its results
_C10D_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "recv_any_source_": "collective-permute",
    # DTensor's functional collectives; their result is the op's output
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
}
# functional ops that wait for or wrap a collective's result, moving nothing
_FUNCOL_PASSIVE = frozenset({"wait_tensor", "_wrap_tensor_autograd"})

# ops that allocate or rename storage without moving its bytes
_NO_TRAFFIC = frozenset({
    "aten::_unsafe_view", "aten::empty", "aten::empty_strided", "aten::empty_like",
    "aten::new_empty", "aten::new_empty_strided", "aten::lift_fresh",
})


def _tensor_bytes(t: torch.Tensor) -> int:
    """The bytes of the elements ``t`` addresses: an expanded (stride 0)
    dimension is one element deep."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        n *= size if stride else min(size, 1)
    return n * t.element_size()


def _tensors(tree, out: list | None = None) -> list[torch.Tensor]:
    """The tensors in nested tuples, lists and dicts (an aten op's arguments
    and results; faster than a pytree flatten, which the count would call
    twice an op)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


class _CostMode(TorchDispatchMode):
    """One pass over a step's aten ops: the products' flops by
    ``FlopCounterMode``'s formulas and rules (an op without a formula is
    first decomposed where it can be, as that mode does, so the totals are
    its own), each op's input and output bytes, each collective's (name,
    result bytes), and the peak of the storage its ops allocate that is
    alive at once; a CUDA tensor raises.  An op on DTensors is left to
    DTensor (``NotImplemented``), whose ops on the local shards and whose
    collectives come back here; ops under a fake mode (DTensor's shape
    propagation) pass uncounted."""

    def __init__(self):
        super().__init__()
        self.flops_by_op: dict[str, int] = {}
        self.bytes = 0
        self.ops = 0
        self.collectives: list[tuple[str, int]] = []
        self.live = 0
        self.peak = 0
        self._storages: set[int] = set()

    def _freed(self, key: int, nbytes: int) -> None:
        self._storages.discard(key)
        self.live -= nbytes

    def _track(self, outputs) -> None:
        """Add the new storages among ``outputs`` to the live bytes, each
        until the storage is freed."""
        for t in outputs:
            st = t.untyped_storage()
            key = id(st)
            if key in self._storages:
                continue
            self._storages.add(key)
            self.live += st.nbytes()
            weakref.finalize(st, self._freed, key, st.nbytes())
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func.namespace == "_c10d_functional":
            return self._funcol(func, args, kwargs)
        if func not in flop_registry and func is not torch.ops.prim.device.default:
            with self:
                decomposed = func.decompose(*args, **kwargs)
            if decomposed is not NotImplemented:
                return decomposed
        out = func(*args, **kwargs)
        inputs, outputs = _tensors((args, kwargs)), _tensors(out)
        if any(t.is_cuda for t in inputs + outputs):
            raise ValueError(f"step_cost: {func} ran on a CUDA tensor; count on 'meta' or the "
                             "CPU, where the plain versions stand for the kernels")
        self.ops += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            name = str(packet)
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops_by_op[name] = self.flops_by_op.get(name, 0) + int(flops)
        if func.namespace == "c10d":
            self.collectives.append((func._opname, sum(map(_tensor_bytes, _tensors(args[0])))))
        if not (func.is_view or func._schema.name in _NO_TRAFFIC):
            self.bytes += sum(map(_tensor_bytes, inputs + outputs))
        self._track(outputs)
        return out

    def _funcol(self, func, args, kwargs):
        """A functional collective: its result bytes under its kind (a
        wait or a wrap of one, or a collective over a group of one, moves
        nothing)."""
        out = func(*args, **kwargs)
        if func._opname not in _FUNCOL_PASSIVE and _group_size(func, args, kwargs) > 1:
            inputs, outputs = _tensors((args, kwargs)), _tensors(out)
            self.ops += 1
            self.collectives.append((f"_c10d_functional.{func._opname}",
                                     sum(map(_tensor_bytes, outputs))))
            self.bytes += sum(map(_tensor_bytes, inputs + outputs))
            self._track(outputs)
        return out


def _group_size(func, args, kwargs) -> int:
    """The rank count of a functional collective's group (its argument
    named ``group_name``)."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    names = [a.name for a in func._schema.arguments]
    name = kwargs.get("group_name", args[names.index("group_name")]
                      if "group_name" in names[:len(args)] else None)
    return _resolve_process_group(name).size() if name is not None else 2


@dataclasses.dataclass(frozen=True)
class StepCost:
    """What one run of a step does: its product flops (by aten op), the
    bytes its aten ops read and write, its collectives' result bytes by
    kind, and the number of aten ops."""

    flops: float
    bytes: float
    coll: dict[str, int]
    flops_by_op: dict[str, int]
    ops: int
    peak_bytes: int = 0  # the most storage the step's ops held at once


def step_cost(fn, *args, **kw) -> StepCost:
    """Run ``fn(*args, **kw)`` once and count it: the product flops that
    ``FlopCounterMode`` would count (its formulas, in the same pass as the
    bytes: two nested modes cost the meta count half again), the bytes of
    each aten op's inputs and outputs, the collectives' result bytes.

    The arguments are ``meta`` tensors (a full-width step costs no memory;
    MoE dispatch then keeps every assignment, the most it can, where the
    CPU keeps what the capacity allows: its product flops are the same) or
    CPU tensors.  A CUDA tensor raises, in the arguments or anywhere the
    step reaches: on the card the kernels are ctypes calls that no counter
    sees.  Nothing on the counted path may read a tensor's value
    (``.item()``, ``int()``), which meta tensors do not have."""
    if any(t.is_cuda for t in _tensors((args, kw))):
        raise ValueError("step_cost takes meta or CPU tensors, not CUDA ones: the kernels on "
                         "the card are invisible to the counters")
    import torch.fx.experimental._config as fx_config

    mode = _CostMode()
    for t in _tensors((args, kw)):  # the arguments' storage is not the step's
        local = t._local_tensor if isinstance(t, DTensor) else t
        mode._storages.add(id(local.untyped_storage()))
    with fx_config.patch(meta_nonzero_assume_all_nonzero=True), mode:
        fn(*args, **kw)
    return StepCost(flops=float(sum(mode.flops_by_op.values())), bytes=float(mode.bytes),
                    coll=collective_bytes(mode.collectives), flops_by_op=mode.flops_by_op,
                    ops=mode.ops, peak_bytes=mode.peak)


def collective_bytes(recorded) -> dict[str, int]:
    """Sum result bytes per collective kind over recorded (c10d op name,
    result bytes) pairs, the reference's five kinds as keys."""
    out: dict[str, int] = {k: 0 for k in _COLLECTIVES}
    for name, nbytes in recorded:
        if name not in _C10D_KINDS:
            raise ValueError(f"collective_bytes: c10d op {name!r} has no kind among "
                             f"{_COLLECTIVES}")
        out[_C10D_KINDS[name]] += nbytes
    return out


@dataclasses.dataclass
class Roofline:
    flops: float  # per-device product flops
    hbm_bytes: float  # per-device bytes moved
    coll_bytes: float  # per-device collective payload bytes
    coll_breakdown: dict[str, int]
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float  # 6*N*D useful flops (per device)
    useful_fraction: float  # model_flops / flops
    peak_mem_bytes: float  # the measured run's peak device memory, or nan

    def as_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d.pop("coll_breakdown")
        return d


def analyze(
    cost: StepCost, *, chips: int, model_flops_global: float,
    machine: Machine, peak_mem_bytes: float = float("nan"),
) -> Roofline:
    """The three-term roofline of a counted step on ``machine``;
    ``peak_mem_bytes`` is ``torch.cuda.max_memory_allocated()`` of a
    measured run of the step, where the caller has one."""
    coll_total = float(sum(cost.coll.values()))
    compute_s = cost.flops / machine.peak_flops
    memory_s = cost.bytes / machine.hbm_bw
    collective_s = coll_total / machine.ici_bw if machine.ici_bw else 0.0
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops_global / chips
    return Roofline(
        flops=cost.flops,
        hbm_bytes=cost.bytes,
        coll_bytes=coll_total,
        coll_breakdown=dict(cost.coll),
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        model_flops=mf,
        useful_fraction=(mf / cost.flops) if cost.flops else float("nan"),
        peak_mem_bytes=float(peak_mem_bytes),
    )


# ---------------------------------------------------------------------------
# star-topology comm term (multi-node FedNL over repro_torch.comm)
# ---------------------------------------------------------------------------

def star_comm_s(
    uplink_bits_per_round: float,
    bcast_bits_per_round: float,
    n_clients: int,
    cost=None,
) -> float:
    """Seconds of wire time for one FedNL star round under a
    :class:`repro_torch.comm.cost.CommCostModel` (default ``DEFAULT_COST``),
    from the measured or analytic bits of a round."""
    if cost is None:
        from repro_torch.comm.cost import DEFAULT_COST as cost
    return cost.round_s(uplink_bits_per_round, bcast_bits_per_round, n_clients)


def star_roofline(
    compute_s: float,
    uplink_bits_per_round: float,
    bcast_bits_per_round: float,
    n_clients: int,
    cost=None,
) -> dict[str, Any]:
    """Two-term (compute vs wire) round model for the multi-node star."""
    comm_s = star_comm_s(uplink_bits_per_round, bcast_bits_per_round, n_clients, cost)
    return {
        "compute_s": compute_s,
        "comm_s": comm_s,
        "round_s": max(compute_s, comm_s),
        "dominant": "comm" if comm_s > compute_s else "compute",
    }


# ---------------------------------------------------------------------------
# MODEL_FLOPS = 6 * N * D  (N = active params, D = tokens)
# ---------------------------------------------------------------------------

def _named_leaves(tree, prefix: str = ""):
    """(path, leaf) of a nested dict in ``jax.tree.leaves`` order (sorted
    keys), the path's keys joined by "/"."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _named_leaves(tree[key], f"{prefix}{key}/")
    else:
        yield prefix.rstrip("/"), tree


def count_params(params) -> int:
    return sum(math.prod(leaf.shape) for _, leaf in _named_leaves(params))


def active_params(cfg, params) -> float:
    """MoE: experts count at top_k/n_experts; everything else fully."""
    total = 0.0
    for keys, leaf in _named_leaves(params):
        n = math.prod(leaf.shape)
        if cfg.moe is not None and "moe" in keys and "router" not in keys:
            n = n * cfg.moe.top_k / cfg.moe.n_experts
        total += n
    return total


def model_flops_global(cfg, params, *, tokens: int, kind: str) -> float:
    """6*N_active*D for training, 2*N_active*D for inference (fwd only)."""
    n_act = active_params(cfg, params)
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_act * tokens
