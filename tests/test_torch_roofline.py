"""The port's roofline (``repro_torch.roofline``) against ``repro.roofline``
on the CPU.

  * ``analyze``: the same flops, bytes and collective bytes through both
    (the reference's by a stub of a compiled module: ``cost_analysis()``,
    an HLO text with one collective of each kind, ``memory_analysis()``):
    ``as_dict()`` equal, exactly;
  * ``collective_bytes``: the port's recorder over the sharded round on a
    gloo world of one (dense_psum: an all-reduce of T + d + 2 f64 and one
    of 3 i64; sparse_allgather: two all-gathers and two all-reduces) and
    over each kind alone, against the reference's parser of an HLO text of
    the same ops: equal, kind by kind;
  * ``star_comm_s`` and ``star_roofline``: equal on a grid, the cases of
    tests/test_comm.py:226 among them;
  * params of every architecture at full size, the port's on meta against
    the reference's ``jax.eval_shape`` (without x64, as the reference's dry
    run traces: under x64 its scaled draws promote to f64): every leaf's
    name, shape and dtype, ``count_params``, ``active_params`` and
    ``model_flops_global`` exact;
  * ``step_cost`` of granite-3-2b's reduced prefill and train step: the
    product flops equal the closed form of the step's products exactly and
    ``FlopCounterMode``'s count exactly, and lie in a band under the
    reference's ``hlo_cost`` with ``unroll_layers=True`` (see
    ``HLO_BANDS``); meta against CPU exact (flops and bytes) for every
    family's prefill, train step and decode step, but for moe's bytes
    (meta keeps every dispatched assignment: at least the CPU's; its
    expert products are the capacity buffers', the same).
"""

import dataclasses
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import repro.roofline as jrl
from repro.comm.cost import CommCostModel as JCost
from repro.configs import get_config as j_get_config
from repro.data import add_intercept, make_synthetic_logreg, partition_clients
from repro.launch.specs import _init_fn as j_init_fn
from repro.train.optimizer import adamw_init as j_adamw_init
from repro.train.step import make_prefill_step as j_prefill_step
from repro.train.step import make_train_step as j_train_step
import repro_torch.roofline as trl
from repro_torch.comm.cost import CommCostModel as TCost
from repro_torch.configs import get_config, list_archs
from repro_torch.core.fednl import FedNLConfig
from repro_torch.distributed import (
    make_sharded_fednl_round,
    shard_problem,
    sharded_fednl_init,
    world_of_one,
)
from repro_torch.launch.specs import _init_fn
from repro_torch.linalg import triu_size
from repro_torch.models.lm import padded_vocab
from repro_torch.train import adamw_init, make_prefill_step, make_serve_step, make_train_step
from repro_torch.models import init_decode_cache, init_encdec_cache

CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# analyze
# ---------------------------------------------------------------------------

def _hlo_line(kind: str, dtype: str, shape: tuple[int, ...], n: int) -> str:
    dims = ",".join(map(str, shape))
    return (f"  %{kind}.{n} = {dtype}[{dims}]{{0}} {kind}({dtype}[{dims}]{{0}} %p.{n}), "
            "replica_groups={}")


def _stub_compiled(flops, nbytes, hlo_text, mem):
    def memory_analysis():
        if mem is None:
            raise RuntimeError("no memory analysis")
        return types.SimpleNamespace(temp_size_in_bytes=mem[0], output_size_in_bytes=mem[1])

    return types.SimpleNamespace(
        cost_analysis=lambda: {"flops": flops, "bytes accessed": nbytes},
        as_text=lambda: hlo_text, memory_analysis=memory_analysis)


@pytest.mark.parametrize("machine", ["tpu_v5e", "h100_sxm", "h100_sxm_fp64"])
@pytest.mark.parametrize("flops,nbytes,mem", [
    (3.98e14, 1.27e13, (6.1e10, 2.0e6)),  # compute-light, memory-heavy
    (5.2e15, 1.0e9, (1.0e9, 0.0)),  # compute-dominant
    (1.0e6, 2.0e6, None),  # memory_analysis fails: nan
    (0.0, 0.0, (0.0, 0.0)),  # no flops: useful_fraction nan
])
def test_analyze_matches_the_reference(machine, flops, nbytes, mem):
    port_machine = {"tpu_v5e": trl.Machine(*dataclasses.astuple(jrl.TPU_V5E)),
                    "h100_sxm": trl.H100_SXM, "h100_sxm_fp64": trl.H100_SXM_FP64}[machine]
    ref_machine = jrl.Machine(*dataclasses.astuple(port_machine))
    shapes = {"all-reduce": ("f64", (45758,)), "all-gather": ("s32", (8, 2008)),
              "reduce-scatter": ("bf16", (16, 4096, 384)), "all-to-all": ("f32", (8, 64, 128)),
              "collective-permute": ("s64", (3,))}
    text = "\n".join(_hlo_line(kind, dt, shape, i)
                     for i, (kind, (dt, shape)) in enumerate(shapes.items()))
    coll = jrl.collective_bytes(text)
    assert all(coll.values())
    want = jrl.analyze(_stub_compiled(flops, nbytes, text, mem), chips=4,
                       model_flops_global=2.49e14, machine=ref_machine)
    cost = trl.StepCost(flops=flops, bytes=nbytes, coll=coll, flops_by_op={}, ops=0)
    got = trl.analyze(cost, chips=4, model_flops_global=2.49e14, machine=port_machine,
                      peak_mem_bytes=float("nan") if mem is None else mem[0] + mem[1])
    g, w = got.as_dict(), want.as_dict()
    assert g.keys() == w.keys()
    for key in w:
        if isinstance(w[key], float) and math.isnan(w[key]):
            assert math.isnan(g[key]), key
        else:
            assert g[key] == w[key], key
    assert got.coll_breakdown == want.coll_breakdown


def test_measure_cpu_machine_gives_positive_rates():
    m = trl.measure_machine("cpu", n=64, dtype=torch.float64, reps=2)
    assert m.name == "cpu-measured-float64" and m.ici_bw == 0.0
    assert math.isfinite(m.peak_flops) and m.peak_flops > 0
    assert math.isfinite(m.hbm_bw) and m.hbm_bw > 0


# ---------------------------------------------------------------------------
# collective_bytes on a gloo world of one
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world():
    world_of_one(CPU)


def _sharded_problem(n_clients=8, n_i=40, d_raw=24, seed=1):
    x, y = make_synthetic_logreg((d_raw, n_clients, n_i), seed=seed)
    return np.asarray(partition_clients(add_intercept(x), y, n_clients, n_i, seed=seed))


@pytest.mark.parametrize("aggregate", ["dense_psum", "sparse_allgather"])
def test_collectives_of_the_sharded_round_match_the_hlo_parser(world, aggregate):
    z = shard_problem(_sharded_problem(), device=CPU)
    cfg = FedNLConfig(compressor="topk", lam=1e-3)
    state = sharded_fednl_init(z, cfg, seed=0)
    cost = trl.step_cost(make_sharded_fednl_round(z, cfg, aggregate=aggregate), state)
    n_clients, _, d = z.shape
    t, k = triu_size(d), cfg.k_for(d)
    if aggregate == "dense_psum":  # s, grad, l, f in one; the three counts in another
        ops = [("all-reduce", "f64", (t + d + 2,)), ("all-reduce", "s64", (3,))]
    else:  # the (idx, val) pairs gathered; grad, l, f; the three counts
        ops = [("all-gather", "s32", (n_clients, k)), ("all-gather", "f64", (n_clients, k)),
               ("all-reduce", "f64", (d + 2,)), ("all-reduce", "s64", (3,))]
    text = "\n".join(_hlo_line(kind, dt, shape, i) for i, (kind, dt, shape) in enumerate(ops))
    assert cost.coll == jrl.collective_bytes(text)
    assert sum(cost.coll.values()) > 0


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather", "reduce-scatter", "all-to-all"])
def test_each_collective_kind_matches_the_hlo_parser(world, kind):
    import torch.distributed as dist

    x = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    out = torch.empty_like(x)

    def step():
        if kind == "all-reduce":
            dist.all_reduce(x)
        elif kind == "all-gather":
            dist.all_gather_into_tensor(out, x)
        elif kind == "reduce-scatter":
            dist.reduce_scatter_tensor(out, x)
        else:
            dist.all_to_all_single(out, x)

    cost = trl.step_cost(step)
    assert cost.coll == jrl.collective_bytes(_hlo_line(kind, "f32", (4, 6), 0))


def test_an_unknown_collective_is_refused():
    with pytest.raises(ValueError, match="broadcast_"):
        trl.collective_bytes([("broadcast_", 8)])


# ---------------------------------------------------------------------------
# the star's wire term
# ---------------------------------------------------------------------------

STAR_GRID = [  # (compute_s, uplink bits, broadcast bits, n_clients)
    (1e-3, 8e9, 1e6, 8),  # tests/test_comm.py:229, comm-bound
    (1.0, 8e3, 1e3, 8),  # tests/test_comm.py:231, compute-bound
    (2.5e-3, 142 * 2408 * 96.0, 301 * 64.0, 142),  # w8a TopK's round
    (0.0, 0.0, 0.0, 1),
    (7e-2, 3.3e7, 1.9e4, 71),
]


@pytest.mark.parametrize("cost", ["default", "parallel_nics"])
@pytest.mark.parametrize("case", STAR_GRID)
def test_star_terms_match_the_reference(case, cost):
    compute_s, up, bcast, n = case
    kw = {} if cost == "default" else {"bandwidth_bps": 1e10, "latency_s": 5e-5,
                                       "master_shared_nic": False}
    t_cost = None if cost == "default" else TCost(**kw)
    j_cost = None if cost == "default" else JCost(**kw)
    assert trl.star_comm_s(up, bcast, n, t_cost) == jrl.star_comm_s(up, bcast, n, j_cost)
    assert (trl.star_roofline(compute_s, up, bcast, n, t_cost)
            == jrl.star_roofline(compute_s, up, bcast, n, j_cost))


# ---------------------------------------------------------------------------
# params at full size
# ---------------------------------------------------------------------------

def _ref_leaves(tree) -> dict[str, tuple]:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(p.key for p in path): (tuple(leaf.shape), jnp.dtype(leaf.dtype).name)
            for path, leaf in flat}


def _port_leaves(tree) -> dict[str, tuple]:
    return {name: (tuple(leaf.shape), str(leaf.dtype).removeprefix("torch."))
            for name, leaf in trl._named_leaves(tree)}


@pytest.mark.parametrize("arch", list_archs())
def test_params_and_model_flops_match_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    init, _ = _init_fn(cfg)
    j_init, _ = j_init_fn(jcfg)
    params = init(0, cfg, "meta")
    with jax.enable_x64(False):
        ref = jax.eval_shape(lambda: j_init(jax.random.PRNGKey(0), jcfg))
    assert list(_port_leaves(params).items()) == list(_ref_leaves(ref).items())
    assert trl.count_params(params) == jrl.count_params(ref)
    assert trl.active_params(cfg, params) == jrl.active_params(jcfg, ref)
    for kind, tokens in (("train", 256 * 4096), ("prefill", 32 * 32768), ("decode", 128)):
        assert (trl.model_flops_global(cfg, params, tokens=tokens, kind=kind)
                == jrl.model_flops_global(jcfg, ref, tokens=tokens, kind=kind))


# ---------------------------------------------------------------------------
# step_cost
# ---------------------------------------------------------------------------

# the port's product flops over the reference's hlo_cost (unroll_layers=True)
# of granite-3-2b's reduced config, B 2, S 256: XLA's count adds its
# elementwise flops (norms, rope, softmax, masks, casts; measured: prefill
# 0.9507, train 0.9534), so the port's is under it by about 5%
HLO_BANDS = {"prefill": (0.93, 0.97), "train": (0.93, 0.97)}


def _dense_product_flops(cfg, b: int, s: int, kind: str) -> int:
    """The closed form of a dense decoder's products (no window, tied or
    untied head): q, k, v, o; QK^T and P.V over all S x S pairs (the plain
    attention's chunks of queries against every key); the MLP; the head at
    the last position (prefill) or at every position (train).  A train
    step runs each product forward, again in the backward (remat "full",
    and each loss chunk), and its two gradient products: 4 times, but for
    each layer's last product, the MLP's down projection, whose output no
    gradient needs: ``torch.utils.checkpoint`` stops a recompute at the
    last tensor the backward reads, so it runs 3 times."""
    t = b * s
    d, a, kv = cfg.d_model, cfg.attn_dim, cfg.kv_dim
    proj = 2 * t * d * (a + 2 * kv) + 2 * t * a * d
    attn = 2 * (2 * b * cfg.n_heads * s * s * cfg.head_dim)
    down = 2 * t * cfg.d_ff * d
    mlp = (3 if cfg.activation == "silu_glu" else 2) * down
    layers = cfg.n_layers * (proj + attn + mlp)
    if kind == "prefill":
        return layers + 2 * b * d * padded_vocab(cfg)
    return 4 * (layers + 2 * t * d * padded_vocab(cfg)) - cfg.n_layers * down


@jax.enable_x64(False)
def _ref_hlo_flops(kind: str, b: int = 2, s: int = 256) -> float:
    jcfg = dataclasses.replace(j_get_config("granite-3-2b").reduced(), unroll_layers=True)
    j_init, _ = j_init_fn(jcfg)
    params = jax.eval_shape(lambda: j_init(jax.random.PRNGKey(0), jcfg))
    tokens = jax.ShapeDtypeStruct((b, s), jnp.int32)
    if kind == "prefill":
        return jrl.hlo_cost(j_prefill_step(jcfg), params, {"tokens": tokens})["flops"]
    opt = jax.eval_shape(lambda: j_adamw_init(params))
    return jrl.hlo_cost(j_train_step(jcfg), params, opt,
                        {"tokens": tokens, "labels": tokens})["flops"]


def _family_args(arch: str, kind: str, device, b: int = 2, s: int = 64):
    """``arch``'s reduced step of ``kind`` and its arguments on ``device``:
    zero tokens (and labels, embeddings, a fresh cache)."""
    cfg = get_config(arch).reduced()
    init, _ = _init_fn(cfg)
    params = init(0, cfg, device)
    tokens = torch.zeros((b, s), dtype=torch.int32, device=device)
    if kind == "decode":
        cache = (init_encdec_cache(cfg, b, s, 16, device) if cfg.family == "encdec"
                 else init_decode_cache(cfg, b, s, device))
        return make_serve_step(cfg), (params, cache, tokens[:, :1])
    batch = {"tokens": tokens}
    if cfg.family == "encdec":
        batch["src_embeds"] = torch.zeros((b, s, cfg.d_model), device=device)
    if cfg.family == "vlm":
        batch["img_embeds"] = torch.zeros((b, cfg.n_frontend_tokens, cfg.d_model), device=device)
    if kind == "prefill":
        return make_prefill_step(cfg), (params, batch)
    batch["labels"] = tokens
    return make_train_step(cfg), (params, adamw_init(params), batch)


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_step_cost_counts_the_products_of_a_dense_step(kind):
    step, args = _family_args("granite-3-2b", kind, "meta", s=256)
    cost = trl.step_cost(step, *args)
    assert cost.flops == _dense_product_flops(get_config("granite-3-2b").reduced(), 2, 256, kind)
    assert set(cost.flops_by_op) == {"aten.mm", "aten.bmm"}
    step, args = _family_args("granite-3-2b", kind, CPU, s=256)
    with FlopCounterMode(display=False) as counter:
        step(*args)
    assert cost.flops == counter.get_total_flops()
    lo, hi = HLO_BANDS[kind]
    assert lo <= cost.flops / _ref_hlo_flops(kind) <= hi


@pytest.mark.parametrize("kind", ["prefill", "train", "decode"])
@pytest.mark.parametrize("arch", list_archs())
def test_meta_counts_equal_the_cpu_counts(arch, kind):
    step, meta_args = _family_args(arch, kind, "meta")
    _, cpu_args = _family_args(arch, kind, CPU)
    meta, cpu = trl.step_cost(step, *meta_args), trl.step_cost(step, *cpu_args)
    assert meta.flops == cpu.flops > 0
    if get_config(arch).family == "moe":
        assert meta.bytes >= cpu.bytes > 0
    else:
        assert meta.bytes == cpu.bytes > 0
    assert meta.coll == cpu.coll == {k: 0 for k in jrl._COLLECTIVES}


def test_step_cost_reads_no_value_of_a_meta_step():
    """A step that reads a tensor's value cannot be counted on meta."""
    with pytest.raises((RuntimeError, NotImplementedError)):
        trl.step_cost(lambda x: float(x.sum()), torch.ones(3, device="meta"))
