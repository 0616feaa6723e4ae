"""The port's sharded backend (``repro_torch.distributed``) against its own
local round and against ``repro.distributed`` (CPU, gloo).

Inputs are the reference's ``_z`` (tests/test_distributed.py: d = 24 + 1,
8 clients, n_i = 40), built with numpy from a seed.  Tolerances:
  * against the port's own local round, TopK, 5 rounds (a world of one
    sums the clients in another order): x rtol 1e-12, grad norm rtol 1e-10,
    the reference's own bounds for its 1-device mesh;
  * against the reference's sharded round: sent_elems and the bits exact
    every round, the support of H^r+1 - H^r exact, grad norms rtol 1e-6 where
    the reference's is >= 1e-10 (tests/test_torch_fednl.py's bounds);
  * 4 spawned gloo ranks against the reference on 4 fake devices: bits
    exact every round, grad norms rtol 1e-6 + 1e-16 absolute where the
    reference's is >= 1e-12, the last norm < 1e-12.
"""

import json
import multiprocessing
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.api import accounting as j_accounting
from repro.core import FedNLConfig as JConfig
from repro.data import add_intercept, make_synthetic_logreg, partition_clients
from repro.distributed import (
    make_sharded_fednl_round as j_sharded_round,
    shard_problem as j_shard_problem,
    sharded_fednl_init as j_sharded_init,
)
import repro_torch.api as tapi
from repro_torch.api import accounting as t_accounting
from repro_torch.core.fednl import FedNLConfig, fednl_init, make_fednl_round
from repro_torch.distributed import (
    ShardedWorld,
    make_sharded_fednl_round,
    shard_problem,
    sharded_fednl_init,
    world_of_one,
)
from repro_torch.distributed.fednl_shard import check_shardable

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
GN_RTOL, GN_FLOOR = 1e-6, 1e-10
SPARSIFIERS = ["topk", "randk", "randseqk", "toplek"]
AGGREGATES = ["dense_psum", "sparse_allgather"]


def _z(n_clients=8, n_i=40, seed=1) -> np.ndarray:
    x, y = make_synthetic_logreg((24, n_clients, n_i), seed=seed)
    return np.asarray(partition_clients(add_intercept(x), y, n_clients, n_i, seed=seed))


@pytest.fixture(scope="module", autouse=True)
def _world():
    world_of_one(CPU)


def _port_rounds(z, comp, agg, rounds, payload_dtype=None):
    cfg = FedNLConfig(compressor=comp, lam=1e-3)
    zl = shard_problem(z, device="cpu")
    st = sharded_fednl_init(zl, cfg, seed=0)
    rf = make_sharded_fednl_round(zl, cfg, aggregate=agg, payload_dtype=payload_dtype)
    ms, hs = [], [st.h_global.numpy().copy()]
    for _ in range(rounds):
        st, m = rf(st)
        ms.append(m)
        hs.append(st.h_global.numpy().copy())
    return st, ms, hs


def _ref_rounds(z, comp, agg, rounds, payload_dtype=None):
    mesh = jax.make_mesh((1,), ("data",))
    cfg = JConfig(compressor=comp, lam=1e-3)
    zs = j_shard_problem(jnp.asarray(z), mesh)
    st = j_sharded_init(zs, cfg, mesh, seed=0)
    rf = jax.jit(j_sharded_round(zs, cfg, mesh, aggregate=agg, payload_dtype=payload_dtype))
    ms, hs = [], [np.asarray(st.h_global)]
    for _ in range(rounds):
        st, m = rf(st)
        ms.append(m)
        hs.append(np.asarray(st.h_global))
    return st, ms, hs


def _assert_matches_reference(got, want):
    (_, ms_t, hs_t), (_, ms_j, hs_j) = got, want
    for name in ("sent_elems", "sent_bits", "sent_bits_payload", "sent_bits_wire"):
        assert [int(getattr(m, name)) for m in ms_t] == [int(m[name]) for m in ms_j], name
    # each round's messages, summed: H^r+1 - H^r's support (from round 1:
    # round 0's corrections are 0 under hess0="exact")
    for r in range(2, len(hs_t)):
        support = hs_t[r] != hs_t[r - 1]
        assert support.any()
        np.testing.assert_array_equal(support, hs_j[r] != hs_j[r - 1])
    gn_t = np.array([float(m.grad_norm) for m in ms_t])
    gn_j = np.array([float(m["grad_norm"]) for m in ms_j])
    live = gn_j >= GN_FLOOR
    np.testing.assert_allclose(gn_t[live], gn_j[live], rtol=GN_RTOL, atol=0)


# ---------------------------------------------------------------------------
# (i) a world of one, in-process, on gloo
# ---------------------------------------------------------------------------

def test_world_of_one_matches_the_local_round():
    """TopK is deterministic: the sharded round is the local round but for
    the order of its sums."""
    z = _z()
    cfg = FedNLConfig(compressor="topk", lam=1e-3)
    zt = torch.as_tensor(z)
    st_ref, ref_round = fednl_init(zt, cfg, seed=0), make_fednl_round(zt, cfg)
    st_sh, ms, _ = _port_rounds(z, "topk", "dense_psum", 5)
    for _ in range(5):
        st_ref, m_ref = ref_round(st_ref)
    np.testing.assert_allclose(st_sh.x.numpy(), st_ref.x.numpy(), rtol=1e-12)
    np.testing.assert_allclose(float(ms[-1].grad_norm), float(m_ref.grad_norm), rtol=1e-10)


@pytest.mark.parametrize("agg", AGGREGATES)
@pytest.mark.parametrize("comp", SPARSIFIERS)
def test_world_of_one_matches_the_reference(comp, agg):
    """The same per-device PRNG streams (fold_in of the rank), the same
    messages: bits and support exact, grad norms within the parity bounds."""
    z = _z()
    _assert_matches_reference(_port_rounds(z, comp, agg, 6), _ref_rounds(z, comp, agg, 6))


# ---------------------------------------------------------------------------
# (ii) both aggregations converge; (iii) the reference's refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("agg", AGGREGATES)
def test_aggregations_converge(agg):
    _, ms, _ = _port_rounds(_z(), "topk", agg, 20)
    assert float(ms[-1].grad_norm) < 1e-12


def test_sparse_allgather_refuses_a_dense_compressor():
    z = _z()
    zl = shard_problem(z, device="cpu")
    with pytest.raises(ValueError, match="natural has no sparse form; use dense_psum"):
        make_sharded_fednl_round(zl, FedNLConfig(compressor="natural"), aggregate="sparse_allgather")
    # the reference refuses the same
    mesh = jax.make_mesh((1,), ("data",))
    with pytest.raises(ValueError, match="natural has no sparse form; use dense_psum"):
        j_sharded_round(j_shard_problem(jnp.asarray(z), mesh), JConfig(compressor="natural"),
                        mesh, aggregate="sparse_allgather")


def test_clients_not_divisible_by_the_world_are_refused():
    """The reference's message, from the rank count, before any rank spawns."""
    from repro_torch.compressors import get_compressor

    comp = get_compressor("topk", 325, 200)
    with pytest.raises(ValueError, match="n_clients=8 not divisible by mesh axis data=3"):
        check_shardable(8, 3, comp, "dense_psum")
    spec = tapi.ExperimentSpec(data=tapi.DataSpec(shape=(12, 8, 20), seed=1), rounds=2,
                               backend="sharded", devices=3)
    with pytest.raises(ValueError, match="n_clients=8 not divisible by mesh axis data=3"):
        tapi.solve(spec, device="cpu")
    assert ShardedWorld.live_count() == 0


def test_more_ranks_than_cards_is_refused(monkeypatch):
    """On the card a world larger than the machine's cards names both counts."""
    from repro_torch.distributed import world_size_for

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"devices=2 .* CUDA devices \(1\)"):
        world_size_for(2, torch.device("cuda"))
    assert world_size_for(None, torch.device("cuda")) == 1
    assert world_size_for(None, CPU) == 1 and world_size_for(4, CPU) == 4


# ---------------------------------------------------------------------------
# (iv) payload_dtype; (v) the collective's bit model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("comp", ["topk", "randseqk"])
def test_payload_dtype_float32_matches_the_reference(comp):
    z = _z()
    got = _port_rounds(z, comp, "sparse_allgather", 6, payload_dtype=torch.float32)
    want = _ref_rounds(z, comp, "sparse_allgather", 6, payload_dtype=jnp.float32)
    _assert_matches_reference(got, want)
    # the f32 payload changes the trajectory from the f64 one
    f64 = _port_rounds(z, comp, "sparse_allgather", 6)
    assert not np.array_equal(got[0].x.numpy(), f64[0].x.numpy())


@pytest.mark.parametrize("agg", AGGREGATES)
@pytest.mark.parametrize("t,k,n", [(325, 200, 8), (45451, 2408, 142), (1, 1, 1)])
def test_sharded_uplink_bits_is_the_reference(agg, t, k, n):
    got = t_accounting.sharded_uplink_bits(agg, t, k, n)
    assert got == j_accounting.sharded_uplink_bits(agg, t, k, n) and isinstance(got, int)
    assert t_accounting.SHARDED_AGGREGATES == j_accounting.SHARDED_AGGREGATES


def test_sharded_uplink_bits_refuses_an_unknown_aggregate():
    with pytest.raises(ValueError) as want:
        j_accounting.sharded_uplink_bits("ring", 10, 2, 3)
    with pytest.raises(ValueError) as got:
        t_accounting.sharded_uplink_bits("ring", 10, 2, 3)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the API: solve / open_session with backend="sharded"
# ---------------------------------------------------------------------------

def _api_specs(**kw):
    common = dict(rounds=20, seed=0, backend="sharded", tol=1e-10, **kw)
    return (
        tapi.ExperimentSpec(data=tapi.DataSpec(dataset="tiny", seed=1),
                            compressor=tapi.CompressorSpec("topk"), **common),
        japi.ExperimentSpec(data=japi.DataSpec(dataset="tiny", seed=1),
                            compressor=japi.CompressorSpec("topk"), **common),
    )


@pytest.mark.parametrize("agg", AGGREGATES)
def test_solve_sharded_runs_accounts_and_matches_the_reference(agg):
    """tests/test_api.py's sharded check on the port, then the reference's
    solve of the same spec: bits exact, grad norms within the bounds."""
    t_spec, j_spec = _api_specs(aggregate=agg)
    got = tapi.solve(t_spec, device="cpu")
    assert got.records[-1].grad_norm < 1e-10
    assert got.records[0].sent_bits == got.records[0].sent_bits_payload
    assert got.records[0].sent_bits_wire > got.records[0].sent_bits_payload
    assert got.extras == {"devices": 1, "aggregate": agg, "device": "cpu"}
    want = japi.solve(j_spec)
    assert got.rounds == want.rounds
    for col in ("sent_bits", "sent_bits_payload", "sent_bits_wire"):
        np.testing.assert_array_equal(getattr(got, col), getattr(want, col))
    live = want.grad_norms >= GN_FLOOR
    np.testing.assert_allclose(got.grad_norms[live], want.grad_norms[live], rtol=GN_RTOL)


@pytest.mark.parametrize("changes", [
    dict(algorithm="fednl-pp", tau=3),
    dict(algorithm="fednl-ls"),
    dict(topology="tree"),
])
def test_sharded_refuses_what_the_reference_refuses(changes):
    t_spec, j_spec = _api_specs()
    if changes.get("topology") == "tree":
        t_changes = dict(topology=tapi.TopologySpec(kind="tree"))
        j_changes = dict(topology=japi.TopologySpec(kind="tree"))
    else:
        t_changes = j_changes = changes
    with pytest.raises(ValueError) as want:
        japi.solve(j_spec.replace(**j_changes))
    with pytest.raises(ValueError) as got:
        tapi.solve(t_spec.replace(**t_changes), device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="does not support an x0"):
        tapi.solve(t_spec, x0=np.zeros(t_spec.data.dims()[0]), device="cpu")


def test_aggregate_and_devices_are_ignored_off_the_sharded_backend():
    spec = tapi.ExperimentSpec(data=tapi.DataSpec(shape=(12, 4, 20), seed=1), rounds=3)
    want = tapi.solve(spec, device="cpu")
    got = tapi.solve(spec.replace(aggregate="sparse_allgather", devices=2), device="cpu")
    assert [r.grad_norm for r in got.records] == [r.grad_norm for r in want.records]
    np.testing.assert_array_equal(got.x, want.x)


# ---------------------------------------------------------------------------
# (vi) spawned gloo ranks against the reference on fake devices
# ---------------------------------------------------------------------------

_REF_4_DEVICES = textwrap.dedent("""
    import json, os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from repro.data import make_synthetic_logreg, add_intercept, partition_clients
    from repro.core import FedNLConfig
    from repro.distributed import make_sharded_fednl_round, shard_problem, sharded_fednl_init

    assert jax.device_count() == 4
    x, y = make_synthetic_logreg((24, 8, 40), seed=1)
    z = jnp.asarray(partition_clients(add_intercept(x), y, 8, 40, seed=1))
    mesh = jax.make_mesh((4,), ("data",))
    zs = shard_problem(z, mesh)
    cfg = FedNLConfig(compressor="randseqk", lam=1e-3)
    out = {}
    for agg in ("dense_psum", "sparse_allgather"):
        st = sharded_fednl_init(zs, cfg, mesh, seed=0)
        rf = jax.jit(make_sharded_fednl_round(zs, cfg, mesh, aggregate=agg))
        gn, bits = [], []
        for _ in range(30):
            st, m = rf(st)
            gn.append(float(m["grad_norm"]))
            bits.append(int(m["sent_bits"]))
        out[agg] = {"grad_norm": gn, "sent_bits": bits}
    print("REF " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def ref_4_devices():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REF_4_DEVICES], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    line = next(ln for ln in out.stdout.splitlines() if ln.startswith("REF "))
    return json.loads(line[4:])


@pytest.mark.net
@pytest.mark.parametrize("agg", AGGREGATES)
def test_four_spawned_ranks_match_four_reference_devices(agg, ref_4_devices):
    want = ref_4_devices[agg]
    world = ShardedWorld(_z(), FedNLConfig(compressor="randseqk", lam=1e-3), 4, "cpu",
                         seed=0, aggregate=agg)
    try:
        world.acquire().release()  # a second holder lets go: the world stays up
        cols = world.step(30)
    finally:
        world.close(join_timeout=30)
    assert not any(p.is_alive() for p in world.procs) and world.exit_codes() == [0] * 4
    assert ShardedWorld.live_count() == 0
    assert cols["sent_bits"].tolist() == want["sent_bits"]
    gn, gn_ref = cols["grad_norm"], np.array(want["grad_norm"])
    live = gn_ref >= 1e-12
    assert np.all(np.abs(gn[live] - gn_ref[live]) <= GN_RTOL * gn_ref[live] + 1e-16)
    assert gn[-1] < 1e-12


@pytest.mark.net
def test_two_rank_session_restores_bit_for_bit(tmp_path):
    """devices=2: step 3, save (h_local gathered to rank 0), restore (each
    rank its block), run on: the uninterrupted 2-rank run bit for bit."""
    spec = tapi.ExperimentSpec(data=tapi.DataSpec(shape=(12, 4, 20), seed=1), rounds=7,
                               backend="sharded", devices=2, aggregate="sparse_allgather",
                               compressor=tapi.CompressorSpec("randk"))
    want = tapi.solve(spec, device="cpu")
    ck = tmp_path / "two.fnlsess"
    with tapi.open_session(spec, device="cpu") as s:
        s.step(3)
        s.save(ck)
    st = tapi.load_state(ck)
    assert st.arrays["state.h_local"].shape == (4, 78)
    with tapi.open_session(spec, restore=ck, device="cpu") as s:
        got = s.run()
    assert ShardedWorld.live_count() == 0
    assert [float(r.grad_norm).hex() for r in got.records] == \
        [float(r.grad_norm).hex() for r in want.records]
    assert [r.sent_bits for r in got.records] == [r.sent_bits for r in want.records]
    np.testing.assert_array_equal(got.x, want.x)
    assert got.extras["devices"] == 2


def test_a_sharded_tenant_is_its_own_session():
    """The serving engine runs a sharded spec on its solo lane: the tenant
    is its solve() bit for bit."""
    from repro_torch.serve_fednl import FedNLServer

    spec = tapi.ExperimentSpec(data=tapi.DataSpec(shape=(12, 4, 20), seed=1), rounds=5,
                               backend="sharded", aggregate="sparse_allgather")
    want = tapi.solve(spec, device="cpu")
    with FedNLServer(device="cpu") as srv:
        h = srv.submit(spec)
        srv.serve_until_idle(max_ticks=50)
        got = h.result()
    assert [float(r.grad_norm).hex() for r in got.records] == \
        [float(r.grad_norm).hex() for r in want.records]
    np.testing.assert_array_equal(got.x, want.x)


@pytest.mark.net
def test_a_failing_rank_raises_and_leaves_no_process():
    """A rank that fails (here: a checkpoint whose x has the wrong length)
    reports its traceback; the world is torn down, no rank left alive."""
    z = _z()
    cfg = FedNLConfig(compressor="topk", lam=1e-3)
    bad = {"state.x": np.zeros(3), "state.h_local": np.zeros((8, 325)),
           "state.h_global": np.zeros(325), "state.key": np.zeros(2, np.uint32),
           "state.round": np.asarray(0, np.int64)}
    with pytest.raises(RuntimeError, match="sharded rank [01] of 2 failed"):
        ShardedWorld(z, cfg, 2, "cpu", seed=0, aggregate="dense_psum", restore=bad)
    assert ShardedWorld.live_count() == 0
    assert not multiprocessing.active_children()
