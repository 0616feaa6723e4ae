"""The port's topology layer against repro.comm.topology on the CPU: the
specs, the AGG and SUBTREE payloads, trees of stars, bounded-staleness async
aggregation and elastic membership, masters of one package over aggregators
of the other, sessions restored by replay, FNLS1 files with a topology or a
membership, the cluster reference count, and (net marked) TCP process trees.

Tolerances: resolved trees, payload bytes, frame sizes, bits, participants
and joined/left cohorts are exact.  An exact tree equals the port's flat
star bit for bit (the root runs the star's aggregation on the same
operands).  Against the reference, grad norms agree within 1e-8 * norm +
1e-16 where the norm is at least 1e-10 (the star's bound: the two packages
sum FP64 in other orders).  combine="sum" reassociates the mean, so it is
held to the reference's own bound against the star: x within rtol 1e-12,
atol 1e-12; its analytic bits stay exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

import repro.api as japi
from repro.comm import protocol as jproto
from repro.comm import topology as jtopo
from repro.core.fednl import FedNLConfig as JConfig
import repro_torch.api as tapi
from repro_torch.api import (
    CompressorSpec,
    DataSpec,
    ExperimentSpec,
    MembershipEvent,
    MembershipSpec,
    TopologySpec,
    load_state,
    open_session,
    save_state,
    solve,
)
from repro_torch.comm import protocol, star, topology
from repro_torch.core.fednl import FedNLConfig

CPU = "cpu"
ALL_COMPRESSORS = ["identity", "topk", "randk", "randseqk", "toplek", "natural"]
RTOL, ATOL, GN_FLOOR = 1e-8, 1e-16, 1e-10
WIDE_SHAPE = (10, 8, 16)  # d, n_clients, n_i: room for depth-3 trees and membership
JOIN_LEAVE = MembershipSpec(events=(MembershipEvent(round=2, action="join", client=7),
                                    MembershipEvent(round=4, action="leave", client=0)))
ASYNC = TopologySpec(mode="async", staleness=2, max_delay=3, schedule_seed=0)
TREES = {
    "depth2": TopologySpec(kind="tree", fanout=2, depth=2),
    "depth3": TopologySpec(kind="tree", fanout=2, depth=3),
    "edges": TopologySpec(kind="tree", edges=((0, 3), (1, 2, 5), (4, 6, 7))),
}


def wide_spec(**overrides) -> ExperimentSpec:
    base = dict(data=DataSpec(shape=WIDE_SHAPE, seed=1), rounds=5, seed=0,
                backend="star-loopback")
    base.update(overrides)
    return ExperimentSpec(**base)


def ref_spec(spec: ExperimentSpec):
    """The same experiment as a repro.api spec (through the FNLS1 dict)."""
    return japi.session.spec_from_dict(tapi.session.spec_to_dict(spec))


def _ref_part(v):
    """A port TopologySpec or MembershipSpec as the reference's; else v."""
    if isinstance(v, TopologySpec):
        return jtopo.TopologySpec(**dataclasses.asdict(v))
    if isinstance(v, MembershipSpec):
        return jtopo.MembershipSpec(events=tuple(
            jtopo.MembershipEvent(**dataclasses.asdict(e)) for e in v.events))
    return v


def assert_reports_bit_identical(got, want):
    assert got.rounds == want.rounds
    for g, w in zip(got.records, want.records):
        assert float(g.grad_norm).hex() == float(w.grad_norm).hex()
        assert float(g.f).hex() == float(w.f).hex()
        assert (g.sent_bits, g.sent_bits_payload, g.sent_bits_wire) == (
            w.sent_bits, w.sent_bits_payload, w.sent_bits_wire)
        assert g.participants == w.participants
    np.testing.assert_array_equal(got.x, want.x)
    np.testing.assert_array_equal(got.extras["measured_frame_bytes"],
                                  want.extras["measured_frame_bytes"])


def assert_matches_reference(got, want):
    """Port against reference: norms within the star's bound; bits, bytes
    and participants exact."""
    assert got.rounds == want.rounds
    g, w = np.asarray(got.grad_norms), np.asarray(want.grad_norms)
    keep = w >= GN_FLOOR
    np.testing.assert_allclose(g[keep], w[keep], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.sent_bits, want.sent_bits)
    np.testing.assert_array_equal(got.sent_bits_payload, want.sent_bits_payload)
    np.testing.assert_array_equal(got.extras["measured_payload_bits"],
                                  want.extras["measured_payload_bits"])
    np.testing.assert_array_equal(got.extras["measured_frame_bytes"],
                                  want.extras["measured_frame_bytes"])
    assert [r.participants for r in got.records] == [r.participants for r in want.records]


# ---------------------------------------------------------------------------
# specs: resolution and validation, against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,fanout,depth", [(8, 2, 2), (7, 3, 2), (142, 4, 3), (142, 12, 2),
                                            (8, 2, 3), (5, 2, 4)])
def test_resolve_balanced_matches_reference(n, fanout, depth):
    got = TopologySpec(kind="tree", fanout=fanout, depth=depth).resolve(n)
    want = jtopo.TopologySpec(kind="tree", fanout=fanout, depth=depth).resolve(n)
    assert got == want
    assert topology.subtree_leaves(got) == jtopo.subtree_leaves(want) == list(range(n))


def test_resolve_explicit_edges_matches_reference():
    edges = ((0, 3), (1, 2, 5), (4, 6, 7))
    assert TopologySpec(kind="tree", edges=edges).resolve(8) == \
        jtopo.TopologySpec(kind="tree", edges=edges).resolve(8)
    for bad in (((0, 1), (2,)), ((0, 1, 2), (2, 3)), ((0, 1, 2, 3), ())):
        for pkg in (topology, jtopo):
            with pytest.raises(ValueError, match="partition"):
                pkg.TopologySpec(kind="tree", edges=bad).resolve(4)


@pytest.mark.parametrize("bad", [
    dict(kind="ring"), dict(combine="mean"), dict(mode="gossip"),
    dict(kind="tree", mode="async"), dict(kind="tree", fanout=1), dict(kind="tree", depth=1),
    dict(staleness=-1, mode="async"), dict(max_delay=-1), dict(staleness=1),
])
def test_topology_validation_raises_in_both(bad):
    with pytest.raises(ValueError) as port_err:
        TopologySpec(**bad)
    with pytest.raises(ValueError) as ref_err:
        jtopo.TopologySpec(**bad)
    assert str(port_err.value) == str(ref_err.value)


def test_membership_validation_matches_reference():
    for pkg in (topology, jtopo):
        with pytest.raises(ValueError, match="unknown membership action"):
            pkg.MembershipEvent(round=1, action="pause", client=0)
        with pytest.raises(ValueError, match=">= 0"):
            pkg.MembershipEvent(round=-1, action="join", client=0)
        spec = pkg.MembershipSpec(events=[pkg.MembershipEvent(1, "join", 9)])
        with pytest.raises(ValueError, match="outside"):
            spec.initial_active(4)
        every = pkg.MembershipSpec(events=[pkg.MembershipEvent(1, "join", i) for i in range(3)])
        with pytest.raises(ValueError, match="empty"):
            every.initial_active(3)
    t = MembershipSpec(events=list(JOIN_LEAVE.events))
    j = jtopo.MembershipSpec(events=[jtopo.MembershipEvent(2, "join", 7),
                                     jtopo.MembershipEvent(4, "leave", 0)])
    assert t.initial_active(8) == j.initial_active(8) == list(range(7))
    assert [dataclasses.astuple(e) for e in t.events_at(4)] == \
        [dataclasses.astuple(e) for e in j.events_at(4)]
    assert TopologySpec().trivial and MembershipSpec().trivial and not t.trivial


def test_experiment_spec_checks_match_reference():
    """Types checked, membership with the flat sync star only, and no
    topology or membership with partial participation: the reference's
    errors."""
    cases = [
        (dict(topology="tree"), TypeError),
        (dict(membership=[1]), TypeError),
        (dict(topology=TREES["depth2"], membership=JOIN_LEAVE), ValueError),
        (dict(algorithm="fednl-pp", topology=TREES["depth2"]), ValueError),
        (dict(algorithm="fednl-pp", membership=JOIN_LEAVE), ValueError),
    ]
    for changes, exc in cases:
        with pytest.raises(exc) as port_err:
            ExperimentSpec(**changes)
        with pytest.raises(exc) as ref_err:
            japi.ExperimentSpec(**{k: _ref_part(v) for k, v in changes.items()})
        assert str(port_err.value) == str(ref_err.value)
    # a trivial topology composes with membership, as in the reference
    ExperimentSpec(topology=TopologySpec(), membership=JOIN_LEAVE)


@pytest.mark.parametrize("changes,what", [
    (dict(topology=TREES["depth2"]), "topology"),
    (dict(topology=ASYNC), "topology"),
    (dict(membership=JOIN_LEAVE), "membership"),
])
def test_local_backend_refuses_with_the_reference_error(changes, what):
    spec = wide_spec(backend="local", **changes)
    with pytest.raises(ValueError) as port_err:
        solve(spec, device=CPU)
    with pytest.raises(ValueError) as ref_err:
        japi.solve(ref_spec(spec))
    assert str(port_err.value) == str(ref_err.value)
    assert f"non-trivial {what}" in str(port_err.value)
    with pytest.raises(ValueError, match=f"non-trivial {what}"):
        open_session(spec, device=CPU)


# ---------------------------------------------------------------------------
# payloads and frames: the reference's bytes
# ---------------------------------------------------------------------------

def _entries(seed):
    rng = np.random.default_rng(seed)
    return [(int(c), int(rng.integers(0, 50)), int(rng.integers(0, 1 << 40)),
             int(rng.integers(32, 4000)), rng.bytes(int(rng.integers(0, 300))))
            for c in (3, 0, 7, 2)]


def test_agg_entries_payload_and_frame_are_the_reference_bytes():
    entries = _entries(0)
    got = protocol.pack_agg_entries(entries)
    assert got == jproto.pack_agg_entries(entries)
    assert protocol.unpack_agg_entries(got) == jproto.unpack_agg_entries(got) == entries
    assert protocol.pack_agg_entries([]) == jproto.pack_agg_entries([])
    frame = protocol.Frame(type=protocol.MsgType.AGG, round=9, client=2, payload=got)
    jframe = jproto.Frame(type=jproto.MsgType.AGG, round=9, client=2, payload=got)
    assert protocol.pack_frame(frame) == jproto.pack_frame(jframe)
    with pytest.raises(ValueError, match="trailing"):
        protocol.unpack_agg_entries(got + b"\0")


def test_subtree_payload_and_frame_are_the_reference_bytes():
    for combine_id, ids in ((0, (5, 1, 3)), (1, ()), (0, range(142))):
        got = protocol.pack_subtree(combine_id, ids)
        assert got == jproto.pack_subtree(combine_id, ids)
        assert protocol.unpack_subtree(got) == jproto.unpack_subtree(got) == \
            (combine_id, tuple(sorted(ids)))
        frame = protocol.Frame(type=protocol.MsgType.SUBTREE, client=4, payload=got)
        assert protocol.pack_frame(frame) == jproto.pack_frame(
            jproto.Frame(type=jproto.MsgType.SUBTREE, client=4, payload=got))


def test_sum_payloads_layout_and_integer_fields_are_the_reference():
    """hsum and roundsum: the same layout (so the same bytes for the same
    vectors) and the integer fields exact through both unpackers."""
    rng = np.random.default_rng(3)
    d, t = 10, 55
    h = rng.standard_normal(t)
    got = protocol.pack_agg_hsum(6, torch.as_tensor(h))
    assert got == jproto.pack_agg_hsum(6, jnp.asarray(h)) and len(got) == 4 + 8 * t
    assert jproto.unpack_agg_hsum(got)[0] == protocol.unpack_agg_hsum(got)[0] == 6
    grad, s = rng.standard_normal(d), rng.standard_normal(t)
    fields = (5, d, 123_456_789_012, 987_654_321, 44_444)
    got = protocol.pack_agg_roundsum(*fields, 0.25, -1.5, torch.as_tensor(grad), s)
    assert got == jproto.pack_agg_roundsum(*fields, 0.25, -1.5, jnp.asarray(grad), jnp.asarray(s))
    assert len(got) == 48 + 8 * (d + t)
    mine, ref = protocol.unpack_agg_roundsum(got), jproto.unpack_agg_roundsum(got)
    assert mine[:4] == ref[:4] == (5, *fields[2:])
    assert (mine[4], mine[5]) == (0.25, -1.5)
    np.testing.assert_array_equal(mine[6], grad)
    np.testing.assert_array_equal(mine[7], np.asarray(ref[7]))


# ---------------------------------------------------------------------------
# trees of stars, async, elastic: against the port's flat star
# ---------------------------------------------------------------------------

_FLAT: dict = {}


def _flat(compressor):
    if compressor not in _FLAT:
        _FLAT[compressor] = solve(wide_spec(compressor=CompressorSpec(compressor)), device=CPU)
    return _FLAT[compressor]


@pytest.mark.parametrize("shape", sorted(TREES))
@pytest.mark.parametrize("compressor", ALL_COMPRESSORS)
def test_exact_tree_equals_the_flat_star_bitwise(compressor, shape):
    spec = wide_spec(compressor=CompressorSpec(compressor), topology=TREES[shape])
    got = solve(spec, device=CPU)
    assert_reports_bit_identical(got, _flat(compressor))
    np.testing.assert_array_equal(got.extras["measured_payload_bits"], got.sent_bits_payload)


def test_sum_tree_is_close_to_the_star_with_exact_bits():
    want = _flat("topk")
    got = solve(wide_spec(topology=TopologySpec(kind="tree", fanout=4, depth=2, combine="sum")),
                device=CPU)
    assert got.rounds == want.rounds
    np.testing.assert_allclose(got.x, want.x, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(got.sent_bits_payload, want.sent_bits_payload)
    np.testing.assert_array_equal(got.extras["measured_frame_bytes"],
                                  want.extras["measured_frame_bytes"])


def test_async_staleness_zero_equals_the_star_bitwise():
    got = solve(wide_spec(topology=TopologySpec(mode="async")), device=CPU)
    want = _flat("topk")
    assert [r.participants for r in got.records] == [tuple(range(8))] * 5
    for g, w in zip(got.records, want.records):
        assert float(g.grad_norm).hex() == float(w.grad_norm).hex()
        assert g.sent_bits == w.sent_bits
    np.testing.assert_array_equal(got.x, want.x)


def test_elastic_join_bits_are_accounted_exactly():
    d = WIDE_SHAPE[0]
    t_bits = d * (d + 1) // 2 * 64
    rep = solve(wide_spec(membership=JOIN_LEAVE, rounds=10), device=CPU)
    base = _flat("topk")
    per_up = base.records[1].sent_bits_payload // WIDE_SHAPE[1]
    per_frame = 8 * base.extras["measured_frame_bytes"][1] // WIDE_SHAPE[1]
    assert rep.records[2].sent_bits_payload - rep.records[1].sent_bits_payload == per_up + t_bits
    assert 8 * (rep.extras["measured_frame_bytes"][2] - rep.extras["measured_frame_bytes"][1]) \
        == per_frame + t_bits + 32 * 8
    assert rep.records[0].participants == tuple(range(7))
    assert rep.records[2].participants == tuple(range(8))
    assert rep.records[4].participants == tuple(range(1, 8))


def test_elastic_leave_retires_the_contribution_exactly():
    """After a leave, H_global is bitwise the mean of a fresh stack of the
    survivors' mirrors."""
    spec = wide_spec(membership=JOIN_LEAVE)
    m = topology.open_loopback_master(spec.data.build(), spec.fednl_config(),
                                      membership=JOIN_LEAVE, seed=spec.seed, device=CPU)
    m.init_handshake()
    for r in range(4):
        m.step_round(r)
    survivors = [c for c in m.order if c != 0]
    want = torch.mean(torch.stack([m._mirrors[c].clone() for c in survivors]), dim=0)
    ev = m._apply_events(4, m.x)
    assert ev["left"] == [0] and ev["joined"] == []
    assert torch.equal(m.h_global.view(torch.int64), want.view(torch.int64))
    assert m.order == survivors and 0 not in m._mirrors
    m.stop()


def test_make_master_picks_the_master_for_the_spec():
    spec = wide_spec()
    z, cfg = spec.data.build(), spec.fednl_config()
    cases = [(None, None, star.StarMaster), (TopologySpec(), None, star.StarMaster),
             (TREES["depth2"], None, topology.TreeMaster), (ASYNC, None, topology.AsyncStarMaster),
             (None, JOIN_LEAVE, topology.ElasticStarMaster)]
    for topo, mem, cls in cases:
        m = topology.open_loopback_master(z, cfg, topology=topo, membership=mem, device=CPU)
        assert type(m) is cls
        m.stop()
    with pytest.raises(ValueError, match="flat sync star only"):
        topology.open_loopback_master(z, cfg, topology=TREES["depth2"], membership=JOIN_LEAVE,
                                      device=CPU)


# ---------------------------------------------------------------------------
# against the reference: the same spec in both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("changes", [
    dict(topology=TREES["depth3"]),
    dict(topology=TREES["edges"], compressor=CompressorSpec("randk")),
    dict(topology=TopologySpec(kind="tree", fanout=4, depth=2, combine="sum")),
    dict(topology=ASYNC, rounds=8),
    dict(membership=JOIN_LEAVE, rounds=8),
], ids=["tree-depth3", "tree-edges-randk", "tree-sum", "async", "elastic"])
def test_port_matches_the_reference(changes):
    spec = wide_spec(**changes)
    got = solve(spec, device=CPU)
    want = japi.solve(ref_spec(spec))
    assert_matches_reference(got, want)


def _tree_fleet(pkg, z, cfg, topo, seed=0):
    if pkg == "port":
        return topology.make_loopback_tree(z, cfg, topo, seed=seed, device=CPU)
    return jtopo.make_loopback_tree(jnp.asarray(z), cfg, topo, seed=seed)


@pytest.mark.parametrize("compressor", ["topk", "randk"])
def test_port_tree_master_drives_reference_aggregators(compressor):
    spec = wide_spec(compressor=CompressorSpec(compressor), topology=TREES["depth3"])
    z = spec.data.build()
    topo = jtopo.TopologySpec(kind="tree", fanout=2, depth=3)
    conns, drive = _tree_fleet("ref", z, JConfig(compressor=compressor), topo)
    master = topology.make_master(conns, z.shape[-1], FedNLConfig(compressor=compressor),
                                  topology=TREES["depth3"], n_clients=8, drive=drive, device=CPU)
    master.init_handshake()
    got = [master.step_round(r) for r in range(4)]
    master.stop()
    want = solve(spec.replace(rounds=4), device=CPU)
    np.testing.assert_allclose([m["grad_norm"] for m in got], want.grad_norms, rtol=RTOL,
                               atol=ATOL)
    assert [m["sent_bits"] for m in got] == list(want.sent_bits)
    assert [m["measured_frame_bytes"] for m in got] == list(want.extras["measured_frame_bytes"])


@pytest.mark.parametrize("compressor", ["topk", "randk"])
def test_reference_tree_master_drives_port_aggregators(compressor):
    spec = wide_spec(compressor=CompressorSpec(compressor), topology=TREES["depth3"])
    z = spec.data.build()
    conns, drive = _tree_fleet("port", z, FedNLConfig(compressor=compressor), TREES["depth3"])
    topo = jtopo.TopologySpec(kind="tree", fanout=2, depth=3)
    master = jtopo.make_master(conns, z.shape[-1], JConfig(compressor=compressor), topology=topo,
                               n_clients=8, drive=drive)
    master.init_handshake()
    got = [master.step_round(r) for r in range(4)]
    master.stop()
    want = japi.solve(ref_spec(spec.replace(rounds=4)))
    np.testing.assert_allclose([m["grad_norm"] for m in got], want.grad_norms, rtol=RTOL,
                               atol=ATOL)
    assert [m["sent_bits"] for m in got] == list(want.sent_bits)
    assert [m["measured_frame_bytes"] for m in got] == list(want.extras["measured_frame_bytes"])


# ---------------------------------------------------------------------------
# sessions: restored by replay, FNLS1 across the packages, refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("changes,save_at", [
    (dict(topology=TREES["depth3"], compressor=CompressorSpec("randk")), 2),
    (dict(topology=TopologySpec(kind="tree", fanout=4, depth=2, combine="sum")), 2),
    (dict(topology=ASYNC), 3),
    (dict(membership=JOIN_LEAVE), 3),
], ids=["tree", "tree-sum", "async", "elastic"])
def test_session_restored_by_replay_is_bit_identical(tmp_path, changes, save_at):
    spec = wide_spec(rounds=8, **changes)
    want = solve(spec, device=CPU)
    path = tmp_path / "run.fnlsess"
    with open_session(spec, device=CPU) as s:
        s.step(save_at)
        s.save(path)
        stepped = s.run()
    with open_session(spec, restore=path, device=CPU) as s:
        assert s.round == save_at
        got = s.run()
    assert_reports_bit_identical(stepped, want)
    assert_reports_bit_identical(got, want)


def test_fnls1_with_topology_and_membership_crosses_the_packages(tmp_path):
    """Both packages write the same FNLS1 bytes for a spec with a topology
    (explicit edges) or a membership, read each other's file, and the port
    resumes a reference checkpoint within the parity bounds."""
    for changes in (dict(topology=TREES["edges"]), dict(membership=JOIN_LEAVE),
                    dict(topology=ASYNC)):
        spec = wide_spec(rounds=5, **changes)
        ref_path, port_path = tmp_path / "ref.fnlsess", tmp_path / "port.fnlsess"
        with japi.open_session(ref_spec(spec)) as s:
            s.step(2)
            s.save(ref_path)
        state = load_state(ref_path)
        assert state.spec == spec
        save_state(state, port_path)
        assert port_path.read_bytes() == ref_path.read_bytes()
        assert japi.load_state(port_path).spec == ref_spec(spec)
        with open_session(spec, restore=ref_path, device=CPU) as s:
            got = s.run()
        assert_matches_reference(got, japi.solve(ref_spec(spec)))


@pytest.mark.parametrize("saved,asked,field", [
    (dict(topology=TREES["depth2"]), dict(topology=TopologySpec(kind="tree", fanout=4)),
     "topology.fanout"),
    (dict(topology=TREES["depth2"]), dict(topology=None), "topology"),
    (dict(membership=JOIN_LEAVE), dict(membership=None), "membership"),
    (dict(membership=JOIN_LEAVE),
     dict(membership=MembershipSpec(events=(MembershipEvent(3, "join", 7),))),
     "membership.events"),
])
def test_restore_refuses_another_shape_or_other_events(tmp_path, saved, asked, field):
    spec = wide_spec(rounds=6, **saved)
    path = tmp_path / "run.fnlsess"
    with open_session(spec, device=CPU) as s:
        s.step(2)
        s.save(path)
    other = spec.replace(**asked)
    with pytest.raises(ValueError) as port_err:
        open_session(other, restore=path, device=CPU)
    with pytest.raises(ValueError) as ref_err:
        ref_spec(other).check_restore_from(ref_spec(spec))
    assert field + ":" in str(port_err.value)
    assert str(port_err.value) == str(ref_err.value)


# ---------------------------------------------------------------------------
# the cluster reference count
# ---------------------------------------------------------------------------

def _bare_cluster(cls):
    """A cluster with its lifecycle and a bound master socket, and no child
    processes: the reference count without a fleet."""
    from repro_torch.comm.transport import TCPMaster

    c = cls.__new__(cls)
    c._master = TCPMaster(1)
    c.procs, c.conns = [], {}
    c._init_lifecycle()
    return c


def test_cluster_reference_count_acquire_release_close():
    from repro_torch.launch.multiproc import ClientCluster, TreeClientCluster

    before = ClientCluster.live_count()
    a = _bare_cluster(ClientCluster)
    b = _bare_cluster(TreeClientCluster)
    assert ClientCluster.live_count() == before + 2
    assert a.acquire() is a
    a.release()
    assert not a.closed and ClientCluster.live_count() == before + 2
    a.release()  # the last holder
    assert a.closed and ClientCluster.live_count() == before + 1
    a.close()  # idempotent
    a.release()
    with pytest.raises(RuntimeError, match="closed"):
        a.acquire()
    b.acquire()
    b.close()  # forced, whatever the count
    assert b.closed and ClientCluster.live_count() == before
    c, d = _bare_cluster(ClientCluster), _bare_cluster(TreeClientCluster)
    assert ClientCluster.close_all() == before + 2
    assert c.closed and d.closed and ClientCluster.live_count() == 0


# ---------------------------------------------------------------------------
# star-tcp: process trees over localhost sockets
# ---------------------------------------------------------------------------

# two aggregator processes of one client process each: four processes
TCP_SPEC = ExperimentSpec(data=DataSpec(shape=(12, 2, 20), seed=1), rounds=4, seed=0,
                          backend="star-tcp", topology=TopologySpec(kind="tree", fanout=2, depth=2))


@pytest.mark.net
def test_tcp_tree_equals_the_loopback_tree_and_leaks_nothing():
    """A process tree: the loopback tree's trajectory bit for bit, and no
    cluster left live."""
    from repro_torch.launch.multiproc import ClientCluster

    before = ClientCluster.live_count()
    got = solve(TCP_SPEC, device=CPU)
    want = solve(TCP_SPEC.replace(backend="star-loopback"), device=CPU)
    assert_reports_bit_identical(got, want)
    assert ClientCluster.live_count() == before


@pytest.mark.net
def test_tcp_tree_session_resumes(tmp_path):
    want = solve(TCP_SPEC.replace(backend="star-loopback"), device=CPU)
    path = tmp_path / "tree_tcp.fnlsess"
    with open_session(TCP_SPEC, device=CPU) as s:
        s.step(2)
        s.save(path)
    with open_session(TCP_SPEC, restore=path, device=CPU) as s:
        got = s.run()
    assert_reports_bit_identical(got, want)
