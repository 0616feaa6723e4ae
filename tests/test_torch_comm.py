"""The port's wire stack against repro.comm on the CPU: the six codecs byte
for byte, the sparse forms, the protocol's frames, loopback runs that mix
the two packages' masters and clients, star-loopback against the port's
local backend, star sessions saved and restored, the pool plan, and (net
marked) a star-tcp run.

Tolerances: bytes, bits, frame sizes, index sets and sent_elems are exact.
Grad norms of two runs whose round ops differ only in the order of FP64
sums (a one-client batch against the whole batch, or the other package)
agree to rtol 1e-8 where the norm is at least 1e-10, with an absolute floor
of 1e-16 (below one ulp of the starting norm, ~0.1): once Newton's
convergence is quadratic, a difference of an ulp in x grows relative to a
grad norm that shrinks toward zero.
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
from repro.comm import star as jstar
from repro.comm import wire as jwire
from repro.comm.cost import CommCostModel as JCost
from repro.compressors import core as jcore
from repro.compressors import get_compressor as jget
from repro.core.fednl import FedNLConfig as JConfig
import repro_torch.api as tapi
from repro_torch.api import CompressorSpec, DataSpec, ExperimentSpec, open_session, solve, solve_many
from repro_torch.comm import protocol, star, wire
from repro_torch.comm.cost import DEFAULT_COST, CommCostModel
from repro_torch.comm.topology import make_master, open_loopback_master
from repro_torch.comm.transport import loopback_pair
from repro_torch.compressors import core as tcore
from repro_torch.compressors import get_compressor
from repro_torch.core.fednl import FedNLConfig

CPU = "cpu"
ALL_COMPRESSORS = ["identity", "topk", "randk", "randseqk", "toplek", "natural"]
RTOL, ATOL, GN_FLOOR = 1e-8, 1e-16, 1e-10


def _rows(t, seed):
    """Fixture rows: Gaussian, ties (values on a grid of 1/2), kept zeros
    (most entries 0.0), heavy-tailed magnitudes, and entries below f32's
    least subnormal (their rank key is 0, their value is not)."""
    rng = np.random.default_rng(seed)
    gauss = rng.standard_normal(t)
    ties = np.round(rng.standard_normal(t) * 2) / 2
    zeros = np.where(rng.uniform(size=t) < 0.7, 0.0, rng.standard_normal(t))
    heavy = rng.standard_normal(t) * np.exp(rng.uniform(-20, 0, t))
    tiny = np.where(rng.uniform(size=t) < 0.5, 0.0, rng.standard_normal(t))
    tiny[rng.uniform(size=t) < 0.2] = 1e-50
    return [gauss, ties, zeros, heavy, tiny]


# (T, k): k < T, k = T (TopLEK's boundary, delta = 1), k = 1
SHAPES = [(300, 37), (210, 160), (210, 210), (45, 45), (28, 1)]


def _bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float64).view(np.int64)


def _close_grad_norms(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    keep = want >= GN_FLOOR
    np.testing.assert_allclose(got[keep], want[keep], rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# codecs and sparse forms: the reference's bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ALL_COMPRESSORS)
@pytest.mark.parametrize("t,k", SHAPES)
def test_codec_bytes_equal_the_reference(name, t, k):
    """Same u and key: the port's encoded bytes, bits and sent_elems are the
    reference's, and both decodes give the same vector bit for bit, which is
    also the port's compressor output where that is exact (the round trip)."""
    jcodec = jwire.make_codec(jget(name, t, k), t)
    comp = get_compressor(name, t, k)
    tcodec = wire.make_codec(comp, t, CPU)
    for seed, u in enumerate(_rows(t, seed=t + k)):
        key = jax.random.PRNGKey(seed)
        want = jcodec.encode(key, jnp.asarray(u))
        got = tcodec.encode(np.array(key, dtype=np.uint32), torch.as_tensor(u))
        assert got.data == want.data, (name, seed)
        assert (got.bits, got.sent_elems) == (want.bits, want.sent_elems)
        assert len(got.data) == -(-got.bits // 8)
        dec = tcodec.decode(got.data, got.sent_elems).numpy()
        np.testing.assert_array_equal(_bits(dec), _bits(jcodec.decode(want.data, want.sent_elems)))
        if name != "toplek":  # TopLEK's dense form keeps the kept entries' -0.0/1e-50 as such
            keys = np.array(key, dtype=np.uint32)[None] if comp.draws else None
            dense, sent = comp.compress(keys, torch.as_tensor(u)[None])
            np.testing.assert_array_equal(dec, dense[0].numpy())
            assert int(sent[0]) == got.sent_elems


@pytest.mark.parametrize("name", ["topk", "randk", "randseqk", "toplek"])
@pytest.mark.parametrize("t,k", SHAPES)
def test_sparse_forms_equal_the_reference(name, t, k):
    """(idx, vals, sent) in lax.top_k's order, zero-padded past sent, from
    the selection kernels' index forms (their plain versions here)."""
    for seed, u in enumerate(_rows(t, seed=7 * t + k)):
        key = jax.random.PRNGKey(seed)
        keys = np.array(key, dtype=np.uint32)[None]
        ut = torch.as_tensor(u)[None]
        if name == "topk":
            want, got = jcore.topk_sparse(jnp.asarray(u), k), tcore.topk_sparse(ut, k)
        elif name == "randk":
            want, got = jcore.randk_sparse(key, jnp.asarray(u), k), tcore.randk_sparse(keys, ut, k)
        elif name == "randseqk":
            want = jcore.randseqk_sparse(key, jnp.asarray(u), k)
            got = tcore.randseqk_sparse(keys, ut, k)
        else:
            want = jcore.toplek_sparse(key, jnp.asarray(u), k)
            got = tcore.toplek_sparse(keys, ut, k)
        np.testing.assert_array_equal(got[0][0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(_bits(got[1][0].numpy()), _bits(want[1]))
        assert int(got[2][0]) == int(want[2])
        assert got[0].dtype == torch.int32


def test_sparse_forms_batch_rows_independently():
    rows = np.stack(_rows(210, seed=3))
    keys = np.stack([np.array(jax.random.PRNGKey(s), dtype=np.uint32) for s in range(len(rows))])
    for fn in (lambda u, kk: tcore.topk_sparse(u, 160),
               lambda u, kk: tcore.randk_sparse(kk, u, 160),
               lambda u, kk: tcore.randseqk_sparse(kk, u, 160),
               lambda u, kk: tcore.toplek_sparse(kk, u, 210)):
        batch = fn(torch.as_tensor(rows), keys)
        for c in range(len(rows)):
            one = fn(torch.as_tensor(rows[c])[None], keys[c][None])
            for a, b in zip(batch, one):
                assert torch.equal(a[c], b[0])


def test_kept_zeros_keep_their_index():
    """TopK with fewer non-zero entries than k keeps zeros: the index form
    names them (the lowest-index zeros), where the dense output cannot."""
    u = torch.zeros(1, 12, dtype=torch.float64)
    u[0, 3], u[0, 7] = 2.0, -1.0
    idx, vals, sent = tcore.topk_sparse(u, 5)
    assert idx[0].tolist() == [3, 7, 0, 1, 2] and vals[0].tolist() == [2.0, -1.0, 0.0, 0.0, 0.0]
    assert int(sent[0]) == 5
    msg = wire.make_codec(get_compressor("topk", 12, 5), 12).encode(None, u[0])
    assert np.frombuffer(msg.data[:20], "<u4").tolist() == [3, 7, 0, 1, 2]


@pytest.mark.parametrize("name", ALL_COMPRESSORS)
def test_bit_models_equal_the_reference(name):
    t, k, d = 300, 37, 24
    comp, jcomp = get_compressor(name, t, k), jget(name, t, k)
    for sent in (0, 1, k, t):
        s = torch.tensor(sent)
        assert wire.payload_bits(comp, sent) == int(jwire.payload_bits(jcomp, sent))
        assert int(wire.frame_bits(comp, s, d)) == int(jwire.frame_bits(jcomp, sent, d))
        assert int(wire.pp_message_bits(comp, s, d)) == int(jwire.pp_message_bits(jcomp, sent, d))
        assert int(wire.pp_frame_bits(comp, s, d)) == int(jwire.pp_frame_bits(jcomp, sent, d))
    assert wire.COMPRESSOR_IDS == jwire.COMPRESSOR_IDS
    assert wire.COMPRESSOR_NAMES == jwire.COMPRESSOR_NAMES
    assert wire.NATURAL_SCALE == jwire.NATURAL_SCALE


def test_codec_refuses_a_compressor_without_one():
    comp = dataclasses.replace(get_compressor("topk", 10, 2), name="custom")
    with pytest.raises(KeyError, match="no wire codec"):
        wire.make_codec(comp, 10)


# ---------------------------------------------------------------------------
# protocol
# ---------------------------------------------------------------------------

def test_msg_types_and_header_are_the_reference():
    assert {m.name: int(m) for m in protocol.MsgType} == {m.name: int(m) for m in jproto.MsgType}
    assert (protocol.MAGIC, protocol.HEADER_FMT, protocol.HEADER_SIZE) == (
        jproto.MAGIC, jproto.HEADER_FMT, jproto.HEADER_SIZE)


@pytest.mark.parametrize("mtype", ["HELLO", "INIT", "INIT_ACK", "ROUND", "UPLINK", "STOP",
                                   "SELECT", "PP_UPDATE", "DROP"])
def test_frames_pack_to_the_reference_bytes(mtype):
    fields = dict(round=7, client=3, comp_id=4, sent_elems=11, payload_bits=2**40 + 5,
                  payload=bytes(range(37)))
    got = protocol.pack_frame(protocol.Frame(type=protocol.MsgType[mtype], **fields))
    want = jproto.pack_frame(jproto.Frame(type=jproto.MsgType[mtype], **fields))
    assert got == want
    frame, plen = protocol.unpack_header(got[: protocol.HEADER_SIZE])
    assert plen == 37 and frame.type.name == mtype and frame.payload_bits == 2**40 + 5
    a, b = loopback_pair()
    assert protocol.send_frame(a, protocol.Frame(type=protocol.MsgType[mtype], **fields)) == len(got)
    back = protocol.recv_frame(b)
    assert back == protocol.Frame(type=protocol.MsgType[mtype], **fields)
    assert back.wire_bytes == len(got) and b.pending() == 0


def test_payload_layouts_are_the_reference_bytes():
    rng = np.random.default_rng(0)
    x, h, g = rng.standard_normal(5), rng.standard_normal(15), rng.standard_normal(5)
    enc = wire.EncodedMessage(b"\x01\x02\x03", 24, 3)
    jenc = jwire.EncodedMessage(b"\x01\x02\x03", 24, 3)
    assert protocol.pack_vector(torch.as_tensor(x)) == jproto.pack_vector(x)
    assert protocol.pack_uplink(x, 0.5, -2.0, enc) == jproto.pack_uplink(jnp.asarray(x), 0.5, -2.0, jenc)
    assert protocol.pack_select(2, 4, x) == jproto.pack_select(2, 4, x)
    assert protocol.pack_pp_state(h, 0.25, g) == jproto.pack_pp_state(h, 0.25, g)
    assert protocol.pack_pp_update(enc, 0.125, g) == jproto.pack_pp_update(jenc, 0.125, g)
    grad, l, f, rest = protocol.unpack_uplink(protocol.pack_uplink(x, 0.5, -2.0, enc), 5)
    assert np.array_equal(grad, x) and (l, f, rest) == (0.5, -2.0, b"\x01\x02\x03")
    slot, tau, xs = protocol.unpack_select(protocol.pack_select(2, 4, x))
    assert (slot, tau) == (2, 4) and np.array_equal(xs, x)
    hh, ll, gg = protocol.unpack_pp_state(protocol.pack_pp_state(h, 0.25, g), 5)
    assert np.array_equal(hh, h) and ll == 0.25 and np.array_equal(gg, g)
    rest, dl, dg = protocol.unpack_pp_update(protocol.pack_pp_update(enc, 0.125, g), 5)
    assert rest == b"\x01\x02\x03" and dl == 0.125 and np.array_equal(dg, g)


def test_frame_rejects_bad_magic():
    data = bytearray(protocol.pack_frame(protocol.Frame(type=protocol.MsgType.STOP)))
    data[:4] = b"XXXX"
    with pytest.raises(ValueError, match="bad magic"):
        protocol.unpack_header(bytes(data[: protocol.HEADER_SIZE]))


def test_loopback_underrun_is_loud():
    a, b = loopback_pair()
    a.send(b"abc")
    with pytest.raises(RuntimeError, match="underrun"):
        b.recv_exact(4)


def test_cost_model_is_the_reference():
    for kw in ({}, dict(master_shared_nic=False), dict(bandwidth_bps=1e8, latency_s=1e-3)):
        got, want = CommCostModel(**kw), JCost(**kw)
        assert got.transfer_s(1e6) == want.transfer_s(1e6)
        assert got.round_s(8e6, 1e4, 8) == want.round_s(8e6, 1e4, 8)
        assert got.run_s([1e6, 2e6], 1e4, 8) == want.run_s([1e6, 2e6], 1e4, 8)
    assert DEFAULT_COST == CommCostModel()


# ---------------------------------------------------------------------------
# loopback runs across the packages
# ---------------------------------------------------------------------------

ROUNDS = 5


@pytest.fixture(scope="module")
def tiny_z():
    return DataSpec(dataset="tiny").build()


def _configs(compressor):
    return FedNLConfig(compressor=compressor), JConfig(compressor=compressor)


def _reference_run(z, compressor):
    return jstar.run_loopback(jnp.asarray(z), _configs(compressor)[1], rounds=ROUNDS, seed=0)


def _check_same_run(got, want):
    _close_grad_norms(got.grad_norms, want.grad_norms)
    np.testing.assert_array_equal(got.sent_bits, want.sent_bits)
    np.testing.assert_array_equal(got.measured_payload_bits, want.measured_payload_bits)
    np.testing.assert_array_equal(got.measured_frame_bytes, want.measured_frame_bytes)
    np.testing.assert_array_equal(got.measured_payload_bits, got.sent_bits)


@pytest.mark.parametrize("compressor", ["topk", "randk"])
def test_port_master_drives_reference_clients(tiny_z, compressor):
    cfg, jcfg = _configs(compressor)
    n, _, d = tiny_z.shape
    conns, clients = {}, []
    for i in range(n):
        a, b = loopback_pair()
        conns[i] = a
        clients.append(jstar.StarClient(i, n, jnp.asarray(tiny_z[i]), jcfg, b, seed=0))

    def drive():
        for c in clients:
            while c.conn.pending():
                if not c.serve_once():
                    break

    got = star.run_star_master(conns, d, cfg, rounds=ROUNDS, drive=drive, device=CPU)
    _check_same_run(got, _reference_run(tiny_z, compressor))


@pytest.mark.parametrize("compressor", ["topk", "randk"])
def test_reference_master_drives_port_clients(tiny_z, compressor):
    cfg, jcfg = _configs(compressor)
    n, _, d = tiny_z.shape
    conns, clients = {}, []
    for i in range(n):
        a, b = loopback_pair()
        conns[i] = a
        clients.append(star.StarClient(i, n, tiny_z[i], cfg, b, seed=0, device=CPU))

    def drive():
        for c in clients:
            while c.conn.pending():
                if not c.serve_once():
                    break

    got = jstar.run_star_master(conns, d, jcfg, rounds=ROUNDS, drive=drive)
    _check_same_run(got, _reference_run(tiny_z, compressor))


# ---------------------------------------------------------------------------
# star-loopback against the port's local backend
# ---------------------------------------------------------------------------

def _spec(compressor, **kw):
    kw.setdefault("rounds", 10)
    return ExperimentSpec(data=DataSpec(dataset="tiny"), compressor=CompressorSpec(compressor),
                          **kw)


@pytest.mark.parametrize("compressor", ALL_COMPRESSORS)
def test_star_loopback_matches_local(compressor):
    spec = _spec(compressor)
    got = solve(spec.replace(backend="star-loopback"), device=CPU)
    want = solve(spec, device=CPU)
    _close_grad_norms(got.grad_norms, want.grad_norms)
    np.testing.assert_array_equal(got.sent_bits, want.sent_bits)
    np.testing.assert_array_equal(got.extras["measured_payload_bits"], got.sent_bits_payload)
    assert got.extras["device"] == "cpu" and got.rounds == 10


def test_star_loopback_wire_accounting_is_the_measured_frames():
    spec = _spec("toplek", accounting="wire")
    got = solve(spec.replace(backend="star-loopback"), device=CPU)
    want = solve(spec, device=CPU)
    np.testing.assert_array_equal(got.sent_bits, 8 * got.extras["measured_frame_bytes"])
    np.testing.assert_array_equal(got.sent_bits, want.sent_bits)


def test_star_loopback_hess0_zero_and_tol_stop():
    spec = _spec("topk", hess0="zero", tol=1e-6, rounds=30)
    got = solve(spec.replace(backend="star-loopback"), device=CPU)
    want = solve(spec, device=CPU)
    assert got.rounds == want.rounds < 30
    _close_grad_norms(got.grad_norms, want.grad_norms)


def test_star_run_loopback_is_the_backend():
    spec = _spec("randseqk")
    res = star.run_loopback(spec.data.build(), spec.fednl_config(), rounds=10, seed=0, device=CPU)
    rep = solve(spec.replace(backend="star-loopback"), device=CPU)
    np.testing.assert_array_equal(res.grad_norms, rep.grad_norms)
    np.testing.assert_array_equal(res.x, rep.x)
    np.testing.assert_array_equal(res.measured_frame_bytes, rep.extras["measured_frame_bytes"])


# ---------------------------------------------------------------------------
# sessions, the topology seam, the pool plan
# ---------------------------------------------------------------------------

def test_star_session_restored_by_replay_is_bit_identical(tmp_path):
    spec = _spec("randk", backend="star-loopback", rounds=6)
    want = solve(spec, device=CPU)
    with open_session(spec, device=CPU) as s:
        s.step(3)
        path = s.save(tmp_path / "star.fnlsess")
    state = tapi.session.load_state(path)
    assert set(state.arrays) == {"x", "h_global", "x_hist", "measured_payload_bits",
                                 "measured_frame_bytes"}
    assert state.arrays["x_hist"].shape == (3, 24)
    with open_session(spec, restore=path, device=CPU) as s2:
        got = s2.run()
    np.testing.assert_array_equal(_bits(got.grad_norms), _bits(want.grad_norms))
    np.testing.assert_array_equal(_bits(got.x), _bits(want.x))
    np.testing.assert_array_equal(got.sent_bits, want.sent_bits)
    np.testing.assert_array_equal(got.extras["measured_frame_bytes"],
                                  want.extras["measured_frame_bytes"])


def test_star_checkpoint_crosses_the_packages(tmp_path):
    """A reference star-loopback checkpoint resumes in the port (the FNLS1
    arrays are the same), and the run goes on as the reference's."""
    jspec = japi.ExperimentSpec(compressor=japi.CompressorSpec("topk"), rounds=6,
                                backend="star-loopback")
    with japi.open_session(jspec) as s:
        s.step(3)
        path = s.save(tmp_path / "ref.fnlsess")
    want = japi.solve(jspec)
    with open_session(_spec("topk", backend="star-loopback", rounds=6), restore=path,
                      device=CPU) as s2:
        got = s2.run()
    _close_grad_norms(got.grad_norms, want.grad_norms)
    np.testing.assert_array_equal(got.sent_bits, want.sent_bits)


def test_topology_seam_builds_the_flat_star_only(tiny_z):
    """The construction seam builds the flat star's StarMaster (with the star's
    drive) for no topology or a trivial one, and the reference's master for
    a tree, async aggregation or membership events; the local backend and a
    tree with membership events are refused with the reference's errors."""
    from repro_torch.comm import topology

    cfg = FedNLConfig()
    for trivial in (None, topology.TopologySpec()):
        master = open_loopback_master(tiny_z, cfg, topology=trivial, device=CPU)
        assert type(master) is star.StarMaster
        master.stop()
    tree = topology.TopologySpec(kind="tree", fanout=2, depth=2)
    conns = {i: loopback_pair()[0] for i in range(2)}
    assert type(make_master(conns, 24, cfg, topology=tree, n_clients=8, device=CPU)) is \
        topology.TreeMaster
    leave = topology.MembershipSpec(events=(topology.MembershipEvent(1, "leave", 0),))
    master = open_loopback_master(tiny_z, cfg, membership=leave, device=CPU)
    assert type(master) is topology.ElasticStarMaster
    master.stop()
    with pytest.raises(ValueError, match="flat sync star only"):
        make_master(conns, 24, cfg, topology=tree, membership=leave, device=CPU)
    spec = _spec("topk", topology=tree)
    with pytest.raises(ValueError) as port_err:
        solve(spec, device=CPU)
    with pytest.raises(ValueError) as ref_err:
        japi.solve(japi.session.spec_from_dict(tapi.session.spec_to_dict(spec)))
    assert str(port_err.value) == str(ref_err.value)
    assert "cannot run a non-trivial topology" in str(port_err.value)


def test_pool_plan_runs_the_wire_specs():
    specs = [_spec("topk", backend="star-loopback", rounds=4, seed=s) for s in range(3)]
    rep = solve_many(specs, device=CPU)
    assert any(line.startswith("pool: 3 specs on star-loopback") for line in rep.log)
    for spec, got in zip(specs, rep.reports):
        want = solve(spec, device=CPU)
        np.testing.assert_array_equal(got.grad_norms, want.grad_norms)
        np.testing.assert_array_equal(got.sent_bits, want.sent_bits)


def test_star_client_keys_are_the_local_rounds_keys():
    """Each client's per-round key is split(sub, n)[client]: what the local
    round hands that client."""
    from repro_torch import prng

    client = star.StarClient(5, 8, np.zeros((3, 4)), FedNLConfig(), loopback_pair()[1],
                             seed=7, device=CPU)
    key = prng.prng_key(7)
    for _ in range(3):
        key, sub = prng.split(key, 2)
        assert np.array_equal(client._round_key(), prng.split(sub, 8)[5])


# ---------------------------------------------------------------------------
# star-tcp: client processes over localhost sockets
# ---------------------------------------------------------------------------

@pytest.mark.net
def test_star_tcp_matches_star_loopback():
    """Three client processes, five rounds at tiny's widths: the same bytes
    and bits as loopback, norms within the tolerance, and every child exits
    within the test's own deadline."""
    from repro_torch.launch.multiproc import ClientCluster

    spec = ExperimentSpec(data=DataSpec(shape=(24, 3, 40)), compressor=CompressorSpec("randk"),
                          rounds=5)
    cfg = spec.fednl_config()
    cluster = ClientCluster(None, spec.data.shape, spec.seed, cfg=cfg, device=CPU,
                            accept_timeout=60.0)
    try:
        got = star.run_star_master(cluster.conns, cluster.d, cfg, rounds=5, device=CPU)
    finally:
        cluster.close(join_timeout=30.0)
    assert cluster.exit_codes() == [0, 0, 0]
    want = solve(spec.replace(backend="star-loopback"), device=CPU)
    _close_grad_norms(got.grad_norms, want.grad_norms)
    np.testing.assert_array_equal(got.sent_bits, want.sent_bits)
    np.testing.assert_array_equal(got.measured_frame_bytes, want.extras["measured_frame_bytes"])
