"""The port's gateway (repro_torch.gateway) and spec wire form
(repro_torch.api.specwire) on the CPU, against repro.gateway and
repro.api.specwire.

Mirrors tests/test_gateway.py:

  * ``encode_spec`` bytes equal the reference's for specs with topology,
    membership and fault; the same dotted-name and version-skew errors;
  * every gateway frame (SUBMIT, RECORD, STREAM_END, RESULT, the JSON
    frames, GW_ERR) is byte for byte the reference's;
  * a live port server and client on 127.0.0.1: submit, stream, result, bit
    for bit the port's ``solve``; synchronous errors naming the field;
    status, cancel and evict; a slow observer's counted drops; METRICS with
    the recorder off and on;
  * a port client with a reference server, and a reference client with a
    port server.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import repro.api as japi
import repro.gateway as jgw
import repro.serve_fednl as jserve
from repro.gateway import protocol as jproto
from repro_torch.api import (
    CompressorSpec,
    DataSpec,
    ExperimentSpec,
    FaultSpec,
    MembershipEvent,
    MembershipSpec,
    TopologySpec,
    decode_spec,
    encode_spec,
    solve,
)
from repro_torch.api.session import spec_to_dict
from repro_torch.comm.protocol import Frame, MsgType, pack_frame, recv_frame
from repro_torch.gateway import GatewayClient, GatewayConfig, GatewayError, GatewayServer
from repro_torch.gateway import protocol as gw
from repro_torch.serve_fednl import ServeConfig, SubmitOptions

CPU = "cpu"
SHAPE = (12, 4, 20)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def spec_of(seed=0, comp="topk", rounds=6, km=8.0, **overrides):
    return ExperimentSpec(
        data=DataSpec(shape=SHAPE, seed=1),
        algorithm="fednl",
        compressor=CompressorSpec(comp, km),
        rounds=rounds,
        seed=seed,
        **overrides,
    )


def to_reference(spec):
    return japi.session.spec_from_dict(spec_to_dict(spec))


_SOLO: dict = {}


def solo_report(spec):
    """The port's own solve on the CPU (cached per spec)."""
    if spec not in _SOLO:
        _SOLO[spec] = solve(spec, device=CPU)
    return _SOLO[spec]


def hex_traj(records):
    return [
        (float(r.grad_norm).hex() if r.grad_norm is not None else None,
         r.sent_bits, r.sent_bits_payload, r.sent_bits_wire)
        for r in records
    ]


def _run_in_thread(server):
    ready = threading.Event()
    addr = {}

    def announce(host, port):
        addr["host"], addr["port"] = host, port
        ready.set()

    thread = threading.Thread(target=server.run, kwargs={"ready": announce}, daemon=True)
    thread.start()
    assert ready.wait(60), "gateway did not bind"
    return addr["host"], addr["port"], thread


@pytest.fixture
def gateway():
    """A port gateway on an ephemeral localhost port, its engine on the CPU."""
    server = GatewayServer(
        GatewayConfig(port=0, serve=ServeConfig(max_resident=2, admit_per_tick=2)), device=CPU)
    host, port, thread = _run_in_thread(server)
    yield host, port, server
    server.request_stop()
    thread.join(30)
    assert not thread.is_alive()


# ---------------------------------------------------------------------------
# the wire: specwire and the frames, byte for byte the reference's
# ---------------------------------------------------------------------------

WIRE_SPECS = [
    spec_of(seed=3, comp="randk", rounds=7, lam=1e-3, mu=0.0),
    spec_of(seed=1, backend="star-loopback", fault=None,
            topology=TopologySpec(kind="tree", fanout=2, depth=2)),
    spec_of(seed=2, backend="star-loopback", topology=TopologySpec(mode="async", staleness=2,
                                                                    max_delay=3)),
    spec_of(seed=4, backend="star-loopback",
            membership=MembershipSpec(events=(MembershipEvent(2, "join", 3),
                                              MembershipEvent(4, "leave", 0)))),
    ExperimentSpec(data=DataSpec(shape=SHAPE, seed=1), algorithm="fednl-pp", tau=2,
                   backend="star-loopback", fault=FaultSpec(drop_prob=0.25, seed=7),
                   compressor=CompressorSpec("natural", 4.0, 0.5), rounds=3),
]


@pytest.mark.parametrize("idx", range(len(WIRE_SPECS)))
def test_specwire_bytes_are_the_references(idx):
    spec = WIRE_SPECS[idx]
    data = encode_spec(spec)
    assert data == japi.encode_spec(to_reference(spec))
    assert decode_spec(data) == spec
    assert japi.decode_spec(data) == to_reference(spec)


def test_specwire_errors_are_the_references():
    base = json.loads(encode_spec(WIRE_SPECS[3]).decode())
    cases = []
    for path, key in ((("spec",), "frobnicate"), (("spec", "data"), "warp"),
                      (("spec", "compressor"), "zeta"),
                      (("spec", "membership", "events", 0), "when"),
                      (("spec",), None)):
        payload = json.loads(json.dumps(base))
        node = payload
        for p in path:
            node = node[p]
        if key is None:
            payload["spec_wire_version"] = 99
        else:
            node[key] = 1
        cases.append(payload)
    topo = json.loads(encode_spec(WIRE_SPECS[1]).decode())
    topo["spec"]["topology"]["leaves"] = 1
    cases.append(topo)
    cases += [{"spec": {}}, {"spec_wire_version": 1, "spec": {}, "extra": 1}]
    for payload in cases:
        with pytest.raises(ValueError) as port_err:
            gw.decode_spec_dict(payload)
        with pytest.raises(ValueError) as ref_err:
            jproto.decode_spec_dict(payload)
        assert str(port_err.value).replace("repro_torch", "repro") == str(ref_err.value)
    with pytest.raises(ValueError, match="not valid JSON"):
        decode_spec(b"\xff\xfe not json")


def test_every_gateway_frame_is_the_references():
    spec = spec_of(seed=0, rounds=4)
    j_spec = to_reference(spec)
    rep = solo_report(spec)
    j_rep = dataclasses.replace(
        japi.solve(j_spec), wall_time_s=rep.wall_time_s, init_time_s=rep.init_time_s)
    # the port's report with the reference's numbers: the codec, not the run
    rep_as_ref = dataclasses.replace(rep, x=np.asarray(j_rep.x), records=[
        type(rep.records[0])(**dataclasses.asdict(r)) for r in j_rep.records],
        extras=dict(j_rep.extras))
    opts = SubmitOptions(priority="high")
    assert gw.pack_submit(spec, until=5, tenant_id="a", options=opts) == jproto.pack_submit(
        j_spec, until=5, tenant_id="a", options=jserve.SubmitOptions(priority="high"))
    assert gw.pack_submit(spec, until=1e-9) == jproto.pack_submit(j_spec, until=1e-9)
    back = gw.unpack_submit(gw.pack_submit(spec, until=5, tenant_id="a", options=opts))
    assert back == (spec, 5, "a", opts)
    for i, r in enumerate(rep_as_ref.records):
        assert pack_frame(gw.pack_record("t0000", i, r)) == jproto.pack_frame(
            jproto.pack_record("t0000", i, j_rep.records[i]))
        assert hex_traj([gw.unpack_record(gw.pack_record("t", i, r).payload)[2]]) == \
            hex_traj([r])
    # a PP record carries its model as a blob
    pp = solve(WIRE_SPECS[4].replace(backend="local", fault=None), device=CPU)
    frame = gw.pack_record("t1", 0, pp.records[0])
    back_pp = gw.unpack_record(frame.payload)[2]
    np.testing.assert_array_equal(back_pp.x, pp.records[0].x)
    assert back_pp.participants == pp.records[0].participants
    assert gw.pack_report(rep_as_ref) == jproto.pack_report(j_rep)
    report = gw.unpack_report(gw.pack_report(rep))
    assert report.spec == spec and hex_traj(report.records) == hex_traj(rep.records)
    np.testing.assert_array_equal(report.x, rep.x)
    assert pack_frame(gw.pack_stream_end("t", 3, "finished")) == jproto.pack_frame(
        jproto.pack_stream_end("t", 3, "finished"))
    for mt in (MsgType.STATUS, MsgType.STREAM, MsgType.GW_OK, MsgType.METRICS):
        obj = {"tenant_id": "t0001", "from_start": False, "n": 3}
        assert pack_frame(gw.pack_json(mt, obj)) == jproto.pack_frame(
            jproto.pack_json(jproto.MsgType(int(mt)), obj))
    for exc in (ValueError("options.priority: unknown priority class 'x'"),
                KeyError("no tenant 't9'"), ValueError("spec wire payload has unknown "
                                                       "field(s): data.warp (this build)"),
                TypeError("until must be None")):
        assert pack_frame(gw.error_frame(exc)) == jproto.pack_frame(jproto.error_frame(exc))


# ---------------------------------------------------------------------------
# a live port gateway
# ---------------------------------------------------------------------------

def test_submit_stream_result_bit_parity(gateway):
    host, port, _server = gateway
    specs = [spec_of(seed=0, comp="topk", rounds=6), spec_of(seed=1, comp="randk", rounds=4),
             spec_of(seed=2, comp="randseqk", rounds=7)]
    prios = ["high", "normal", "low"]
    with GatewayClient(host, port) as gwc:
        handles = [gwc.submit(s, priority=p) for s, p in zip(specs, prios)]
        assert [h.priority for h in handles] == prios and handles[0].lane == "batch"
        with GatewayClient(host, port) as observer:
            streamed = list(observer.stream(handles[0].id))
            assert observer.stream_drops == 0
        reports = [gwc.result(h.id) for h in handles]
    for spec, rep in zip(specs, reports):
        want = solo_report(spec)
        assert hex_traj(rep.records) == hex_traj(want.records)
        np.testing.assert_array_equal(rep.x, want.x)
        assert rep.spec == spec and rep.extras["served"] is True
    assert hex_traj(streamed) == hex_traj(solo_report(specs[0]).records)


def test_submit_errors_are_synchronous_and_name_the_field(gateway):
    host, port, _server = gateway
    with GatewayClient(host, port) as gwc:
        with pytest.raises(GatewayError, match="unknown priority class") as err:
            gwc.submit(spec_of(), priority="platinum")
        assert err.value.field == "options.priority"
        raw = json.loads(encode_spec(spec_of()).decode())
        raw["spec"]["data"]["warp"] = 1
        payload = gw._pack({"spec_wire_version": 1, "spec": raw["spec"], "until": None,
                            "tenant_id": None, "options": None})
        with pytest.raises(GatewayError, match=r"data\.warp") as err:
            gwc._rpc(Frame(type=MsgType.SUBMIT, payload=payload))
        assert err.value.field == "data.warp"
        with pytest.raises(GatewayError):
            gwc.submit(spec_of(comp="no-such-compressor"))
        h = gwc.submit(spec_of(seed=5, rounds=3))  # the engine is still healthy
        assert gwc.result(h.id).rounds == 3


def test_status_cancel_evict_over_the_wire(gateway):
    host, port, server = gateway
    with GatewayClient(host, port) as gwc:
        h1 = gwc.submit(spec_of(seed=0, rounds=60))
        h2 = gwc.submit(spec_of(seed=1, rounds=60))
        st = gwc.status(h1.id)
        assert st["tenant_id"] == h1.id and st["status"] in ("queued", "running", "spilled")
        gwc.cancel(h1.id)
        with pytest.raises(GatewayError, match="cancelled"):
            gwc.result(h1.id)
        path = gwc.evict(h2.id)
        with pytest.raises(GatewayError, match="evicted"):
            gwc.result(h2.id)
        stats = gwc.status()
        assert stats["cancelled"] == 1 and stats["evicted"] == 1
        with pytest.raises(GatewayError, match="no tenant"):
            gwc.status("t9999")
    # the evicted checkpoint resumes server-side, driven by the gateway's tick loop
    spec = spec_of(seed=1, rounds=60)
    h3 = server.engine.resume(path)
    assert h3.wait(180), "resumed tenant never finished"
    got = h3.result()
    assert hex_traj(got.records) == hex_traj(solo_report(spec).records)
    np.testing.assert_array_equal(got.x, solo_report(spec).x)


def test_slow_observer_bounded_queue_counts_drops():
    # the subscription layer driven synchronously: a stalled writer costs the
    # tick O(1) deque appends, newest records kept, drops counted
    from repro_torch.gateway.server import _Subscription

    rounds = 30
    server = GatewayServer(GatewayConfig(stream_queue=4), device=CPU)
    try:
        h = server.engine.submit(spec_of(seed=0, rounds=rounds))
        sub = _Subscription(h.id, maxlen=4)
        server._subs.append(sub)
        pump_wall = []
        while server.engine._has_work():
            server.engine.tick()
            t0 = time.perf_counter()
            server._pump()
            pump_wall.append(time.perf_counter() - t0)
        assert h.result().rounds == rounds
        assert sub.closed and len(sub.queue) == 4 and sub.drops == rounds - 4
        assert [i for i, _ in sub.queue] == list(range(rounds - 4, rounds))
        assert max(pump_wall) < 0.05
    finally:
        server.engine.shutdown()


def test_stalled_tcp_observer_and_metrics(gateway):
    host, port, _server = gateway
    rounds = 12
    with GatewayClient(host, port) as gwc:
        assert gwc.metrics()["enabled"] is False  # the verb answers with obs off
        h = gwc.submit(spec_of(seed=0, rounds=rounds))
        stalled = GatewayClient(host, port)
        stalled._rpc(gw.pack_json(MsgType.STREAM, {"tenant_id": h.id, "from_start": True}))
        rep = gwc.result(h.id)  # the engine finishes while the observer reads nothing
        assert rep.rounds == rounds
        got = []
        while True:
            frame = recv_frame(stalled._conn)
            if frame.type == MsgType.STREAM_END:
                end = gw.unpack_stream_end(frame.payload)
                break
            got.append(gw.unpack_record(frame.payload)[2])
        stalled.close()
        assert len(got) + end["drops"] == rounds and end["status"] == "finished"
        want = solo_report(spec_of(seed=0, rounds=rounds))
        assert hex_traj(got) == hex_traj(want.records[rounds - len(got):])


def test_stream_drops_and_engine_series_in_metrics():
    from repro_torch import obs

    rounds, queue = 20, 4
    rec = obs.enable(span_capacity=256)
    try:
        server = GatewayServer(GatewayConfig(port=0, stream_queue=queue,
                                             serve=ServeConfig(max_resident=2, admit_per_tick=2)),
                               device=CPU)
        host, port, thread = _run_in_thread(server)
        try:
            with GatewayClient(host, port) as gwc:
                h = gwc.submit(spec_of(seed=0, rounds=rounds))
                assert gwc.result(h.id).rounds == rounds
                with GatewayClient(host, port) as sub:
                    got = list(sub.stream(h.id, from_start=True))
                    assert len(got) == queue and sub.stream_drops == rounds - queue
                    assert hex_traj(got) == hex_traj(
                        solo_report(spec_of(seed=0, rounds=rounds)).records[rounds - queue:])
                snap = gwc.metrics()
                assert snap["enabled"] is True
                counters = snap["metrics"]["counters"]
                assert counters["gateway.stream.dropped"] == rounds - queue
                assert any(k.startswith("engine.rounds") for k in counters)
                assert any(k.startswith("engine.tick") for k in snap["metrics"]["histograms"])
                prom = gwc.metrics(format="prometheus")
                assert f"gateway_stream_dropped_total {rounds - queue}" in prom["prometheus"]
        finally:
            server.request_stop()
            thread.join(30)
    finally:
        obs.disable()
    assert rec.value("gateway.stream.dropped") == rounds - queue
    spans = rec.spans("engine.tick")
    assert spans and all("compiles" in s.labels for s in spans if s.labels.get("slots"))


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def test_port_client_with_a_reference_server():
    server = jgw.GatewayServer(jgw.GatewayConfig(
        port=0, serve=jserve.ServeConfig(max_resident=2, admit_per_tick=2)))
    host, port, thread = _run_in_thread(server)
    try:
        spec = spec_of(seed=2, comp="randseqk", rounds=5)
        with GatewayClient(host, port) as gwc:
            h = gwc.submit(spec, priority="low")
            assert h.priority == "low"
            with GatewayClient(host, port) as observer:
                streamed = list(observer.stream(h.id))
            rep = gwc.result(h.id)
            with pytest.raises(GatewayError) as err:
                gwc.submit(spec, priority="platinum")
            assert err.value.field == "options.priority"
        assert rep.spec == spec and hex_traj(streamed) == hex_traj(rep.records)
        want = japi.solve(to_reference(spec))
        assert hex_traj(rep.records) == hex_traj(want.records)  # the reference's own run
        np.testing.assert_allclose(rep.grad_norms, solo_report(spec).grad_norms, rtol=1e-6)
    finally:
        server.request_stop()
        thread.join(30)


def test_reference_client_with_a_port_server(gateway):
    host, port, _server = gateway
    spec = spec_of(seed=1, comp="randk", rounds=5)
    with jgw.GatewayClient(host, port) as jc:
        h = jc.submit(to_reference(spec), until=4)
        with jgw.GatewayClient(host, port) as observer:
            streamed = list(observer.stream(h.id))
        rep = jc.result(h.id)
        with pytest.raises(jgw.GatewayError, match="no tenant"):
            jc.status("t9999")
    assert rep.rounds == 4 and rep.spec == to_reference(spec)
    want = solo_report(spec).records[:4]
    assert hex_traj(rep.records) == hex_traj(want) == hex_traj(streamed)


# ---------------------------------------------------------------------------
# the launcher, as a process (net: subprocess + TCP)
# ---------------------------------------------------------------------------

@pytest.mark.net
def test_launcher_serves_and_a_killed_gateway_resumes_from_its_spills(tmp_path):
    from repro_torch.serve_fednl import FedNLServer

    spill_dir = tmp_path / "spills"
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.gateway_serve", "--port", "0",
         "--max-resident", "1", "--admit-per-tick", "1", "--spill-dir", str(spill_dir),
         "--device", "cpu"],
        stdout=subprocess.PIPE, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    try:
        line = proc.stdout.readline().strip()
        assert line.startswith("LISTENING"), line
        _, host, port = line.split()
        specs = [spec_of(seed=0, rounds=30), spec_of(seed=1, rounds=30)]
        with GatewayClient(host, int(port), connect_retry_s=30) as gwc:
            ids = [gwc.submit(s).id for s in specs]
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                if gwc.status()["spills"] >= 2 and all(
                        gwc.status(t)["round"] >= 3 for t in ids):
                    break
                time.sleep(0.2)
            else:
                pytest.fail("tenants never progressed/spilled")
        proc.kill()
        proc.wait(30)
        with FedNLServer(device=CPU) as srv:
            resumed = []
            for tid in ids:
                cks = sorted(spill_dir.glob(f"{tid}.r*.fnlsess"),
                             key=lambda p: int(p.name.split(".r")[1].split(".")[0]))
                assert cks, f"no spill files for {tid}"
                resumed.append(srv.resume(cks[-1]))
            srv.serve_until_idle(max_ticks=500)
            for h, spec in zip(resumed, specs):
                got = h.result()
                assert hex_traj(got.records) == hex_traj(solo_report(spec).records)
                np.testing.assert_array_equal(got.x, solo_report(spec).x)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
