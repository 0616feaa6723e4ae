"""The port's copy of the obs recorder against repro.obs, and its sites in
the port's wire stack and sessions (CPU).

Exact throughout: the recorder's series, snapshots and exports are the
reference's for the same calls (span durations are the clock's, so spans
are compared by name, depth, parent and labels); a run with the recorder
on is the run with it off bit for bit; the frame counters equal the bytes
the masters measure.
"""

import math

import numpy as np
import pytest

from repro import obs as jobs
from repro_torch import obs
from repro_torch.api import (
    CompressorSpec,
    DataSpec,
    ExperimentSpec,
    TopologySpec,
    open_session,
    solve,
)

CPU = "cpu"
SHAPE = (10, 8, 16)  # d, n_clients, n_i


@pytest.fixture(autouse=True)
def _recorders_off():
    obs.disable()
    jobs.disable()
    yield
    obs.disable()
    jobs.disable()


def _spec(**kw):
    kw.setdefault("rounds", 3)
    return ExperimentSpec(data=DataSpec(shape=SHAPE, seed=1), backend="star-loopback", **kw)


def test_bucket_geometry_is_the_reference():
    assert (obs.HIST_BUCKETS, obs.HIST_LO_EXP) == (jobs.HIST_BUCKETS, jobs.HIST_LO_EXP)
    values = [0.0, -1.0, 1e-300, 2.0 ** -31, 2.0 ** -30, 3e-9, 0.5, 1.0, 7.25, 1e9, 1e300,
              math.inf]
    assert [obs.bucket_index(v) for v in values] == [jobs.bucket_index(v) for v in values]
    assert [obs.bucket_le(i) for i in range(70)] == [jobs.bucket_le(i) for i in range(70)]


def _drive(mod):
    """The same calls on a fresh recorder of ``mod``."""
    rec = mod.enable(span_capacity=4)
    rec.add("comm.frames.sent", type="ROUND")
    rec.add("comm.bytes.sent", 120, type="ROUND")
    rec.add("comm.bytes.sent", 7, type="ROUND")
    rec.counter("engine.spills").add(3)
    rec.gauge("engine.slots", 5, lane="a")
    rec.gauge("engine.slots", 2, lane="a")
    for v in (1e-6, 3e-3, 3e-3, 0.75, 12.0):
        rec.observe("session.step.s", v, backend="star-loopback")
    rec.histogram("x.lat").observe(0.125)
    with rec.span("comm.round", master="StarMaster") as sp:
        with rec.span("comm.hop", node=1, round=0):
            pass
        sp.set(round=0, wire_bytes=99)
    for i in range(5):  # overflows the ring of 4
        with rec.span("tick", i=i):
            pass
    return rec


def _series(rec):
    snap = rec.snapshot()
    snap.pop("uptime_s")
    # span durations feed same-named histograms: keep their counts only
    for key, h in snap["histograms"].items():
        if key.startswith(("comm.", "tick")):
            snap["histograms"][key] = h["count"]
    return snap


def test_recorder_series_and_exports_are_the_reference():
    mine, ref = _drive(obs), _drive(jobs)
    assert _series(mine) == _series(ref)
    assert mine.spans_dropped == ref.spans_dropped == 3
    shape = [(s.name, s.depth, s.parent, s.labels) for s in mine.spans()]
    assert shape == [(s.name, s.depth, s.parent, s.labels) for s in ref.spans()]
    assert mine.value("comm.bytes.sent", type="ROUND") == 127
    # exports: Prometheus text without the span histograms, and the console
    # table of one snapshot, identical
    for rec in (mine, ref):
        with rec._lock:
            for key in [k for k in rec._hists if k[0].startswith(("comm.", "tick"))]:
                del rec._hists[key]
    assert obs.export.prometheus_text(mine) == jobs.export.prometheus_text(ref)
    snap = ref.snapshot()
    assert obs.export.render_snapshot(snap) == jobs.export.render_snapshot(snap)
    assert obs.export.render_snapshot({"enabled": False}) == \
        jobs.export.render_snapshot({"enabled": False})


def test_null_recorder_and_the_global_slot():
    assert obs.core.CURRENT is obs.NULL and not obs.NULL.enabled
    assert obs.NULL.span("a") is obs.NULL.span("b")
    assert obs.NULL.counter("a") is obs.NULL.histogram("b")
    rec = obs.enable()
    assert obs.core.CURRENT is rec and obs.CURRENT is rec and obs.get() is rec
    assert jobs.core.CURRENT is jobs.NULL  # the two packages' slots are separate
    obs.disable()
    assert obs.core.CURRENT is obs.NULL and obs.CURRENT is obs.NULL


def test_span_jsonl_round_trip(tmp_path):
    rec = _drive(obs)
    path = tmp_path / "spans.jsonl"
    assert rec.dump_spans_jsonl(path) == 4
    assert obs.load_spans_jsonl(path) == rec.spans()
    assert obs.export.spans_jsonl(rec) == path.read_text()
    assert [s.to_dict() for s in jobs.load_spans_jsonl(path)] == [s.to_dict() for s in rec.spans()]


@pytest.mark.parametrize("changes,round_spans", [
    (dict(), 3),
    (dict(topology=TopologySpec(kind="tree", fanout=2, depth=3)), 3),
    # as in the reference, the sum tree's and the async master's own rounds
    # open no comm.round span
    (dict(topology=TopologySpec(kind="tree", fanout=4, depth=2, combine="sum")), 0),
    (dict(topology=TopologySpec(mode="async", staleness=2, max_delay=3)), 0),
    (dict(algorithm="fednl-pp", tau=3, compressor=CompressorSpec("randk")), 3),
], ids=["star", "tree", "tree-sum", "async", "pp"])
def test_a_run_with_the_recorder_on_is_the_run_with_it_off(changes, round_spans):
    spec = _spec(**changes)
    off = solve(spec, device=CPU)
    rec = obs.enable()
    on = solve(spec, device=CPU)
    obs.disable()
    assert rec.value("comm.frames.sent", type="STOP") > 0
    if spec.algorithm == "fednl-pp":
        np.testing.assert_array_equal(on.x_hist, off.x_hist)
        assert on.participants == off.participants
    else:
        assert [float(g).hex() for g in on.grad_norms] == [float(g).hex() for g in off.grad_norms]
    np.testing.assert_array_equal(on.x, off.x)
    np.testing.assert_array_equal(on.sent_bits, off.sent_bits)
    np.testing.assert_array_equal(on.extras["measured_frame_bytes"],
                                  off.extras["measured_frame_bytes"])
    assert len(rec.spans("comm.round")) == round_spans


def _stepped(spec, rounds):
    """A session's rounds under a live recorder that starts after INIT, and
    the run's records."""
    with open_session(spec, device=CPU) as s:
        rec = obs.enable()
        s.step(rounds)
        obs.disable()
        rep = s.report()
    return rec, rep


def test_flat_star_frame_counters_equal_the_measured_bytes():
    rec, rep = _stepped(_spec(), 3)
    measured = int(np.sum(rep.extras["measured_frame_bytes"]))
    assert rec.value("comm.bytes.recv", type="UPLINK") == measured
    assert rec.value("comm.frames.recv", type="UPLINK") == 3 * SHAPE[1]
    assert rec.value("comm.frames.recv", type="ROUND") == 3 * SHAPE[1]
    spans = rec.spans("comm.round")
    assert [s.labels["round"] for s in spans] == [0, 1, 2]
    assert [s.labels["wire_bytes"] for s in spans] == list(rep.extras["measured_frame_bytes"])
    assert rec.value("session.rounds", backend="star-loopback") == 3
    assert rec.value("session.host_syncs", backend="star-loopback") == 1


def test_tree_hop_spans_and_agg_counters():
    """A depth-3 exact tree of 2 + 4 aggregators, 2 rounds: one comm.hop span
    per aggregator per round; the leaves' UPLINK bytes are the measured
    bytes.  An AGG frame is a 32-byte header, a 4-byte count and, per leaf
    entry it carries, a 24-byte entry head and the leaf's payload (the leaf
    frame less its 32-byte header); each leaf's entry crosses depth - 1 = 2
    AGG hops, so the AGG bytes received are 36 per aggregator per round plus
    2 * (measured - 8 per leaf per round)."""
    topo = TopologySpec(kind="tree", fanout=2, depth=3)
    rec, rep = _stepped(_spec(topology=topo), 2)
    hops = rec.spans("comm.hop")
    n_aggs = 6
    assert len(hops) == 2 * n_aggs
    assert sorted((s.labels["round"], s.depth) for s in hops) == sorted(
        [(r, depth) for r in range(2) for depth in (1,) * 2 + (2,) * 4])
    assert all(s.parent == "comm.round" or s.parent == "comm.hop" for s in hops)
    measured = int(np.sum(rep.extras["measured_frame_bytes"]))
    assert rec.value("comm.bytes.recv", type="UPLINK") == measured
    leaves = SHAPE[1]
    assert rec.value("comm.bytes.recv", type="AGG") == \
        2 * 36 * n_aggs + 2 * (measured - 2 * 8 * leaves)
    assert rec.value("comm.frames.recv", type="AGG") == 2 * n_aggs
