"""The port's serving engine (repro_torch.serve_fednl) on the CPU, against its
own solo sessions and against repro.serve_fednl.

Mirrors tests/test_serve_fednl.py at its SHAPE = (12, 4, 20):

  * every tenant served by the port's ``FedNLServer`` is bit for bit the
    port's solo ``open_session(spec).run()`` (records' grad norms, f, bits,
    PP models and participants, the final x): mixed compressors, rounds and
    algorithms; staggered admission across two problems; a ``tol`` stop;
    memory pressure under both victim policies; the solo-lane backends
    (star-loopback, FedNL-PP); zero-round specs; evict and resume;
  * served tenants against ``repro.serve_fednl`` on the same submissions
    within the sweep tests' bounds: grad norms rtol 1e-6 where the
    reference's are >= 1e-10, x rtol 1e-8, bits exact;
  * the engine's integer surface equals the reference engine's tick for
    tick on the same submissions: the ``tick()`` dicts, ``stats()`` and the
    admission order;
  * ``FairShareQueue``'s pop order and ``starvation_bound`` equal the
    reference's on seeded random push/pop sequences;
  * a port engine's spill file is resumed by the reference engine, and the
    reverse.
"""

import threading

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import repro.api as japi
import repro.serve_fednl as jserve
from repro_torch.api import CompressorSpec, DataSpec, ExperimentSpec, load_state, open_session
from repro_torch.api.session import spec_to_dict
from repro_torch.core.fednl_batch import BatchRoundTable
from repro_torch.serve_fednl import (
    FairShareQueue,
    FedNLServer,
    ServeConfig,
    SubmitOptions,
    serve_all,
    serve_lane,
)
from repro_torch.serve_fednl.scheduler import host_metrics, stack_states, unstack_state

CPU = "cpu"
SHAPE = (12, 4, 20)  # d, n_clients, n_i
GN_RTOL, GN_FLOOR, X_RTOL = 1e-6, 1e-10, 1e-8


def spec_of(seed=0, comp="topk", rounds=6, algo="fednl", backend="local",
            data_seed=1, tol=0.0, km=8.0, **overrides):
    return ExperimentSpec(
        data=DataSpec(shape=SHAPE, seed=data_seed),
        algorithm=algo,
        compressor=CompressorSpec(comp, km),
        backend=backend,
        rounds=rounds,
        tol=tol,
        seed=seed,
        **overrides,
    )


def to_reference(spec):
    return japi.session.spec_from_dict(spec_to_dict(spec))


_SOLO_CACHE: dict = {}


def solo_report(spec):
    """The port's own solo session run (cached per spec)."""
    if spec not in _SOLO_CACHE:
        with open_session(spec, device=CPU) as s:
            _SOLO_CACHE[spec] = s.run()
    return _SOLO_CACHE[spec]


def assert_served_bit_identical(got, spec):
    want = solo_report(spec)
    assert got.rounds == want.rounds
    for g, w in zip(got.records, want.records):
        assert g.round == w.round
        assert (g.grad_norm is None) == (w.grad_norm is None)
        if g.grad_norm is not None:
            assert float(g.grad_norm).hex() == float(w.grad_norm).hex()
        if g.f is not None:
            assert float(g.f).hex() == float(w.f).hex()
        assert g.sent_elems == w.sent_elems
        assert g.sent_bits == w.sent_bits
        assert g.sent_bits_payload == w.sent_bits_payload
        assert g.sent_bits_wire == w.sent_bits_wire
        assert g.ls_steps == w.ls_steps
        if g.x is not None or w.x is not None:
            np.testing.assert_array_equal(g.x, w.x)
        assert g.participants == w.participants
    np.testing.assert_array_equal(got.x, want.x)


def assert_parity(got, want):
    """A port report against the reference's: the sweep tests' bounds."""
    assert got.rounds == want.rounds
    for col in ("sent_bits", "sent_bits_payload", "sent_bits_wire"):
        np.testing.assert_array_equal(getattr(got, col), getattr(want, col))
    if want.records and want.records[0].grad_norm is not None:
        live = want.grad_norms >= GN_FLOOR
        np.testing.assert_allclose(got.grad_norms[live], want.grad_norms[live], rtol=GN_RTOL)
    else:  # PP: the models each round
        np.testing.assert_allclose(got.x_hist, want.x_hist, rtol=X_RTOL, atol=1e-14)
        assert got.participants == want.participants
    np.testing.assert_allclose(got.x, want.x, rtol=X_RTOL, atol=1e-14)


# ---------------------------------------------------------------------------
# bit parity: served == the port's solo session
# ---------------------------------------------------------------------------

MIXED = [
    spec_of(seed=0, comp="topk", rounds=6),
    spec_of(seed=1, comp="randk", rounds=4),
    spec_of(seed=2, comp="randseqk", rounds=7),
    spec_of(seed=3, comp="topk", km=4.0, rounds=5),
    spec_of(seed=4, comp="identity", rounds=3),
    spec_of(seed=5, comp="topk", rounds=5, algo="fednl-ls"),
    spec_of(seed=6, comp="natural", rounds=4),
    spec_of(seed=7, comp="toplek", rounds=5),
]


def test_parity_mixed_compressors_rounds_and_algorithms():
    # one shared problem, mixed compressors / k / seeds / round budgets and
    # both batched algorithms: maximal co-batching, per-slot stops
    reports = serve_all(MIXED, device=CPU)
    for spec, rep in zip(MIXED, reports):
        assert_served_bit_identical(rep, spec)
        assert rep.extras["served"] is True and rep.extras["device"] == "cpu"


def test_parity_staggered_admission_and_mixed_data():
    # tenants arrive mid-flight at differing round indices, across TWO
    # problems (distinct data seeds -> distinct groups)
    first = [spec_of(seed=0, rounds=8), spec_of(seed=1, rounds=8, data_seed=2)]
    late = [spec_of(seed=2, comp="randk", rounds=5),
            spec_of(seed=3, comp="randseqk", rounds=5, data_seed=2)]
    with FedNLServer(device=CPU) as srv:
        handles = [srv.submit(s) for s in first]
        srv.tick()
        srv.tick()  # the first two are now at round >= 1
        handles += [srv.submit(s) for s in late]
        srv.serve_until_idle(max_ticks=100)
        for spec, h in zip(first + late, handles):
            assert_served_bit_identical(h.result(), spec)
        assert srv.stats()["groups"] == 2


def test_parity_tol_early_stop():
    # tol > 0 blocks the sweep's batch lane but not the serve one
    spec = spec_of(seed=0, rounds=40, tol=1e-10)
    rep = serve_all([spec, spec_of(seed=1, rounds=6)], device=CPU)[0]
    assert_served_bit_identical(rep, spec)
    assert rep.rounds < 40  # the tol fired


def test_parity_solo_lane_backends():
    # the wire protocol and PP run as per-tenant sessions, one round a tick
    specs = [
        spec_of(seed=0, rounds=5, backend="star-loopback"),
        spec_of(seed=1, rounds=5, algo="fednl-pp", tau=3),
        spec_of(seed=2, rounds=4, hessian="pallas"),
    ]
    with FedNLServer(device=CPU) as srv:
        handles = [srv.submit(s) for s in specs]
        assert [h._tenant.lane for h in handles] == ["solo", "solo", "solo"]
        srv.serve_until_idle(max_ticks=50)
        for spec, h in zip(specs, handles):
            assert_served_bit_identical(h.result(), spec)


@pytest.mark.parametrize("eviction", ["lru", "cost"])
def test_parity_under_memory_pressure(eviction, tmp_path):
    # 8 tenants through 3 resident slots: constant spill/resume churn must
    # not move a single bit
    specs = [spec_of(seed=i, comp=["topk", "randk", "randseqk"][i % 3], rounds=5 + i % 3)
             for i in range(8)]
    cfg = ServeConfig(max_resident=3, admit_per_tick=2, eviction=eviction, spill_dir=tmp_path)
    with FedNLServer(cfg, device=CPU) as srv:
        handles = [srv.submit(s) for s in specs]
        srv.serve_until_idle(max_ticks=500)
        stats = srv.stats()
        assert stats["spills"] > len(specs) and stats["resumes"] > 0
        for spec, h in zip(specs, handles):
            assert_served_bit_identical(h.result(), spec)
        # each spill superseded the tenant's previous file: one file a tenant
        # that ever spilled, its newest
        files = sorted(p.name for p in tmp_path.glob("*.fnlsess"))
        spilled = [h for h in handles if h._tenant.spill_count]
        assert files == sorted(h._tenant.spill_path.name for h in spilled)


def test_zero_round_spec_finishes_at_admission():
    spec = spec_of(seed=0, rounds=0)
    rep = serve_all([spec], device=CPU)[0]
    assert rep.rounds == 0
    np.testing.assert_array_equal(rep.x, solo_report(spec).x)


def test_explicit_evict_checkpoint_roundtrip(tmp_path):
    spec = spec_of(seed=7, comp="randk", rounds=10)
    with FedNLServer(ServeConfig(spill_dir=tmp_path), device=CPU) as srv:
        h = srv.submit(spec)
        for _ in range(4):
            srv.tick()
        path = srv.evict(h.id)
        assert h.status == "evicted" and path.exists()
        with pytest.raises(RuntimeError, match="evicted"):
            h.result()
        h2 = srv.resume(path)
        assert h2.round == 4
        srv.serve_until_idle(max_ticks=100)
        assert_served_bit_identical(h2.result(), spec)
    # the spill file is an ordinary session checkpoint
    with open_session(spec, restore=path, device=CPU) as s:
        assert_served_bit_identical(s.run(), spec)


def test_evict_solo_lane_tenant_and_queued_resume(tmp_path):
    star = spec_of(seed=0, rounds=6, backend="star-loopback")
    local = spec_of(seed=3, rounds=8)
    with FedNLServer(ServeConfig(spill_dir=tmp_path), device=CPU) as srv:
        hs, hl = srv.submit(star), srv.submit(local)
        for _ in range(3):
            srv.tick()
        ps, pl = srv.evict(hs.id), srv.evict(hl.id)
        hs2 = srv.resume(ps)  # the star rebuilds its clients by replay
        hl2 = srv.resume(pl)  # queued with a pending restore...
        pl2 = srv.evict(hl2.id)  # ...evicted before ever being admitted
        assert pl2.exists()
        hl3 = srv.resume(pl2)
        srv.serve_until_idle(max_ticks=100)
        assert_served_bit_identical(hs2.result(), star)
        assert_served_bit_identical(hl3.result(), local)


def test_background_thread_serving():
    specs = [spec_of(seed=i, rounds=4) for i in range(3)]
    with FedNLServer(device=CPU) as srv:
        srv.start()
        handles = [srv.submit(s) for s in specs]
        for h in handles:
            assert h.wait(timeout=120)
        srv.stop()
        for spec, h in zip(specs, handles):
            assert_served_bit_identical(h.result(), spec)


def test_submit_validates_and_lifecycle():
    with FedNLServer(device=CPU) as srv:
        with pytest.raises(ValueError, match="partial participation"):
            srv.submit(spec_of(algo="fednl-pp", tau=3), until=1e-8)
        with pytest.raises(KeyError):
            srv.submit(spec_of(comp="no-such-compressor"))
        with pytest.raises(ValueError):
            srv.submit(spec_of(algo="fednl-ls", backend="star-loopback"))
        with pytest.raises(ValueError, match=r"options\.priority"):
            srv.submit(spec_of(), options=SubmitOptions(priority="vip"))
        with pytest.raises(TypeError):
            srv.submit(spec_of(), options={"priority": "high"})
        assert srv.stats()["tenants"] == 0  # failed submissions left nothing
        h1, h2 = srv.submit(spec_of(seed=30, rounds=8)), srv.submit(spec_of(seed=31, rounds=3),
                                                                   until=2)
        srv.tick()
        srv.cancel(h1.id)
        assert h1.status == "cancelled" and h1.done
        with pytest.raises(RuntimeError, match="cancelled"):
            h1.result()
        srv.serve_until_idle(max_ticks=50)
        assert h2.result().rounds == 2
        with pytest.raises(ValueError, match="only queued"):
            srv.cancel(h2.id)
        with pytest.raises(KeyError):
            srv.cancel("t9999")
    assert h2.status == "finished"
    with pytest.raises(RuntimeError):
        srv.tick()
    with pytest.raises(RuntimeError):
        srv.submit(spec_of(seed=1))


def test_shutdown_with_spill_leaves_resumable_checkpoints(tmp_path):
    spec = spec_of(seed=4, rounds=8)
    srv = FedNLServer(ServeConfig(spill_dir=tmp_path), device=CPU)
    h = srv.submit(spec)
    for _ in range(3):
        srv.tick()
    srv.shutdown(spill=True)
    assert h.status == "evicted" and h.wait(timeout=1)
    (ck,) = tmp_path.glob(f"{h.id}.*")
    with FedNLServer(ServeConfig(spill_dir=tmp_path / "second"), device=CPU) as srv2:
        h2 = srv2.resume(ck)
        srv2.serve_until_idle(max_ticks=100)
        assert_served_bit_identical(h2.result(), spec)


# ---------------------------------------------------------------------------
# the round table and the slot stacking
# ---------------------------------------------------------------------------

def test_round_table_counts_the_references_compiles_and_slots_are_independent():
    """compiles = new (table length, slot bucket) keys; a tick over slots at
    different rounds, in tenant order with mixed branches and a pad slot,
    gives each live slot its solo round's bits."""
    import dataclasses

    from repro_torch.core.fednl import fednl_init, make_fednl_round

    z = torch.as_tensor(spec_of().data.build())
    cfg = spec_of().fednl_config()
    table = BatchRoundTable(z, cfg, 1.0)
    assert table.bucket_for(3) == 4 and table.bucket_for(3, pad_pow2=False) == 3
    comps = [("topk", 48), ("randseqk", 36), ("topk", 24)]  # d = 12, T = 78
    idx = [table.branch_index(*c) for c in comps]
    assert idx == [0, 1, 2] and table.branch_index("topk", 48) == 0

    def cfg_of(which):
        return dataclasses.replace(cfg, compressor=comps[which][0],
                                   k_multiplier=comps[which][1] / 12)

    states = []
    for seed in range(3):
        c = cfg_of(seed)
        st0 = fednl_init(z, c, seed=seed)
        for _ in range(seed):  # slots at rounds 0, 1, 2
            st0 = make_fednl_round(z, c)(st0)[0]
        states.append(st0)
    pattern = [2, 0, 1, 2]  # tenant order, a pad slot duplicating slot 0
    st_b, m_b = table.tick(pattern, stack_states([states[2], states[0], states[1], states[2]]))
    assert table.compiles == 1 and list(st_b.round) == [3, 1, 2, 3]
    assert table.bucket_for(3) == 4  # the bucket seen at this table length
    rows = host_metrics(m_b, 3)
    for slot, which in enumerate([2, 0, 1]):
        want_state, want_m = make_fednl_round(z, cfg_of(which))(states[which])
        got = unstack_state(st_b, slot)
        assert got.round == want_state.round and isinstance(got.round, int)
        for f in ("x", "h_local", "h_global"):
            assert torch.equal(getattr(got, f).view(torch.int64),
                               getattr(want_state, f).view(torch.int64))
        np.testing.assert_array_equal(got.key, want_state.key)
        assert float(rows[slot]["grad_norm"]).hex() == float(want_m.grad_norm).hex()
        assert int(rows[slot]["sent_bits"]) == int(want_m.sent_bits)
    table.tick([0, 1], stack_states(states[:2]))
    table.branch_index("identity", 78)
    table.tick([3], stack_states(states[:1]))
    assert table.compiles == 3


# ---------------------------------------------------------------------------
# against repro.serve_fednl: numbers and the integer surface
# ---------------------------------------------------------------------------

def _drive_both(specs, cfg_kwargs, late=(), late_after=2, options=None):
    """The same submissions through both engines, tick by tick: returns the
    reports, the tick dicts and stats() of each, and each engine's admission
    order (tenant ids in the order they were first admitted)."""
    out = {}
    for name, srv in (("port", FedNLServer(ServeConfig(**cfg_kwargs), device=CPU)),
                      ("ref", jserve.FedNLServer(jserve.ServeConfig(**cfg_kwargs)))):
        conv = (lambda s: s) if name == "port" else to_reference
        opt = (lambda o: o) if name == "port" else (
            lambda o: None if o is None else jserve.SubmitOptions(priority=o.priority))
        with srv:
            opts = options or [None] * (len(specs) + len(late))
            handles = [srv.submit(conv(s), options=opt(o)) for s, o in zip(specs, opts)]
            ticks, order = [], []
            n = 0
            while srv._has_work() or n < late_after:
                if n == late_after:
                    handles += [srv.submit(conv(s), options=opt(o))
                                for s, o in zip(late, opts[len(specs):])]
                ticks.append(srv.tick())
                for t in srv._tenants.values():
                    if t.admitted_tick >= 0 and t.tenant_id not in order:
                        order.append(t.tenant_id)
                n += 1
                assert n < 500
            out[name] = ([h.result() for h in handles], ticks, srv.stats(), order)
    return out


@pytest.mark.parametrize(
    "case",
    [
        "mixed",
        "pressure_lru",
        "pressure_cost_staggered",
        "solo_and_priorities",
    ],
)
def test_served_tenants_and_engine_surface_match_the_reference(case):
    if case == "mixed":
        specs, late, cfg = MIXED[:6], (), dict(max_group=4)
        options = None
    elif case == "pressure_lru":
        specs = [spec_of(seed=i, comp=["topk", "randk", "randseqk"][i % 3], rounds=4 + i % 3)
                 for i in range(6)]
        late, cfg, options = (), dict(max_resident=3, admit_per_tick=2), None
    elif case == "pressure_cost_staggered":
        specs = [spec_of(seed=i, rounds=5, tol=1e-10 if i == 0 else 0.0) for i in range(3)]
        late = [spec_of(seed=9, comp="natural", rounds=4, data_seed=2),
                spec_of(seed=10, comp="toplek", rounds=3)]
        cfg, options = dict(max_resident=2, admit_per_tick=2, eviction="cost"), None
    else:
        specs = [spec_of(seed=0, rounds=4, backend="star-loopback"),
                 spec_of(seed=1, rounds=4, algo="fednl-pp", tau=3),
                 spec_of(seed=2, rounds=5), spec_of(seed=3, rounds=5, comp="randk"),
                 spec_of(seed=4, rounds=0)]
        late = ()
        cfg = dict(max_resident=3, admit_per_tick=2,
                   priorities={"gold": 2.0, "bronze": 1.0})
        options = [SubmitOptions(priority=p) for p in ("bronze", "gold", "gold", "bronze",
                                                       "gold")]
    got = _drive_both(specs, cfg, late=late, options=options)
    port, ref = got["port"], got["ref"]
    for spec, g, w in zip(list(specs) + list(late), port[0], ref[0]):
        assert_parity(g, w)
        assert_served_bit_identical(g, spec)
    assert port[1] == ref[1]  # every tick() dict
    assert port[2] == ref[2]  # stats(): launches, compiles, occupancy, spills, ...
    assert port[3] == ref[3]  # admission order


def test_engine_obs_series_and_tick_spans_match_the_reference():
    """With both packages' recorders on, the same submissions give the same
    engine.tick span fields (the compiles delta included) tick for tick,
    the same engine.* counters and gauges, and the same engine.* histogram
    counts; the served tenants are still their solo runs bit for bit."""
    from repro import obs as jobs
    from repro_torch import obs as tobs

    specs = [spec_of(seed=i, comp=["topk", "randseqk", "natural"][i % 3], rounds=3 + i % 2)
             for i in range(5)] + [spec_of(seed=9, rounds=3, backend="star-loopback")]
    cfg = dict(max_resident=3, admit_per_tick=2, max_group=2)
    recs = {"port": tobs.enable(span_capacity=1024), "ref": jobs.enable(span_capacity=1024)}
    try:
        got = _drive_both(specs, cfg)
    finally:
        tobs.disable()
        jobs.disable()
    for spec, rep in zip(specs, got["port"][0]):
        assert_served_bit_identical(rep, spec)
    assert got["port"][1:] == got["ref"][1:]

    def engine_view(rec):
        snap = rec.snapshot()
        return (
            [s.labels for s in rec.spans("engine.tick")],
            {k: v for k, v in snap["counters"].items() if k.startswith("engine.")},
            {k: v for k, v in snap["gauges"].items() if k.startswith("engine.")},
            {k: h["count"] for k, h in snap["histograms"].items() if k.startswith("engine.")},
        )

    port, ref = engine_view(recs["port"]), engine_view(recs["ref"])
    assert port == ref
    assert any(labels.get("compiles") for labels in port[0])


def test_spill_files_cross_the_packages(tmp_path):
    """A port spill resumed by the reference engine, and the reverse, within
    the parity bounds of the other package's uninterrupted run."""
    spec = spec_of(seed=5, comp="randseqk", rounds=7)
    j_spec = to_reference(spec)
    with FedNLServer(ServeConfig(spill_dir=tmp_path / "port"), device=CPU) as srv:
        h = srv.submit(spec)
        for _ in range(3):
            srv.tick()
        port_path = srv.evict(h.id)
    with jserve.FedNLServer(jserve.ServeConfig(spill_dir=tmp_path / "ref")) as jsrv:
        jh = jsrv.submit(j_spec)
        for _ in range(3):
            jsrv.tick()
        ref_path = jsrv.evict(jh.id)
        jh2 = jsrv.resume(port_path)
        jsrv.serve_until_idle(max_ticks=50)
        from_port = jh2.result()
    with FedNLServer(ServeConfig(spill_dir=tmp_path / "port2"), device=CPU) as srv:
        h2 = srv.resume(ref_path)
        assert h2.round == 3
        srv.serve_until_idle(max_ticks=50)
        from_ref = h2.result()
    with japi.open_session(j_spec) as s:
        j_want = s.run()
    assert_parity(from_ref, j_want)
    assert_parity(solo_report(spec), from_port)
    assert from_port.rounds == from_ref.rounds == 7
    # the two packages wrote the same records for the shared prefix, bits exact
    assert load_state(port_path).round == load_state(ref_path).round == 3


# ---------------------------------------------------------------------------
# fair-share admission
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_fair_share_queue_is_the_references(seed):
    rng = np.random.default_rng(seed)
    dyadic = [0.25, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 8.0]
    n_cls = int(rng.integers(1, 5))
    classes = {c: float(rng.choice(dyadic)) for c in "abcd"[:n_cls]}
    quantum = float(rng.choice([0.25, 0.5, 1.0, 2.0, 4.0]))
    q, jq = FairShareQueue(classes, quantum), jserve.FairShareQueue(classes, quantum)
    assert {c: q.starvation_bound(c) for c in classes} == {
        c: jq.starvation_bound(c) for c in classes}
    names = sorted(classes)
    for i in range(400):
        if rng.random() < 0.55:
            c = names[int(rng.integers(len(names)))]
            q.push(f"{c}#{i}", priority=c)
            jq.push(f"{c}#{i}", priority=c)
        else:
            assert q.pop() == jq.pop()
        assert q.backlog() == jq.backlog() and len(q) == len(jq)


def test_fair_share_queue_weights_and_validation():
    q = FairShareQueue({"high": 4.0, "normal": 2.0, "low": 1.0}, quantum=1.0)
    for i in range(40):
        for cls in ("high", "normal", "low"):
            q.push(f"{cls}-{i}", priority=cls)
    got = [q.pop() for _ in range(70)]  # 10 full DRR cycles of 4+2+1
    assert {c: sum(t.startswith(c) for t in got) for c in ("high", "normal", "low")} == {
        "high": 40, "normal": 20, "low": 10}
    with pytest.raises(ValueError, match="at least one"):
        FairShareQueue({})
    with pytest.raises(ValueError, match="positive weight"):
        FairShareQueue({"bad": 0.0})
    with pytest.raises(ValueError, match="quantum"):
        FairShareQueue({"a": 1.0}, quantum=0.0)
    with pytest.raises(ValueError, match="unknown priority class"):
        FairShareQueue({"a": 1.0}).push("x", priority="b")


def test_serve_lane_is_the_references():
    from repro.api.registry import get_algorithm as j_algo
    from repro.api.registry import get_backend as j_backend
    from repro_torch.api.registry import get_algorithm, get_backend

    for spec in MIXED + [spec_of(backend="star-loopback"), spec_of(algo="fednl-pp", tau=3),
                         spec_of(hessian="pallas"), spec_of(tol=1e-9), spec_of(rounds=0)]:
        j = to_reference(spec)
        assert serve_lane(spec, get_algorithm(spec.algorithm), get_backend(spec.backend)) == \
            jserve.serve_lane(j, j_algo(j.algorithm), j_backend(j.backend))


# ---------------------------------------------------------------------------
# property test: random admit / evict / tick schedules
# ---------------------------------------------------------------------------

_POOL = [
    spec_of(seed=0, comp="topk", rounds=4),
    spec_of(seed=1, comp="randk", rounds=5),
    spec_of(seed=2, comp="topk", rounds=3),
    spec_of(seed=3, comp="randseqk", rounds=6),
]

_SCHEDULES = st.lists(
    st.one_of(
        st.tuples(st.just("submit"), st.integers(0, len(_POOL) - 1)),
        st.tuples(st.just("tick"), st.just(0)),
        st.tuples(st.just("evict_resume"), st.integers(0, len(_POOL) - 1)),
    ),
    min_size=1,
    max_size=12,
)


@settings(max_examples=6, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(schedule=_SCHEDULES)
def test_random_admit_evict_tick_schedules_preserve_parity(schedule):
    """Whatever interleaving of admissions, ticks and evict -> resume cycles,
    every tenant that completes is bit for bit its solo run."""
    with FedNLServer(ServeConfig(max_resident=2, admit_per_tick=2), device=CPU) as srv:
        handles: dict[int, object] = {}
        for op, i in schedule:
            if op == "submit" and i not in handles:
                handles[i] = srv.submit(_POOL[i])
            elif op == "tick":
                srv.tick()
            elif op == "evict_resume" and i in handles:
                h = handles[i]
                if h.status in ("queued", "running", "spilled") and (
                    h.status != "queued" or h.round > 0
                ):
                    handles[i] = srv.resume(srv.evict(h.id))
        srv.serve_until_idle(max_ticks=300)
        for i, h in handles.items():
            assert_served_bit_identical(h.result(), _POOL[i])


@pytest.mark.net
def test_star_tcp_tenant_evicted_mid_run_leaks_no_processes(tmp_path):
    from repro_torch.launch.multiproc import ClientCluster

    assert ClientCluster.live_count() == 0
    spec = spec_of(seed=0, rounds=4, backend="star-tcp")
    with FedNLServer(ServeConfig(spill_dir=tmp_path), device=CPU) as srv:
        h = srv.submit(spec)
        srv.tick()
        srv.tick()
        assert ClientCluster.live_count() == 1
        path = srv.evict(h.id)  # the spill closes the session: the fleet is torn down
        assert ClientCluster.live_count() == 0
        h2 = srv.resume(path)
        srv.serve_until_idle(max_ticks=100)
        assert_served_bit_identical(h2.result(), spec)
    assert ClientCluster.live_count() == 0


def test_concurrent_submits_while_ticking():
    """Submitters on several threads while the engine thread ticks: every
    tenant gets a distinct id and finishes bit for bit its solo run."""
    import sys

    specs = [spec_of(seed=i % 4, rounds=3 + i % 2) for i in range(12)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with FedNLServer(ServeConfig(max_resident=4, admit_per_tick=3), device=CPU) as srv:
            srv.start()
            handles = [None] * len(specs)

            def submit(lo):
                for i in range(lo, len(specs), 4):
                    handles[i] = srv.submit(specs[i])

            threads = [threading.Thread(target=submit, args=(lo,)) for lo in range(4)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(60)
                assert not th.is_alive()
            for h in handles:
                assert h.wait(timeout=120)
            srv.stop()
            assert len({h.id for h in handles}) == len(specs)
            for spec, h in zip(specs, handles):
                assert_served_bit_identical(h.result(), spec)
    finally:
        sys.setswitchinterval(old)
