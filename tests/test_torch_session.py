"""The port's Session API against its own solve() and against repro's (CPU).

Mirrors tests/test_session.py on the local backend of repro_torch:

  * step composability: ``step(3)`` then ``step(2)`` is bit-identical to
    ``step(5)`` and to ``solve()``, for fednl, fednl-ls and fednl-pp;
  * save -> restore mid-run is bit-identical to an uninterrupted run, and a
    checkpoint resumes under a larger round budget;
  * FNLS1 is byte-stable (save -> load -> save is the identity on bytes);
  * restore validation names the mismatched fields.

Across the packages (the FNLS1 format is the reference's byte for byte):
  (a) a reference checkpoint loaded and saved by the port is byte-identical;
  (b) a port checkpoint loads in ``repro.api.load_state`` with an equal spec;
  (c) resumed in both packages, the continuations agree within the parity
      bounds of tests/test_torch_fednl.py (grad norms rtol 1e-6 where the
      reference's is >= 1e-10, x rtol 1e-8), bits exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.api as japi
import repro_torch.api as tapi
from repro_torch.api import (
    CompressorSpec,
    DataSpec,
    ExperimentSpec,
    StopPolicy,
    load_state,
    open_session,
    save_state,
    solve,
)

SHAPE = (12, 4, 20)  # d, n_clients, n_i: small enough for per-round stepping
GN_RTOL, GN_FLOOR, X_RTOL = 1e-6, 1e-10, 1e-8
CPU = "cpu"


def full_spec(**overrides) -> ExperimentSpec:
    base = dict(data=DataSpec(shape=SHAPE, seed=1), rounds=6, seed=0)
    base.update(overrides)
    return ExperimentSpec(**base)


def pp_spec(**overrides) -> ExperimentSpec:
    return full_spec(algorithm="fednl-pp", tau=3, **overrides)


def assert_reports_bit_identical(got, want):
    assert got.rounds == want.rounds
    for g, w in zip(got.records, want.records):
        assert (g.grad_norm is None) == (w.grad_norm is None)
        if g.grad_norm is not None:
            assert float(g.grad_norm).hex() == float(w.grad_norm).hex()
        assert g.sent_bits == w.sent_bits
        assert g.sent_bits_payload == w.sent_bits_payload
        assert g.sent_bits_wire == w.sent_bits_wire
        assert g.ls_steps == w.ls_steps
        if g.x is not None or w.x is not None:
            np.testing.assert_array_equal(g.x, w.x)
        assert g.participants == w.participants
        assert g.dropped == w.dropped
    np.testing.assert_array_equal(got.x, want.x)


# ---------------------------------------------------------------------------
# step composability: step(3) + step(2) == step(5) == solve()
# ---------------------------------------------------------------------------

# (algorithm, backend overrides): the local backend for the three
# algorithms, and the sharded backend (a world of one on gloo) for FedNL with
# both aggregations, as tests/test_session.py adds "sharded"
SESSION_CASES = [
    pytest.param("fednl", {}, id="fednl"),
    pytest.param("fednl-ls", {}, id="fednl-ls"),
    pytest.param("fednl-pp", {}, id="fednl-pp"),
    pytest.param("fednl", {"backend": "sharded"}, id="fednl-sharded"),
    pytest.param("fednl", {"backend": "sharded", "aggregate": "sparse_allgather",
                           "compressor": CompressorSpec("randseqk")},
                 id="fednl-sharded-sparse_allgather"),
]


@pytest.mark.parametrize("algorithm,backend", SESSION_CASES)
def test_step_composability(algorithm, backend):
    spec = (pp_spec if algorithm == "fednl-pp" else full_spec)(rounds=5, **backend)
    if algorithm == "fednl-ls":
        spec = spec.replace(algorithm="fednl-ls")
    want = solve(spec, device=CPU)
    with open_session(spec, device=CPU) as s:
        s.step(3)
        s.step(2)
        got = s.report()
    assert_reports_bit_identical(got, want)
    with open_session(spec, device=CPU) as s:
        s.step(5)
        assert_reports_bit_identical(s.report(), want)
    if algorithm == "fednl-pp":
        np.testing.assert_array_equal(got.x_hist, want.x_hist)
        assert got.final_grad_norm == want.final_grad_norm
        assert got.extras["tau"] == 3 and got.dropped == [[]] * 5


def test_run_is_solve_and_reports_are_cumulative():
    spec = full_spec()
    want = solve(spec, device=CPU)
    with open_session(spec, device=CPU) as s:
        mid = s.run(until=3)
        assert mid.rounds == 3
        full = s.run()  # continues from round 3 under the spec's budget
        assert full.rounds == spec.rounds
    assert_reports_bit_identical(full, want)
    assert_reports_bit_identical(mid, solve(spec.replace(rounds=3), device=CPU))
    assert full.extras["device"] == "cpu"


# ---------------------------------------------------------------------------
# observers + stop policies
# ---------------------------------------------------------------------------

def test_observer_streams_records_in_order():
    spec = full_spec()
    seen = []
    with open_session(spec, device=CPU) as s:
        s.on_round(lambda rec: seen.append(rec.round))
        s.step(2)
        s.run()
    assert seen == list(range(spec.rounds))


def test_run_until_tol_matches_solve_early_stop():
    spec = full_spec(rounds=40, tol=1e-10)
    want = solve(spec, device=CPU)
    with open_session(spec, device=CPU) as s:
        got = s.run()
    assert got.rounds == want.rounds < 40
    assert_reports_bit_identical(got, want)
    # a float until behaves like a spec tol
    with open_session(spec.replace(tol=0.0), device=CPU) as s:
        assert s.run(until=1e-10).rounds == want.rounds


def test_run_until_int_predicate_and_policy():
    spec = full_spec(rounds=30)
    with open_session(spec, device=CPU) as s:
        assert s.run(until=4).rounds == 4  # an int caps the total rounds
    stop_at = []
    with open_session(spec, device=CPU) as s:
        got = s.run(
            until=StopPolicy(predicate=lambda rec: stop_at.append(rec.round) or rec.round >= 3)
        )
    assert got.rounds == 4 and stop_at == [0, 1, 2, 3]  # the stopping round is included
    with open_session(spec, device=CPU) as s:
        assert s.run(until=StopPolicy(max_rounds=2)).rounds == 2
    with pytest.raises(TypeError, match="until must be"):
        with open_session(spec, device=CPU) as s:
            s.run(until="forever")
    with pytest.raises(TypeError, match="until must be"):
        with open_session(spec, device=CPU) as s:
            s.run(until=True)


def test_run_until_tol_rejected_for_pp():
    with open_session(pp_spec(), device=CPU) as s:
        with pytest.raises(ValueError, match="partial participation"):
            s.run(until=1e-9)


def test_closed_session_refuses_steps():
    s = open_session(full_spec(), device=CPU)
    s.close()
    with pytest.raises(RuntimeError, match="closed"):
        s.step()
    s.close()  # idempotent


# ---------------------------------------------------------------------------
# save -> restore mid-run == uninterrupted run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algorithm,backend", SESSION_CASES)
def test_save_restore_midrun(tmp_path, algorithm, backend):
    spec = pp_spec(**backend) if algorithm == "fednl-pp" else full_spec(algorithm=algorithm,
                                                                        **backend)
    want = solve(spec, device=CPU)
    ck = tmp_path / "mid.fnlsess"
    with open_session(spec, device=CPU) as s:
        s.step(3)
        s.save(ck)
    with open_session(spec, restore=ck, device=CPU) as s:
        assert s.round == 3 and len(s.records) == 3
        got = s.run()
    assert_reports_bit_identical(got, want)
    if algorithm == "fednl-pp":
        assert got.final_grad_norm == want.final_grad_norm


def test_restore_can_extend_rounds(tmp_path):
    short, long = full_spec(rounds=4), full_spec(rounds=9)
    want = solve(long, device=CPU)
    ck = tmp_path / "short.fnlsess"
    with open_session(short, device=CPU) as s:
        s.step(4)
        s.save(ck)
    with open_session(long, restore=ck, device=CPU) as s:
        got = s.run()
    assert_reports_bit_identical(got, want)


# ---------------------------------------------------------------------------
# serialization: byte stability
# ---------------------------------------------------------------------------

COMPRESSORS = ["topk", "randk", "randseqk", "toplek", "natural", "identity"]


@pytest.mark.parametrize("algorithm", ["fednl", "fednl-ls", "fednl-pp"])
@pytest.mark.parametrize("comp", COMPRESSORS)
def test_checkpoint_byte_stable(tmp_path, algorithm, comp):
    """save -> load -> save is the identity on bytes, and the loaded state
    round-trips structurally."""
    spec = full_spec(
        algorithm=algorithm,
        compressor=CompressorSpec(comp),
        tau=3 if algorithm == "fednl-pp" else None,
        rounds=3,
    )
    p1, p2 = tmp_path / "a", tmp_path / "b"
    with open_session(spec, device=CPU) as s:
        s.step(2)
        s.save(p1)
    save_state(load_state(p1), p2)
    assert p1.read_bytes() == p2.read_bytes()
    st = load_state(p1)
    assert st.spec == spec and st.round == 2 and len(st.records) == 2
    assert st.arrays["state.key"].dtype == np.uint32
    assert st.arrays["state.round"].dtype == np.int64


def _torn_writer(f, hdr, blobs):
    """An FNLS1 write that dies after the magic, as a killed process would."""
    f.write(b"FNLSESS1")
    raise OSError("killed mid-write")


def test_an_interrupted_save_leaves_no_file_under_its_name(tmp_path, monkeypatch):
    """save_state is atomic: a write that fails midway leaves neither the
    final name nor a temporary file, and the earlier checkpoint loads."""
    with open_session(full_spec(), device=CPU) as s:
        s.step(2)
        prev = s.save(tmp_path / "t0000.r2.fnlsess")
        s.step(1)
        monkeypatch.setattr(tapi.session, "_write_fnls1", _torn_writer)
        with pytest.raises(OSError, match="killed mid-write"):
            s.save(tmp_path / "t0000.r3.fnlsess")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["t0000.r2.fnlsess"]
    assert load_state(prev).round == 2


def test_an_interrupted_spill_keeps_the_previous_spill(tmp_path, monkeypatch):
    """The serving engine's spill goes through save_state: a spill that
    fails midway leaves the tenant's previous spill whole, the newest file
    a resume would pick, and nothing else in the directory."""
    from repro_torch.serve_fednl import FedNLServer, ServeConfig

    spec = full_spec(rounds=10)
    with FedNLServer(ServeConfig(spill_dir=tmp_path), device=CPU) as srv:
        h = srv.submit(spec)
        for _ in range(3):
            srv.tick()
        first = srv.evict(h.id)
        h2 = srv.resume(first)
        for _ in range(2):
            srv.tick()
        assert h2.round > 3
        monkeypatch.setattr(tapi.session, "_write_fnls1", _torn_writer)
        with pytest.raises(OSError, match="killed mid-write"):
            srv.evict(h2.id)
        assert sorted(p.name for p in tmp_path.iterdir()) == [first.name]
        st = load_state(first)
    assert st.round == 3 and st.spec == spec


def test_load_rejects_foreign_files(tmp_path):
    p = tmp_path / "notacheckpoint"
    p.write_bytes(b"PK\x03\x04 definitely a zip")
    with pytest.raises(ValueError, match="bad magic"):
        load_state(p)


# ---------------------------------------------------------------------------
# restore validation
# ---------------------------------------------------------------------------

def test_restore_incompatible_specs_rejected(tmp_path):
    spec = pp_spec(rounds=4)
    ck = tmp_path / "pp.fnlsess"
    with open_session(spec, device=CPU) as s:
        s.step(2)
        s.save(ck)
    with pytest.raises(ValueError, match="tau"):
        open_session(spec.replace(tau=2), restore=ck, device=CPU)
    with pytest.raises(ValueError, match="compressor.name"):
        open_session(spec.replace(compressor=CompressorSpec("randk")), restore=ck, device=CPU)
    with pytest.raises(ValueError, match="backend"):
        open_session(spec.replace(backend="star-loopback"), restore=ck, device=CPU)
    with pytest.raises(ValueError, match="checkpoint ran with 0, spec asks for 1"):
        open_session(spec.replace(seed=1), restore=ck, device=CPU)
    # rounds/tol may change (run control)
    with open_session(spec.replace(rounds=6), restore=ck, device=CPU) as s:
        assert s.run().rounds == 6


def test_restore_refuses_x0_override(tmp_path):
    spec = full_spec()
    ck = tmp_path / "f.fnlsess"
    with open_session(spec, device=CPU) as s:
        s.save(ck)
    with pytest.raises(ValueError, match="x0"):
        open_session(spec, x0=np.zeros(SHAPE[0]), restore=ck, device=CPU)


def test_restore_refuses_a_truncated_state(tmp_path):
    spec = full_spec()
    with open_session(spec, device=CPU) as s:
        s.step(1)
        st = s.state
    arrays = {k: v for k, v in st.arrays.items() if k != "state.h_local"}
    with pytest.raises(ValueError, match="missing state arrays"):
        open_session(spec, restore=dataclasses.replace(st, arrays=arrays), device=CPU)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    """device=None means the card: without one, open_session, solve and
    solve_many raise before running anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = full_spec(rounds=1)
    for call in (lambda: open_session(spec), lambda: solve(spec),
                 lambda: tapi.solve_many(spec.grid(seed=[0, 1]))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ---------------------------------------------------------------------------
# the full spec: the reference's fields, refusals of what is not ported
# ---------------------------------------------------------------------------

def test_public_names_are_the_reference_but_what_waits():
    """Nothing waits now that specwire is ported; the topology specs are lazy
    attributes, as the reference's."""
    assert set(tapi.__all__) == set(japi.__all__)
    assert all(hasattr(tapi, name) for name in tapi.__all__)


def test_spec_fields_and_defaults_are_the_reference():
    t_dict = tapi.session.spec_to_dict(ExperimentSpec())
    j_dict = japi.session.spec_to_dict(japi.ExperimentSpec())
    assert t_dict == j_dict
    assert tapi.list_backends() == japi.list_backends()
    assert tapi.list_algorithms() == japi.list_algorithms()
    assert DataSpec(dataset="w8a").dims() == japi.DataSpec(dataset="w8a").dims()
    assert DataSpec(shape=(5, 3, 7)).dims() == (5, 3, 7)
    for bad in (dict(hessian="xla"), dict(on_dropout="retry"), dict(tau=2),
                dict(fault=tapi.FaultSpec(drop_prob=0.1))):
        with pytest.raises(ValueError):
            ExperimentSpec(**bad)


@pytest.mark.parametrize(
    "changes,exc,match",
    [  # ids as before the sharded cases (changes1, 2 and 4) went
        pytest.param(dict(algorithm="fednl-pp", tau=2, fault=tapi.FaultSpec(drop_prob=0.1)),
                     ValueError, "needs a wire backend",
                     id="changes0-ValueError-needs a wire backend"),
        pytest.param(dict(hessian="jnp"), ValueError, "one Hessian kernel",
                     id="changes3-ValueError-one Hessian kernel"),
        pytest.param(dict(topology=tapi.TopologySpec(kind="tree")), ValueError,
                     "cannot run a non-trivial topology",
                     id="changes5-ValueError-cannot run a non-trivial topology"),
    ],
)
def test_fields_not_ported_are_refused_at_solve(changes, exc, match):
    spec = full_spec(rounds=1, **changes)  # accepted at construction
    with pytest.raises(exc, match=match):
        solve(spec, device=CPU)
    with pytest.raises(exc, match=match):
        open_session(spec, device=CPU)


def test_topology_refused_and_pallas_runs_the_syrk_kernel():
    """The local backend refuses a tree with the reference's error; a spec
    dict with a topology and a membership rebuilds as the reference's does."""
    with pytest.raises(ValueError, match="cannot run a non-trivial topology"):
        solve(full_spec(rounds=1, topology=tapi.TopologySpec(kind="tree")), device=CPU)
    base = tapi.session.spec_to_dict(full_spec())
    tree = dict(base, topology={"kind": "tree", "edges": [[0, 2], [1]]})
    mem = dict(base, membership={"events": [{"round": 1, "action": "leave", "client": 2}]})
    got = tapi.session.spec_from_dict(tree)
    assert got.topology == tapi.TopologySpec(kind="tree", edges=((0, 2), (1,)))
    got_mem = tapi.session.spec_from_dict(mem)
    assert got_mem.membership == tapi.MembershipSpec(events=(tapi.MembershipEvent(1, "leave", 2),))
    for d, spec in ((tree, got), (mem, got_mem)):
        assert tapi.session.spec_to_dict(spec) == japi.session.spec_to_dict(
            japi.session.spec_from_dict(d))
    want = solve(full_spec(rounds=3), device=CPU)
    for changes in (dict(hessian="pallas"), dict(use_kernel=True)):
        assert_reports_bit_identical(solve(full_spec(rounds=3, **changes), device=CPU), want)


def test_registered_compressor_runs_in_a_session():
    from repro_torch.compressors import get_compressor
    from repro_torch.compressors.core import CUSTOM_COMPRESSORS

    def make(t, k):
        return dataclasses.replace(get_compressor("topk", t, k), name="topk-copy")

    tapi.register_compressor("topk-copy", make)
    try:
        with pytest.raises(ValueError, match="already registered"):
            tapi.register_compressor("topk", make)
        got = solve(full_spec(compressor=CompressorSpec("topk-copy")), device=CPU)
        assert_reports_bit_identical(got, solve(full_spec(), device=CPU))
    finally:
        CUSTOM_COMPRESSORS.pop("topk-copy", None)
    with pytest.raises(ValueError, match="unknown algorithm kind"):
        tapi.Algorithm("x", "half", init=None, make_round=None)


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

XPKG = [("fednl", "topk"), ("fednl", "natural"), ("fednl-ls", "toplek"), ("fednl-pp", "randseqk")]


def _pair(algorithm, comp, rounds=8):
    kw = dict(rounds=rounds, algorithm=algorithm, tau=4 if algorithm == "fednl-pp" else None)
    t_spec = ExperimentSpec(data=DataSpec(dataset="tiny", seed=1), compressor=CompressorSpec(comp), **kw)
    j_spec = japi.ExperimentSpec(
        data=japi.DataSpec(dataset="tiny", seed=1), compressor=japi.CompressorSpec(comp), **kw)
    return t_spec, j_spec


@pytest.mark.parametrize("algorithm,comp", XPKG)
def test_reference_checkpoint_round_trips_byte_for_byte(tmp_path, algorithm, comp):
    """(a) the reference's FNLS1 file, loaded and saved by the port."""
    t_spec, j_spec = _pair(algorithm, comp)
    with japi.open_session(j_spec) as s:
        s.step(3)
        s.save(tmp_path / "ref")
    st = load_state(tmp_path / "ref")
    assert st.spec == t_spec and st.round == 3
    save_state(st, tmp_path / "port")
    assert (tmp_path / "port").read_bytes() == (tmp_path / "ref").read_bytes()


@pytest.mark.parametrize("algorithm,comp", XPKG)
def test_port_checkpoint_resumes_in_both_packages(tmp_path, algorithm, comp):
    """(b) a port file loads in repro.api.load_state; (c) the two
    continuations agree within the parity bounds, bits exact."""
    t_spec, j_spec = _pair(algorithm, comp)
    ck = tmp_path / "port.fnlsess"
    with open_session(t_spec, device=CPU) as s:
        s.step(3)
        s.save(ck)
    j_state = japi.load_state(ck)
    assert j_state.spec == j_spec and j_state.round == 3 and len(j_state.records) == 3
    with japi.open_session(j_spec, restore=ck) as s:
        want = s.run()
    with open_session(t_spec, restore=ck, device=CPU) as s:
        got = s.run()
    assert got.rounds == want.rounds == t_spec.rounds
    for col in ("sent_bits", "sent_bits_payload", "sent_bits_wire"):
        np.testing.assert_array_equal(getattr(got, col), getattr(want, col))
    np.testing.assert_allclose(got.x, want.x, rtol=X_RTOL)
    if algorithm == "fednl-pp":
        assert got.participants == want.participants
        np.testing.assert_allclose(got.x_hist, want.x_hist, rtol=X_RTOL, atol=1e-14)
    else:
        live = want.grad_norms >= GN_FLOOR
        np.testing.assert_allclose(got.grad_norms[live], want.grad_norms[live], rtol=GN_RTOL)
        assert [r.ls_steps for r in got.records] == [r.ls_steps for r in want.records]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_sharded_checkpoint_crosses_the_packages(tmp_path, writer):
    """A sharded session's FNLS1 file, written by one package and resumed by
    both: the continuations agree within the parity bounds, bits exact."""
    kw = dict(rounds=8, backend="sharded", aggregate="sparse_allgather")
    t_spec = ExperimentSpec(data=DataSpec(dataset="tiny", seed=1), **kw)
    j_spec = japi.ExperimentSpec(data=japi.DataSpec(dataset="tiny", seed=1), **kw)
    ck = tmp_path / "sharded.fnlsess"
    if writer == "port":
        with open_session(t_spec, device=CPU) as s:
            s.step(3)
            s.save(ck)
    else:
        with japi.open_session(j_spec) as s:
            s.step(3)
            s.save(ck)
    assert load_state(ck).spec == t_spec and japi.load_state(ck).spec == j_spec
    with japi.open_session(j_spec, restore=ck) as s:
        want = s.run()
    with open_session(t_spec, restore=ck, device=CPU) as s:
        got = s.run()
    assert got.rounds == want.rounds == 8
    for col in ("sent_bits", "sent_bits_payload", "sent_bits_wire"):
        np.testing.assert_array_equal(getattr(got, col), getattr(want, col))
    live = want.grad_norms >= GN_FLOOR
    np.testing.assert_allclose(got.grad_norms[live], want.grad_norms[live], rtol=GN_RTOL)
    np.testing.assert_allclose(got.x, want.x, rtol=X_RTOL)
