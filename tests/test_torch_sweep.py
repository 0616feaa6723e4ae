"""The port's sweeps (SweepSpec -> solve_many) against its own solve() and
against repro's solve_many (CPU).

Mirrors tests/test_sweep.py:

  * grid expansion is the reference's, spec by spec (``spec_to_dict``), and
    invalid axes fail as ``solve()`` fails;
  * ``plan_sweep`` partitions the specs into the reference's plans;
  * a batched group is bit-identical to the port's sequential ``solve()`` of
    each spec on the CPU (the "scan" layout runs the matrix-vector products
    one per spec; everything else in the round acts per row), and within
    the parity bounds of tests/test_torch_fednl.py of the reference's
    ``solve_many``: grad norms rtol 1e-6 where the reference's is >= 1e-10,
    x rtol 1e-8, bits exact;
  * the "vmap" layout within the reference's own vmap bounds (x atol 1e-12,
    grad norms rtol 1e-9 / atol 1e-15), bits exact.
"""

import numpy as np
import pytest
import torch

import repro.api as japi
from repro.api.batch import plan_sweep as j_plan_sweep
from repro_torch.api import CompressorSpec, DataSpec, ExperimentSpec, SweepSpec, solve, solve_many
from repro_torch.api.batch import plan_sweep
from repro_torch.api.session import spec_to_dict
from repro_torch.core import fednl_batch as fb
from repro_torch.linalg import frob_norm_from_packed

CPU = "cpu"
GN_RTOL, GN_FLOOR, X_RTOL = 1e-6, 1e-10, 1e-8
BASE = ExperimentSpec(data=DataSpec(dataset="tiny", seed=1), rounds=4)
J_BASE = japi.ExperimentSpec(data=japi.DataSpec(dataset="tiny", seed=1), rounds=4)


def to_reference(spec):
    return japi.session.spec_from_dict(spec_to_dict(spec))


def assert_bit_identical(got, want):
    assert [g.hex() for g in got.grad_norms] == [g.hex() for g in want.grad_norms]
    np.testing.assert_array_equal(got.x, want.x)
    for col in ("sent_bits", "sent_bits_payload", "sent_bits_wire"):
        assert list(getattr(got, col)) == list(getattr(want, col))
    assert [r.sent_elems for r in got.records] == [r.sent_elems for r in want.records]
    assert [r.ls_steps for r in got.records] == [r.ls_steps for r in want.records]
    assert [r.f for r in got.records] == [r.f for r in want.records]


def assert_parity(got, want):
    """The port against the reference: the slice's parity bounds."""
    assert got.rounds == want.rounds
    for col in ("sent_bits", "sent_bits_payload", "sent_bits_wire"):
        np.testing.assert_array_equal(getattr(got, col), getattr(want, col))
    live = want.grad_norms >= GN_FLOOR
    np.testing.assert_allclose(got.grad_norms[live], want.grad_norms[live], rtol=GN_RTOL)
    np.testing.assert_allclose(got.x, want.x, rtol=X_RTOL)


# ---------------------------------------------------------------------------
# expansion contracts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "axes",
    [
        dict(seed=[0, 1, 2], compressor=["topk", "randseqk"]),
        dict(k_multiplier=[2, 8], comp_alpha=[None, 0.5], data_seed=[1, 2]),
        dict(dataset=["tiny", "phishing"], option=["A", "B"], accounting=["payload", "wire"]),
        dict(compressor=[CompressorSpec("natural"), "toplek"], lam=[1e-3, 1e-2], rounds=[1, 3]),
    ],
)
def test_grid_expansion_is_the_reference(axes):
    sweep = BASE.grid(**axes)
    j_axes = {
        name: [japi.CompressorSpec(v.name, v.k_multiplier, v.alpha)
               if isinstance(v, CompressorSpec) else v for v in values]
        for name, values in axes.items()
    }
    want = J_BASE.grid(**j_axes).specs()
    got = sweep.specs()
    assert len(got) == sweep.n_specs == len(sweep) == len(want)
    assert [spec_to_dict(s) for s in got] == [japi.session.spec_to_dict(s) for s in want]
    assert list(sweep) == list(got) and len(set(got)) == len(got)


def test_grid_invalid_axis_values_fail_like_solve():
    with pytest.raises(ValueError, match="unknown option"):
        BASE.grid(option=["A", "Z"]).specs()
    with pytest.raises(ValueError, match="accounting"):
        BASE.grid(accounting=["payload", "bytes"]).specs()
    with pytest.raises(ValueError, match="partial participation"):
        BASE.grid(tau=[2]).specs()
    with pytest.raises(KeyError, match="unknown algorithm"):
        solve_many(BASE.grid(algorithm=["fednl", "fednl2"]), device=CPU)
    with pytest.raises(KeyError, match="unknown backend"):
        solve_many(BASE.grid(backend=["local", "ray"]), device=CPU)
    with pytest.raises(KeyError, match="unknown compressor"):
        solve_many(BASE.grid(compressor=["topk", "bzip2"], rounds=[1]), device=CPU)
    # a topology on the local backend is refused, like solve() refuses it
    # (the reference's rule), before anything runs
    from repro_torch.api import TopologySpec

    with pytest.raises(ValueError, match="cannot run a non-trivial topology"):
        solve_many([BASE, BASE.replace(topology=TopologySpec(kind="tree"))], device=CPU)


def test_sweep_spec_shape_validation():
    with pytest.raises(ValueError, match="unknown sweep axis"):
        BASE.grid(compresor=["topk"])
    with pytest.raises(ValueError, match="duplicate values"):
        BASE.grid(seed=[1, 1])
    with pytest.raises(ValueError, match="no values"):
        BASE.grid(seed=[])
    with pytest.raises(ValueError, match="unknown batch mode"):
        BASE.grid(seed=[0, 1], batch="eventually")
    with pytest.raises(ValueError, match="duplicate sweep axis"):
        SweepSpec(base=BASE, axes=(("seed", (0,)), ("seed", (1,))))
    with pytest.raises(ValueError, match="duplicate specs"):
        BASE.grid(compressor=["topk", CompressorSpec("topk")]).specs()
    with pytest.raises(TypeError, match="DataSpec"):
        BASE.grid(data=["tiny"]).specs()
    sweep = BASE.grid(seed=[0, 1])
    assert sweep.replace(batch="never").batch == "never"
    assert sweep.batch == "auto"


# ---------------------------------------------------------------------------
# planning: the reference's partition
# ---------------------------------------------------------------------------

MIXED = [
    BASE.replace(seed=0),
    BASE.replace(seed=1, compressor=CompressorSpec("randseqk")),
    BASE.replace(algorithm="fednl-pp", tau=3, rounds=3),
    BASE.replace(tol=1e-10, rounds=30),
    BASE.replace(rounds=0, seed=7),
    BASE.replace(algorithm="fednl-ls", option="A", data=DataSpec(dataset="tiny", seed=2)),
    BASE.replace(algorithm="fednl-ls", option="A", data=DataSpec(dataset="tiny", seed=2), seed=3),
    BASE.replace(hessian="pallas", seed=4),
    BASE.replace(lam=1e-2),
    BASE.replace(algorithm="fednl-pp", tau=3, rounds=5),
    BASE.replace(seed=2, compressor=CompressorSpec("topk", alpha=0.5)),
    BASE.replace(data=DataSpec(dataset="tiny", seed=2), seed=5),
]


@pytest.mark.parametrize("batch_mode", ["auto", "vmap", "never"])
def test_plan_sweep_partitions_as_the_reference(batch_mode):
    plans, log = plan_sweep(MIXED, batch_mode)
    j_plans, j_log = j_plan_sweep([to_reference(s) for s in MIXED], batch_mode)
    assert [(p.kind, p.indices) for p in plans] == [(p.kind, p.indices) for p in j_plans]
    assert len(log) == len(j_log)
    assert sorted(i for p in plans for i in p.indices) == list(range(len(MIXED)))
    if batch_mode == "auto":
        kinds = [p.kind for p in plans]
        assert kinds.count("batch") == 2 and "warm" in kinds and "seq" in kinds


# ---------------------------------------------------------------------------
# the batched group against sequential solve() and the reference
# ---------------------------------------------------------------------------

def test_solve_many_8_spec_grid_bit_identical_to_sequential_and_near_the_reference():
    axes = dict(seed=[0, 1, 2, 3], compressor=["topk", "randseqk"])
    sweep = BASE.grid(**axes)
    rep = solve_many(sweep, device=CPU)
    assert rep.extras["batched_specs"] == 8 and rep.extras["n_groups"] == 1, rep.log
    assert "batched 8 specs as one group" in rep.log[0] and "64 clients a SYRK launch" in rep.log[0]
    j_rep = japi.solve_many(J_BASE.grid(**axes))
    for spec, got, want in zip(sweep.specs(), rep.reports, j_rep.reports):
        assert got.spec == spec
        assert_bit_identical(got, solve(spec, device=CPU))
        assert_parity(got, want)
        assert got.extras["sweep_batched"] is True and got.extras["devices"] == 1
        assert got.extras["compressor_branch"] == spec.compressor.name
        assert got.extras["device"] == "cpu" and got.extras["batch_size"] == 8


def test_solve_many_ls_and_data_axis():
    """FedNL-LS batches (its trials a host loop over the specs still
    searching), and a data axis splits into one group per DataSpec."""
    axes = dict(data_seed=[1, 2], compressor=["randseqk", "toplek"])
    sweep = BASE.replace(algorithm="fednl-ls", option="A").grid(**axes)
    rep = solve_many(sweep, device=CPU)
    assert rep.extras["batched_specs"] == 4
    assert rep.extras["n_groups"] == 2  # one group per DataSpec
    assert rep.extras["n_data_builds"] == 2
    j_rep = japi.solve_many(J_BASE.replace(algorithm="fednl-ls", option="A").grid(**axes))
    for spec, got, want in zip(sweep.specs(), rep.reports, j_rep.reports):
        assert_bit_identical(got, solve(spec, device=CPU))
        assert_parity(got, want)
        assert [r.ls_steps for r in got.records] == [r.ls_steps for r in want.records]


def test_batched_round_dispatches_every_branch():
    """Two TopK branches of different k, RandSeqK, TopLEK, RandK, Natural
    and Identity in one group: one call per branch, each spec bit-identical
    to its own solve()."""
    comps = [CompressorSpec("topk", 8.0), CompressorSpec("topk", 2.0), "randseqk", "toplek",
             "randk", "natural", "identity"]
    sweep = BASE.replace(rounds=3).grid(compressor=comps, seed=[0, 1])
    rep = solve_many(sweep, device=CPU)
    assert rep.extras["batched_specs"] == 14 and rep.extras["n_groups"] == 1, rep.log
    assert "7 compressor branch(es)" in rep.log[0]
    for spec, got in zip(sweep.specs(), rep.reports):
        assert_bit_identical(got, solve(spec, device=CPU))
    topk8, topk2 = rep.reports[0], rep.reports[2]
    assert topk8.records[0].sent_elems == 4 * topk2.records[0].sent_elems
    one_branch = BASE.replace(rounds=3).grid(seed=[0, 1, 2])  # all rows one call
    rep = solve_many(one_branch, device=CPU)
    assert "1 compressor branch(es)" in rep.log[0]
    for spec, got in zip(one_branch.specs(), rep.reports):
        assert_bit_identical(got, solve(spec, device=CPU))


def test_batched_round_on_interleaved_branches():
    """Specs of one branch need not be contiguous in the stacked state: the
    rows are gathered and scattered back (index_select / index_copy)."""
    from repro_torch.compressors import get_compressor
    from repro_torch.core.fednl import fednl_init, make_fednl_round
    from repro_torch.core.fednl_batch import fednl_batch_init, make_fednl_batch_round
    from repro_torch.linalg import triu_size

    z = torch.as_tensor(BASE.data.build())
    d = z.shape[-1]
    names, seeds = ["topk", "natural", "randseqk", "topk", "natural"], [0, 1, 2, 3, 4]
    cfgs = [BASE.replace(compressor=CompressorSpec(n)).fednl_config() for n in names]
    table = ["topk", "natural", "randseqk"]
    comps = [get_compressor(n, triu_size(d), cfgs[0].k_for(d)) for n in table]
    round_b = make_fednl_batch_round(z, cfgs[0], comps, [table.index(n) for n in names], 1.0)
    state_b = fednl_batch_init(z, cfgs[0], seeds)
    states = [fednl_init(z, cfg, seed=s) for cfg, s in zip(cfgs, seeds)]
    rounds = [make_fednl_round(z, cfg) for cfg in cfgs]
    for r in range(4):
        if r:
            state_b, m_b = round_b(state_b)
        for s in range(len(names)):
            if r:
                states[s], m = rounds[s](states[s])
                assert torch.equal(m_b.grad_norm[s], m.grad_norm)
                assert int(m_b.sent_bits[s]) == int(m.sent_bits)
            for name in ("x", "h_local", "h_global"):
                assert torch.equal(getattr(state_b, name)[s], getattr(states[s], name)), (r, s)
            np.testing.assert_array_equal(state_b.key[s], states[s].key)


def test_group_past_the_syrk_grid_is_split(monkeypatch):
    import repro_torch.api.batch as tbatch

    monkeypatch.setattr(tbatch, "MAX_GROUP_CLIENTS", 20)  # tiny has 8 clients: 2 specs a group
    sweep = BASE.replace(rounds=2).grid(seed=[0, 1, 2], compressor=["topk", "randseqk"])
    rep = solve_many(sweep, device=CPU)
    assert any("split into groups of at most 2" in line for line in rep.log), rep.log
    assert sum(line.startswith("batched 2 specs") for line in rep.log) == 3
    for spec, got in zip(sweep.specs(), rep.reports):
        assert_bit_identical(got, solve(spec, device=CPU))


def test_solve_many_fallbacks_are_logged_not_dropped():
    specs = [
        BASE.replace(algorithm="fednl-pp", tau=3, rounds=3),
        BASE.replace(tol=1e-10, rounds=30),
        BASE.replace(seed=5),  # lone batchable spec -> sequential, logged
    ]
    rep = solve_many(specs, device=CPU)
    assert len(rep.reports) == 3 and all(r is not None for r in rep.reports)
    assert rep.extras["batched_specs"] == 0
    assert sum("fallback" in line for line in rep.log) == 3
    np.testing.assert_array_equal(rep.reports[0].x_hist, solve(specs[0], device=CPU).x_hist)
    assert rep.reports[1].rounds == solve(specs[1], device=CPU).rounds < 30


def test_solve_many_warm_start_reports_each_prefix():
    specs = [BASE.replace(algorithm="fednl-pp", tau=3, rounds=r) for r in (5, 2, 3)]
    rep = solve_many(specs, device=CPU)
    assert any("warm-start" in line for line in rep.log)
    for spec, got in zip(specs, rep.reports):
        want = solve(spec, device=CPU)
        assert got.spec == spec and got.rounds == spec.rounds
        np.testing.assert_array_equal(got.x_hist, want.x_hist)
        np.testing.assert_array_equal(got.x, want.x)


def test_solve_many_batch_never_and_list_input():
    sweep = BASE.grid(seed=[0, 1], batch="never")
    rep = solve_many(sweep, device=CPU)
    assert rep.extras["batched_specs"] == 0 and rep.log == []
    for spec, got in zip(sweep.specs(), rep.reports):
        assert_bit_identical(got, solve(spec, device=CPU))
    assert len(solve_many(list(sweep.specs()), device=CPU).reports) == 2
    with pytest.raises(ValueError, match="empty sweep"):
        solve_many([], device=CPU)
    with pytest.raises(TypeError, match="SweepSpec or ExperimentSpecs"):
        solve_many(["fednl"], device=CPU)


@pytest.mark.parametrize("algorithm", ["fednl", "fednl-ls"])
def test_solve_many_vmap_mode_close_to_sequential(algorithm):
    """vmap batches the products over the specs and groups across datasets
    of one shape: within float64 noise of the sequential trajectories."""
    sweep = BASE.replace(algorithm=algorithm).grid(
        data_seed=[1, 2], compressor=["topk", "randseqk"], batch="vmap")
    rep = solve_many(sweep, device=CPU)
    assert rep.extras["batched_specs"] == 4 and rep.extras["n_groups"] == 1
    for spec, got in zip(sweep.specs(), rep.reports):
        ref = solve(spec, device=CPU)
        np.testing.assert_allclose(got.x, ref.x, rtol=0, atol=1e-12)
        np.testing.assert_allclose(got.grad_norms, ref.grad_norms, rtol=1e-9, atol=1e-15)
        assert list(got.sent_bits) == list(ref.sent_bits)
        assert got.extras["vectorize"] == "vmap"


# ---------------------------------------------------------------------------
# SweepReport aggregation
# ---------------------------------------------------------------------------

def test_sweep_report_aggregation_helpers():
    sweep = BASE.grid(seed=[0, 1], compressor=["topk", "randseqk"])
    rep = solve_many(sweep, device=CPU)
    assert len(rep) == 4 and rep[0] is rep.reports[0] and list(rep) == rep.reports
    by_comp = rep.group_by("compressor.name")
    assert set(by_comp) == {("topk",), ("randseqk",)}
    assert all(len(v) == 2 for v in by_comp.values())
    rows = rep.table("seed", "compressor.name")
    assert len(rows) == 4
    assert rows[0]["compressor.name"] == "topk" and rows[0]["rounds"] == 4
    assert rows[0]["sent_bits_total"] == int(np.sum(rep.reports[0].sent_bits))
    table = rep.round_table("grad_norm")
    assert table.shape == (4, 4)
    np.testing.assert_array_equal(table[1], rep.reports[1].grad_norms)
    assert rep.summary().startswith("sweep: 4 specs")


@pytest.mark.parametrize("shape", [(3, 142), (5, 7, 301), (2, 4, 8)])
def test_aligned_spec_blocks_start_on_32_byte_boundaries(shape):
    """``_aligned`` lays each spec's block from a 32-byte boundary, values
    unchanged, and is a no-op where every block already starts on one."""
    # torch's own allocation, 64-byte aligned as the round's tensors are
    # (numpy's memory, which torch.as_tensor would share, need not be)
    v = torch.tensor(np.random.default_rng(0).standard_normal(shape))
    got = fb._aligned(v)
    assert torch.equal(got, v)
    assert all(got[s].data_ptr() % 32 == 0 for s in range(shape[0]))
    assert all(got[s].is_contiguous() for s in range(shape[0]))
    if v[0].numel() % 4 == 0:
        assert got.data_ptr() == v.data_ptr()
    # a tensor whose first block does not start on a boundary is copied
    shifted = torch.cat([torch.zeros(1, dtype=v.dtype), v.reshape(-1)])[1:].view(shape)
    got = fb._aligned(shifted)
    assert torch.equal(got, v)
    assert all(got[s].data_ptr() % 32 == 0 for s in range(shape[0]))


def test_client_frob_norms_are_the_sequential_rounds():
    """The clients' Frobenius norms from spec-aligned squares, bit for bit
    the per-spec ``frob_norm_from_packed`` of the sequential round."""
    d, n, s_count = 9, 5, 3
    delta = torch.as_tensor(np.random.default_rng(1).standard_normal((s_count * n, d * (d + 1) // 2)))
    got = fb._client_frob_norms(delta, s_count, d)
    want = torch.stack([frob_norm_from_packed(delta[s * n:(s + 1) * n].clone(), d)
                        for s in range(s_count)])
    assert got.shape == (s_count, n)
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))
