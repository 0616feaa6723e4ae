"""The rest of the paper's algorithm family against the live reference (CPU):
FedNL with RandK and Natural, FedNL-LS (Algorithm 2), FedNL-PP (Algorithm 3),
the centralized baselines and the quadratic objective.

Tolerances (as tests/test_torch_fednl.py; the rounds add in other orders
than XLA does):
  * sent_bits (payload and wire), sent_elems, PP's chosen clients: exact,
    every round;
  * grad norms: rtol GN_RTOL on every round where the reference's norm is
    >= GN_FLOOR, and each run reaches a norm below 1e-12;
  * PP's per-round models x_hist and final x: rtol X_RTOL, every round.

FedNL-LS's backtracking count is exact on every round whose reference grad
norm is at least LS_DECIDED, and the grad norms are compared up to the first
round below it.  Below it the Armijo test compares f-values whose difference
is under their rounding error: the sufficient decrease c <grad, d> is about
c ||grad||^2 / lambda_max(H), under 1e-16 relative to f ~ 0.5 at ||grad|| ~
1e-9, so there each package's decision follows its own summation order
(measured on these problems: the two disagree at norms of 9e-11 to 5e-9),
and the trajectories part.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.api.backends import state_arrays
from repro.core.fednl_pp import fednl_pp_init as j_pp_init, make_fednl_pp_round as j_pp_round
import repro_torch.api as tapi
from repro_torch.core import fednl as tfednl
from repro_torch.core import fednl_pp as tpp
from repro_torch.core.runner import gd_baseline, newton_baseline, run_fednl, run_fednl_pp

GN_RTOL, GN_FLOOR, X_RTOL = 1e-6, 1e-10, 1e-8
LS_DECIDED = 1e-7


def _specs(dataset, compressor="topk", **common):
    return (
        tapi.ExperimentSpec(data=tapi.DataSpec(dataset=dataset),
                            compressor=tapi.CompressorSpec(compressor), **common),
        japi.ExperimentSpec(data=japi.DataSpec(dataset=dataset),
                            compressor=japi.CompressorSpec(compressor), **common),
    )


def _check_bits(got, want):
    for col in ("sent_bits", "sent_bits_payload", "sent_bits_wire", "sent_elems"):
        np.testing.assert_array_equal(got._column(col), want._column(col), err_msg=col)
    assert got.sent_bits.dtype == np.int64


@pytest.mark.parametrize("dataset", ["tiny", "phishing"])
@pytest.mark.parametrize("compressor", ["randk", "natural"])
def test_random_compressors_match_reference(compressor, dataset):
    t_spec, j_spec = _specs(dataset, compressor, rounds=20)
    got, want = tapi.solve(t_spec, device="cpu"), japi.solve(j_spec)
    assert got.rounds == want.rounds == 20
    _check_bits(got, want)
    live = want.grad_norms >= GN_FLOOR
    assert live.sum() >= 6
    np.testing.assert_allclose(got.grad_norms[live], want.grad_norms[live], rtol=GN_RTOL, atol=0)
    assert got.grad_norms.min() < 1e-12


LS_CASES = {
    "topk": dict(),
    "randk": dict(compressor="randk"),
    "zero_option_a": dict(hess0="zero", option="A"),  # backtracks 6-8 times in round 0
}


@pytest.mark.parametrize("dataset", ["tiny", "phishing"])
@pytest.mark.parametrize("case", sorted(LS_CASES))
def test_line_search_matches_reference(case, dataset):
    t_spec, j_spec = _specs(dataset, algorithm="fednl-ls", rounds=25, **LS_CASES[case])
    got, want = tapi.solve(t_spec, device="cpu"), japi.solve(j_spec)
    assert got.rounds == want.rounds == 25
    _check_bits(got, want)
    gn_j = want.grad_norms
    first_below = int(np.argmax(gn_j < LS_DECIDED))
    assert gn_j[first_below] < LS_DECIDED and first_below >= 2
    decided = slice(0, first_below)
    np.testing.assert_array_equal(got.ls_steps[decided], want._column("ls_steps")[decided])
    upto = slice(0, first_below + 1)
    np.testing.assert_allclose(got.grad_norms[upto], gn_j[upto], rtol=GN_RTOL, atol=0)
    assert got.ls_steps.dtype == np.int64 and np.all(got.ls_steps >= 0)
    assert got.grad_norms.min() < 1e-12 and gn_j.min() < 1e-12
    if case == "zero_option_a":
        assert got.ls_steps[0] == want.records[0].ls_steps > 0
    assert "fednl-ls@local[cpu]" in got.summary()


PP_CASES = {
    "topk": dict(),
    "randk": dict(compressor="randk"),
    "natural_wire_tau3": dict(compressor="natural", accounting="wire", tau=3),
}


@pytest.mark.parametrize("dataset", ["tiny", "phishing"])
@pytest.mark.parametrize("case", sorted(PP_CASES))
def test_partial_participation_matches_reference(case, dataset):
    t_spec, j_spec = _specs(dataset, algorithm="fednl-pp", rounds=15, **PP_CASES[case])
    got, want = tapi.solve(t_spec, device="cpu"), japi.solve(j_spec)
    assert got.rounds == want.rounds == 15
    _check_bits(got, want)
    assert got.participants == want.participants
    n = t_spec.data.build().shape[0]
    assert all(len(set(p)) == t_spec.tau_for(n) for p in got.participants)
    assert got.extras["tau"] == want.extras["tau"] == t_spec.tau_for(n)
    np.testing.assert_allclose(got.x_hist, want.x_hist, rtol=X_RTOL, atol=1e-300)
    np.testing.assert_allclose(got.l_vals, want.l_vals, rtol=X_RTOL)
    np.testing.assert_allclose(got.x, want.x, rtol=X_RTOL)
    assert all(r.grad_norm is None for r in got.records)
    np.testing.assert_allclose(got.final_grad_norm, want.final_grad_norm, rtol=1e-5)
    assert "||grad(x_final)||" in got.summary()


def test_pp_state_carried_across_continues():
    """A reference FedNLPPState after 2 rounds goes into the port; each side
    runs one more round from it and the states agree, the key included."""
    t_spec, j_spec = _specs("tiny", algorithm="fednl-pp", compressor="randk")
    cfg_j, cfg_t = j_spec.fednl_config(), t_spec.fednl_config()
    z = np.array(j_spec.data.build())
    tau = j_spec.tau_for(z.shape[0])
    round_j = jax.jit(j_pp_round(jnp.asarray(z), cfg_j, tau))
    state_j = j_pp_init(jnp.asarray(z), cfg_j, seed=0)
    for _ in range(2):
        state_j, _ = round_j(state_j)
    arrays = state_arrays(state_j)

    state_t = tfednl.state_from_numpy(arrays, "cpu", state_type=tpp.FedNLPPState)
    assert state_t.round == 2
    back = tfednl.state_to_numpy(state_t)
    for name, arr in arrays.items():
        np.testing.assert_array_equal(back[name], arr)
        assert back[name].dtype == arr.dtype, name

    state_j3, m_j = round_j(state_j)
    state_t3, m_t = tpp.make_fednl_pp_round(torch.as_tensor(z), cfg_t, tau)(state_t)
    np.testing.assert_array_equal(m_t.idx, np.asarray(m_j.idx))
    np.testing.assert_allclose(m_t.x.numpy(), np.asarray(m_j.x), rtol=1e-12)
    assert int(m_t.sent_bits) == int(m_j.sent_bits)
    for name in ("h_local", "l_local", "g_local", "w_local", "h_global", "l_global", "g_global"):
        want = np.asarray(getattr(state_j3, name))
        got = getattr(state_t3, name).numpy()
        assert np.max(np.abs(got - want)) <= 1e-12 * max(np.max(np.abs(want)), 1e-300), name
    np.testing.assert_array_equal(state_t3.key, np.asarray(state_j3.key))
    assert state_t3.round == int(state_j3.round) == 3


def test_pp_round_leaves_its_input_state_alone():
    """The round updates the chosen clients' rows out of place, so the init
    state is unchanged after the warm-up round and a replay gives the same."""
    t_spec, _ = _specs("tiny", algorithm="fednl-pp")
    z = torch.as_tensor(t_spec.data.build())
    cfg = t_spec.fednl_config()
    state = tpp.fednl_pp_init(z, cfg)
    before = tfednl.state_to_numpy(state)
    round_fn = tpp.make_fednl_pp_round(z, cfg, 4)
    s1, m1 = round_fn(state)
    s2, m2 = round_fn(state)
    for name, arr in tfednl.state_to_numpy(state).items():
        np.testing.assert_array_equal(arr, before[name])
    np.testing.assert_array_equal(m1.idx, m2.idx)
    assert torch.equal(s1.h_local, s2.h_local) and torch.equal(m1.x, m2.x)
    rest = np.setdiff1d(np.arange(z.shape[0]), m1.idx)
    assert torch.equal(s1.h_local[rest], state.h_local[rest])


def test_runners_match_solve():
    t_spec, _ = _specs("tiny", rounds=6)
    z, cfg = t_spec.data.build(), t_spec.fednl_config()
    res = run_fednl(z, cfg, rounds=6, line_search=True, device="cpu")
    rep = tapi.solve(t_spec.replace(algorithm="fednl-ls"), device="cpu")
    np.testing.assert_array_equal(res.grad_norms, rep.grad_norms)
    np.testing.assert_array_equal(res.x, rep.x)
    pp = run_fednl_pp(z, cfg, tau=4, rounds=6, device="cpu")
    rep = tapi.solve(t_spec.replace(algorithm="fednl-pp", tau=4), device="cpu")
    np.testing.assert_array_equal(pp.x_hist, rep.x_hist)
    np.testing.assert_array_equal(pp.x, rep.x)
    np.testing.assert_array_equal(pp.sent_bits, rep.sent_bits)
    assert pp.grad_norm == rep.final_grad_norm and pp.rounds == 6


def test_spec_checks_match_reference():
    for kw in (dict(algorithm="fednl", tau=3), dict(algorithm="fednl-pp", tol=1e-9)):
        for pkg in (tapi, japi):
            with pytest.raises(ValueError):
                pkg.ExperimentSpec(**kw)
    for n, tau in ((8, None), (8, 3), (1, None), (142, None)):
        t = tapi.ExperimentSpec(algorithm="fednl-pp", tau=tau)
        j = japi.ExperimentSpec(algorithm="fednl-pp", tau=tau)
        assert t.tau_for(n) == j.tau_for(n)
    with pytest.raises(ValueError, match="tau"):
        tapi.ExperimentSpec(algorithm="fednl-pp", tau=9).tau_for(8)
    t, j = tapi.ExperimentSpec(), japi.ExperimentSpec()
    for field in ("mu", "ls_c", "ls_gamma", "ls_max_steps", "ls_tol", "tau"):
        assert getattr(t, field) == getattr(j, field), field
    cfg = tapi.ExperimentSpec(ls_c=0.3, ls_max_steps=4).fednl_config()
    assert (cfg.ls_c, cfg.ls_max_steps) == (0.3, 4)


@pytest.mark.parametrize("compressor", ["topk", "randk", "randseqk", "toplek", "natural", "identity"])
def test_pp_bit_models_match_reference(compressor):
    from repro.comm.wire import pp_frame_bits as j_frame, pp_message_bits as j_msg
    from repro.compressors.core import get_compressor as j_get
    from repro_torch.api.accounting import payload_bits_fn, wire_bits_fn
    from repro_torch.comm.wire import pp_frame_bits, pp_message_bits
    from repro_torch.compressors import get_compressor

    t, k, d = 300, 24, 24
    comp_t, comp_j = get_compressor(compressor, t, k), j_get(compressor, t, k)
    sent = torch.tensor([0, 1, 7, 24, 300], dtype=torch.int32)
    for s in sent.tolist():
        assert int(pp_message_bits(comp_t, sent, d)[sent.tolist().index(s)]) == int(j_msg(comp_j, s, d))
        assert int(pp_frame_bits(comp_t, sent, d)[sent.tolist().index(s)]) == int(j_frame(comp_j, s, d))
    assert torch.equal(payload_bits_fn(comp_t, d, pp=True)(sent), pp_message_bits(comp_t, sent, d))
    assert torch.equal(wire_bits_fn(comp_t, d, pp=True)(sent), pp_frame_bits(comp_t, sent, d))
    assert pp_frame_bits(comp_t, sent, d).dtype == torch.int64


def test_launcher_runs_line_search_on_cpu(capsys):
    from repro_torch.launch.fednl_run import main

    main(["--dataset", "tiny", "--line-search", "--compressor", "randk", "--rounds", "3",
          "--device", "cpu"])
    assert "fednl-ls@local[cpu]: rounds=3" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the centralized baselines, the quadratic objective, finite differences
# ---------------------------------------------------------------------------


def test_newton_baseline_matches_reference():
    from repro.core.runner import newton_baseline as j_newton

    z = japi.DataSpec(dataset="tiny").build()
    got = newton_baseline(np.array(z), 1e-3, device="cpu")
    want = j_newton(z, 1e-3)
    assert got.rounds == want.rounds
    live = want.grad_norms >= GN_FLOOR
    np.testing.assert_allclose(got.grad_norms[live], want.grad_norms[live], rtol=GN_RTOL)
    np.testing.assert_allclose(got.f_vals, want.f_vals, rtol=1e-12)
    np.testing.assert_allclose(got.x, want.x, rtol=X_RTOL)


def test_gd_baseline_matches_reference():
    from repro.core.runner import gd_baseline as j_gd

    z = japi.DataSpec(dataset="tiny").build()
    got = gd_baseline(np.array(z), 1e-3, iters=60, device="cpu")
    want = j_gd(z, 1e-3, iters=60)
    assert got.rounds == want.rounds == 60
    np.testing.assert_allclose(got.grad_norms, want.grad_norms, rtol=1e-10)
    np.testing.assert_allclose(got.x, want.x, rtol=1e-10)


def test_numpy_reference_baseline_is_the_reference_copy():
    from repro.baselines import run_fednl_numpy_reference as j_ref
    from repro_torch.baselines import run_fednl_numpy_reference as t_ref

    z = np.asarray(japi.DataSpec(dataset="tiny").build())
    for compressor in ("topk", "randk", "identity"):
        assert t_ref(z, 1e-3, 4, compressor)[0] == j_ref(z, 1e-3, 4, compressor)[0]


def test_quadratic_oracles_match_reference():
    from repro.objectives.quadratic import quadratic_oracles as j_quad
    from repro_torch.objectives import QuadraticProblem, quadratic_oracles

    rng = np.random.default_rng(3)
    a = rng.standard_normal((4, 6, 6))
    b = a @ np.swapaxes(a, -1, -2) + np.eye(6)
    c = rng.standard_normal((4, 6))
    x = rng.standard_normal(6)
    f, g, h = quadratic_oracles(torch.as_tensor(b), torch.as_tensor(c), torch.as_tensor(x))
    for i in range(4):
        fj, gj, hj = j_quad(jnp.asarray(b[i]), jnp.asarray(c[i]), jnp.asarray(x))
        np.testing.assert_allclose(f[i].item(), float(fj), rtol=1e-13)
        np.testing.assert_allclose(g[i].numpy(), np.asarray(gj), rtol=1e-13, atol=1e-14)
        np.testing.assert_array_equal(h[i].numpy(), np.asarray(hj))
    prob = QuadraticProblem(torch.as_tensor(b), torch.as_tensor(c))
    assert (prob.n_clients, prob.dim) == (4, 6)
    # the Newton step of the averaged quadratic lands on its minimiser
    x1 = x - np.linalg.solve(b.mean(0), g.mean(0).numpy())
    np.testing.assert_allclose(b.mean(0) @ x1, c.mean(0), rtol=1e-10, atol=1e-12)


def test_port_oracles_pass_the_finite_difference_check():
    from repro_torch.numerics import check_oracles
    from repro_torch.objectives import logreg_f, logreg_grad, logreg_hess

    z = torch.as_tensor(np.array(japi.DataSpec(dataset="tiny").build())[0])
    x = np.random.default_rng(1).standard_normal(z.shape[-1]) * 0.1

    def on(fn):
        return lambda v: fn(z, torch.as_tensor(v), 1e-3).numpy()

    g_err, h_err = check_oracles(on(logreg_f), on(logreg_grad), on(logreg_hess), x)
    assert g_err < 1e-7 and h_err < 1e-4
