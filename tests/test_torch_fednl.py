"""The slice whole: repro_torch.api.solve against repro.api.solve (CPU).

Tolerances (the rounds add in other orders than XLA does):
  * sent_bits, payload and wire, and sent_elems: exact, every round;
  * grad norms: rtol 1e-6 on every round where the reference's norm is
    >= 1e-10 (below that the two trajectories' rounding noise dominates);
  * final x: rtol 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.api.backends import state_arrays
from repro.core.fednl import fednl_init as j_init, make_fednl_round as j_round
import repro_torch.api as tapi
from repro_torch.core import fednl as tfednl
from repro_torch.core.runner import run_fednl

GN_RTOL, GN_FLOOR, X_RTOL = 1e-6, 1e-10, 1e-8


def _specs(compressor, accounting="payload", option="B", rounds=12):
    common = dict(rounds=rounds, option=option, accounting=accounting)
    return (
        tapi.ExperimentSpec(
            data=tapi.DataSpec(dataset="tiny"), compressor=tapi.CompressorSpec(compressor), **common
        ),
        japi.ExperimentSpec(
            data=japi.DataSpec(dataset="tiny"), compressor=japi.CompressorSpec(compressor), **common
        ),
    )


@pytest.mark.parametrize("compressor", ["topk", "identity"])
@pytest.mark.parametrize("accounting", ["payload", "wire"])
def test_solve_matches_reference(compressor, accounting):
    t_spec, j_spec = _specs(compressor, accounting)
    got = tapi.solve(t_spec, device="cpu")
    want = japi.solve(j_spec)
    assert got.rounds == want.rounds == 12
    for col in ("sent_bits", "sent_bits_payload", "sent_bits_wire"):
        np.testing.assert_array_equal(getattr(got, col), getattr(want, col))
    np.testing.assert_array_equal(got._column("sent_elems"), want._column("sent_elems"))
    assert got.sent_bits.dtype == np.int64
    gn_t, gn_j = got.grad_norms, want.grad_norms
    live = gn_j >= GN_FLOOR
    assert live.sum() >= 6
    np.testing.assert_allclose(gn_t[live], gn_j[live], rtol=GN_RTOL, atol=0)
    np.testing.assert_allclose(got.f_vals, want.f_vals, rtol=1e-12)
    np.testing.assert_allclose(got.x, want.x, rtol=X_RTOL, atol=0)
    assert gn_t[-1] < 1e-12
    assert got.extras["device"] == "cpu"
    assert "fednl@local[cpu]" in got.summary()


def test_solve_option_a_matches_reference():
    t_spec, j_spec = _specs("topk", option="A", rounds=6)
    got, want = tapi.solve(t_spec, device="cpu"), japi.solve(j_spec)
    live = want.grad_norms >= GN_FLOOR
    np.testing.assert_allclose(got.grad_norms[live], want.grad_norms[live], rtol=GN_RTOL)
    np.testing.assert_array_equal(got.sent_bits, want.sent_bits)


def test_solve_tol_stops_on_the_same_round():
    t_spec, j_spec = _specs("topk", rounds=40)
    got = tapi.solve(t_spec.replace(tol=1e-9), device="cpu")
    want = japi.solve(j_spec.replace(tol=1e-9))
    assert got.rounds == want.rounds < 40
    assert got.grad_norms[-1] < 1e-9 <= got.grad_norms[-2]


def test_run_fednl_matches_solve():
    t_spec, _ = _specs("topk", rounds=8)
    z = t_spec.data.build()
    res = run_fednl(z, t_spec.fednl_config(), rounds=8, device="cpu")
    rep = tapi.solve(t_spec.replace(rounds=8), device="cpu")
    np.testing.assert_array_equal(res.grad_norms, rep.grad_norms)
    np.testing.assert_array_equal(res.sent_bits, rep.sent_bits)
    np.testing.assert_array_equal(res.x, rep.x)
    assert res.rounds == 8 and res.init_time_s > 0 and res.wall_time_s > 0


def test_state_from_numpy_continues_a_reference_run():
    """A JAX state after 2 rounds goes into the port; each side runs one more
    round from it and the two states agree."""
    t_spec, j_spec = _specs("topk")
    cfg_j = j_spec.fednl_config()
    z = np.array(j_spec.data.build())
    zj = jnp.asarray(z)
    round_j = jax.jit(j_round(zj, cfg_j))
    state_j = j_init(zj, cfg_j, seed=0)
    for _ in range(2):
        state_j, _ = round_j(state_j)
    arrays = state_arrays(state_j)

    state_t = tfednl.state_from_numpy(arrays, "cpu")
    assert state_t.round == 2 and state_t.x.dtype == torch.float64
    np.testing.assert_array_equal(state_t.key, arrays["state.key"])
    back = tfednl.state_to_numpy(state_t)
    for name, arr in arrays.items():
        np.testing.assert_array_equal(back[name], arr)
        assert back[name].dtype == arr.dtype, name

    state_j3, m_j = round_j(state_j)
    round_t = tfednl.make_fednl_round(torch.as_tensor(z), t_spec.fednl_config())
    state_t3, m_t = round_t(state_t)
    assert state_t3.round == int(state_j3.round) == 3
    np.testing.assert_allclose(state_t3.x.numpy(), np.asarray(state_j3.x), rtol=1e-10)
    for name in ("h_local", "h_global"):
        want = np.asarray(getattr(state_j3, name))
        got = getattr(state_t3, name).numpy()
        assert np.max(np.abs(got - want)) <= 1e-13 * np.max(np.abs(want))
    np.testing.assert_allclose(m_t.grad_norm.item(), float(m_j.grad_norm), rtol=1e-10)
    assert int(m_t.sent_bits) == int(m_j.sent_bits)


def test_init_key_is_the_reference_key():
    for seed in (0, 5, 2**33 + 7):
        np.testing.assert_array_equal(
            tfednl.prng_key(seed), np.asarray(jax.random.PRNGKey(seed))
        )


def test_k_for_matches_reference():
    from repro.core.fednl import FedNLConfig as JCfg

    for d in (1, 2, 24, 301, 1000):
        for mult in (0.5, 8.0, 1e6):
            assert tfednl.FedNLConfig(k_multiplier=mult).k_for(d) == JCfg(k_multiplier=mult).k_for(d)
    assert tfednl.FedNLConfig().k_for(301) == 2408


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card behaviour cannot be shown here")


def test_solve_without_device_needs_a_card(no_card):
    t_spec, _ = _specs("topk", rounds=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.solve(t_spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_fednl(t_spec.data.build(), t_spec.fednl_config(), rounds=1)


@pytest.mark.parametrize(
    "changes,where",
    [
        (dict(algorithm="fednl-ls"), "A9"),
        (dict(algorithm="fednl-pp"), "A9"),
        (dict(backend="star-tcp"), "A11"),
        (dict(backend="sharded"), "A13"),
    ],
)
def test_solve_refuses_what_is_not_ported(changes, where):
    t_spec, _ = _specs("topk", rounds=1)
    with pytest.raises(NotImplementedError, match=where):
        tapi.solve(t_spec.replace(**changes), device="cpu")


@pytest.mark.parametrize("name", ["randk", "randseqk", "toplek", "natural"])
def test_random_compressors_are_not_ported(name):
    from repro_torch.compressors import get_compressor

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_compressor(name, 300, 24)
    with pytest.raises(KeyError):
        get_compressor("nope", 300, 24)


def test_launcher_runs_on_cpu(capsys):
    from repro_torch.launch.fednl_run import main

    main(["--dataset", "tiny", "--rounds", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "problem: n=8 clients, n_i=40, d=24" in out
    assert "fednl@local[cpu]: rounds=3" in out
