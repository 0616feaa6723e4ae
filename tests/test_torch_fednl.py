"""The slice whole: repro_torch.api.solve against repro.api.solve (CPU).

Tolerances (the rounds add in other orders than XLA does):
  * sent_bits, payload and wire, and sent_elems: exact, every round;
  * grad norms: rtol 1e-6 on every round where the reference's norm is
    >= 1e-10 (below that the two trajectories' rounding noise dominates);
  * final x: rtol 1e-8.

The random compressors (RandSeqK, TopLEK; RandK and Natural in
tests/test_torch_fednl_ls_pp.py) take the same threefry draws as the
reference (repro_torch.prng is bit-exact with jax.random), so their
trajectories compare round for round like the deterministic ones.
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
from repro_torch import prng
from repro_torch.core import fednl as tfednl
from repro_torch.core.runner import run_fednl

GN_RTOL, GN_FLOOR, X_RTOL = 1e-6, 1e-10, 1e-8
# rounds on tiny to reach a grad norm below 1e-12, with a margin (RandSeqK
# converges linearly, TopLEK sends fewer entries than TopK)
ROUNDS = {"topk": 12, "identity": 12, "randseqk": 18, "toplek": 18}


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


@pytest.mark.parametrize("compressor", ["topk", "identity", "randseqk", "toplek"])
@pytest.mark.parametrize("accounting", ["payload", "wire"])
def test_solve_matches_reference(compressor, accounting):
    rounds = ROUNDS[compressor]
    t_spec, j_spec = _specs(compressor, accounting, rounds=rounds)
    got = tapi.solve(t_spec, device="cpu")
    want = japi.solve(j_spec)
    assert got.rounds == want.rounds == rounds
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


@pytest.mark.parametrize("compressor", ["topk", "toplek"])
def test_state_from_numpy_continues_a_reference_run(compressor):
    """A JAX state after 2 rounds goes into the port; each side runs one more
    round from it and the two states agree, the key included."""
    t_spec, j_spec = _specs(compressor)
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
    assert int(m_t.sent_elems) == int(m_j.sent_elems)
    np.testing.assert_array_equal(state_t3.key, np.asarray(state_j3.key))


def test_init_key_is_the_reference_key():
    z = torch.zeros(2, 3, 4, dtype=torch.float64)
    for seed in (0, 5, 2**33 + 7):
        want = np.asarray(jax.random.PRNGKey(seed))
        np.testing.assert_array_equal(prng.prng_key(seed), want)
        state = tfednl.fednl_init(z, tfednl.FedNLConfig(), seed=seed)
        np.testing.assert_array_equal(state.key, want)


@pytest.mark.parametrize(
    "compressor", ["topk", "identity", "randseqk", "toplek", "randk", "natural"]
)
def test_state_key_advances_as_the_reference(compressor):
    """After 1..3 rounds the port's checkpointed key is the JAX state's key,
    for every compressor, whether it draws or not."""
    t_spec, j_spec = _specs(compressor)
    z = np.array(j_spec.data.build())
    zj = jnp.asarray(z)
    round_j = jax.jit(j_round(zj, j_spec.fednl_config()))
    state_j = j_init(zj, j_spec.fednl_config(), seed=3)
    round_t = tfednl.make_fednl_round(torch.as_tensor(z), t_spec.fednl_config())
    state_t = tfednl.fednl_init(torch.as_tensor(z), t_spec.fednl_config(), seed=3)
    for r in range(3):
        state_j, m_j = round_j(state_j)
        state_t, m_t = round_t(state_t)
        got = tfednl.state_to_numpy(state_t)["state.key"]
        want = state_arrays(state_j)["state.key"]
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype == np.uint32
        assert int(m_t.sent_bits) == int(m_j.sent_bits), r
    assert not np.array_equal(state_t.key, prng.prng_key(3))


@pytest.mark.parametrize(
    "compressor", ["topk", "identity", "randseqk", "toplek", "randk", "natural"]
)
@pytest.mark.parametrize("t,k", [(300, 24), (45451, 2408), (10, 10)])
def test_registry_matches_reference(compressor, t, k):
    from repro.compressors.core import get_compressor as j_get
    from repro_torch.compressors import get_compressor as t_get

    got, want = t_get(compressor, t, k), j_get(compressor, t, k)
    assert got.name == want.name
    for field in ("alpha", "delta", "bits_per_elem", "header_bits"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.draws == (compressor in ("randseqk", "toplek", "randk", "natural"))


@pytest.mark.parametrize("compressor", ["randseqk", "toplek", "randk"])
def test_registry_refuses_bad_budgets(compressor):
    from repro_torch.compressors import get_compressor

    for k in (0, 301):
        with pytest.raises(ValueError, match="0 < k <= T"):
            get_compressor(compressor, 300, k)


@pytest.mark.parametrize(
    "name,scaled", [("randseqk", True), ("randseqk", False), ("toplek", None), ("topk", None)]
)
def test_compress_matches_reference_per_client(name, scaled):
    """compress(keys, u) on all clients at once against the reference's
    compress(key_c, u_c) per client: the same draws, the same output bits."""
    from repro.compressors import core as jcore
    from repro_torch.compressors import core as tcore

    t, k, n = 300, 24, 6
    u = np.random.default_rng(4).standard_normal((n, t))
    sub = jax.random.split(jax.random.PRNGKey(9))[1]
    jkeys = jax.random.split(sub, n)
    keys = prng.split(prng.split(prng.prng_key(9), 2)[1], n)
    if scaled is False:
        got, sent = tcore.randseqk(keys, torch.as_tensor(u), k, scaled=False)
    else:
        got, sent = tcore.get_compressor(name, t, k).compress(keys, torch.as_tensor(u))
    for c in range(n):
        if scaled is False:
            want, want_sent = jcore.randseqk(jkeys[c], jnp.asarray(u[c]), k, scaled=False)
        else:
            want, want_sent = jcore.get_compressor(name, t, k).compress(jkeys[c], jnp.asarray(u[c]))
        np.testing.assert_array_equal(got[c].numpy().view(np.int64), np.asarray(want).view(np.int64))
        assert int(sent[c]) == int(want_sent)


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


REFUSALS = {  # what the message names -> the exception solve raises
    "cannot run a non-trivial": ValueError,
    "partial participation": ValueError,
    "unknown compressor": KeyError,
}


@pytest.mark.parametrize(
    "changes,where",
    [  # ids as before the sharded backend's case (changes3) went
        pytest.param(dict(topology=tapi.TopologySpec(kind="tree")), "cannot run a non-trivial",
                     id="changes0-cannot run a non-trivial"),
        pytest.param(dict(algorithm="fednl-pp", tol=1e-9), "partial participation",
                     id="changes1-partial participation"),
        pytest.param(dict(membership=tapi.MembershipSpec(
            events=(tapi.MembershipEvent(1, "leave", 0),))), "cannot run a non-trivial",
            id="changes2-cannot run a non-trivial"),
        pytest.param(dict(compressor=tapi.CompressorSpec("nope")), "unknown compressor",
                     id="changes4-unknown compressor"),
    ],
)
def test_solve_refuses_what_is_not_ported(changes, where):
    """What solve refuses: a topology or membership events on the local
    backend (the reference's rule: they need a wire backend), a PP spec with
    an early-stop tol (the reference refuses it too) and an unknown
    compressor."""
    t_spec, _ = _specs("topk", rounds=1)
    with pytest.raises(REFUSALS[where], match=where):
        tapi.solve(t_spec.replace(**changes), device="cpu")


@pytest.mark.parametrize("name", ["randk", "natural"])
def test_random_compressors_are_registered(name):
    """RandK and Natural are built, draw on the clients' keys, and an unknown
    name is still refused."""
    from repro_torch.compressors import get_compressor

    comp = get_compressor(name, 300, 24)
    assert comp.name == name and comp.draws
    u = torch.as_tensor(np.random.default_rng(1).standard_normal((3, 300)))
    keys = prng.split(prng.prng_key(1), 3)
    u_hat, sent = comp.compress(keys, u)
    assert u_hat.shape == u.shape and sent.tolist() == [24 if name == "randk" else 300] * 3
    with pytest.raises(KeyError, match="unknown compressor"):
        get_compressor("nope", 300, 24)


def test_launcher_runs_on_cpu(capsys):
    from repro_torch.launch.fednl_run import main

    main(["--dataset", "tiny", "--rounds", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "problem: n=8 clients, n_i=40, d=24" in out
    assert "fednl@local[cpu]: rounds=3" in out


@pytest.mark.parametrize("compressor", ["randseqk", "toplek"])
def test_launcher_runs_the_new_compressors(capsys, compressor):
    from repro_torch.launch.fednl_run import main

    main(["--dataset", "tiny", "--compressor", compressor, "--rounds", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "fednl@local[cpu]: rounds=3" in out
