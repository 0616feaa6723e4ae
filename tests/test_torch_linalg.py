"""repro_torch.linalg against repro.linalg on the same numpy inputs (CPU).

Packing, unpacking and the packed Frobenius forms copy values or sum the
same products, so they must match exactly; the Option A/B Newton directions
go through different LAPACK factorizations and match to rtol 1e-12 on
well-conditioned systems.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.linalg as jl
from repro.linalg.triu import frob_inner_from_packed as j_frob_inner
import repro_torch.linalg as tl


def _sym(rng, d, batch=()):
    a = rng.standard_normal(batch + (d, d))
    return a + np.swapaxes(a, -1, -2)


def _spd(rng, d):
    a = rng.standard_normal((d, d)) / np.sqrt(d)
    return a @ a.T + np.eye(d)


@pytest.mark.parametrize("d", [1, 5, 24, 69])
def test_triu_indices_and_size_match(d):
    assert tl.triu_size(d) == jl.triu_size(d)
    for a, b in zip(tl.triu_indices(d), jl.triu_indices(d)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("d", [1, 5, 24, 69])
def test_pack_unpack_exact(d):
    rng = np.random.default_rng(d)
    m = _sym(rng, d, batch=(3,))
    packed_t = tl.pack_triu(torch.as_tensor(m))
    packed_j = np.asarray(jl.pack_triu(jnp.asarray(m)))
    np.testing.assert_array_equal(packed_t.numpy(), packed_j)
    un_t = tl.unpack_triu(packed_t, d).numpy()
    un_j = np.asarray(jl.unpack_triu(jnp.asarray(packed_j), d))
    np.testing.assert_array_equal(un_t, un_j)
    np.testing.assert_array_equal(un_t, m)


@pytest.mark.parametrize("d", [5, 24, 69])
def test_frobenius_forms_match(d):
    """The weighted products are exact; the sums over T terms agree to 1e-14
    of the sum of |terms|, since XLA and PyTorch add in different orders."""
    rng = np.random.default_rng(100 + d)
    u = rng.standard_normal((4, tl.triu_size(d)))
    v = rng.standard_normal((4, tl.triu_size(d)))
    ut, vt = torch.as_tensor(u), torch.as_tensor(v)
    w = np.where(np.equal(*jl.triu_indices(d)), 1.0, 2.0)
    terms = np.abs(w * u * v).sum(-1)
    inner_j = np.asarray(j_frob_inner(jnp.asarray(u), jnp.asarray(v), d))
    assert np.all(np.abs(tl.frob_inner_from_packed(ut, vt, d).numpy() - inner_j) <= 1e-14 * terms)
    norm_j = np.asarray(jl.frob_norm_from_packed(jnp.asarray(u), d))
    np.testing.assert_allclose(tl.frob_norm_from_packed(ut, d).numpy(), norm_j, rtol=1e-14, atol=0)
    # the weights are exact: on a one-hot vector the inner product is the weight
    for idx in (0, 1, tl.triu_size(d) - 1):
        e = torch.zeros(tl.triu_size(d), dtype=torch.float64)
        e[idx] = 1.0
        assert tl.frob_inner_from_packed(e, e, d).item() == w[idx]
    # and the packed norm is the dense norm of the unpacked matrix
    dense = np.linalg.norm(tl.unpack_triu(ut, d).numpy(), axis=(-2, -1))
    np.testing.assert_allclose(tl.frob_norm_from_packed(ut, d).numpy(), dense, rtol=1e-13)


def test_packed_eye_is_packed_identity():
    for d in (1, 7, 24):
        np.testing.assert_array_equal(
            tl.packed_eye(d, torch.float64, torch.device("cpu")).numpy(),
            np.asarray(jl.pack_triu(jnp.eye(d, dtype=jnp.float64))),
        )


@pytest.mark.parametrize("d", [8, 24, 69])
def test_newton_solves_match(d):
    rng = np.random.default_rng(200 + d)
    h = _spd(rng, d)
    g = rng.standard_normal(d)
    l = 0.37
    mu = 1.5  # above some eigenvalues of h: the projection clips them
    got_b = tl.newton_solve_optionB(torch.as_tensor(h), torch.as_tensor(g), torch.tensor(l, dtype=torch.float64))
    want_b = jl.newton_solve_optionB(jnp.asarray(h), jnp.asarray(g), jnp.asarray(l))
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=1e-12, atol=0)
    got_a = tl.newton_solve_optionA(torch.as_tensor(h), torch.as_tensor(g), mu)
    want_a = jl.newton_solve_optionA(jnp.asarray(h), jnp.asarray(g), mu)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=1e-12, atol=1e-14)
    got_p = tl.psd_project(torch.as_tensor(h), mu).numpy()
    assert np.linalg.eigvalsh(got_p).min() >= mu - 1e-12
    np.testing.assert_allclose(got_p, np.asarray(jl.psd_project(jnp.asarray(h), mu)), rtol=0, atol=1e-12)


def test_cholesky_solve_solves():
    rng = np.random.default_rng(7)
    a = _spd(rng, 30)
    b = rng.standard_normal(30)
    x = tl.cholesky_solve(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(a @ x, b, rtol=0, atol=1e-12)


def test_cholesky_solve_gives_nan_where_not_positive_definite():
    """cholesky_ex makes no check (no host sync); a matrix that is not
    positive-definite gives NaN in both packages, row by row in a batch."""
    a = np.array([[1.0, 2.0], [2.0, 1.0]])
    b = np.array([1.0, 1.0])
    got = tl.cholesky_solve(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    want = np.asarray(jl.cholesky_solve(jnp.asarray(a), jnp.asarray(b)))
    assert np.isnan(got).all() and np.isnan(want).all()
    batch = np.stack([a, np.array([[2.0, 1.0], [1.0, 2.0]])])
    got = tl.cholesky_solve(torch.as_tensor(batch), torch.as_tensor(np.stack([b, b]))).numpy()
    assert np.isnan(got[0]).all()
    np.testing.assert_allclose(got[1], np.linalg.solve(batch[1], b), rtol=1e-15)
