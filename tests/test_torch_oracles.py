"""repro_torch.objectives.logreg against repro.objectives.logreg (CPU).

f and grad to 1e-12 relative to their largest magnitude (different BLAS,
different summation order); the packed Hessian to 1e-13 x max(|Z|^T|h||Z|),
the scale of its FP64 rounding.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.objectives import logreg as jlog
from repro_torch.linalg import pack_triu
from repro_torch.objectives import logreg as tlog
from repro_torch.api import DataSpec


CASES = ("tiny", "w8a_client")


@functools.cache
def _problem(case):
    if case == "tiny":
        return DataSpec(dataset="tiny").build()
    return DataSpec(dataset="w8a").build()[:1]  # one w8a-width client, d = 301


def _rel(a, b):
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("x_seed", [0, 1])
def test_oracles_packed_match(case, x_seed):
    z = _problem(case)
    d = z.shape[-1]
    lam = 1e-3
    x = np.random.default_rng(x_seed).standard_normal(d) * (0.0 if x_seed == 0 else 0.5)
    f_t, g_t, h_t = tlog.logreg_oracles_packed(torch.as_tensor(z), torch.as_tensor(x), lam)
    for c in range(z.shape[0]):
        f_j, g_j, h_j = jlog.logreg_oracles_packed(jnp.asarray(z[c]), jnp.asarray(x), lam)
        f_j, g_j, h_j = float(f_j), np.asarray(g_j), np.asarray(h_j)
        assert abs(f_t[c].item() - f_j) <= 1e-12 * abs(f_j)
        assert _rel(g_t[c].numpy(), g_j) <= 1e-12
        sigma = 1.0 / (1.0 + np.exp(-(z[c] @ x)))
        hw = np.abs(sigma * (1.0 - sigma) / z.shape[1])
        scale = np.max(np.abs(z[c]).T @ (hw[:, None] * np.abs(z[c])))
        assert np.max(np.abs(h_t[c].numpy() - h_j)) <= 1e-13 * scale


def test_individual_oracles_match_packed():
    z = _problem("tiny")
    x = np.random.default_rng(3).standard_normal(z.shape[-1]) * 0.3
    zt, xt = torch.as_tensor(z), torch.as_tensor(x)
    f, g, hp = tlog.logreg_oracles_packed(zt, xt, 1e-3)
    torch.testing.assert_close(tlog.logreg_f(zt, xt, 1e-3), f, rtol=1e-14, atol=0)
    torch.testing.assert_close(tlog.logreg_grad(zt, xt, 1e-3), g, rtol=1e-13, atol=1e-17)
    torch.testing.assert_close(pack_triu(tlog.logreg_hess(zt, xt, 1e-3)), hp, rtol=1e-13, atol=1e-17)
    for c in range(z.shape[0]):
        np.testing.assert_allclose(
            tlog.logreg_f(zt[c], xt, 1e-3).item(),
            float(jlog.logreg_f(jnp.asarray(z[c]), jnp.asarray(x), 1e-3)),
            rtol=1e-12,
        )


def test_gradient_matches_autograd():
    z = torch.as_tensor(_problem("tiny")[0])
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(z.shape[-1]) * 0.3)
    x.requires_grad_(True)
    tlog.logreg_f(z, x, 1e-3).backward()
    torch.testing.assert_close(tlog.logreg_grad(z, x.detach(), 1e-3), x.grad, rtol=1e-12, atol=1e-15)


def test_softplus_is_stable_for_large_margins():
    z = torch.tensor([[[50.0, 0.0]], [[-50.0, 0.0]]], dtype=torch.float64)
    x = torch.tensor([1.0, 0.0], dtype=torch.float64)
    f = tlog.logreg_f(z, x, 0.0)
    want = np.log1p(np.exp(-np.array([50.0, -50.0])))
    np.testing.assert_allclose(f.numpy(), want, rtol=1e-15)
