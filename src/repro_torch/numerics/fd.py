"""Finite-difference oracle verification (paper Appendix L.4 item 8:
"means for sanity checks for gradient and Hessian oracles with finite
differences approach").

Central differences in float64; used by tests to certify the analytic
logistic-regression oracles of Eq. (3)-(5).  A copy of
``repro.numerics.fd``, which is plain numpy: ``f``, ``grad`` and ``hess`` are
any callables of a numpy vector whose results convert with ``float`` and
``np.asarray``.
"""

from __future__ import annotations

import numpy as np


def fd_grad(f, x: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    g = np.zeros_like(x)
    for i in range(x.size):
        e = np.zeros_like(x)
        e[i] = eps
        g[i] = (float(f(x + e)) - float(f(x - e))) / (2 * eps)
    return g


def fd_hess(f, x: np.ndarray, eps: float = 1e-5) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    d = x.size
    h = np.zeros((d, d))
    fx = float(f(x))
    for i in range(d):
        ei = np.zeros_like(x)
        ei[i] = eps
        for j in range(i, d):
            ej = np.zeros_like(x)
            ej[j] = eps
            h[i, j] = (
                float(f(x + ei + ej)) - float(f(x + ei)) - float(f(x + ej)) + fx
            ) / (eps * eps)
            h[j, i] = h[i, j]
    return h


def check_oracles(f, grad, hess, x: np.ndarray, *, gtol=1e-5, htol=1e-3):
    """Return (grad_err, hess_err) max-abs deviations vs finite differences."""
    g_err = float(np.max(np.abs(np.asarray(grad(x)) - fd_grad(f, x))))
    h_err = float(np.max(np.abs(np.asarray(hess(x)) - fd_hess(f, x))))
    return g_err, h_err
