"""Reference-style FedNL baseline: per-client Python loop over NumPy.

This mirrors the structure of the original FedNL prototype the paper starts
from (https://github.com/Rustem-Islamov/FedNL-Public): a Python `for` loop
over clients per round, dense d x d Hessian handling, NumPy everywhere, no
fusion/symmetry/sparsity exploitation.  The paper's Table 1 compares its
compute-optimized implementation against this style (C++/AVX-512 against
Python/NumPy on a 24-core Xeon); the port's counterpart of that table
(ROADMAP A15) holds the port on the card against it.  A copy of
``repro.baselines.numpy_reference``, which is plain numpy.
"""

from __future__ import annotations

import time

import numpy as np


def _topk_dense(m: np.ndarray, k: int) -> np.ndarray:
    """TopK on the full dense matrix, the reference way (no triu packing)."""
    flat = np.abs(m).ravel()
    idx = np.argpartition(flat, -k)[-k:]
    out = np.zeros_like(m).ravel()
    out[idx] = m.ravel()[idx]
    return out.reshape(m.shape)


def _randk_dense(rng, m: np.ndarray, k: int) -> np.ndarray:
    idx = rng.choice(m.size, size=k, replace=False)
    out = np.zeros_like(m).ravel()
    out[idx] = m.ravel()[idx]
    return out.reshape(m.shape)


def run_fednl_numpy_reference(
    z: np.ndarray, lam: float, rounds: int, compressor: str = "topk",
    k_multiplier: float = 8.0, seed: int = 0,
):
    """z: (n_clients, n_i, d).  Returns (grad_norm_last, wall_seconds)."""
    n, n_i, d = z.shape
    k = int(k_multiplier * d) * 2  # dense-matrix budget ~= 2x triu budget
    rng = np.random.default_rng(seed)
    x = np.zeros(d)
    h_local = np.zeros((n, d, d))
    # reference initializes shifts at the exact Hessians
    for i in range(n):
        mrg = z[i] @ x
        s = 1.0 / (1.0 + np.exp(-mrg))
        w = s * (1 - s) / n_i
        h_local[i] = z[i].T @ (w[:, None] * z[i]) + lam * np.eye(d)
    h_global = h_local.mean(axis=0)

    t0 = time.perf_counter()
    gnorm = np.inf
    for _ in range(rounds):
        grads = np.zeros((n, d))
        s_sum = np.zeros((d, d))
        l_sum = 0.0
        for i in range(n):  # the reference's per-client Python loop
            mrg = z[i] @ x
            sig = 1.0 / (1.0 + np.exp(-mrg))
            grads[i] = -(z[i].T @ (1.0 - sig)) / n_i + lam * x
            w = sig * (1 - sig) / n_i
            hess = z[i].T @ (w[:, None] * z[i]) + lam * np.eye(d)
            diff = hess - h_local[i]
            if compressor == "topk":
                s_i = _topk_dense(diff, k)
            elif compressor == "randk":
                s_i = _randk_dense(rng, diff, k)
            else:
                s_i = diff
            l_sum += np.linalg.norm(diff, "fro")
            h_local[i] = h_local[i] + s_i
            s_sum += s_i
        grad = grads.mean(axis=0)
        l = l_sum / n
        x = x - np.linalg.solve(h_global + l * np.eye(d), grad)
        h_global = h_global + s_sum / n
        gnorm = float(np.linalg.norm(grad))
    return gnorm, time.perf_counter() - t0
