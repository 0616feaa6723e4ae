"""Client partitioning: the paper's preprocessing pipeline (numpy).

Port of ``repro.data.partition``: add an intercept feature, reshuffle u.a.r.,
split across n clients of n_i samples (the rest is dropped), and fold the
labels into the design matrix (§5.13: z_j = b_ij * a_ij).
"""

from __future__ import annotations

import numpy as np


def add_intercept(x: np.ndarray) -> np.ndarray:
    return np.concatenate([x, np.ones((x.shape[0], 1), dtype=x.dtype)], axis=1)


def absorb_labels(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    return x * y[:, None]


def partition_clients(
    x: np.ndarray,
    y: np.ndarray,
    n_clients: int,
    n_i: int,
    seed: int = 0,
    shuffle: bool = True,
) -> np.ndarray:
    """Return z: (n_clients, n_i, d) label-absorbed per-client design matrices.

    Samples beyond n_clients * n_i are dropped.
    """
    n_total = n_clients * n_i
    if x.shape[0] < n_total:
        raise ValueError(
            f"need {n_total} samples for {n_clients} clients x {n_i}, have {x.shape[0]}"
        )
    if shuffle:
        perm = np.random.default_rng(seed).permutation(x.shape[0])
        x, y = x[perm], y[perm]
    z = absorb_labels(x[:n_total], y[:n_total])
    return z.reshape(n_clients, n_i, x.shape[1])
