"""Synthetic logistic-regression problem generator (numpy).

Port of ``repro.data.synthetic``, kept as the port's own copy so that it
imports nothing of ``repro``.  Same generator, same seed handling: the
problem arrays come out bit-identical to the reference's.

The real LIBSVM W8A/A9A/PHISHING files are not shipped, so experiments use
synthetic instances with the same dimensions and splits as the paper's tables:

    w8a       d=301 (300 features + intercept), n=142 clients, n_i=348
    a9a       d=124, n_i=229
    phishing  d=69,  n_i=77
"""

from __future__ import annotations

import numpy as np

# (d_including_intercept, n_clients, n_i) per paper Tables 1-3
DATASET_SHAPES = {
    "w8a": (301, 142, 348),
    "a9a": (124, 142, 229),
    "phishing": (69, 142, 77),
    "tiny": (24, 8, 40),  # test-sized instance
}


def make_synthetic_logreg(
    name_or_dims,
    seed: int = 0,
    density: float = 0.25,
):
    """Generate (features, labels) with shapes matching a paper dataset.

    Returns x: (n_samples, d-1) raw features (intercept NOT yet added) and
    y: (n_samples,) in {-1, +1}; pass through add_intercept + partition_clients
    to obtain the federated problem (augment with intercept -> reshuffle
    u.a.r. -> split into n_i chunks).
    """
    if isinstance(name_or_dims, str):
        d, n_clients, n_i = DATASET_SHAPES[name_or_dims]
    else:
        d, n_clients, n_i = name_or_dims
    n_samples = n_clients * n_i
    rng = np.random.default_rng(seed)
    d_raw = d - 1  # the intercept column is appended later
    x = rng.standard_normal((n_samples, d_raw))
    mask = rng.random((n_samples, d_raw)) < density
    x = np.where(mask, x, 0.0)
    # keep feature scale comparable to LIBSVM's 0/1-ish features
    x /= max(1.0, np.sqrt(density * d_raw) / 2.0)
    x_star = rng.standard_normal(d_raw) / np.sqrt(d_raw)
    logits = x @ x_star + 0.25 * rng.standard_normal(n_samples)
    p = 1.0 / (1.0 + np.exp(-logits))
    y = np.where(rng.random(n_samples) < p, 1.0, -1.0)
    return x, y
