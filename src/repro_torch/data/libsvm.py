"""LIBSVM text-format reader/writer (numpy); port of ``repro.data.libsvm``.

Format per line:  <label> <index>:<value> <index>:<value> ...
Indices are 1-based.  The file is memory-mapped and parsed in one pass.
"""

from __future__ import annotations

import mmap
import os

import numpy as np


def parse_libsvm(path: str | os.PathLike, n_features: int | None = None):
    """Parse a LIBSVM file into a dense (n, d) float64 matrix + (n,) labels.

    Labels are normalized to {-1, +1} (0/1 inputs are mapped to -1/+1).
    """
    labels: list[float] = []
    rows: list[list[tuple[int, float]]] = []
    max_idx = 0
    with open(path, "rb") as fh:
        size = os.fstat(fh.fileno()).st_size
        if size == 0:
            return np.zeros((0, n_features or 0)), np.zeros((0,))
        with mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ) as mm:
            for line in iter(mm.readline, b""):
                line = line.strip()
                if not line or line.startswith(b"#"):
                    continue
                parts = line.split()
                labels.append(float(parts[0]))
                feats = []
                for tok in parts[1:]:
                    idx_b, val_b = tok.split(b":", 1)
                    idx = int(idx_b)
                    feats.append((idx, float(val_b)))
                    if idx > max_idx:
                        max_idx = idx
                rows.append(feats)
    d = n_features if n_features is not None else max_idx
    x = np.zeros((len(rows), d), dtype=np.float64)
    for r, feats in enumerate(rows):
        for idx, val in feats:
            if idx <= d:
                x[r, idx - 1] = val
    y = np.asarray(labels, dtype=np.float64)
    uniq = np.unique(y)
    if set(uniq.tolist()) <= {0.0, 1.0}:
        y = 2.0 * y - 1.0
    y = np.where(y > 0, 1.0, -1.0)
    return x, y


def write_libsvm(path: str | os.PathLike, x: np.ndarray, y: np.ndarray) -> None:
    """Write a dense matrix as LIBSVM text."""
    with open(path, "w") as fh:
        for row, lab in zip(np.asarray(x), np.asarray(y)):
            feats = " ".join(
                f"{i + 1}:{v:.17g}" for i, v in enumerate(row) if v != 0.0
            )
            fh.write(f"{int(lab):+d} {feats}\n")
