"""Packed upper-triangular representation of symmetric matrices.

Port of ``repro.linalg.triu``: the Hessian-shaped state lives as a packed
vector of T = d(d+1)/2 entries (paper §5.10/§5.13), row-major over the upper
triangle, element (i, j >= i) at offset ``i*d - i*(i-1)//2 + (j - i)``.  Every
function takes any number of leading (batch) dimensions; the clients are one.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def triu_size(d: int) -> int:
    """Number of elements in the upper triangle (incl. diagonal) of a d x d matrix."""
    return d * (d + 1) // 2


@functools.lru_cache(maxsize=64)
def triu_indices(d: int) -> tuple[np.ndarray, np.ndarray]:
    """Static (rows, cols) int32 index arrays of the packed layout, cached per d
    (paper §5.11: indices computed once)."""
    rows, cols = np.triu_indices(d)
    return rows.astype(np.int32), cols.astype(np.int32)


@functools.lru_cache(maxsize=64)
def _index_tensors(d: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    rows, cols = triu_indices(d)
    return (
        torch.as_tensor(rows, dtype=torch.int64, device=device),
        torch.as_tensor(cols, dtype=torch.int64, device=device),
    )


@functools.lru_cache(maxsize=64)
def _offdiag_weights(d: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Weight 1.0 on diagonal entries, 2.0 off-diagonal (norms/inner products)."""
    rows, cols = triu_indices(d)
    return torch.as_tensor(np.where(rows == cols, 1.0, 2.0), dtype=dtype, device=device)


@functools.lru_cache(maxsize=64)
def packed_eye(d: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``pack_triu(eye(d))``: 1.0 on the packed diagonal, 0.0 elsewhere."""
    rows, cols = triu_indices(d)
    return torch.as_tensor(np.where(rows == cols, 1.0, 0.0), dtype=dtype, device=device)


def pack_triu(m: torch.Tensor) -> torch.Tensor:
    """Pack the upper triangle of (..., d, d) matrices into (..., T) vectors."""
    rows, cols = _index_tensors(m.shape[-1], m.device)
    return m[..., rows, cols]


def unpack_triu(u: torch.Tensor, d: int) -> torch.Tensor:
    """Unpack (..., T) packed vectors into the full symmetric (..., d, d) matrices."""
    rows, cols = _index_tensors(d, u.device)
    out = torch.zeros(u.shape[:-1] + (d, d), dtype=u.dtype, device=u.device)
    out[..., rows, cols] = u
    # mirror: add the transpose, subtract the diagonal counted twice
    diag = torch.diagonal(out, dim1=-2, dim2=-1)
    return out + out.mT - torch.diag_embed(diag)


def frob_norm_from_packed(u: torch.Tensor, d: int) -> torch.Tensor:
    """||M||_F of the symmetric matrices represented by packed vectors u."""
    w = _offdiag_weights(d, u.dtype, u.device)
    return torch.sqrt(torch.sum(w * u * u, dim=-1))


def frob_inner_from_packed(u: torch.Tensor, v: torch.Tensor, d: int) -> torch.Tensor:
    """<U, V>_F for symmetric matrices in packed form."""
    w = _offdiag_weights(d, u.dtype, u.device)
    return torch.sum(w * u * v, dim=-1)
