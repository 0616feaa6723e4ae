"""Newton-system solves for the FedNL master (paper §5.9).

Port of ``repro.linalg.solve``.  The solve was never a Pallas kernel there
(``cho_factor``/``cho_solve``), so the port calls ``torch.linalg`` for it.

Two master step rules (Algorithm 1, Line 11):
  Option A:  x+ = x - [H]_mu^{-1} grad       ([.]_mu = eigenvalue projection to >= mu)
  Option B:  x+ = x - (H + l I)^{-1} grad    (l = averaged Frobenius error, keeps PD)
"""

from __future__ import annotations

import torch


def psd_project(h: torch.Tensor, mu: float | torch.Tensor) -> torch.Tensor:
    """[H]_mu: clip eigenvalues of a symmetric matrix from below at mu.

    ``torch.linalg.eigh`` checks convergence and so waits for the card on a
    CUDA tensor; it has no ``_ex`` form.  Option A is off the main path
    (Option B), so that sync is left here."""
    w, v = torch.linalg.eigh(h)
    w = torch.clamp(w, min=mu)
    return (v * w[..., None, :]) @ v.mT


def cholesky_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for symmetric positive-definite A via Cholesky.

    ``cholesky_ex`` and the two triangular solves make no check, so the host
    never waits for the card.  Where A is not positive-definite
    (``info != 0``) the result is NaN, as the reference's
    ``cho_factor``/``cho_solve`` gives, chosen on the device."""
    chol, info = torch.linalg.cholesky_ex(a)
    y = torch.linalg.solve_triangular(chol, b.unsqueeze(-1), upper=False)
    x = torch.linalg.solve_triangular(chol.mT, y, upper=True).squeeze(-1)
    return torch.where((info == 0).unsqueeze(-1), x, torch.full_like(x, float("nan")))


def newton_solve_optionA(h: torch.Tensor, grad: torch.Tensor, mu: float) -> torch.Tensor:
    """Direction [H]_mu^{-1} grad (Option A / 'projection')."""
    return cholesky_solve(psd_project(h, mu), grad)


def newton_solve_optionB(h: torch.Tensor, grad: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """Direction (H + l I)^{-1} grad (Option B / 'Frobenius shift'); a
    leading batch of H, grad and l is solved as one batch."""
    d = h.shape[-1]
    h_reg = h + l[..., None, None] * torch.eye(d, dtype=h.dtype, device=h.device)
    return cholesky_solve(h_reg, grad)
