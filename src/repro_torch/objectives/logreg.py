"""L2-regularized logistic regression oracles (paper Eq. 2-5), batched over clients.

Port of ``repro.objectives.logreg``.  Labels are absorbed into the design
matrix (§5.13): client c holds Z_c (n_i, d) with rows z_j = b_j * a_j, and
with margins m = Z_c x

    f_c(x)    = (1/n_i) sum_j log(1 + exp(-m_j)) + (lambda/2) ||x||^2
    grad f_c  = -(1/n_i) Z_c^T (1 - sigma(m)) + lambda x
    hess f_c  = (1/n_i) Z_c^T diag(sigma(m) (1 - sigma(m))) Z_c + lambda I

z carries any number of leading dimensions before (n_i, d); the round passes
(n_clients, n_i, d).  The margins and sigmoid are computed once for all three
oracles (§5.7).  log(1 + exp(-m)) is ``logaddexp(-m, 0)``, which is what
``jax.nn.softplus`` computes (``torch.nn.functional.softplus`` switches to the
identity above 20 and is not used).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def _matvec(z: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Z x over the leading dimensions of z."""
    return (z @ x.unsqueeze(-1)).squeeze(-1)


def _rmatvec(z: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Z^T v over the leading dimensions of z."""
    return (z.mT @ v.unsqueeze(-1)).squeeze(-1)


def logreg_f(z: torch.Tensor, x: torch.Tensor, lam: float) -> torch.Tensor:
    m = _matvec(z, x)
    return torch.mean(_softplus(-m), dim=-1) + 0.5 * lam * torch.sum(x * x, dim=-1)


def logreg_grad(z: torch.Tensor, x: torch.Tensor, lam: float) -> torch.Tensor:
    sigma = torch.sigmoid(_matvec(z, x))
    n_i = z.shape[-2]
    return -_rmatvec(z, 1.0 - sigma) / n_i + lam * x


def logreg_hess(z: torch.Tensor, x: torch.Tensor, lam: float) -> torch.Tensor:
    sigma = torch.sigmoid(_matvec(z, x))
    n_i, d = z.shape[-2:]
    h = sigma * (1.0 - sigma) / n_i
    return z.mT @ (h[..., None] * z) + lam * torch.eye(d, dtype=z.dtype, device=z.device)


def logreg_oracles_packed(z: torch.Tensor, x: torch.Tensor, lam: float):
    """(f, grad, packed hess) per client from one margin/sigmoid pass.

    z (n_clients, n_i, d), x (d,) -> f (n_clients,), grad (n_clients, d),
    hess (n_clients, T).  The packed Hessian comes from the SYRK kernel (its
    plain version on the CPU) with ``lam`` added on the packed diagonal and
    ``lam * 0.0`` elsewhere, the op order of ``repro``'s
    ``hp + lam * packed_eye``.
    """
    n_i = z.shape[-2]
    m = _matvec(z, x)
    sigma = torch.sigmoid(m)
    f = torch.mean(_softplus(-m), dim=-1) + 0.5 * lam * torch.sum(x * x)
    grad = -_rmatvec(z, 1.0 - sigma) / n_i + lam * x
    hw = sigma * (1.0 - sigma) / n_i
    return f, grad, kops.hessian_syrk_packed(z, hw.contiguous(), lam)
