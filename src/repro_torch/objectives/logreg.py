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

import dataclasses

import torch

from repro_torch.kernels import ops as kops
from repro_torch.linalg.triu import unpack_triu


@dataclasses.dataclass(frozen=True)
class LogRegProblem:
    """A federated logistic-regression instance.

    z: (n_clients, n_i, d) label-absorbed design matrices (rows b_ij * a_ij)
    lam: L2 regularization coefficient
    """

    z: torch.Tensor
    lam: float

    @property
    def n_clients(self) -> int:
        return self.z.shape[0]

    @property
    def n_i(self) -> int:
        return self.z.shape[1]

    @property
    def dim(self) -> int:
        return self.z.shape[2]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def _matvec(z: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Z x over the leading dimensions of z."""
    return (z @ x.unsqueeze(-1)).squeeze(-1)


def _rmatvec(z: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Z^T v over the leading dimensions of z."""
    return (z.mT @ v.unsqueeze(-1)).squeeze(-1)


def logreg_margin_stats(z: torch.Tensor, x: torch.Tensor):
    """The margins m = Z x and their sigmoid, which the three oracles share
    (§5.7)."""
    m = _matvec(z, x)
    return m, torch.sigmoid(m)


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


HESSIAN_IMPLS = ("fused", "jnp", "pallas")


def logreg_oracles(z: torch.Tensor, x: torch.Tensor, lam: float, *, use_kernel: bool = False,
                   hessian: str | None = None):
    """(f, grad, hess) from one margin/sigmoid pass, the Hessian dense (d, d):
    z (..., n_i, d), x (d,) -> f (...), grad (..., d), hess (..., d, d).

    ``hessian`` names the reference's routes of Z^T diag(h) Z: "fused" (the
    default) and "pallas" both run the SYRK kernel (its plain version on the
    CPU) and unpack its packed upper triangle, as ``ExperimentSpec.hessian``
    routes them; "jnp" is the plain product.  ``lam * I`` is added to the
    dense matrix, the reference's ``hess + lam * eye`` order.
    ``use_kernel=True`` is the deprecated spelling of ``hessian="pallas"``.
    """
    if hessian is None:
        hessian = "pallas" if use_kernel else "fused"
    if hessian not in HESSIAN_IMPLS:
        raise ValueError(f"unknown hessian {hessian!r}; use {' | '.join(HESSIAN_IMPLS)}")
    n_i, d = z.shape[-2:]
    m, sigma = logreg_margin_stats(z, x)
    f = torch.mean(_softplus(-m), dim=-1) + 0.5 * lam * torch.sum(x * x)
    grad = -_rmatvec(z, 1.0 - sigma) / n_i + lam * x
    h = sigma * (1.0 - sigma) / n_i
    reg = lam * torch.eye(d, dtype=z.dtype, device=z.device)
    if hessian == "jnp":
        return f, grad, z.mT @ (h[..., None] * z) + reg
    lead = z.shape[:-2]
    packed = kops.hessian_syrk_packed(z.reshape(-1, n_i, d).contiguous(),
                                      h.reshape(-1, n_i).contiguous(), 0.0)
    return f, grad, unpack_triu(packed, d).reshape(*lead, d, d) + reg
