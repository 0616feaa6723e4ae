"""Symmetric quadratic objectives, the paper's second problem family
(Appendix L.5), port of ``repro.objectives.quadratic``:

    f_c(x) = 0.5 x^T B_c x - c_c^T x,   grad = B_c x - c_c,   hess = B_c.

Exact tests use it: FedNL with the Identity compressor converges in one step
from any x0 once H = mean(B_c).  ``b`` carries any number of leading (client)
dimensions before (d, d), ``c`` the same before (d,).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class QuadraticProblem:
    b: torch.Tensor  # (n_clients, d, d) symmetric PD
    c: torch.Tensor  # (n_clients, d)

    @property
    def n_clients(self) -> int:
        return self.b.shape[0]

    @property
    def dim(self) -> int:
        return self.b.shape[-1]


def quadratic_oracles(b: torch.Tensor, c: torch.Tensor, x: torch.Tensor):
    """(f, grad, hess) of each client's quadratic at x (d,)."""
    bx = (b @ x.unsqueeze(-1)).squeeze(-1)
    f = 0.5 * torch.sum(x * bx, dim=-1) - torch.sum(c * x, dim=-1)
    return f, bx - c, b
