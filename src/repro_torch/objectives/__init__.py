from repro_torch.objectives.logreg import (
    logreg_f,
    logreg_grad,
    logreg_hess,
    logreg_oracles_packed,
)
from repro_torch.objectives.quadratic import QuadraticProblem, quadratic_oracles

__all__ = [
    "logreg_f",
    "logreg_grad",
    "logreg_hess",
    "logreg_oracles_packed",
    "QuadraticProblem",
    "quadratic_oracles",
]
