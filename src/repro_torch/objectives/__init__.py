from repro_torch.objectives.logreg import (
    LogRegProblem,
    logreg_f,
    logreg_grad,
    logreg_hess,
    logreg_margin_stats,
    logreg_oracles,
    logreg_oracles_packed,
)
from repro_torch.objectives.quadratic import QuadraticProblem, quadratic_oracles

__all__ = [
    "LogRegProblem",
    "logreg_f",
    "logreg_grad",
    "logreg_hess",
    "logreg_oracles",
    "logreg_margin_stats",
    "logreg_oracles_packed",
    "QuadraticProblem",
    "quadratic_oracles",
]
