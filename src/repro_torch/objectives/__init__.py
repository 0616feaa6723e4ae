from repro_torch.objectives.logreg import (
    logreg_f,
    logreg_grad,
    logreg_hess,
    logreg_oracles_packed,
)

__all__ = ["logreg_f", "logreg_grad", "logreg_hess", "logreg_oracles_packed"]
