from repro_torch.linalg.triu import (
    triu_size,
    triu_indices,
    packed_eye,
    pack_triu,
    unpack_triu,
    frob_norm_from_packed,
    frob_inner_from_packed,
)
from repro_torch.linalg.solve import (
    newton_solve_optionA,
    newton_solve_optionB,
    psd_project,
    cholesky_solve,
)

__all__ = [
    "triu_size",
    "triu_indices",
    "packed_eye",
    "pack_triu",
    "unpack_triu",
    "frob_norm_from_packed",
    "frob_inner_from_packed",
    "newton_solve_optionA",
    "newton_solve_optionB",
    "psd_project",
    "cholesky_solve",
]
