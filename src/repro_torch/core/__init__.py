# The FedNL algorithm family on PyTorch (port of ``repro.core``).
from repro_torch.core.fednl import FedNLConfig, FedNLState, fednl_init, make_fednl_round
from repro_torch.core.fednl_ls import make_fednl_ls_round
from repro_torch.core.fednl_pp import (
    FedNLPPState,
    fednl_pp_init,
    make_fednl_pp_round,
    make_pp_bits_fn,
)
from repro_torch.core.runner import (
    eval_full,
    gd_baseline,
    newton_baseline,
    run_fednl,
    run_fednl_pp,
)

__all__ = [
    "FedNLConfig",
    "FedNLState",
    "fednl_init",
    "make_fednl_round",
    "make_fednl_ls_round",
    "FedNLPPState",
    "fednl_pp_init",
    "make_fednl_pp_round",
    "make_pp_bits_fn",
    "run_fednl",
    "run_fednl_pp",
    "newton_baseline",
    "gd_baseline",
    "eval_full",
]
