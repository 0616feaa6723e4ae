from repro_torch.numerics.fd import check_oracles, fd_grad, fd_hess

__all__ = ["fd_grad", "fd_hess", "check_oracles"]
