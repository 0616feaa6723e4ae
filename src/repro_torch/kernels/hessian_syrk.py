"""Batched packed SYRK: the FedNL client Hessians, FP64, in one launch.

    hessian_syrk_packed(z, hw, lam)[c] = pack_triu(Z_c^T diag(hw_c) Z_c) + lam * pack_triu(I)

z is (n_clients, n_i, d), hw = sigma(1 - sigma) / n_i is (n_clients, n_i),
the result (n_clients, T) with T = d(d+1)/2.

Replaces ``repro/kernels/hessian_syrk.py:hessian_syrk_pallas`` (body
``_syrk_kernel``), which the JAX round reaches through
``repro/kernels/ops.py:hessian_syrk_packed``; source
``csrc/hessian_syrk.cu``.

What bounds it on an H100: operations.  At w8a (142 clients, n_i = 348,
d = 301) the upper triangle is 2 * n_i * T * 142 = 4.49 GFLOP of FP64, about
67 us at the 67 TFLOP/s FP64 tensor-core peak (132 us at the 34 TFLOP/s of
the FP64 pipes), against 171 MB moved (Z read once, the packed result written
once), about 51 us at 3.35 TB/s.

What the design does about it: it does half the work -- only the tile pairs
ti <= tj of 64 x 64 tiles, the paper's upper-triangle trick at tile size,
1.35x the exact triangle's operations at d = 301 after the ragged edge -- and
it keeps the operands out of device memory between uses: one launch for all
clients with the client as the outer grid axis, so the 15 tile pairs of one
client run together and can share its Z (0.84 MB) through L2; the sample
axis is a loop over 32-sample chunks staged in shared memory, with hw folded
into the right strip as it loads (no scaled copy of Z anywhere); each thread
accumulates a 4 x 4 block in FP64 registers with FMA.  The epilogue writes
the packed triangle and the ``+lam`` directly, so no (d, d) matrix and no
second pass exist.  It uses the FP64 pipes, not the tensor cores (DMMA
``mma.sync.m8n8k4.f64`` is the next step; WGMMA has no FP64 shape).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.linalg.triu import pack_triu, packed_eye, triu_size

_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_void_p,
)


def hessian_syrk_packed_plain(z: torch.Tensor, hw: torch.Tensor, lam: float) -> torch.Tensor:
    """The plain PyTorch version: full square product, packed, +lam packed."""
    d = z.shape[-1]
    hp = pack_triu(z.mT @ (hw[..., None] * z))
    return hp + lam * packed_eye(d, z.dtype, z.device)


def hessian_syrk_packed_cuda(z: torch.Tensor, hw: torch.Tensor, lam: float) -> torch.Tensor:
    """Launch the CUDA kernel on z's device and current stream."""
    if z.dtype != torch.float64 or hw.dtype != torch.float64:
        raise TypeError(f"hessian_syrk_packed takes float64, got {z.dtype}, {hw.dtype}")
    if z.ndim != 3 or hw.shape != z.shape[:2]:
        raise ValueError(
            f"need z (n_clients, n_i, d) and hw (n_clients, n_i), got "
            f"{tuple(z.shape)} and {tuple(hw.shape)}"
        )
    if not (z.is_cuda and hw.device == z.device):
        raise ValueError(f"z and hw must be on one CUDA device, got {z.device}, {hw.device}")
    if not (z.is_contiguous() and hw.is_contiguous()):
        raise ValueError("hessian_syrk_packed needs contiguous z and hw")
    n_clients, n, d = z.shape
    if n_clients > 65535:
        raise ValueError(f"{n_clients} clients exceed the kernel's grid (65535)")
    out = torch.empty((n_clients, triu_size(d)), dtype=torch.float64, device=z.device)
    if out.numel() == 0:
        return out
    fn = build.function("hessian_syrk", "syrk_packed_f64", _ARGTYPES)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        code = fn(z.data_ptr(), hw.data_ptr(), out.data_ptr(), n_clients, n, d,
                  float(lam), stream)
    build.check_launch("hessian_syrk_packed", code)
    hessian_syrk_packed_cuda.launches += 1
    return out


hessian_syrk_packed_cuda.launches = 0
