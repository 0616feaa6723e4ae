"""Batched packed SYRK: the FedNL client Hessians, FP64, in one launch.

    hessian_syrk_packed(z, hw, lam)[c] = pack_triu(Z_c^T diag(hw_c) Z_c) + lam * pack_triu(I)

z is (n_clients, n_i, d), hw = sigma(1 - sigma) / n_i is (n_clients, n_i),
the result (n_clients, T) with T = d(d+1)/2.  The shared form takes z with
n_z clients and hw with a multiple of them: client c reads z[c mod n_z], so
a batched sweep group of S specs on one dataset runs its S * n_z clients in
one launch without copying z.

Replaces ``repro/kernels/hessian_syrk.py:hessian_syrk_pallas`` (body
``_syrk_kernel``), which the JAX round reaches through
``repro/kernels/ops.py:hessian_syrk_packed``; source
``csrc/hessian_syrk.cu``.

What bounds it on an H100: operations.  At w8a (142 clients, n_i = 348,
d = 301) the upper triangle is 2 * n_i * T * 142 = 4.49 GFLOP of FP64, 67 us
at the 67 TFLOP/s of the FP64 tensor cores, against 171 MB moved (Z read
once, the packed result written once), 51 us at 3.35 TB/s.  Beside them, the
blocks stage Z's columns out of L2 again and again: :func:`syrk_l2_bytes`,
447 MB a call at w8a.

What the design does about it: the products run on the FP64 tensor cores
(DMMA, ``mma.sync.m16n8k8.f64``; WGMMA has no FP64 shape), 32 x 32 warp
tiles whose accumulators stay in registers over all samples, fed from a
double-buffered ring of 32-sample chunks that ``cp.async`` fills while the
warps multiply (8-byte copies: rows of Z are 8 d bytes, at odd d only
8-byte aligned); hw is folded into B as the fragment is read, the same IEEE
multiply as the plain version's ``hw * z``.  The schedule
(:func:`syrk_schedule`) cuts the work to the 16 x 8 DMMA tiles that hold an
upper entry below d (1.07x the exact triangle at d = 301) and spreads a
narrow block's tiles over all its warps, and it cuts the L2 reads with
64 x 128 block tiles whose column chunks start at their own diagonal, so the
diagonal block loads one strip for both operands; the client is the slowest
grid axis, so the blocks in flight share one client's Z in L2.  The epilogue
writes the packed triangle and the ``+lam`` directly, so no (d, d) matrix
and no second pass exist.  What holds it above its bound: ``PERF.md``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.linalg.triu import pack_triu, packed_eye, triu_size

_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_void_p,
)


# The kernel's schedule, mirrored from csrc/hessian_syrk.cu (kRows, kCols,
# kWarpTile, kNarrowCols there) for the tests and the L2 reckoning.
ROWS = 64  # rows r of a block tile
COLS = 128  # columns q of a block tile; a row strip's chunks start at its diagonal
WARP_TILE = 32  # a warp's tile edge: 2 x 4 DMMA tiles
NARROW_COLS = 64  # a block with at most this many columns below d: 16 x 32 warp tiles
DMMA_ROWS, DMMA_COLS = 16, 8  # a DMMA tile, mma.sync.m16n8k8


def syrk_schedule(d: int) -> list[tuple[int, int, list[list[tuple[int, int]]]]]:
    """The blocks of one client that do work, in grid order, as the kernel
    walks them: ``(r0, q0, warps)`` for the block of rows [r0, r0 + ROWS)
    and columns [q0, q0 + COLS), ``warps[w]`` the (row, column) starts of the
    DMMA_ROWS x DMMA_COLS tiles that warp w computes -- those whose column
    start is >= their row start and < d.  Warp w owns the 32 x 32 warp tile
    (w % 2, w // 2), or, in a block with at most NARROW_COLS columns below
    d, the 16 x 32 warp tile (w % 4, w // 4)."""
    blocks = []
    n_warps = (ROWS // WARP_TILE) * (COLS // WARP_TILE)
    for r0 in range(0, d, ROWS):
        for q0 in range(r0, d, COLS):
            narrow = d - q0 <= NARROW_COLS
            rows = DMMA_ROWS if narrow else WARP_TILE
            warps = []
            for w in range(n_warps):
                row0 = r0 + rows * (w % 4 if narrow else w % 2)
                col0 = q0 + WARP_TILE * (w // 4 if narrow else w // 2)
                warps.append([
                    (rt, qt)
                    for rt in range(row0, row0 + rows, DMMA_ROWS)
                    for qt in range(col0, col0 + WARP_TILE, DMMA_COLS)
                    if rt <= qt < d
                ])
            blocks.append((r0, q0, warps))
    return blocks


def syrk_l2_bytes(n_clients: int, n: int, d: int) -> int:
    """Bytes the kernel's blocks copy out of L2 (or device memory) in one
    call: per block the columns of Z it stages -- its COLS columns, and its
    ROWS rows unless they lie inside those columns (the diagonal block) --
    cut at d, for all n samples, and its client's hw."""
    blocks = syrk_schedule(d)
    cols = sum(min(q0 + COLS, d) - q0 + (0 if q0 == r0 else min(r0 + ROWS, d) - r0)
               for r0, q0, _ in blocks)
    return n_clients * 8 * n * (cols + len(blocks))


def _check_shared(z: torch.Tensor, hw: torch.Tensor) -> None:
    if z.ndim != 3 or hw.ndim != 2 or hw.shape[1] != z.shape[1] or (
        hw.shape[0] % max(z.shape[0], 1) or (z.shape[0] == 0) != (hw.shape[0] == 0)
    ):
        raise ValueError(
            f"need z (n_z, n_i, d) and hw (n_clients, n_i), n_clients a multiple "
            f"of n_z, got {tuple(z.shape)} and {tuple(hw.shape)}"
        )


def hessian_syrk_packed_plain(z: torch.Tensor, hw: torch.Tensor, lam: float) -> torch.Tensor:
    """The plain PyTorch version: full square product, packed, +lam packed
    (hw's clients in blocks of z's, for the shared form)."""
    _check_shared(z, hw)
    d = z.shape[-1]
    hw_b = hw.view(-1, *z.shape[:2]) if hw.shape[0] != z.shape[0] else hw
    hp = pack_triu(z.mT @ (hw_b[..., None] * z)).reshape(hw.shape[0], -1)
    return hp + lam * packed_eye(d, z.dtype, z.device)


def hessian_syrk_packed_cuda(z: torch.Tensor, hw: torch.Tensor, lam: float) -> torch.Tensor:
    """Launch the CUDA kernel on z's device and current stream."""
    if z.dtype != torch.float64 or hw.dtype != torch.float64:
        raise TypeError(f"hessian_syrk_packed takes float64, got {z.dtype}, {hw.dtype}")
    _check_shared(z, hw)
    if not (z.is_cuda and hw.device == z.device):
        raise ValueError(f"z and hw must be on one CUDA device, got {z.device}, {hw.device}")
    if not (z.is_contiguous() and hw.is_contiguous()):
        raise ValueError("hessian_syrk_packed needs contiguous z and hw")
    n_z, n, d = z.shape
    n_clients = hw.shape[0]
    if n_clients > 65535:
        raise ValueError(f"{n_clients} clients exceed the kernel's grid (65535)")
    out = torch.empty((n_clients, triu_size(d)), dtype=torch.float64, device=z.device)
    if out.numel() == 0:
        return out
    fn = build.function("hessian_syrk", "syrk_packed_f64", _ARGTYPES)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        code = fn(z.data_ptr(), hw.data_ptr(), out.data_ptr(), n_clients, n_z, n, d,
                  float(lam), stream)
    build.check_launch("hessian_syrk_packed", code)
    hessian_syrk_packed_cuda.launches += 1
    return out


hessian_syrk_packed_cuda.launches = 0
