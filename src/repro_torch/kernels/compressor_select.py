"""Batched TopK selection over packed upper-triangle vectors, one launch.

    select_topk(u, k) -> (u_hat, sent):  u (n_clients, T) float64,
    u_hat = where(keep, u, +0.0) with keep the k largest f32(|u|) keys,
    lowest index first among ties; sent (n_clients,) int32, all equal to k.

Replaces ``repro/kernels/compressor_select.py:select_topk_pallas`` (body
``_topk_kernel``), which the JAX round reaches through
``repro/kernels/ops.py:select_topk``; source ``csrc/compressor_select.cu``.
RandSeqK and TopLEK (``select_randseqk_pallas``, ``select_toplek_pallas``)
are not ported yet (ROADMAP B3, B4).

What bounds it on an H100: bytes.  At w8a (142 clients, T = 45451, k = 2408)
it must read u and write u_hat once, 103.3 MB, about 31 us at 3.35 TB/s;
its integer work (a compare and a count per key in 33 passes over 6.45 M
keys, 426 M operations) takes 6.4 us at the 67 T/s 32-bit rate outside the
tensor cores.

What the design does about it: u is read from device memory once into
f32 keys that stay on chip -- one block of 1024 threads per client holds its
T * 4 bytes of keys (181.8 KB at w8a) in dynamic shared memory, so the 31
search steps and the tie pass never touch device memory -- and u_hat is
written once, in index order, coalesced.  The kernel reads u a second time
for the output values (from L2 when the client's 363 KB is still there).
Each search step is one block-wide count; the tie split is an exact
block-wide exclusive scan (ballot + popc inside a warp, a scan over the 32
warp totals across warps) carried from tile to tile in index order, so the
set is exactly the lowest-index tie-break of ``lax.top_k``.  Where the keys
do not fit the 227 KB opt-in shared memory (T > 58,000, i.e. d > 340) the
same kernel recomputes each key from u in device memory on every pass.
Known cost: 142 blocks of one per SM run in two waves on 132 SMs.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.compressors.select import rank_keys, threshold_keep_mask
from repro_torch.kernels import build

_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
)


def select_topk_plain(u: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: the threshold mask, batched over clients."""
    keep = threshold_keep_mask(rank_keys(u), k)
    sent = torch.full(u.shape[:-1], k, dtype=torch.int32, device=u.device)
    return torch.where(keep, u, torch.zeros_like(u)), sent


def select_topk_cuda(u: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on u's device and current stream."""
    if u.dtype != torch.float64:
        raise TypeError(f"select_topk takes float64, got {u.dtype}")
    if u.ndim != 2 or not u.is_cuda or not u.is_contiguous():
        raise ValueError(
            f"need a contiguous (n_clients, T) CUDA tensor, got {tuple(u.shape)} "
            f"on {u.device}"
        )
    n_clients, t = u.shape
    if not 0 < k <= t:
        raise ValueError(f"select_topk needs 0 < k <= T, got k={k}, T={t}")
    if n_clients > 2**31 - 1 or t >= 2**31:
        raise ValueError(f"shape {tuple(u.shape)} exceeds the kernel's index range")
    out = torch.empty_like(u)
    sent = torch.empty(n_clients, dtype=torch.int32, device=u.device)
    if n_clients == 0:
        return out, sent
    fn = build.function("compressor_select", "topk_select_f64", _ARGTYPES)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        code = fn(u.data_ptr(), out.data_ptr(), sent.data_ptr(), n_clients, t, k, stream)
    build.check_launch("select_topk", code)
    select_topk_cuda.launches += 1
    return out, sent


select_topk_cuda.launches = 0


def keys_in_shared_memory(t: int, device: torch.device) -> bool:
    """True when the kernel keeps the T keys in shared memory on ``device``
    (False: it recomputes them from u in device memory on every pass)."""
    fn = build.function("compressor_select", "topk_select_smem_bytes", (ctypes.c_int,))
    with torch.cuda.device(device):
        return fn(t) > 0
