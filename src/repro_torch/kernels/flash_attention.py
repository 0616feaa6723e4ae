"""Flash attention: online softmax over key tiles, causal and sliding-window
masks, every batch row and head in one launch.

    flash_attention_cuda(q, k, v, causal=True, window=None, scale=None)
    q (B, Sq, H, dh), k and v (B, Sk, Kv, dh) -> (B, Sq, H, dh) in q's dtype

Key j is visible to query i when j < Sk, j <= i (causal) and j > i - window
(window); the logits are f32 dot products times ``scale`` (default
dh**-0.5), the softmax and P.V are f32, and a row with no visible key gives
0.  Query head h reads kv head h // (H // Kv) (GQA).

Replaces ``repro/kernels/flash_attention.py:flash_attention_pallas`` (body
``_flash_kernel``), reached in the JAX package through
``repro/kernels/ops.py:flash_attention``; the models there call its jnp twin
``repro/models/layers.py:chunked_attention``, and the port's
``models/layers.chunked_attention`` sends CUDA tensors here.  Source
``csrc/flash_attention.cu``.

What bounds it on an H100: operations.  At granite-3-2b's 32k prefill
(B = 1, S = 32,768, H = 32, Kv = 8, dh = 64, causal) QK^T and P.V are 2.2
TFLOP each over the visible half.  The reference keeps p in f32 for P.V, so
at reference precision P.V runs at the 67 TFLOP/s of f32 (32.8 ms) and QK^T,
whose operands are bf16, could run at the 989 TFLOP/s of bf16 (2.2 ms): about
35 ms a launch.  The bytes (q, k, v read once, the output written once,
335 MB) take 0.10 ms.  Rounding p to bf16, as library flash kernels do, would
lower the bound to 4.45 ms; that is another function at lower precision.

What the design does about it, simply for now: no (S, S) matrix and no
padded or repeated copy exists; one block per (64-query tile, head, batch
row), the heaviest causal tiles first; the kv axis that the TPU grid ran in
order is a loop over 64-key tiles inside the block, visiting only the tiles
that the causal and window masks leave visible; K/V tiles in shared memory,
4 x 4 logits and 4 x dh/16 outputs per thread in f32 FMA on the CUDA cores.
``wgmma`` for QK^T, TMA and a pipelined ring of tiles are for later.

``flash_attention_plain`` is the same function in plain PyTorch, chunked
over queries (the logits of one chunk at a time), for the CPU and for
holding the kernel to it on the card.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG = -1e30  # the reference's mask sentinel (flash_attention.py:31)
HEAD_DIMS = (16, 32, 64, 128)  # the kernel's instantiations
PLAIN_Q_CHUNK = 512

_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
)


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(
            f"need q (B, Sq, H, dh) and k, v (B, Sk, Kv, dh), got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, _, h, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(
            f"q {tuple(q.shape)} and k {tuple(k.shape)}: batch and head_dim must "
            "match and the kv heads divide the query heads"
        )


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    q_chunk: int = PLAIN_Q_CHUNK,
) -> torch.Tensor:
    """The plain PyTorch version: per chunk of queries, f32 logits over all
    keys, masked softmax, f32 P.V, divided by the row sum (0 where no key is
    visible), rounded to q's dtype."""
    _check_shapes(q, k, v)
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    s = dh**-0.5 if scale is None else scale
    kf, vf = k.float(), v.float()
    kpos = torch.arange(sk, device=q.device)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    for q0 in range(0, sq, q_chunk):
        qc = q[:, q0 : q0 + q_chunk].float()
        c = qc.shape[1]
        qg = qc.reshape(b, c, kv, h // kv, dh)
        logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, kf) * s
        qpos = torch.arange(q0, q0 + c, device=q.device)[:, None]
        mask = torch.ones((c, sk), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (kpos[None, :] <= qpos)
        if window is not None:
            mask = mask & (kpos[None, :] > qpos - window)
        logits = logits.masked_fill(~mask, NEG)
        m = logits.amax(dim=-1, keepdim=True)
        p = torch.where(mask, torch.exp(logits - m), 0.0)
        denom = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bgrqk,bkgd->bgrqd", p, vf) / torch.where(denom > 0, denom, 1.0)
        out[:, q0 : q0 + c] = o.permute(0, 3, 1, 2, 4).reshape(b, c, h, dh).to(q.dtype)
    return out


# Where two f32 computations of one attention output are compared after
# rounding to bf16, the ulp is taken at no less than this magnitude: the f32
# sums' own rounding leaves ~1e-7 absolute (a few 2**-24 of the row's unit
# values), more than a bf16 ulp of an output that sits near 0 (seen: -4e-8
# against -6e-8, 45 bf16 ulps apart).  At 2**-14 the ulp is 2**-21 = 4.8e-7.
BF16_ULP_FLOOR = 2.0**-14


def bf16_ulps(got: torch.Tensor, want: torch.Tensor, floor: float = 0.0) -> torch.Tensor:
    """|got - want| per element in bf16 ulps: units of the bf16 spacing at
    max(|got|, |want|, floor) (8 significant bits: 2**(e - 8) for a magnitude
    in [2**(e-1), 2**e))."""
    g, w = got.float(), want.float()
    mag = torch.maximum(torch.maximum(g.abs(), w.abs()), torch.tensor(floor, device=g.device))
    _, e = torch.frexp(mag)
    return (g - w).abs() / torch.ldexp(torch.ones_like(mag), e - 8)


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Launch the CUDA kernel on q's device and current stream."""
    _check_shapes(q, k, v)
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention takes bf16 or f32 of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"q, k, v must be on one CUDA device, got {q.device}, {k.device}, {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous q, k, v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention needs q, k, v aligned to 16 bytes")
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention has head_dim {HEAD_DIMS}, got {dh}")
    if b > 65535 or h > 65535 or max(sq, sk) >= 2**31 - 64:
        raise ValueError(f"shapes {tuple(q.shape)}, {tuple(k.shape)} exceed the kernel's grid")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    s = dh**-0.5 if scale is None else scale
    fn = build.function("flash_attention", "flash_attention_fwd", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, sk, h, kv,
                  dh, int(q.dtype == torch.bfloat16), int(causal),
                  0 if window is None else int(window), float(s), stream)
    build.check_launch("flash_attention", code)
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
