"""Public kernel entry points: FedNL's round and the LM zoo's attention
(port of ``repro.kernels.ops``).

Each routes on the device of its input, and on nothing else: a CPU tensor
goes to the kernel's plain PyTorch version, and so does a ``meta`` tensor
(a step counted without data, ``roofline.step_cost``); a CUDA tensor
launches the CUDA kernel (or raises).  There is no fallback from the kernel
to the plain version.  ``attention`` also routes on whether a gradient is
wanted: then it is the autograd Function (the forward's training
instantiation and the backward kernels on the card).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import compressor_select, hessian_syrk, threefry
from repro_torch.kernels import flash_attention as flash_attention_mod


def _route(name: str, t: torch.Tensor) -> bool:
    """True for the CUDA kernel, False for the plain version."""
    if t.device.type == "cuda":
        return True
    if t.device.type in ("cpu", "meta"):
        return False
    raise ValueError(f"{name}: no kernel for device {t.device}")


def hessian_syrk_packed(z: torch.Tensor, hw: torch.Tensor, lam: float) -> torch.Tensor:
    """``pack_triu(Z^T diag(hw) Z) + lam * pack_triu(I)`` per client:
    z (n_clients, n_i, d), hw (n_clients, n_i) -> (n_clients, T)."""
    if _route("hessian_syrk_packed", z):
        return hessian_syrk.hessian_syrk_packed_cuda(z, hw, lam)
    return hessian_syrk.hessian_syrk_packed_plain(z, hw, lam)


def select_topk(u: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """TopK selection per client: u (n_clients, T) -> (u_hat, sent)."""
    if _route("select_topk", u):
        return compressor_select.select_topk_cuda(u, k)
    return compressor_select.select_topk_plain(u, k)


def select_topk_by_keys(
    u: torch.Tensor, keys: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """TopK selection per client on the given f32 keys (RandK's uniforms):
    u, keys (n_clients, T) -> (u_hat, sent)."""
    if _route("select_topk_by_keys", u):
        return compressor_select.select_topk_by_keys_cuda(u, keys, k)
    return compressor_select.select_topk_by_keys_plain(u, keys, k)


def select_topk_idx(u: torch.Tensor, k: int):
    """TopK's index form: u (n_clients, T) -> (u_hat, sent, idx), idx the
    kept indices (n_clients, k) int32 in index order."""
    if _route("select_topk_idx", u):
        return compressor_select.select_topk_idx_cuda(u, k)
    return compressor_select.select_topk_idx_plain(u, k)


def select_topk_by_keys_idx(u: torch.Tensor, keys: torch.Tensor, k: int):
    """TopK by keys' index form: -> (u_hat, sent, idx), as ``select_topk_idx``."""
    if _route("select_topk_by_keys_idx", u):
        return compressor_select.select_topk_by_keys_idx_cuda(u, keys, k)
    return compressor_select.select_topk_by_keys_idx_plain(u, keys, k)


def threefry_uniform(keys: torch.Tensor, t: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.random.uniform(key_c, (t,), dtype)`` for each client's key:
    keys (n_clients, 2) int32 -> (n_clients, t) float32 or float64."""
    if _route("threefry_uniform", keys):
        return threefry.threefry_uniform_cuda(keys, t, dtype)
    return threefry.threefry_uniform_plain(keys, t, dtype)


def select_randseqk(
    u: torch.Tensor, k: int, s: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """RandSeqK selection per client given the window starts s (n_clients,)
    int64: u (n_clients, T) -> (u_hat, sent)."""
    if _route("select_randseqk", u):
        return compressor_select.select_randseqk_cuda(u, k, s)
    return compressor_select.select_randseqk_plain(u, k, s)


def select_toplek(
    u: torch.Tensor, k: int, unif: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """TopLEK selection per client given the Bernoulli uniforms unif
    (n_clients,) float64: u (n_clients, T) -> (u_hat, sent)."""
    if _route("select_toplek", u):
        return compressor_select.select_toplek_cuda(u, k, unif)
    return compressor_select.select_toplek_plain(u, k, unif)


def select_toplek_idx(u: torch.Tensor, k: int, unif: torch.Tensor):
    """TopLEK's index form: -> (u_hat, sent, idx), idx the ``sent`` kept
    indices of each row in index order, zeros after them."""
    if _route("select_toplek_idx", u):
        return compressor_select.select_toplek_idx_cuda(u, k, unif)
    return compressor_select.select_toplek_idx_plain(u, k, unif)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    q_offset: int = 0,
    k_offset: int = 0,
) -> torch.Tensor:
    """Batched GQA flash attention, the models' entry: q (B, Sq, H, dh), k and
    v (B, Sk, Kv, dh) -> (B, Sq, H, dh); the offsets are the positions of q's
    and k's first rows, which the masks read (0 on whole sequences).  Where
    grad is enabled and q, k or v requires it, the autograd Function
    ``FlashAttention``; otherwise the inference kernel (or its plain
    version)."""
    kw = dict(causal=causal, window=window, scale=scale, q_offset=q_offset, k_offset=k_offset)
    on_card = _route("flash_attention", q)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return flash_attention_mod.FlashAttention.apply(q, k, v, causal, window, scale, q_offset,
                                                        k_offset)
    if on_card:
        return flash_attention_mod.flash_attention_cuda(q, k, v, **kw)
    return flash_attention_mod.flash_attention_plain(q, k, v, **kw)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Flash attention in the reference's (seq, heads, head_dim) layout, one
    batch row, as ``repro.kernels.ops.flash_attention``.  The reference pads
    seq to block multiples and masks keys past ``kv_len``; here the kernel
    bounds-checks, so nothing is padded and any Sq, Sk is taken."""
    return attention(q[None], k[None], v[None], causal=causal, window=window, scale=scale)[0]


KERNELS = {
    "hessian_syrk_packed": hessian_syrk.hessian_syrk_packed_cuda,
    "select_topk": compressor_select.select_topk_cuda,
    "select_topk_by_keys": compressor_select.select_topk_by_keys_cuda,
    "select_randseqk": compressor_select.select_randseqk_cuda,
    "select_toplek": compressor_select.select_toplek_cuda,
    "select_topk_idx": compressor_select.select_topk_idx_cuda,
    "select_topk_by_keys_idx": compressor_select.select_topk_by_keys_idx_cuda,
    "select_toplek_idx": compressor_select.select_toplek_idx_cuda,
    "flash_attention": flash_attention_mod.flash_attention_cuda,
    # the training instantiation of flash's forward, and the backward's two kernels
    "flash_attention_train": flash_attention_mod.flash_attention_train_cuda,
    "flash_attention_bwd_dq": flash_attention_mod.flash_attention_bwd_dq_cuda,
    "flash_attention_bwd_dkdv": flash_attention_mod.flash_attention_bwd_dkdv_cuda,
    "threefry_uniform": threefry.threefry_uniform_cuda,
}


def launch_counts() -> dict[str, int]:
    """Launches of each CUDA kernel in this process since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    for by in (flash_attention_mod.flash_attention_cuda.route_launches,
               flash_attention_mod.flash_attention_train_cuda.route_launches,
               flash_attention_mod.flash_attention_bwd_dq_cuda.route_launches,
               flash_attention_mod.flash_attention_bwd_dkdv_cuda.route_launches,
               threefry.threefry_uniform_cuda.dtype_launches):
        by.update({name: 0 for name in by})
