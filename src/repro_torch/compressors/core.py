"""FedNL matrix compressors on packed upper-triangle vectors, batched over clients.

Port of ``repro.compressors.core`` for TopK (keep the k largest-magnitude
entries; contractive with delta = k/T), RandSeqK (the paper's cache-aware
RandK: one random start per client, k contiguous entries mod T), TopLEK (the
paper's adaptive Top-<=K: k' <= k entries, randomised between two prefix
sizes so that the contraction holds with equality at delta = k/T) and
Identity.  RandK and Natural draw one number per element and are not ported
yet (ROADMAP A6); they raise ``NotImplementedError``.

``Compressor.compress(keys, u)`` takes the clients' PRNG keys (n_clients, 2)
uint32 -- :func:`repro_torch.prng.split` of the round's subkey, as the
reference's round makes them -- and u (n_clients, T), and returns
``(u_hat, sent_elems)``: the dense decompressed result and, per client, the
number of scalar payload entries a real transfer would carry.  A compressor
that draws nothing (``draws`` False) is given ``keys=None``.  The random
compressors make their draws on the host from the keys, one scalar per
client, and upload them in one copy.  :func:`message_bits` prices the sent
entries in the paper's Section-7 encodings.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch import prng
from repro_torch.compressors.select import randseqk_dense

FP_BITS = 64  # the paper runs FP64 end to end
IDX_BITS = 32  # fixed-width 32-bit indices

_NOT_PORTED = {
    "randk": "ROADMAP A6 (per-element draws: device threefry or precomputation)",
    "natural": "ROADMAP A6 (per-element draws: device threefry or precomputation)",
}


def upload_draws(draws: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host array of draws as a tensor on ``device``.

    For a card the copy goes from pinned memory with ``non_blocking=True``,
    so the host does not wait behind the queue.  The pinned buffer comes
    from PyTorch's caching host allocator, which records the copy on the
    stream and does not hand the buffer out again until the copy has run,
    so the buffer may be dropped here."""
    host = torch.from_numpy(np.ascontiguousarray(draws))
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


def topk(u: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Deterministic TopK by magnitude, through the selection kernel."""
    from repro_torch.kernels import ops as kops  # kernels import compressors.select

    return kops.select_topk(u, k)


def randseqk(
    keys: np.ndarray, u: torch.Tensor, k: int, *, scaled: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """Cache-aware RandK (paper Appendix C): per client one start
    s ~ U[0, T) = ``randint(key, (), 0, T)``, and the slots {s, ..., s+k-1
    mod T}.  ``scaled=True`` is the contractive C/(1+omega) form, a plain
    window (through the selection kernel); ``scaled=False`` the unbiased
    form, the window times T/k."""
    from repro_torch.kernels import ops as kops

    t = u.shape[-1]
    s = upload_draws(prng.randint(keys, 0, t), u.device)
    if scaled:
        return kops.select_randseqk(u, k, s)
    sent = torch.full(u.shape[:-1], k, dtype=torch.int32, device=u.device)
    return randseqk_dense(u, k, s) * (t / k), sent


def toplek(keys: np.ndarray, u: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Adaptive Top-<=K (paper Algorithm 4), through the selection kernel.
    The Bernoulli draw is ``uniform(key, (), float64)`` per client, which
    ``jax.random.bernoulli(key, p)`` lowers to (``unif < p``)."""
    from repro_torch.kernels import ops as kops

    unif = upload_draws(prng.uniform(keys), u.device)
    return kops.select_toplek(u, k, unif)


def identity(u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    sent = torch.full(u.shape[:-1], u.shape[-1], dtype=torch.int32, device=u.device)
    return u, sent


@dataclasses.dataclass(frozen=True)
class Compressor:
    """A configured compressor: ``compress(keys, u) -> (u_hat, sent_elems)``."""

    name: str
    compress: Callable[[np.ndarray | None, torch.Tensor], tuple[torch.Tensor, torch.Tensor]]
    alpha: float  # recommended Hessian learning rate for FedNL
    delta: float  # contraction parameter
    bits_per_elem: int  # payload bits per sent element
    header_bits: int  # per-message constant (seed / count)
    k: int = 0
    draws: bool = False  # True: compress needs the clients' PRNG keys


def get_compressor(name: str, t: int, k: int = 0) -> Compressor:
    """Build a compressor for packed-triu length ``t`` with sparsity budget ``k``."""
    if name in ("topk", "randseqk", "toplek") and not 0 < k <= t:
        raise ValueError(f"{name} needs 0 < k <= T, got k={k}, T={t}")
    if name == "topk":
        return Compressor("topk", lambda keys, u: topk(u, k), alpha=1.0, delta=k / t,
                          bits_per_elem=FP_BITS + IDX_BITS, header_bits=0, k=k)
    if name == "randseqk":
        return Compressor("randseqk", lambda keys, u: randseqk(keys, u, k), alpha=1.0,
                          delta=k / t, bits_per_elem=FP_BITS, header_bits=IDX_BITS,
                          k=k, draws=True)
    if name == "toplek":
        return Compressor("toplek", lambda keys, u: toplek(keys, u, k), alpha=1.0,
                          delta=k / t, bits_per_elem=FP_BITS + IDX_BITS,
                          header_bits=IDX_BITS, k=k, draws=True)
    if name == "identity":
        return Compressor("identity", lambda keys, u: identity(u), alpha=1.0, delta=1.0,
                          bits_per_elem=FP_BITS, header_bits=0)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"compressor {name!r} is not ported yet: {_NOT_PORTED[name]}"
        )
    raise KeyError(
        f"unknown compressor {name!r}; have ['identity', 'randseqk', 'toplek', 'topk']"
    )


def message_bits(c: Compressor, sent_elems: torch.Tensor) -> torch.Tensor:
    """Wire bits of one compressed Hessian message (Section 7), int64, exact."""
    return sent_elems.to(torch.int64) * c.bits_per_elem + c.header_bits
