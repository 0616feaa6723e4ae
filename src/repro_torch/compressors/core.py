"""FedNL matrix compressors on packed upper-triangle vectors, batched over clients.

Port of ``repro.compressors.core``, the paper's six compressors: TopK (keep
the k largest-magnitude entries; contractive with delta = k/T), RandK (k
entries uniformly at random without replacement), RandSeqK (the paper's
cache-aware RandK: one random start per client, k contiguous entries mod
T), TopLEK (the paper's adaptive Top-<=K: k' <= k entries, randomised between
two prefix sizes so that the contraction holds with equality at delta =
k/T), Natural (probabilistic rounding to a power of two) and Identity.

``Compressor.compress(keys, u)`` takes the clients' PRNG keys (n_clients, 2)
uint32 -- :func:`repro_torch.prng.split` of the round's subkey, as the
reference's round makes them -- and u (n_clients, T), and returns
``(u_hat, sent_elems)``: the dense decompressed result and, per client, the
number of scalar payload entries a real transfer would carry.  A compressor
that draws nothing (``draws`` False) is given ``keys=None``.  RandSeqK and
TopLEK make their draws on the host from the keys, one scalar per client,
and upload them in one copy; RandK and Natural draw one uniform per entry,
on the card (the threefry kernel, ``kernels/threefry.py``), from the keys
uploaded.  :func:`message_bits` prices the sent entries in the paper's
Section-7 encodings.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch import prng
from repro_torch.compressors.select import natural_from_uniform, randseqk_dense, rank_keys

FP_BITS = 64  # the paper runs FP64 end to end
IDX_BITS = 32  # fixed-width 32-bit indices
NATURAL_BITS = 12  # sign + 11-bit FP64 exponent per entry


def upload_draws(draws: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host array (draws, keys or client indices) as a tensor on ``device``.

    For a card the copy goes from pinned memory with ``non_blocking=True``,
    so the host does not wait behind the queue.  The pinned buffer comes
    from PyTorch's caching host allocator, which records the copy on the
    stream and does not hand the buffer out again until the copy has run,
    so the buffer may be dropped here."""
    host = torch.from_numpy(np.ascontiguousarray(draws))
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


def device_uniform(keys: np.ndarray, t: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``uniform(key_c, (t,), dtype)`` for each client key (n_clients, 2),
    drawn on ``device`` by the threefry kernel (its plain version on the
    CPU) from the keys, uploaded."""
    from repro_torch.kernels import ops as kops

    keys_dev = upload_draws(np.asarray(keys, dtype=np.uint32).view(np.int32), device)
    return kops.threefry_uniform(keys_dev, t, dtype)


def topk(u: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Deterministic TopK by magnitude, through the selection kernel."""
    from repro_torch.kernels import ops as kops  # kernels import compressors.select

    return kops.select_topk(u, k)


def randk(
    keys: np.ndarray, u: torch.Tensor, k: int, *, scaled: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """RandK: k slots uniformly at random without replacement, as the
    reference draws them: the k largest of T f32 uniforms per client
    (``lax.top_k``, lowest index first on ties), through the threefry kernel
    and the TopK-by-keys selection kernel.  ``scaled=True`` is C/(1+omega),
    the plain mask; ``scaled=False`` the unbiased form, times T/k."""
    unif = device_uniform(keys, u.shape[-1], torch.float32, u.device)
    return randk_from_uniform(u, unif, k, scaled=scaled)


def randk_from_uniform(
    u: torch.Tensor, unif: torch.Tensor, k: int, *, scaled: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """RandK given its f32 uniforms (one per entry of u)."""
    from repro_torch.kernels import ops as kops

    t = u.shape[-1]
    u_hat, sent = kops.select_topk_by_keys(u, unif, k)
    return (u_hat, sent) if scaled else (u_hat * (t / k), sent)


def natural(
    keys: np.ndarray, u: torch.Tensor, *, scaled: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """Natural compression: probabilistic rounding to the nearest powers of
    two, unbiased with omega = 1/8 (scaled: times 8/9).  The Bernoulli
    draws are ``uniform(key, u.shape[-1:], float64)`` per client (what
    ``jax.random.bernoulli`` lowers to), through the threefry kernel; the
    rounding is elementwise PyTorch, as the reference's is elementwise jnp."""
    unif = device_uniform(keys, u.shape[-1], torch.float64, u.device)
    return natural_with_sent(u, unif, scaled=scaled)


def natural_with_sent(
    u: torch.Tensor, unif: torch.Tensor, *, scaled: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """Natural given its f64 uniforms (one per entry of u): every entry is sent."""
    sent = torch.full(u.shape[:-1], u.shape[-1], dtype=torch.int32, device=u.device)
    return natural_from_uniform(u, unif, scaled=scaled), sent


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


# ---------------------------------------------------------------------------
# sparse (index, value) forms, the wire codecs' payloads: per row the sent
# indices and values in the reference's order, ``lax.top_k``'s (rank key
# descending, lowest index first on ties), entries past ``sent`` zero-padded.
# The kept set comes from the index forms of the selection kernels; putting
# its k pairs in that order is a stable sort of k entries, serialisation.
# u is (n, T); idx (n, k) int32, vals (n, k), sent (n,) int32.
# ---------------------------------------------------------------------------


def _descending(idx: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """idx (n, k) in index order, reordered by keys descending, stably."""
    order = torch.sort(keys, dim=-1, descending=True, stable=True).indices
    return torch.gather(idx, -1, order)


def topk_sparse(u: torch.Tensor, k: int):
    """TopK's k (index, value) pairs: ``topk_indices``' order."""
    from repro_torch.kernels import ops as kops

    _, sent, idx = kops.select_topk_idx(u, k)
    idx = _descending(idx, rank_keys(torch.gather(u, -1, idx.long())))
    return idx, torch.gather(u, -1, idx.long()), sent


def randk_sparse(keys: np.ndarray, u: torch.Tensor, k: int):
    """RandK's k pairs in ``lax.top_k``'s order of the f32 uniform keys."""
    from repro_torch.kernels import ops as kops

    unif = device_uniform(keys, u.shape[-1], torch.float32, u.device)
    _, sent, idx = kops.select_topk_by_keys_idx(u, unif, k)
    idx = _descending(idx, torch.gather(unif, -1, idx.long()))
    return idx, torch.gather(u, -1, idx.long()), sent


def randk_indices(keys: np.ndarray, t: int, k: int, device: torch.device) -> torch.Tensor:
    """RandK's index set, replayed from the keys alone (the receiver's side
    of the PRG-seed reconstruction): :func:`randk_sparse`'s idx."""
    zeros = torch.zeros((len(keys), t), dtype=torch.float64, device=device)
    return randk_sparse(keys, zeros, k)[0]


def randseqk_sparse(keys: np.ndarray, u: torch.Tensor, k: int):
    """RandSeqK's window {s, ..., s+k-1 mod T} in window order, through the
    selection kernel."""
    from repro_torch.kernels import ops as kops

    t = u.shape[-1]
    s = upload_draws(prng.randint(keys, 0, t), u.device)
    u_hat, sent = kops.select_randseqk(u, k, s)
    idx = ((s[:, None] + torch.arange(k, device=u.device)) % t).to(torch.int32)
    return idx, torch.gather(u_hat, -1, idx.long()), sent


def toplek_sparse(keys: np.ndarray, u: torch.Tensor, k: int):
    """TopLEK's pairs, as the reference forms them: the first ``kept`` of
    ``lax.top_k(rank_keys(u_hat), k)`` and ``u_hat`` there, zeros after.  So
    the kept entries of non-zero key come first, by key; the slots of kept
    entries whose key is 0 go, as in ``lax.top_k``, to the lowest indices of
    key 0 in u_hat, which need not be theirs (their value is 0.0 either way,
    but for an |u| below f32's least subnormal)."""
    from repro_torch.kernels import ops as kops

    n, t = u.shape
    unif = upload_draws(prng.uniform(keys), u.device)
    u_hat, kept, idx_io = kops.select_toplek_idx(u, k, unif)
    pos = torch.arange(k, device=u.device)
    first = pos < kept[:, None]
    key_io = torch.where(first, rank_keys(torch.gather(u, -1, idx_io.long())), 0.0)
    nonzero = key_io > 0
    n_nonzero = nonzero.sum(-1, keepdim=True)
    by_key = _descending(idx_io, torch.where(nonzero, key_io, -1.0))
    # the lowest indices outside the non-zero-key set, in index order (the
    # first k indices hold at least the kept - n_nonzero needed)
    taken = torch.zeros((n, k + 1), dtype=torch.bool, device=u.device)
    taken.scatter_(-1, torch.where(nonzero & (idx_io < k), idx_io.long(), k), True)
    free = torch.sort(torch.where(taken[:, :k], k + pos, pos), dim=-1).values
    fill = torch.gather(free, -1, torch.clamp(pos - n_nonzero, min=0))
    idx = torch.where(pos < n_nonzero, by_key.long(), fill)
    idx = torch.where(first, idx, 0)
    vals = torch.where(first, torch.gather(u_hat, -1, idx), 0.0)
    return idx.to(torch.int32), vals, kept


def scatter_add_sparse(idx: torch.Tensor, vals: torch.Tensor, t: int) -> torch.Tensor:
    """Decompress and add a batch of sparse messages into one (T,) vector."""
    out = torch.zeros(t, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, idx.reshape(-1).long(), vals.reshape(-1))


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
    # RandK and Natural draw one uniform per entry on the device: the dtype
    # of those uniforms, and the compression given them, so that a batched
    # sweep round draws every row of one dtype in one threefry launch
    entry_uniform: torch.dtype | None = None
    compress_from_uniform: Callable[[torch.Tensor, torch.Tensor], tuple] | None = None
    # ``compress_sparse(keys, u) -> (idx, vals, sent_elems)``, the batched
    # (index, value) form of the sparsifiers (TopK, RandK, RandSeqK, TopLEK);
    # None for the dense ones (Natural, Identity)
    compress_sparse: Callable[[np.ndarray | None, torch.Tensor], tuple] | None = None


@dataclasses.dataclass(frozen=True)
class CompressorSpec:
    """A registered compressor: its name and ``make(T, k) -> Compressor``."""

    name: str
    make: Callable[[int, int], Compressor]


def _make_topk(t: int, k: int) -> Compressor:
    return Compressor("topk", lambda keys, u: topk(u, k), alpha=1.0, delta=k / t,
                      bits_per_elem=FP_BITS + IDX_BITS, header_bits=0, k=k,
                      compress_sparse=lambda keys, u: topk_sparse(u, k))


def _make_randk(t: int, k: int) -> Compressor:
    return Compressor("randk", lambda keys, u: randk(keys, u, k), alpha=1.0,
                      delta=k / t, bits_per_elem=FP_BITS, header_bits=FP_BITS,
                      k=k, draws=True, entry_uniform=torch.float32,
                      compress_from_uniform=lambda u, unif: randk_from_uniform(u, unif, k),
                      compress_sparse=lambda keys, u: randk_sparse(keys, u, k))


def _make_randseqk(t: int, k: int) -> Compressor:
    return Compressor("randseqk", lambda keys, u: randseqk(keys, u, k), alpha=1.0,
                      delta=k / t, bits_per_elem=FP_BITS, header_bits=IDX_BITS,
                      k=k, draws=True,
                      compress_sparse=lambda keys, u: randseqk_sparse(keys, u, k))


def _make_toplek(t: int, k: int) -> Compressor:
    return Compressor("toplek", lambda keys, u: toplek(keys, u, k), alpha=1.0,
                      delta=k / t, bits_per_elem=FP_BITS + IDX_BITS,
                      header_bits=IDX_BITS, k=k, draws=True,
                      compress_sparse=lambda keys, u: toplek_sparse(keys, u, k))


def _make_natural(t: int, k: int) -> Compressor:
    del t, k
    return Compressor("natural", lambda keys, u: natural(keys, u), alpha=1.0,
                      delta=8.0 / 9.0, bits_per_elem=NATURAL_BITS, header_bits=0,
                      draws=True, entry_uniform=torch.float64,
                      compress_from_uniform=natural_with_sent)


def _make_identity(t: int, k: int) -> Compressor:
    del t, k
    return Compressor("identity", lambda keys, u: identity(u), alpha=1.0, delta=1.0,
                      bits_per_elem=FP_BITS, header_bits=0)


# name -> CompressorSpec: the six built-ins, and what
# ``repro_torch.api.register_compressor`` adds
COMPRESSORS: dict[str, CompressorSpec] = {
    "topk": CompressorSpec("topk", _make_topk),
    "randk": CompressorSpec("randk", _make_randk),
    "randseqk": CompressorSpec("randseqk", _make_randseqk),
    "toplek": CompressorSpec("toplek", _make_toplek),
    "natural": CompressorSpec("natural", _make_natural),
    "identity": CompressorSpec("identity", _make_identity),
}


def get_compressor(name: str, t: int, k: int = 0) -> Compressor:
    """Build the compressor registered under ``name`` (``COMPRESSORS``) for
    packed-triu length ``t`` with sparsity budget ``k``."""
    if name not in COMPRESSORS:
        raise KeyError(f"unknown compressor {name!r}; have {sorted(COMPRESSORS)}")
    if name in ("topk", "randk", "randseqk", "toplek") and not 0 < k <= t:
        raise ValueError(f"{name} needs 0 < k <= T, got k={k}, T={t}")
    return COMPRESSORS[name].make(t, k)


def message_bits(c: Compressor, sent_elems: torch.Tensor) -> torch.Tensor:
    """Wire bits of one compressed Hessian message (Section 7), int64, exact."""
    return sent_elems.to(torch.int64) * c.bits_per_elem + c.header_bits
