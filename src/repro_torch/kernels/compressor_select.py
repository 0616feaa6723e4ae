"""Batched selection kernels over packed upper-triangle vectors, one launch each.

    select_topk(u, k)           -> (u_hat, sent)  keep the k largest keys
    select_topk_by_keys(u, keys, k) -> (u_hat, sent)  keep the k largest given keys
    select_randseqk(u, k, s)    -> (u_hat, sent)  keep the circular window at s
    select_toplek(u, k, unif)   -> (u_hat, sent)  keep TopLEK's adaptive prefix

u is (n_clients, T) float64; u_hat = u on the kept set and +0.0 elsewhere;
sent (n_clients,) int32 is the number kept.  The index forms
``select_topk_idx``, ``select_topk_by_keys_idx`` and ``select_toplek_idx``
(the same kernels with an index output, for the wire codecs) also return
idx (n_clients, k) int32: each row's kept indices in index order, zeros
after the first ``sent``; a kept entry whose value is 0.0 is in idx, where
u_hat cannot show it.  The draws (``s`` int64,
``unif`` float64, one per client; RandK's ``keys``, float32, one per entry)
are made outside the selection from the PRNG keys and passed in as device
tensors; no selection kernel draws anything.  Source:
``csrc/compressor_select.cu``.  Each ``*_cuda`` wrapper launches its kernel
on u's device and current stream and counts the launch; each ``*_plain`` is
the same function in plain PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.compressors.select import (
    in_index_order,
    kept_prefix_dense,
    randseqk_dense_masked,
    rank_keys,
    threshold_keep_mask,
    toplek_from_uniform,
    toplek_kept_prefix,
)
from repro_torch.kernels import build

# topk_select_f64: u, out, sent, idx (null: no index output), n, t, k, stream
_TOPK_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
)
# randseqk_select_f64: u, s, out, sent, n, t, k, stream
_DRAWS_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
)
# topk_select_by_keys_f64: u, keys, out, sent, idx, n, t, k, stream
_BY_KEYS_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
)
# toplek_select_f64: u, unif, out, sent, idx, n, t, k, scratch, stream
_TOPLEK_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
)


def _check_u(name: str, u: torch.Tensor, k: int) -> tuple[int, int]:
    """The checks every selection wrapper makes before it builds or launches."""
    if u.dtype != torch.float64:
        raise TypeError(f"{name} takes float64, got {u.dtype}")
    if u.ndim != 2 or not u.is_cuda or not u.is_contiguous():
        raise ValueError(
            f"need a contiguous (n_clients, T) CUDA tensor, got {tuple(u.shape)} "
            f"on {u.device}"
        )
    n_clients, t = u.shape
    if not 0 < k <= t:
        raise ValueError(f"{name} needs 0 < k <= T, got k={k}, T={t}")
    if n_clients > 2**31 - 1 or t >= 2**30:
        raise ValueError(f"shape {tuple(u.shape)} exceeds the kernel's index range")
    return n_clients, t


def _check_draws(name: str, draws: torch.Tensor, dtype: torch.dtype, u: torch.Tensor) -> None:
    if draws.dtype != dtype:
        raise TypeError(f"{name}: the draws must be {dtype}, got {draws.dtype}")
    if draws.shape != u.shape[:1] or draws.device != u.device or not draws.is_contiguous():
        raise ValueError(
            f"{name}: need contiguous draws of shape {tuple(u.shape[:1])} on "
            f"{u.device}, got {tuple(draws.shape)} on {draws.device}"
        )


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _outputs(u: torch.Tensor, k: int, with_idx: bool):
    """u_hat, sent and (the index forms) idx, allocated for a launch."""
    out = torch.empty_like(u)
    sent = torch.empty(u.shape[0], dtype=torch.int32, device=u.device)
    idx = torch.zeros((u.shape[0], k), dtype=torch.int32, device=u.device) if with_idx else None
    return out, sent, idx


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _idx_plain(keep: torch.Tensor, k: int) -> torch.Tensor:
    """The index forms' idx from a keep mask with k kept per row (on meta,
    where nonzero's count is a value it does not have, the kept indices
    in order by a stable sort of the mask)."""
    if keep.device.type == "meta":
        return torch.argsort(~keep, dim=-1, stable=True)[..., :k].to(torch.int32)
    return keep.nonzero()[:, -1].reshape(*keep.shape[:-1], k).to(torch.int32)


# ---------------------------------------------------------------------------
# TopK
#
# Replaces ``repro/kernels/compressor_select.py:select_topk_pallas`` (body
# ``_topk_kernel``), reached through ``repro/kernels/ops.py:select_topk``.
#
# What bounds it on an H100: bytes.  At w8a (142 clients, T = 45451,
# k = 2408) it must read u and write u_hat once, 103.3 MB, about 31 us at
# 3.35 TB/s.  The work the function needs is small beside that: a key per
# entry, four histogram passes of a radix select and one compare, some
# 14 operations per key (90 M, 1.3 us at the 67 T/s 32-bit rate outside the
# tensor cores).
#
# What the design does about it: u is read from device memory once into f32
# keys that stay on chip -- one block of 1024 threads per client holds its
# T * 4 bytes of keys (181.8 KB at w8a) in dynamic shared memory -- and u_hat
# is written once, in index order, coalesced; u is read again only where an
# entry is kept (k of T).  The threshold is a radix select on the 31 key
# bits in digits of 7, 8, 8 and 8 bits: each pass histograms, in 256 shared
# counters, the digit of the keys that match the digits found so far, and one
# warp finds the bin that holds the k-th key; the first digit (the
# exponent's high bits, few distinct values) is counted once per warp and
# value (``__match_any_sync``).  The result is the bit search's threshold,
# and ``need = k - #{key > thr}``, by construction, and the last pass also
# counts the keys equal to the threshold.  When that count is ``need``, the
# common case, every tie is kept and the output pass is ``key >= thr``.
# Otherwise the lowest-index ties are kept by one ordered scan: each warp
# owns a contiguous segment, counts its ties, one scan of the 32 warp counts
# gives each warp its first tie rank, and each tie's rank is that plus the
# ballot of the lanes below it; so the set is exactly the lowest-index
# tie-break of ``lax.top_k``.  Where the keys do not fit the 227 KB opt-in
# shared memory beside the kernel's static shared memory (32 warp counts,
# 256 bins, a pass's pick: 1,168 bytes as compiled for sm_90a; T > 57,820,
# i.e. d > 339) the same kernel recomputes each key from u in device memory
# on every pass.  Known cost: 142 blocks of one per SM run in two waves on 132
# SMs.
# ---------------------------------------------------------------------------


def select_topk_plain(u: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: the threshold mask, batched over clients."""
    keep = threshold_keep_mask(rank_keys(u), k)
    sent = torch.full(u.shape[:-1], k, dtype=torch.int32, device=u.device)
    return torch.where(keep, u, torch.zeros_like(u)), sent


def _launch_topk(name: str, u: torch.Tensor, k: int, with_idx: bool):
    n_clients, t = _check_u(name, u, k)
    out, sent, idx = _outputs(u, k, with_idx)
    if n_clients == 0:
        return out, sent, idx, False
    fn = build.function("compressor_select", "topk_select_f64", _TOPK_ARGTYPES)
    with torch.cuda.device(u.device):
        code = fn(u.data_ptr(), out.data_ptr(), sent.data_ptr(), _ptr(idx), n_clients, t, k,
                  _stream(u.device))
    build.check_launch(name, code)
    return out, sent, idx, True


def select_topk_cuda(u: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the TopK kernel on u's device and current stream."""
    out, sent, _, launched = _launch_topk("select_topk", u, k, False)
    select_topk_cuda.launches += launched
    return out, sent


select_topk_cuda.launches = 0


# ---------------------------------------------------------------------------
# Index forms (TopK, TopK by keys, TopLEK): the wire codecs' selections
#
# The reference's codecs send (index, value) pairs from ``topk_sparse``,
# ``randk_sparse`` and ``toplek_sparse`` (``repro/compressors/core.py:184``,
# ``:189``, ``:204``), and its RandK decode replays ``lax.top_k`` of the PRG's
# uniforms (``repro/comm/wire.py:184``): the same selections as the dense
# kernels, with the kept indices as output.  A kept entry whose value is 0.0
# is kept all the same, and ``u_hat`` cannot show it, so the kernels write the
# indices themselves: idx (n_clients, k) int32, in index order, zeros after
# ``sent``.  Putting the k pairs in ``lax.top_k``'s order for the bytes is a
# stable sort of k entries on the caller's side (serialisation).
#
# What bounds them on an H100: bytes, as the dense forms, plus k * 4 of idx.
# On the star path a client calls them on its own row, (1, 45451): 0.73 MB,
# 0.22 us at 3.35 TB/s; one block of 1024 threads on one SM is latency-bound
# far above that, as the dense form on one row is.
#
# What the design does: TopK's two forms run the same kernel with the keep
# pass in per-warp segments (``keep_pass_ordered``): a first pass counts each
# warp's keys above the threshold and its ties, one scan of the 32 warp
# counts gives each warp the rank of its first kept index, and a ballot ranks
# the rest, so each kept index is written to its slot in index order.
# TopLEK's form, after the dense output, sorts the first ``kept`` of its rank
# order again by index alone (a second bitonic sort of the same P slots).
# ---------------------------------------------------------------------------


def select_topk_idx_plain(u: torch.Tensor, k: int):
    """The plain version of the index form: (u_hat, sent, idx)."""
    keep = threshold_keep_mask(rank_keys(u), k)
    sent = torch.full(u.shape[:-1], k, dtype=torch.int32, device=u.device)
    return torch.where(keep, u, torch.zeros_like(u)), sent, _idx_plain(keep, k)


def select_topk_idx_cuda(u: torch.Tensor, k: int):
    """Launch the TopK kernel's index form: (u_hat, sent, idx)."""
    out, sent, idx, launched = _launch_topk("select_topk_idx", u, k, True)
    select_topk_idx_cuda.launches += launched
    return out, sent, idx


select_topk_idx_cuda.launches = 0


def keys_in_shared_memory(t: int, device: torch.device) -> bool:
    """True when the TopK kernel keeps the T keys in shared memory on
    ``device`` (False: it recomputes them from u in device memory on every
    pass)."""
    fn = build.function("compressor_select", "topk_select_smem_bytes", (ctypes.c_int,))
    with torch.cuda.device(device):
        return fn(t) > 0


# ---------------------------------------------------------------------------
# TopK by keys (RandK's selection)
#
# The reference's RandK (``repro/compressors/core.py:randk``) keeps
# ``lax.top_k(uniform_f32(key, (T,)), k)``: the k largest of T f32 uniforms,
# lowest index first among equal keys (about 123 pairs tie per client among
# 45,451 f32 uniforms).  That is TopK's selection with other keys, so it runs
# TopK's kernel (the same radix threshold and keep pass) with ``key_at(i)``
# reading the uniform's bit pattern, non-negative and so ordered as its
# value, and copying u where kept.  Selection kernel of
# ``repro/kernels/compressor_select.py:select_topk_pallas``'s contract, on
# RandK's keys.
#
# What bounds it on an H100: bytes.  At w8a it must read the keys (25.8 MB),
# the k kept entries of u (2.7 MB) and write u_hat (51.6 MB), 80.2 MB, about
# 24 us at 3.35 TB/s; the selection is TopK's, 14 operations per key.
#
# What the design does about it: TopK's (one block of 1024 threads per
# client, the keys held in shared memory where T * 4 bytes fit, u read only
# where kept, u_hat written once in index order).
# ---------------------------------------------------------------------------


def _check_keys(name: str, keys: torch.Tensor, u: torch.Tensor) -> None:
    if keys.dtype != torch.float32:
        raise TypeError(f"{name}: the keys must be float32, got {keys.dtype}")
    if keys.shape != u.shape or keys.device != u.device or not keys.is_contiguous():
        raise ValueError(
            f"{name}: need contiguous keys of shape {tuple(u.shape)} on {u.device}, "
            f"got {tuple(keys.shape)} on {keys.device}"
        )


def select_topk_by_keys_plain(
    u: torch.Tensor, keys: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: the threshold mask on the given keys."""
    keep = threshold_keep_mask(keys, k)
    sent = torch.full(u.shape[:-1], k, dtype=torch.int32, device=u.device)
    return torch.where(keep, u, torch.zeros_like(u)), sent


def _launch_by_keys(name: str, u: torch.Tensor, keys: torch.Tensor, k: int, with_idx: bool):
    n_clients, t = _check_u(name, u, k)
    _check_keys(name, keys, u)
    out, sent, idx = _outputs(u, k, with_idx)
    if n_clients == 0:
        return out, sent, idx, False
    fn = build.function("compressor_select", "topk_select_by_keys_f64", _BY_KEYS_ARGTYPES)
    with torch.cuda.device(u.device):
        code = fn(u.data_ptr(), keys.data_ptr(), out.data_ptr(), sent.data_ptr(), _ptr(idx),
                  n_clients, t, k, _stream(u.device))
    build.check_launch(name, code)
    return out, sent, idx, True


def select_topk_by_keys_cuda(
    u: torch.Tensor, keys: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the TopK-by-keys kernel on u's device and current stream;
    ``keys`` (n_clients, T) float32, non-negative, on the same device."""
    out, sent, _, launched = _launch_by_keys("select_topk_by_keys", u, keys, k, False)
    select_topk_by_keys_cuda.launches += launched
    return out, sent


select_topk_by_keys_cuda.launches = 0


def select_topk_by_keys_idx_plain(u: torch.Tensor, keys: torch.Tensor, k: int):
    """The plain version of the index form: (u_hat, sent, idx)."""
    keep = threshold_keep_mask(keys, k)
    sent = torch.full(u.shape[:-1], k, dtype=torch.int32, device=u.device)
    return torch.where(keep, u, torch.zeros_like(u)), sent, _idx_plain(keep, k)


def select_topk_by_keys_idx_cuda(u: torch.Tensor, keys: torch.Tensor, k: int):
    """Launch the TopK-by-keys kernel's index form: (u_hat, sent, idx)."""
    out, sent, idx, launched = _launch_by_keys("select_topk_by_keys_idx", u, keys, k, True)
    select_topk_by_keys_idx_cuda.launches += launched
    return out, sent, idx


select_topk_by_keys_idx_cuda.launches = 0


# ---------------------------------------------------------------------------
# RandSeqK
#
# Replaces ``repro/kernels/compressor_select.py:select_randseqk_pallas`` (body
# ``_randseqk_kernel``), reached through ``repro/kernels/ops.py:
# select_randseqk``.
#
# What bounds it on an H100: bytes.  It must read the k window entries of u
# and write all of u_hat: at w8a 142 * (2408 + 45451) * 8 B = 54.4 MB, about
# 16 us at 3.35 TB/s; its index arithmetic is a few integer operations per
# entry.
#
# What the design does about it: a grid-stride masked copy, one grid row of
# blocks per client, neighbouring threads on neighbouring entries.  A thread
# loads u only inside the window, so u outside it is never read (the TPU
# kernel reads all of u because u is resident in VMEM).  The window test is
# ``(pos - s mod T + T) mod T < k`` with s first reduced into [0, T): C++'s
# ``%`` keeps the dividend's sign, the reference's ``%`` the divisor's.
# ---------------------------------------------------------------------------


def select_randseqk_plain(
    u: torch.Tensor, k: int, s: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: the window mask, batched over clients."""
    sent = torch.full(u.shape[:-1], k, dtype=torch.int32, device=u.device)
    return randseqk_dense_masked(u, k, s), sent


def select_randseqk_cuda(
    u: torch.Tensor, k: int, s: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the RandSeqK kernel on u's device and current stream;
    ``s`` (n_clients,) int64 on the same device."""
    n_clients, t = _check_u("select_randseqk", u, k)
    _check_draws("select_randseqk", s, torch.int64, u)
    out = torch.empty_like(u)
    sent = torch.empty(n_clients, dtype=torch.int32, device=u.device)
    if n_clients == 0:
        return out, sent
    fn = build.function("compressor_select", "randseqk_select_f64", _DRAWS_ARGTYPES)
    with torch.cuda.device(u.device):
        code = fn(u.data_ptr(), s.data_ptr(), out.data_ptr(), sent.data_ptr(),
                  n_clients, t, k, _stream(u.device))
    build.check_launch("select_randseqk", code)
    select_randseqk_cuda.launches += 1
    return out, sent


select_randseqk_cuda.launches = 0


# ---------------------------------------------------------------------------
# TopLEK
#
# Replaces ``repro/kernels/compressor_select.py:select_toplek_pallas`` (body
# ``_toplek_kernel`` = ``select.toplek_from_uniform``), reached through
# ``repro/kernels/ops.py:select_toplek``.
#
# What bounds it on an H100: bytes.  It must read u and write u_hat once,
# 103.3 MB at w8a, about 31 us at 3.35 TB/s; at the FedNL probe's (8,
# 2,098,176) 268.6 MB, 80 us.  The selection (14 32-bit operations a key)
# and the sort of k survivors per client are smaller.
#
# What the design does about it, by memory path (``toplek_plan`` in the
# source, :func:`toplek_plan_for` here):
#
# * Path 0 (w8a, a9a, phishing: the T keys fit shared memory beside the
#   survivors).  One block of 1024 threads per client runs TopK's radix
#   threshold and keep pass (the same device code) on keys held in shared
#   memory, reading u once for the keys and for total = sum(u*u), and
#   writing +0.0 over the row in the same pass that compacts the k
#   survivors as 64-bit composites (inverted key << 32 | index), each warp
#   taking its slots with one shared atomic; their order does not matter,
#   because a bitonic sort of the composites, padded to a power of two P,
#   gives the order (key descending, index ascending) -- the lowest-index
#   tie-break of ``lax.top_k``.  An f64 block scan of the squared values
#   gives the prefix energies, m* = min(1 + #{alpha < delta}, k), p and kept
#   as in the reference; the kept values are then scattered over the zeros.
#   Shared memory at w8a: 181.8 KB of keys, then 32 KB of composites (P =
#   4096); the prefix sums reuse the keys' region.
# * Path 3, the spread route (the keys do not fit; the 8 P bytes of
#   composites do: 128 KB at the probe's k = 16,384).  What held
#   the one-block design back there was one block a client (8 of 132 SMs at
#   the probe) reading its 16.8 MB row six times.  Two kernels over a grid
#   of (client, block), each client's row cut into ``toplek_spread_for``
#   contiguous segments (16 at the probe: 128 blocks), so u is read twice
#   by all the SMs: ``toplek_tally_kernel`` sums each segment's u*u in f64
#   and tallies its keys' top 12 bits (4,096 bins; a warp whose keys share
#   one bin adds once); ``toplek_spread_kernel``'s blocks each add the
#   client's tallies (bin*: the bin of the k-th largest key; the candidates,
#   the keys in bin* and above, before the block's segment and in all; the
#   total, the blocks' sums in block order), read their segment again,
#   write +0.0 over it and append its candidates as composites to the
#   client's scratch, those above bin* (all kept) before those in it (tens
#   of thousands at the probe, not 2 million).  The client's last block (a
#   count in the scratch, which the tally kernel clears) finishes alone in
#   shared memory: the radix threshold over bin*'s candidates only; where
#   the ties at it are not all kept, the need-th smallest index among them
#   by a second radix select, which is the lowest-index tie-break without
#   ordering the candidates; the k composites sorted as on path 0; the
#   prefix sums scanned in that order (the block scan of path 0, so the same
#   m*, alpha_m* and kept) but not stored: they do not decrease, so {alpha <
#   delta} is a prefix of the ranks, and the scan keeps only the sums at
#   ranks m* - 1 and m* - 2 as it passes them; the kept values over the
#   zeros.
#   The candidates can number T -- an all-zero row (which keeps nothing:
#   its blocks only write zeros), or mass ties at the k-th key (dyadic rows:
#   ~T/11) -- so the scratch holds T composites a client beside the
#   tallies.  The wrapper counts one launch a call; the route is two CUDA
#   kernels.  What holds it back: the finish runs on one SM a client, and
#   its bitonic sort of k composites is 105 passes over 128 KB of shared
#   memory at k = 16,384.
# * Path 2 (k too large for path 3's shared memory, e.g. k = T at w8a:
#   P = 65536).  The one-block kernel recomputes the keys from u on every
#   radix pass and keeps the composites and prefix sums in a scratch buffer
#   in device memory.
#
# The squares and sums use __dmul_rn / __dadd_rn so that no FMA
# contraction changes a rounding; the total's and the prefix sum's orders
# are a block reduction and a block scan, so kept can differ from the plain
# version by one only where alpha_m* lies within a few ulps of delta or
# unif of p.
# ---------------------------------------------------------------------------


def select_toplek_plain(
    u: torch.Tensor, k: int, unif: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: a stable sort and ``torch.cumsum``."""
    return toplek_from_uniform(u, k, unif)


def toplek_plan(t: int, k: int, device: torch.device) -> tuple[int, int]:
    """(memory path, scratch bytes per client) of the TopLEK kernels on ``device``."""
    path = build.function("compressor_select", "toplek_select_memory_path",
                          (ctypes.c_int, ctypes.c_int))
    scratch = build.function("compressor_select", "toplek_select_scratch_bytes",
                             (ctypes.c_int, ctypes.c_int), restype=ctypes.c_longlong)
    with torch.cuda.device(device):
        return path(t, k), scratch(t, k)


def toplek_spread(n_clients: int, device: torch.device) -> int:
    """Blocks a client that the spread route (path 3) launches on ``device``."""
    fn = build.function("compressor_select", "toplek_select_spread", (ctypes.c_int,))
    with torch.cuda.device(device):
        return fn(n_clients)


# the one-block kernel's static shared memory beside the dynamic
# (kTopLekStaticSmem in csrc/compressor_select.cu): the selection's warp
# parts, radix bins and picks, the f64 warp parts, and slack
TOPLEK_STATIC_SMEM = 4 * (32 + 256 + 4) + 8 * 32 + 64
# the same for the spread route's second kernel (kSpreadStaticSmem)
TOPLEK_SPREAD_STATIC_SMEM = 4 * (32 + 256 + 16) + 8 * (2 * 32 + 3) + 64
# the spread route (kTallyBits, kMaxSpread): a key's top 12 bits are its
# tally bin; at most 16 blocks a client; each client's scratch holds 16
# tallies of 4,096 int32 bins, 16 f64 partial sums, a 16-byte count and T
# 8-byte candidates
TALLY_BITS, MAX_SPREAD = 12, 16
SPREAD_HEAD_BYTES = 4 * MAX_SPREAD * (1 << TALLY_BITS) + 8 * MAX_SPREAD + 16


def toplek_plan_for(t: int, k: int, optin: int) -> tuple[int, int]:
    """(memory path, scratch bytes per client) that the kernels' host-side
    plan (``toplek_plan`` in csrc/compressor_select.cu) gives for (T, k) on a
    card whose blocks may opt in to ``optin`` bytes of shared memory, worked
    out here on the host: path 0 while the T f32 keys, the composites of the
    k survivors padded to a power of two P (8 P bytes) and their k f64 prefix
    sums fit shared memory beside the static part; else path 3 while the 8 P
    bytes of composites do, its scratch the tallies and T candidates; else
    path 2, the composites and prefix sums in scratch."""
    budget = optin - TOPLEK_STATIC_SMEM
    p = 1 << (k - 1).bit_length()
    keys, comps, csums = (4 * t + 15) // 16 * 16, 8 * p, 8 * k
    if keys + comps + (0 if csums <= keys else csums) <= budget:
        return 0, 0
    if comps <= optin - TOPLEK_SPREAD_STATIC_SMEM:
        return 3, (SPREAD_HEAD_BYTES + 8 * t + 15) // 16 * 16
    return 2, comps + csums


def toplek_spread_for(n_clients: int, sms: int) -> int:
    """Blocks a client of the spread route (``toplek_spread`` in the source)
    on a card of ``sms`` SMs: the SMs shared among the clients, 1 to 16."""
    return max(1, min(MAX_SPREAD, sms // max(1, n_clients)))


def smem_optin(device: torch.device) -> int:
    """The shared memory a block may opt in to on ``device``, bytes."""
    fn = build.function("compressor_select", "select_smem_optin", ())
    with torch.cuda.device(device):
        return fn()


def toplek_memory_path(t: int, k: int, device: torch.device) -> int:
    """Where the TopLEK kernels keep their buffers for (T, k) on ``device``:
    0 keys and survivors in shared memory, one block a client; 3 the spread
    route, many blocks a client, candidates in a scratch buffer, survivors
    in one block's shared memory; 2 keys recomputed from u, survivors in a
    scratch buffer in device memory, one block a client."""
    return toplek_plan(t, k, device)[0]


def _launch_toplek(name: str, u: torch.Tensor, k: int, unif: torch.Tensor, with_idx: bool):
    n_clients, t = _check_u(name, u, k)
    _check_draws(name, unif, torch.float64, u)
    out, sent, idx = _outputs(u, k, with_idx)
    if n_clients == 0:
        return out, sent, idx, False
    fn = build.function("compressor_select", "toplek_select_f64", _TOPLEK_ARGTYPES)
    _, scratch_bytes = toplek_plan(t, k, u.device)
    scratch = (
        torch.empty(n_clients * scratch_bytes, dtype=torch.uint8, device=u.device)
        if scratch_bytes else None
    )
    with torch.cuda.device(u.device):
        code = fn(u.data_ptr(), unif.data_ptr(), out.data_ptr(), sent.data_ptr(), _ptr(idx),
                  n_clients, t, k, _ptr(scratch), _stream(u.device))
    build.check_launch(name, code)
    return out, sent, idx, True


def select_toplek_cuda(
    u: torch.Tensor, k: int, unif: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the TopLEK kernel on u's device and current stream;
    ``unif`` (n_clients,) float64 on the same device."""
    out, sent, _, launched = _launch_toplek("select_toplek", u, k, unif, False)
    select_toplek_cuda.launches += launched
    return out, sent


select_toplek_cuda.launches = 0


def select_toplek_idx_plain(u: torch.Tensor, k: int, unif: torch.Tensor):
    """The plain version of the index form: (u_hat, sent, idx)."""
    order, kept = toplek_kept_prefix(u, k, unif)
    return kept_prefix_dense(u, order, kept), kept, in_index_order(order, kept)


def select_toplek_idx_cuda(u: torch.Tensor, k: int, unif: torch.Tensor):
    """Launch the TopLEK kernel's index form: (u_hat, sent, idx)."""
    out, sent, idx, launched = _launch_toplek("select_toplek_idx", u, k, unif, True)
    select_toplek_idx_cuda.launches += launched
    return out, sent, idx


select_toplek_idx_cuda.launches = 0
