"""Threefry-2x32 uniforms on the card, one launch for all clients of a round.

    threefry_uniform(keys, t, dtype) -> (n_clients, t) in [0, 1)

keys (n_clients, 2) int32 holds the bits of each client's uint32 threefry
key (:func:`repro_torch.prng.split` of the round's subkey, uploaded); the
result is ``jax.random.uniform(key_c, (t,), dtype)`` for each client c, bit
for bit, in float32 (RandK's selection keys) or float64 (Natural's Bernoulli
uniforms).  :func:`repro_torch.prng.uniform` is the same function on the
host.  Source: ``csrc/threefry.cu``.  ``threefry_uniform_cuda`` launches the
kernel on the keys' device and current stream and counts the launch;
``threefry_uniform_plain`` is the same function in plain PyTorch, on int64
tensors masked to 32 bits (``torch.uint32`` has too few operations on CUDA).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p)
_SYMBOLS = {torch.float32: "threefry_uniform_f32", torch.float64: "threefry_uniform_f64"}
PLAN_FIELDS = ("counters", "run", "tiles_per_row", "tiles", "tail_slots", "blocks", "per_sm",
               "small")


def _check(name: str, keys: torch.Tensor, t: int, dtype: torch.dtype) -> int:
    if dtype not in _SYMBOLS:
        raise TypeError(f"{name} draws float32 or float64, got {dtype}")
    if keys.dtype != torch.int32 or keys.ndim != 2 or keys.shape[1] != 2:
        raise ValueError(
            f"{name} takes (n_clients, 2) int32 keys, got {tuple(keys.shape)} {keys.dtype}"
        )
    if t < 0 or keys.shape[0] > 2**31 - 1:
        raise ValueError(f"{name}: bad shape ({keys.shape[0]}, {t})")
    return keys.shape[0]


# ---------------------------------------------------------------------------
# Not a port of a Pallas kernel: the reference draws these numbers with
# ``jax.random.uniform`` inside its jitted round (``src/repro/compressors/
# core.py``: ``randk`` and, through ``jax.random.bernoulli``, ``natural``),
# which XLA computes on the device.  On the host (numpy) the same draws cost
# ~0.8 s a round at w8a (142 clients x 45,451 entries), against a round of
# ~2 ms.
#
# What bounds it on an H100: its integer instructions at f32, its stores at
# f64, nearly evenly.  It reads 8 bytes of key per client and writes T * 4
# (f32) or T * 8 (f64) bytes per client: 25.8 or 51.6 MB at w8a, 7.7 or
# 15.4 us at 3.35 TB/s.  Each element needs the hash: 2 additions of the
# key, 20 rounds of an add, a rotation and a xor, 5 key injections of two
# adds, and the float from the words, 75 32-bit integer operations; with
# IADD3's three-input adds, 69 instructions at f32 (70 at f64).  Those run
# on the two integer pipes, 64 instructions a clock per SM each (the INT32
# pipe; IMAD on the FMA pipe's heavy half), not at the 128 of the f32
# pipes.  Only the xors must take the INT32 pipe (a rotation is also an
# IMAD.WIDE, an add an IMAD), so at best each pipe takes half: 34.5
# instructions an element, ~13 us at w8a at 132 SMs and 1.98 GHz.
# chip_smoke.py's phase 6 prices that at the card's clock and prints each
# instantiation's compiled main loop, per element and pipe, beside it.
#
# What the design does about it (``csrc/threefry.cu``; its choices are the
# constants at the top of the file, and ``scripts/threefry_probe.py`` times
# variants of them and the parent's kernel in turns; PERF.md section 6):
# - 4 counters a thread, hashed interleaved, so one counter's serial chain
#   of add -> rotate -> xor hides another's latency;
# - a client's constants (k0, k1, k2, the five injections into x1) once a
#   thread a row: a block walks a contiguous share of the rows' tiles (a
#   tile: 256 threads' runs of one row), and the grid is the tiles or the
#   SMs' resident blocks, whichever is fewer, not one block per 256
#   elements of a row;
# - the counter's high word folded away: it is 0 for every T below 2**32,
#   which the CUDA wrapper holds (the plain version keeps the general form);
# - a thread's run is one aligned 16-byte vector of the output (four floats,
#   two doubles), so a warp stores 512 contiguous bytes in one instruction;
#   rows at odd T are not aligned, so the elements before a row's first
#   aligned run and after its last (at most 3 at f32, 1 at f64) go to a
#   scalar tail loop in the same launch, from the last block back (the
#   blocks with a tile fewer);
# - the pipes steered: every add, the key injections' too, and the float's
#   words as IMAD (``x * one + y``, ``one`` a kernel argument the compiler
#   cannot fold back into IADD3), the rotations and xors on the INT32 pipe:
#   about 42 and 33 instructions an element, against the parent's 51 and
#   27.  IMAD.WIDE and IMAD.HI issue at half rate on the H100 (the probe's
#   rates), so a rotation as IMAD.WIDE costs two FMA slots to save one INT32
#   slot; every such mix measured was slower;
# - max(0, f) left out: f = 1.m - 1 is exact and >= +0, so it is the
#   identity and the bits stay jax's (the plain version keeps it);
# - a draw of at most 2 elements a resident thread (one client of w8a:
#   45,451; phishing's round) takes the small route: one element a thread,
#   a row of 256-thread blocks a client, as the parent's kernel cut every
#   draw, so it keeps its warps and its short prologue.
# ---------------------------------------------------------------------------


def threefry_uniform_plain(keys: torch.Tensor, t: int, dtype: torch.dtype) -> torch.Tensor:
    """The plain PyTorch version on int64 words masked to 32 bits."""
    _check("threefry_uniform", keys, t, dtype)
    k = keys.to(torch.int64) & _MASK
    k0, k1 = k[:, 0:1], k[:, 1:2]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    j = torch.arange(t, dtype=torch.int64, device=keys.device)
    a = ((j >> 32) + k0) & _MASK
    b = ((j & _MASK) + k1) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _MASK
            b = (((b << r) | (b >> (32 - r))) & _MASK) ^ a
        a = (a + ks[(i + 1) % 3]) & _MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _MASK
    if dtype == torch.float32:
        bits = (((a ^ b) >> 9) | 0x3F800000).to(torch.int32)
        return torch.clamp_min(bits.view(torch.float32) - 1.0, 0.0)
    # (a << 32 | b) >> 12 without leaving int64's range
    bits = (a << 20) | (b >> 12) | 0x3FF0000000000000
    return torch.clamp_min(bits.view(torch.float64) - 1.0, 0.0)


def threefry_uniform_cuda(keys: torch.Tensor, t: int, dtype: torch.dtype) -> torch.Tensor:
    """Launch the threefry kernel on the keys' device and current stream."""
    n_clients = _check("threefry_uniform", keys, t, dtype)
    if t >= 2**32:
        raise ValueError(
            f"threefry_uniform_cuda draws T < 2**32 (a counter's high word of 0), got {t}")
    if not keys.is_cuda or not keys.is_contiguous():
        raise ValueError(f"need contiguous CUDA keys, got keys on {keys.device}")
    out = torch.empty((n_clients, t), dtype=dtype, device=keys.device)
    if n_clients == 0 or t == 0:
        return out
    fn = build.function("threefry", _SYMBOLS[dtype], _ARGTYPES)
    with torch.cuda.device(keys.device):
        code = fn(keys.data_ptr(), out.data_ptr(), n_clients, t,
                  torch.cuda.current_stream(keys.device).cuda_stream)
    build.check_launch("threefry_uniform", code)
    threefry_uniform_cuda.launches += 1
    threefry_uniform_cuda.dtype_launches[str(dtype).removeprefix("torch.")] += 1
    return out


threefry_uniform_cuda.launches = 0
# launches by dtype since the last reset (ops.reset_launch_counts)
threefry_uniform_cuda.dtype_launches = {"float32": 0, "float64": 0}


def threefry_launch_plan(n_clients: int, t: int, dtype: torch.dtype,
                         device: torch.device) -> dict[str, int]:
    """How the CUDA kernel's launcher cuts a draw of (n_clients, t) on the
    card ``device`` (its SM count and occupancy): counters a thread, elements
    a run (one vector store), tiles a row, tiles, tail slots, blocks,
    resident blocks a SM, and ``small`` 1 for the small route (one element a
    thread) or 0 for the main one (``csrc/threefry.cu``)."""
    if dtype not in _SYMBOLS or not 0 < t < 2**32 or n_clients <= 0:
        raise ValueError(f"threefry_launch_plan: bad draw ({n_clients}, {t}) {dtype}")
    fn = build.function("threefry", "threefry_uniform_plan",
                        (ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p))
    out = (ctypes.c_longlong * len(PLAN_FIELDS))()
    with torch.cuda.device(device):
        code = fn(int(dtype == torch.float64), n_clients, t, ctypes.addressof(out))
    build.check_launch("threefry_launch_plan", code)
    return dict(zip(PLAN_FIELDS, out))
