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
# chip_smoke.py's phase 6 prices that at the card's clock and prints the
# compiled loop's counts on each pipe beside it (PERF.md).
#
# What the design does about it: one thread per element, neighbouring
# threads on neighbouring counters so the stores coalesce; a block row per
# client reads the client's two key words once into registers; the 20 rounds
# are unrolled in registers with each rotation one ``__funnelshift_l``; the
# float is built from the bits as jax builds it (the top mantissa bits OR the
# exponent of 1.0, minus 1.0, rounded to nearest, no contraction).
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
