"""Threefry2x32 keys and draws, bit-exact with ``jax.random`` (numpy, host).

The port's own copy of the generator the JAX package draws from, so that a
random compressor takes the same draws, round for round, as the reference:
trajectories, TopLEK's data-dependent ``sent_bits`` and the checkpointed
``state.key`` all compare exactly.  It reproduces jax 0.9.0's defaults with
x64 on (as ``repro`` runs): the threefry2x32 hash, and the *partitionable*
branch (``jax_threefry_partitionable=True``) of ``split`` and of the random
bits, where each output element hashes its own (hi, lo) 64-bit counter.

Every function is vectorised over a leading batch of keys: ``keys`` has
shape ``(..., 2)`` (uint32), so one call draws for all clients of a round.
The draws of one scalar per client per round (RandSeqK's start, TopLEK's
Bernoulli uniform, FedNL-PP's choice of clients) are made here, on the host,
and uploaded.  RandK and Natural draw one uniform per packed entry per
client; those are made on the card by the threefry kernel
(``repro_torch.kernels.threefry``), whose tests hold it against
:func:`uniform` over a shape here.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_MASK = 0xFFFFFFFF
# Up to this many hashes per call go through Python ints, above it through
# numpy arrays: per call, numpy's overhead (~1 us a ufunc, ~120 ufuncs a
# hash) makes one key's split(key, 2) about 5x slower as arrays than as ints,
# and ints cost ~10 us a hash, so a round's 142 client keys go as arrays.
_INT_HASHES = 4


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` (threefry) as a numpy uint32 pair."""
    return np.array([(seed >> 32) & _MASK, seed & _MASK], dtype=np.uint32)


def threefry2x32_int(k1: int, k2: int, x1: int, x2: int) -> tuple[int, int]:
    """The Threefry-2x32 hash (20 rounds) of one counter (x1, x2) under key
    (k1, k2), on Python ints masked to 32 bits."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    a, b = (x1 + k1) & _MASK, (x2 + k2) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _MASK
            b = (((b << r) | (b >> (32 - r))) & _MASK) ^ a
        a = (a + ks[(i + 1) % 3]) & _MASK
        b = (b + ks[(i + 2) % 3] + i + 1) & _MASK
    return a, b


def threefry2x32(k1, k2, x1, x2) -> tuple[np.ndarray, np.ndarray]:
    """The same hash on uint32 arrays broadcast together (uint32 wraps, so
    no masks), with in-place ufuncs on two working arrays."""
    k1, k2, x1, x2 = (np.asarray(v, dtype=np.uint32) for v in (k1, k2, x1, x2))
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(_KS_PARITY))
    a, b = (v.copy() for v in np.broadcast_arrays(x1 + ks[0], x2 + ks[1]))
    tmp = np.empty_like(b)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            np.add(a, b, out=a)
            np.right_shift(b, np.uint32(32 - r), out=tmp)
            np.left_shift(b, np.uint32(r), out=b)
            np.bitwise_or(b, tmp, out=b)
            np.bitwise_xor(b, a, out=b)
        np.add(a, ks[(i + 1) % 3], out=a)
        np.add(b, ks[(i + 2) % 3] + np.uint32(i + 1), out=b)
    return a, b


def _hash_counters(keys: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """The two hash words of counters 0..n-1 under each key: (..., n) each,
    uint32 (a counter's high word is its bits above 32, as in jax)."""
    keys = np.asarray(keys, dtype=np.uint32)
    if keys.size // 2 * n <= _INT_HASHES:
        words = np.array(
            [[threefry2x32_int(int(k1), int(k2), i >> 32, i & _MASK) for i in range(n)]
             for k1, k2 in keys.reshape(-1, 2)],
            dtype=np.uint32,
        ).reshape(*keys.shape[:-1], n, 2)
        return words[..., 0], words[..., 1]
    count = np.arange(n, dtype=np.uint64)
    hi = (count >> np.uint64(32)).astype(np.uint32)
    return threefry2x32(keys[..., 0, None], keys[..., 1, None], hi, count.astype(np.uint32))


def split(keys: np.ndarray, n: int = 2) -> np.ndarray:
    """``jax.random.split(key, n)`` for each key: (..., 2) -> (..., n, 2)."""
    b1, b2 = _hash_counters(keys, n)
    return np.stack([b1, b2], axis=-1)


def split_one(keys: np.ndarray, n: int, i: int) -> np.ndarray:
    """``jax.random.split(key, n)[i]`` for each key: (..., 2) -> (..., 2),
    hashing only counter i (the partitionable split hashes each output key's
    own counter, so the i-th key does not depend on the others)."""
    if not 0 <= i < n:
        raise ValueError(f"split_one needs 0 <= i < n, got i={i}, n={n}")
    return _hash_one(keys, i >> 32, i & _MASK)


def _hash_one(keys: np.ndarray, x1: int, x2: int) -> np.ndarray:
    """The hash of one counter (x1, x2) under each key, as a key (..., 2)."""
    keys = np.asarray(keys, dtype=np.uint32)
    if keys.shape == (2,):
        return np.array(threefry2x32_int(int(keys[0]), int(keys[1]), x1, x2), dtype=np.uint32)
    b1, b2 = threefry2x32(keys[..., 0], keys[..., 1], x1, x2)
    return np.stack([b1, b2], axis=-1)


def fold_in(keys: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` for each key: (..., 2) -> (..., 2).

    As jax's threefry ``fold_in``: the key hashes the one counter (0, data),
    data taken as uint32, and the two hash words are the new key."""
    return _hash_one(keys, 0, int(data) & _MASK)


def random_bits(keys: np.ndarray, bit_width: int, shape: tuple[int, ...] = ()) -> np.ndarray:
    """``jax.random.bits(key, shape, uint32 | uint64)`` for each key:
    (..., 2) -> (..., *shape).

    Each element hashes its own flat (row-major) counter, split into a high
    and a low word; the two hash words b1, b2 give ``b1 ^ b2`` for 32 bits
    and ``b1 << 32 | b2`` for 64."""
    keys = np.asarray(keys, dtype=np.uint32)
    shape = tuple(shape)
    b1, b2 = _hash_counters(keys, int(np.prod(shape, dtype=np.int64)))
    if bit_width == 32:
        bits = b1 ^ b2
    elif bit_width == 64:
        bits = (b1.astype(np.uint64) << np.uint64(32)) | b2.astype(np.uint64)
    else:
        raise ValueError(f"bit_width must be 32 or 64, got {bit_width}")
    return bits.reshape(keys.shape[:-1] + shape)


def _bits64(keys: np.ndarray) -> np.ndarray:
    """``random_bits(key, 64, ())`` for each key: (..., 2) -> (...,) uint64."""
    return random_bits(keys, 64)


def randint(keys: np.ndarray, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, (), minval, maxval)`` (int64) for each key.

    As in jax: two 64-bit words from the key's two subkeys, reduced mod the
    span with the 2**64 mod span multiplier (a slight bias where the span is
    not a power of two, the same as the reference's)."""
    if maxval > np.iinfo(np.int64).max or minval < np.iinfo(np.int64).min:
        raise ValueError("randint bounds must fit int64")
    words = _bits64(split(keys, 2))  # (..., 2): the higher and the lower word
    higher, lower = words[..., 0], words[..., 1]
    span = np.uint64(maxval - minval if maxval > minval else 1)
    with np.errstate(over="ignore"):  # uint64 wraps, as in the reference
        mult = np.uint64(2**32) % span
        mult = (mult * mult) % span
        offset = ((higher % span) * mult + lower % span) % span
        return (np.int64(minval) + offset.astype(np.int64)).astype(np.int64)


def uniform(keys: np.ndarray, shape: tuple[int, ...] = (), dtype=np.float64) -> np.ndarray:
    """``jax.random.uniform(key, shape, dtype)`` on [0, 1) for each key:
    (..., 2) -> (..., *shape).  The top mantissa bits of a random word (52 of
    64 for float64, 23 of 32 for float32) as the mantissa of a number in
    [1, 2), minus 1, then ``max(0, .)``."""
    dtype = np.dtype(dtype)
    if dtype == np.float64:
        bits = (random_bits(keys, 64, shape) >> np.uint64(12)) | np.uint64(0x3FF0000000000000)
    elif dtype == np.float32:
        bits = (random_bits(keys, 32, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    else:
        raise ValueError(f"uniform draws float32 or float64, got {dtype}")
    return np.maximum(dtype.type(0.0), bits.view(dtype) - dtype.type(1.0))


def permutation(key: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.permutation(key, n)`` for one key: int64 (n,).

    As jax's ``_shuffle``: ceil(3 ln n / ln(2**32 - 1)) rounds (one for n up
    to 1625), each ``key, sub = split(key)`` and a stable sort of the
    entries by 32-bit ``random_bits(sub, (n,))``."""
    key = np.asarray(key, dtype=np.uint32)
    if key.shape != (2,):
        raise ValueError(f"permutation takes one key of shape (2,), got {key.shape}")
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    x = np.arange(n, dtype=np.int64)
    for _ in range(rounds):
        key, sub = split(key, 2)
        x = x[np.argsort(random_bits(sub, 32, (n,)), kind="stable")]
    return x


def choice(key: np.ndarray, n: int, shape: tuple[int, ...], replace: bool = False) -> np.ndarray:
    """``jax.random.choice(key, n, shape, replace=False)`` for one key: the
    first prod(shape) entries of :func:`permutation` (jax's path without
    replacement and without weights).  int64."""
    if replace:
        raise NotImplementedError("only choice without replacement is ported")
    size = int(np.prod(shape, dtype=np.int64))
    if size > n:
        raise ValueError(f"cannot take {size} of {n} without replacement")
    return permutation(key, n)[:size].reshape(shape)
