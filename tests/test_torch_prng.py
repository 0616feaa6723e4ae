"""repro_torch.prng against live jax.random, bit for bit (CPU).

x64 is on (tests/conftest.py), as in the JAX package's entry points, so
``randint`` draws int64 from two 64-bit words and ``uniform`` float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro_torch import prng

SEEDS = [0, 1, 2, 7, 42, 1234, 99991, 2**31 - 1, 2**32 + 3, 2**40 + 17]


def _chain(seed, rounds):
    """(jax key, port key) pairs along the reference round's key chain."""
    jk, pk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    out = []
    for _ in range(rounds):
        jk, jsub = jax.random.split(jk)
        pk, psub = prng.split(pk, 2)
        out.append((jk, jsub, pk, psub))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches(seed):
    want = np.asarray(jax.random.PRNGKey(seed))
    got = prng.prng_key(seed)
    assert got.dtype == np.uint32 and got.shape == (2,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_split_chain_matches(seed):
    """key, sub = split(key), five rounds deep."""
    for jk, jsub, pk, psub in _chain(seed, 5):
        np.testing.assert_array_equal(pk, np.asarray(jk))
        np.testing.assert_array_equal(psub, np.asarray(jsub))


@pytest.mark.parametrize("n", [1, 2, 3, 8, 142])
@pytest.mark.parametrize("seed", SEEDS[:5])
def test_split_n_matches(seed, n):
    for _, jsub, _, psub in _chain(seed, 3):
        got = prng.split(psub, n)
        assert got.shape == (n, 2) and got.dtype == np.uint32
        np.testing.assert_array_equal(got, np.asarray(jax.random.split(jsub, n)))


def test_split_is_vectorised_over_keys():
    keys = prng.split(prng.prng_key(5), 6)
    batched = prng.split(keys, 4)
    assert batched.shape == (6, 4, 2)
    for i in range(6):
        np.testing.assert_array_equal(batched[i], prng.split(keys[i], 4))


@pytest.mark.parametrize("t", [300, 7750, 45451, 2**31 - 1])
@pytest.mark.parametrize("seed", SEEDS[:6])
def test_randint_matches(seed, t):
    _, jsub, _, psub = _chain(seed, 2)[-1]
    jkeys = jax.random.split(jsub, 8)
    got = prng.randint(prng.split(psub, 8), 0, t)
    want = np.array([int(jax.random.randint(k, (), 0, t)) for k in jkeys])
    assert got.dtype == np.int64 and got.shape == (8,)
    assert jax.random.randint(jkeys[0], (), 0, t).dtype == jnp.int64
    np.testing.assert_array_equal(got, want)
    assert np.all((0 <= got) & (got < t))


def test_randint_single_key_and_bounds():
    key = prng.split(prng.prng_key(3), 2)[1]
    jkey = jax.random.split(jax.random.PRNGKey(3))[1]
    for lo, hi in [(0, 1), (5, 6), (-10, 10), (0, 2**40), (7, 7)]:
        got = prng.randint(key, lo, hi)
        assert got.shape == () and got.dtype == np.int64
        assert int(got) == int(jax.random.randint(jkey, (), lo, hi))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_matches(seed):
    _, jsub, _, psub = _chain(seed, 3)[-1]
    jkeys = jax.random.split(jsub, 142)
    got = prng.uniform(prng.split(psub, 142))
    want = np.array([float(jax.random.uniform(k, (), jnp.float64)) for k in jkeys[:30]])
    assert got.dtype == np.float64 and got.shape == (142,)
    np.testing.assert_array_equal(got[:30].view(np.int64), want.view(np.int64))
    assert np.all((0.0 <= got) & (got < 1.0))


def test_uniform_is_bernoulli_draw():
    """jax.random.bernoulli(key, p) is uniform(key, (), p.dtype) < p."""
    keys = prng.split(prng.prng_key(11), 64)
    jkeys = jax.random.split(jax.random.PRNGKey(11), 64)
    unif = prng.uniform(keys)
    for p in (0.1, 0.5, 0.9):
        want = np.array([bool(jax.random.bernoulli(k, jnp.float64(p))) for k in jkeys])
        np.testing.assert_array_equal(unif < p, want)


def test_int_and_array_hashes_agree():
    """The two forms of the hash (Python ints for a few hashes, uint32
    arrays for a batch) on the same random keys and counters."""
    rng = np.random.default_rng(0)
    k = rng.integers(0, 2**32, size=(2, 64), dtype=np.uint64).astype(np.uint32)
    x = rng.integers(0, 2**32, size=(2, 64), dtype=np.uint64).astype(np.uint32)
    a, b = prng.threefry2x32(k[0], k[1], x[0], x[1])
    for i in range(64):
        want = prng.threefry2x32_int(int(k[0, i]), int(k[1, i]), int(x[0, i]), int(x[1, i]))
        assert (int(a[i]), int(b[i])) == want
    # split on both sides of the size switch
    keys = prng.split(prng.prng_key(8), 3)
    np.testing.assert_array_equal(prng.split(keys, 2)[1], prng.split(keys[1], 2))


SHAPES = [(), (1,), (7,), (3, 5), (300,), (45451,)]


@pytest.mark.parametrize("bit_width", [32, 64])
@pytest.mark.parametrize("seed", SEEDS[:6])
def test_random_bits_match(seed, bit_width):
    """Each element hashes its own flat counter: b1 ^ b2 (32) or b1 << 32 | b2 (64)."""
    _, jsub, _, psub = _chain(seed, 2)[-1]
    dtype = jnp.uint32 if bit_width == 32 else jnp.uint64
    for shape in SHAPES:
        want = np.asarray(jax.random.bits(jsub, shape, dtype))
        got = prng.random_bits(psub, bit_width, shape)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", SEEDS[:6])
def test_uniform_over_a_shape_matches(seed, dtype):
    _, jsub, _, psub = _chain(seed, 3)[-1]
    for shape in SHAPES:
        want = np.atleast_1d(np.asarray(jax.random.uniform(jsub, shape, dtype)))
        got = np.atleast_1d(prng.uniform(psub, shape, dtype))
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    batched = prng.uniform(prng.split(psub, 4), (9,), dtype)
    assert batched.shape == (4, 9)
    for i, key in enumerate(jax.random.split(jsub, 4)):
        want = np.asarray(jax.random.uniform(key, (9,), dtype))
        np.testing.assert_array_equal(batched[i].view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("n,tau", [(142, 71), (8, 4), (1, 1), (5, 5), (2000, 10)])
@pytest.mark.parametrize("seed", SEEDS[:5])
def test_choice_without_replacement_matches(seed, n, tau):
    """choice(key, n, (tau,), replace=False) = permutation(key, n)[:tau]; one
    shuffle round up to n = 1625, two at n = 2000."""
    _, jsub, _, psub = _chain(seed, 2)[-1]
    want = np.asarray(jax.random.choice(jsub, n, (tau,), replace=False))
    got = prng.choice(psub, n, (tau,), replace=False)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(prng.permutation(psub, n), np.asarray(jax.random.permutation(jsub, n)))
    assert len(set(got.tolist())) == tau


def test_choice_refuses_what_it_does_not_port():
    key = prng.prng_key(0)
    with pytest.raises(NotImplementedError):
        prng.choice(key, 5, (2,), replace=True)
    with pytest.raises(ValueError):
        prng.choice(key, 5, (6,))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n_clients,t", [(142, 300), (1, 1), (3, 45451), (2, 7)])
def test_threefry_plain_is_the_generator(n_clients, t, dtype):
    """The threefry kernel's plain version (int64 PyTorch ops) against
    prng.uniform over a shape and against live jax.random, bit for bit."""
    import torch

    from repro_torch.kernels import threefry

    _, jsub, _, psub = _chain(n_clients + t, 2)[-1]
    keys = prng.split(psub, n_clients)
    got = threefry.threefry_uniform_plain(
        torch.as_tensor(keys.view(np.int32)), t, getattr(torch, dtype)
    ).numpy()
    want = prng.uniform(keys, (t,), np.dtype(dtype))
    assert got.dtype == want.dtype and got.shape == (n_clients, t)
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    for i, key in enumerate(jax.random.split(jsub, n_clients)[:3]):
        live = np.asarray(jax.random.uniform(key, (t,), np.dtype(dtype)))
        np.testing.assert_array_equal(got[i].view(np.uint8), live.view(np.uint8))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_matches(seed):
    """fold_in(key, data) for the data the PP master folds in (1 + attempt)
    and across uint32's range."""
    for data in (0, 1, 2, 3, 17, 2**31 - 1, 2**31 + 7, 2**32 - 1):
        want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), data))
        got = prng.fold_in(prng.prng_key(seed), data)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.uint32


def test_fold_in_is_vectorised_over_keys():
    keys = prng.split(prng.prng_key(3), 5)
    got = prng.fold_in(keys, 9)
    want = np.stack([np.asarray(jax.random.fold_in(jnp.asarray(k), 9)) for k in keys])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 3, 142])
def test_split_one_is_one_row_of_split(n):
    """split_one(key, n, i) is split(key, n)[i] (each output key of the
    partitionable split hashes its own counter), for one key and a batch."""
    key = prng.prng_key(11)
    keys = prng.split(key, 4)
    jkeys = np.asarray(jax.random.split(jax.random.PRNGKey(11), n))
    for i in {0, n // 2, n - 1}:
        np.testing.assert_array_equal(prng.split_one(key, n, i), jkeys[i])
        np.testing.assert_array_equal(prng.split_one(keys, n, i), prng.split(keys, n)[:, i])
    with pytest.raises(ValueError, match="0 <= i < n"):
        prng.split_one(key, n, n)
