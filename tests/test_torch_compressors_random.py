"""RandK and Natural, the port's per-element random compressors, against
repro.compressors on the same inputs and keys (CPU).

Every comparison is exact: u_hat bit patterns, sent_elems and message_bits.
The draws are the same threefry numbers (repro_torch.prng and the threefry
kernel's plain version are bit-exact with jax.random), RandK's selection is
``lax.top_k``'s set (lowest index first among equal keys), and Natural is
elementwise.  The Natural fixtures span the normal exponent range; below it
(subnormals) XLA on the CPU flushes to zero and the port follows IEEE, which
``test_natural_rounds_subnormals_to_a_neighbouring_power_of_two`` pins.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compressors import core as jcore
from repro_torch import prng
from repro_torch.compressors import core as tcore
from repro_torch.compressors import select as tsel
from repro_torch.kernels import compressor_select as tcs

# a seed whose RandK keys tie at the k-th largest at w8a's T and k: client 4
# of split(split(PRNGKey(65))[1], 8) has two equal f32 uniforms at ranks
# k and k + 1 (found by search over seeds 0..400; about one client in 185)
TIE_SEED, TIE_CLIENT, T_W8A, K_W8A = 65, 4, 45451, 2408


def _keys(seed, n):
    """The clients' keys of a round, in both packages."""
    jkeys = jax.random.split(jax.random.split(jax.random.PRNGKey(seed))[1], n)
    keys = prng.split(prng.split(prng.prng_key(seed), 2)[1], n)
    np.testing.assert_array_equal(keys, np.asarray(jkeys))
    return jkeys, keys


def _wide_rows(n, t, seed):
    """Gaussians times 2**e for e across the normal range, with zeros, a
    negative zero, the largest double and values near 2**-1022."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((n, t)) * np.ldexp(1.0, rng.integers(-1000, 1000, size=(n, t)))
    u[0, :5] = 0.0
    u[0, 5] = -0.0
    u[1, 3] = 1.5 * 2.0**-1021
    u[1, 4] = np.finfo(np.float64).max
    u[1, 5] = -np.finfo(np.float64).max
    u[-1] = rng.standard_normal(t)  # a row at the Hessians' scale
    return u


def _check_per_client(name, got, sent, jkeys, u, call):
    comp_t = tcore.get_compressor(name, u.shape[1], 24)
    comp_j = jcore.get_compressor(name, u.shape[1], 24)
    for c in range(u.shape[0]):
        want, want_sent = call(jkeys[c], jnp.asarray(u[c]))
        np.testing.assert_array_equal(got[c].numpy().view(np.int64), np.asarray(want).view(np.int64))
        assert int(sent[c]) == int(want_sent)
    bits_t = tcore.message_bits(comp_t, sent)
    bits_j = np.array([int(jcore.message_bits(comp_j, int(s))) for s in sent])
    assert bits_t.dtype == torch.int64
    np.testing.assert_array_equal(bits_t.numpy(), bits_j)


@pytest.mark.parametrize("scaled", [True, False])
@pytest.mark.parametrize("seed", [0, 9, 2**33 + 1])
def test_randk_matches_reference_per_client(seed, scaled):
    t, k, n = 300, 24, 6
    jkeys, keys = _keys(seed, n)
    u = np.random.default_rng(seed % 1000).standard_normal((n, t))
    u[0, ::7] = -0.0
    got, sent = tcore.randk(keys, torch.as_tensor(u), k, scaled=scaled)
    assert sent.dtype == torch.int32
    _check_per_client("randk", got, sent, jkeys, u,
                      lambda key, uc: jcore.randk(key, uc, k, scaled=scaled))


@pytest.mark.parametrize("scaled", [True, False])
@pytest.mark.parametrize("seed", [0, 9, 2**33 + 1])
def test_natural_matches_reference_per_client(seed, scaled):
    t, n = 300, 6
    jkeys, keys = _keys(seed, n)
    u = _wide_rows(n, t, seed % 1000)
    got, sent = tcore.natural(keys, torch.as_tensor(u), scaled=scaled)
    assert sent.dtype == torch.int32 and sent.tolist() == [t] * n
    _check_per_client("natural", got, sent, jkeys, u,
                      lambda key, uc: jcore.natural(key, uc, scaled=scaled))


def test_randk_tie_at_the_kth_key_matches_reference():
    """At w8a's T and k, on the pinned seed whose k-th and (k+1)-th keys are
    equal: the port keeps the lower index, as lax.top_k does."""
    jkeys, keys = _keys(TIE_SEED, 8)
    keys_f32 = prng.uniform(keys, (T_W8A,), np.float32)
    row = keys_f32[TIE_CLIENT]
    order = -np.sort(-row)
    assert order[K_W8A - 1] == order[K_W8A]  # the fixture ties at the boundary
    tied = np.flatnonzero(row == order[K_W8A - 1])
    u = np.random.default_rng(5).standard_normal((8, T_W8A))
    got, sent = tcore.randk(keys, torch.as_tensor(u), K_W8A)
    kept = got[TIE_CLIENT].numpy() != 0
    assert kept[tied.min()] and not kept[tied.max()]
    for c in range(8):
        want, _ = jcore.randk(jkeys[c], jnp.asarray(u[c]), K_W8A)
        np.testing.assert_array_equal(got[c].numpy().view(np.int64), np.asarray(want).view(np.int64))
    assert sent.tolist() == [K_W8A] * 8


@pytest.mark.parametrize("levels,k", [(16, 40), (16, 1), (7, 300), (1000, 100)])
def test_topk_by_keys_plain_is_lax_top_k(levels, k):
    """The keys/values selection's plain version against lax.top_k on keys
    with many exact ties at the k-th key."""
    rng = np.random.default_rng(levels + k)
    keys = (rng.integers(0, levels, size=(5, 300)) / levels).astype(np.float32)
    u = rng.standard_normal((5, 300))
    got, sent = tcs.select_topk_by_keys_plain(torch.as_tensor(u), torch.as_tensor(keys), k)
    for c in range(5):
        _, idx = jax.lax.top_k(jnp.asarray(keys[c]), k)
        want = jnp.zeros_like(jnp.asarray(u[c])).at[idx].set(jnp.asarray(u[c])[idx])
        np.testing.assert_array_equal(got[c].numpy().view(np.int64), np.asarray(want).view(np.int64))
    assert sent.tolist() == [k] * 5


def test_device_uniform_is_the_host_generator():
    """The draws RandK and Natural take (the threefry kernel's plain version
    on the CPU) are prng.uniform over a shape, in f32 and f64."""
    keys = prng.split(prng.prng_key(3), 5)
    for dtype, np_dtype in ((torch.float32, np.float32), (torch.float64, np.float64)):
        got = tcore.device_uniform(keys, 777, dtype, torch.device("cpu"))
        want = prng.uniform(keys, (777,), np_dtype)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.numpy().view(np.uint8), want.view(np.uint8))


def test_pow2_is_exact_over_every_exponent():
    e = torch.arange(-1100, 1100)
    with np.errstate(over="ignore"):
        want = np.ldexp(1.0, e.numpy())
    np.testing.assert_array_equal(tsel.pow2(e).numpy().view(np.int64), want.view(np.int64))
    np.testing.assert_array_equal(
        tsel.pow2(e.to(torch.int32)).numpy().view(np.int64), want.view(np.int64)
    )


def test_natural_rounds_subnormals_to_a_neighbouring_power_of_two():
    """Below 2**-1022 the port rounds to one of the two neighbouring powers
    of two, as IEEE arithmetic (and the card) gives; XLA on the CPU flushes
    such inputs to zero, so the reference returns 0.0 there."""
    u = torch.tensor([5e-320, -3e-310, 2.0**-1074], dtype=torch.float64)
    for unif in (0.0, 0.999999):
        got = tsel.natural_from_uniform(u, torch.full_like(u, unif), scaled=False)
        _, e = torch.frexp(u.abs())
        lo, hi = tsel.pow2(e - 1), tsel.pow2(e)
        assert bool(((got.abs() == lo) | (got.abs() == hi)).all())
        assert torch.equal(torch.sign(got), torch.sign(u))
    want, _ = jcore.natural(jax.random.PRNGKey(0), jnp.asarray(u.numpy()), scaled=False)
    assert not np.asarray(want).any()
