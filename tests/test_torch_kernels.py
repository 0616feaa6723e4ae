"""The port's kernels: plain versions against the JAX reference (CPU), and
the CUDA kernels against their plain versions (``cuda`` marker, on a card).

Tolerances:
  * SYRK: 1e-13 x max(|Z|^T |h| |Z|) -- FP64 sums of n terms in another order;
  * TopK, RandSeqK: bit-exact -- the selected values are copies and the
    zeros +0.0;
  * TopLEK: u_hat bit patterns and the kept count exact.  The one allowed
    difference: the prefix energies are sums in another order (torch.cumsum,
    XLA's scan, the kernel's block scan), so kept may move by one on a row
    where alpha_m* lies within a few ulps of delta = k/T or unif within a
    few ulps of p.  Dyadic rows, whose sums are exact in any order, have
    no such row.

The JAX reference is imported inside a fixture, so the ``cuda`` tests also
collect on a machine without JAX; whether a card is present is decided
inside a fixture too.
"""

import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.compressors import select as tsel
from repro_torch.kernels import compressor_select as tcs
from repro_torch.kernels import hessian_syrk as ths
from repro_torch.kernels import ops as tops
from repro_torch.kernels import threefry as tth
from repro_torch.linalg import pack_triu, packed_eye, triu_size

SYRK_TOL = 1e-13


@pytest.fixture(scope="module")
def ref():
    """The JAX reference: repro's kernel wrappers and selection primitives."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from repro.compressors import select as jsel
    from repro.kernels import ops as jops
    from repro.kernels.compressor_select import (
        select_randseqk_pallas,
        select_topk_pallas,
        select_toplek_pallas,
    )

    return types.SimpleNamespace(
        jnp=jnp, ops=jops, sel=jsel, topk_pallas=select_topk_pallas,
        randseqk_pallas=select_randseqk_pallas, toplek_pallas=select_toplek_pallas,
    )


@pytest.fixture
def cuda():
    """The first CUDA device; skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _syrk_inputs(n_clients, n, d, seed):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n_clients, n, d)) * (rng.random((n_clients, n, d)) < 0.3)
    sigma = rng.uniform(0.0, 1.0, size=(n_clients, n))
    return z, sigma * (1.0 - sigma) / n


def _syrk_scale(z, hw):
    return np.max(np.abs(z).transpose(0, 2, 1) @ (np.abs(hw)[..., None] * np.abs(z)))


def near_tie_rows(n_rows, t, seed):
    """f64 entries, pairwise distinct, that collide in groups of four when
    rounded to f32 keys (tests/test_kernels.py's fixture, batched)."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n_rows, -(-t // 4))).astype(np.float32).astype(np.float64)
    eps = np.array([0.0, 1e-12, 2.5e-12, -1e-12])
    u = (base[:, :, None] * (1.0 + eps)).reshape(n_rows, -1)[:, :t]
    return rng.permuted(u, axis=1)


def dyadic_rows(n_rows, t, seed):
    """Entries +-2**-e, e in [0, 10], many exact ties: every sum of their
    squares (at most 2**16 terms spanning 2**-20..1) is exact in any order."""
    rng = np.random.default_rng(seed)
    e = rng.integers(0, 11, size=(n_rows, t))
    return np.where(rng.random((n_rows, t)) < 0.5, -1.0, 1.0) * np.ldexp(1.0, -e)


def _bits(a):
    return np.asarray(a, dtype=np.float64).view(np.int64)


def toplek_near_boundary(u, k, unif, tol=1e-12):
    """True when row u is TopLEK's allowed case of difference: alpha_m* (or
    alpha_m*-1) within tol of delta, or unif within tol of p, with the prefix
    energies summed exactly rounded (math.fsum)."""
    import math

    t = u.shape[0]
    delta = k / t
    keys = np.abs(u).astype(np.float32)
    order = np.lexsort((np.arange(t), -keys))[:k]
    total = math.fsum(u * u)
    if total == 0:
        return False
    alphas = np.array([math.fsum(u[order[: m + 1]] ** 2) / total for m in range(k)])
    m_star = min(int(np.sum(alphas < delta)) + 1, k)
    hi = alphas[m_star - 1]
    lo = alphas[m_star - 2] if m_star > 1 else 0.0
    p = np.clip((hi - delta) / (hi - lo), 0, 1) if hi > lo else 0.0
    return min(abs(hi - delta), abs(lo - delta), abs(unif - p)) <= tol


def _check_toplek_rows(got, sent, want_rows, u, k, unif, exact):
    """got/sent (port) against want_rows [(u_hat, kept)] row by row; returns
    the number of rows in the allowed boundary case (0 when ``exact``)."""
    boundary = 0
    for c, (want, want_kept) in enumerate(want_rows):
        if int(sent[c]) != int(want_kept) and not exact:
            assert abs(int(sent[c]) - int(want_kept)) == 1
            assert toplek_near_boundary(u[c], k, float(unif[c])), f"row {c}"
            boundary += 1
            continue
        assert int(sent[c]) == int(want_kept), f"row {c}"
        np.testing.assert_array_equal(_bits(got[c]), _bits(want), err_msg=f"row {c}")
    return boundary


# ---------------------------------------------------------------------------
# SYRK: plain version against the reference (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d", [(40, 24), (60, 150), (348, 301)])
def test_syrk_plain_matches_reference_packed(ref, n, d):
    z, hw = _syrk_inputs(2, n, d, seed=d)
    got = ths.hessian_syrk_packed_plain(torch.as_tensor(z), torch.as_tensor(hw), 0.0).numpy()
    scale = _syrk_scale(z, hw)
    for c in range(2):
        want = np.asarray(ref.ops.hessian_syrk_packed(ref.jnp.asarray(z[c]), ref.jnp.asarray(hw[c])))
        assert np.max(np.abs(got[c] - want)) <= SYRK_TOL * scale


def test_syrk_plain_matches_pallas_interpret(ref):
    """d = 150 spans two 128-wide Pallas tiles: the (i, j >= i) grid and the
    mirror epilogue are both exercised."""
    z, hw = _syrk_inputs(1, 60, 150, seed=11)
    want = ref.ops.hessian_syrk(ref.jnp.asarray(z[0]), ref.jnp.asarray(hw[0]), interpret=True)
    want = np.asarray(want)[np.triu_indices(150)]
    got = ths.hessian_syrk_packed_plain(torch.as_tensor(z), torch.as_tensor(hw), 0.0)[0].numpy()
    assert np.max(np.abs(got - want)) <= SYRK_TOL * _syrk_scale(z, hw)


def test_syrk_plain_adds_lam_packed():
    """+lam on the packed diagonal and lam*0.0 elsewhere, after the product."""
    z, hw = _syrk_inputs(3, 20, 9, seed=3)
    zt, ht = torch.as_tensor(z), torch.as_tensor(hw)
    bare = pack_triu(zt.mT @ (ht[..., None] * zt))
    got = ths.hessian_syrk_packed_plain(zt, ht, 0.25)
    want = bare + 0.25 * packed_eye(9, torch.float64, torch.device("cpu"))
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))


@pytest.mark.parametrize("n_z,reps", [(3, 1), (3, 4), (1, 5)])
def test_syrk_plain_shared_z_is_each_block(n_z, reps):
    """The shared form (hw holds reps blocks of z's n_z clients, client c
    reading z[c mod n_z]) is, block by block, the plain result on z, bit for
    bit; hw that is not a multiple of z's clients is refused."""
    z, _ = _syrk_inputs(n_z, 20, 9, seed=n_z + reps)
    _, hw = _syrk_inputs(n_z * reps, 20, 9, seed=7)
    zt, ht = torch.as_tensor(z), torch.as_tensor(hw)
    got = ths.hessian_syrk_packed_plain(zt, ht, 1e-3)
    assert got.shape == (n_z * reps, triu_size(9))
    for b in range(reps):
        want = ths.hessian_syrk_packed_plain(zt, ht[b * n_z:(b + 1) * n_z], 1e-3)
        assert torch.equal(got[b * n_z:(b + 1) * n_z].view(torch.int64), want.view(torch.int64))
    with pytest.raises(ValueError, match="multiple of n_z"):
        ths.hessian_syrk_packed_plain(torch.zeros(2, 20, 9, dtype=torch.float64),
                                      torch.zeros(3, 20, dtype=torch.float64), 0.0)


# ---------------------------------------------------------------------------
# SYRK: the CUDA kernel's tile schedule, mirrored in syrk_schedule (CPU)
# ---------------------------------------------------------------------------

def test_syrk_schedule_constants_match_the_kernel_source():
    """The mirror's block and warp tiles are the kernel's."""
    src = (Path(ths.__file__).parent / "csrc" / "hessian_syrk.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (consts["kRows"], consts["kCols"], consts["kWarpTile"], consts["kNarrowCols"]) == (
        ths.ROWS, ths.COLS, ths.WARP_TILE, ths.NARROW_COLS)


@pytest.mark.parametrize("d_lo", range(1, 321, 32))
def test_syrk_schedule_covers_each_packed_entry_once(d_lo):
    """For every d in [d_lo, d_lo + 32): each (r, q >= r) below d lies in
    exactly one computed DMMA tile, every tile holds an upper entry below d
    and lies inside its block, and the blocks are those of the kernel's grid
    (column chunk, row strip) whose chunk starts below d."""
    for d in range(d_lo, d_lo + 32):
        blocks = ths.syrk_schedule(d)
        grid = [(ths.ROWS * i, ths.ROWS * i + ths.COLS * j)
                for i in range(-(-d // ths.ROWS)) for j in range(-(-d // ths.COLS))]
        assert [(r0, q0) for r0, q0, _ in blocks] == [(r0, q0) for r0, q0 in grid if q0 < d]
        tr, tc = ths.DMMA_ROWS, ths.DMMA_COLS
        count = np.zeros((d + tr, d + tc), dtype=np.int64)
        for r0, q0, warps in blocks:
            tiles = [t for w in warps for t in w]
            assert len(set(tiles)) == len(tiles)
            for rt, qt in tiles:
                assert r0 <= rt and rt + tr <= r0 + ths.ROWS
                assert q0 <= qt and qt + tc <= q0 + ths.COLS
                assert rt < d and qt < d and qt + tc - 1 >= rt
                count[rt:rt + tr, qt:qt + tc] += 1
        upper = np.triu(np.ones((d, d), dtype=bool))
        assert np.all(count[:d, :d][upper] == 1), d
        assert np.all(count[:d, :d][~upper] <= 1), d


def _syrk_by_schedule(z, hw, lam):
    """The packed result assembled as the kernel assembles it: per computed
    DMMA tile Z[:, rows]^T (hw Z[:, cols]), then the epilogue's mask (q < d,
    q >= r), offset off(r, q) and +lam / +lam*0.0."""
    n_clients, _, d = z.shape
    tr, tc = ths.DMMA_ROWS, ths.DMMA_COLS
    zp = torch.nn.functional.pad(z, (0, tr))
    hz = hw[..., None] * zp
    out = torch.full((n_clients, triu_size(d)), float("nan"), dtype=torch.float64)
    for _, _, warps in ths.syrk_schedule(d):
        for rt, qt in (t for w in warps for t in w):
            acc = zp[:, :, rt:rt + tr].mT @ hz[:, :, qt:qt + tc]
            for i in range(tr):
                for j in range(tc):
                    r, q = rt + i, qt + j
                    if q < d and q >= r:
                        off = r * d - r * (r - 1) // 2 + (q - r)
                        out[:, off] = acc[:, i, j] + (lam if q == r else lam * 0.0)
    return out


@pytest.mark.parametrize("n_clients,n,d", [(2, 1, 1), (2, 7, 5), (2, 9, 8), (1, 13, 63),
                                           (1, 13, 64), (2, 5, 65), (2, 11, 69), (1, 6, 150),
                                           (1, 3, 301)])
def test_syrk_schedule_assembles_the_plain_result(n_clients, n, d):
    z, hw = _syrk_inputs(n_clients, n, d, seed=d)
    zt, ht = torch.as_tensor(z), torch.as_tensor(hw)
    got = _syrk_by_schedule(zt, ht, 1e-3)
    want = ths.hessian_syrk_packed_plain(zt, ht, 1e-3)
    assert not bool(torch.isnan(got).any())
    assert (got - want).abs().max().item() <= SYRK_TOL * _syrk_scale(z, hw)


def test_syrk_l2_bytes_at_w8a():
    """9 blocks a client at d = 301 stage 1,121 of Z's columns (the 64 x 64
    pair grid of the FP64-pipe kernel staged 1,806) and hw once each."""
    blocks = ths.syrk_schedule(301)
    assert len(blocks) == 9 and sum(len(t) for *_, w in blocks for t in w) == 380
    assert ths.syrk_l2_bytes(142, 348, 301) == 142 * 348 * 8 * (1121 + 9)


# ---------------------------------------------------------------------------
# TopK: plain version against the Pallas kernel in interpret mode (CPU)
# ---------------------------------------------------------------------------

def _check_topk_against_pallas(ref, u, k):
    got, sent = tcs.select_topk_plain(torch.as_tensor(u), k)
    for c in range(u.shape[0]):
        want, want_sent = ref.topk_pallas(ref.jnp.asarray(u[c]), k, interpret=True)
        np.testing.assert_array_equal(_bits(got[c].numpy()), _bits(want))
        assert int(sent[c]) == int(want_sent[0]) == k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topk_plain_bit_exact_vs_pallas_near_ties(ref, seed):
    _check_topk_against_pallas(ref, near_tie_rows(2, 512, seed), 100)


def test_topk_plain_bit_exact_vs_pallas_w8a_size(ref):
    """T = 45451, k = 2408: the w8a shape of the main path."""
    t, k = triu_size(301), 8 * 301
    rows = np.concatenate([near_tie_rows(1, t, 5), np.random.default_rng(6).standard_normal((1, t))])
    _check_topk_against_pallas(ref, rows, k)


@pytest.mark.parametrize("t,k", [(300, 24), (257, 1), (130, 130), (1000, 64)])
def test_topk_plain_bit_exact_vs_reference_select(ref, t, k):
    """Against repro's sorted and masked selections, zeros and ties included."""
    rng = np.random.default_rng(t + k)
    u = rng.standard_normal((3, t))
    u[0, ::3] = 0.0
    u[1, : t // 2] = -0.0
    u[2] = np.round(u[2], 1)  # many exact ties
    got = tsel.topk_dense_masked(torch.as_tensor(u), k).numpy()
    for c in range(3):
        uj = ref.jnp.asarray(u[c])
        np.testing.assert_array_equal(_bits(got[c]), _bits(ref.sel.topk_dense_masked(uj, k)))
        np.testing.assert_array_equal(_bits(got[c]), _bits(ref.sel.topk_dense(uj, k)))


@pytest.mark.parametrize("seed", [0, 1])
def test_topk_sorted_and_masked_forms_agree(seed):
    u = torch.as_tensor(near_tie_rows(3, 777, seed))
    k = 50
    masked = tsel.topk_dense_masked(u, k)
    assert torch.equal(masked.view(torch.int64), tsel.topk_dense(u, k).view(torch.int64))
    keys = tsel.rank_keys(u).numpy()
    for c in range(3):
        order = np.lexsort((np.arange(777), -keys[c]))  # stable: lowest index first
        np.testing.assert_array_equal(tsel.topk_indices(u, k)[c].numpy(), order[:k])
        np.testing.assert_array_equal(np.flatnonzero(masked[c].numpy()), np.sort(order[:k]))


def test_topk_plain_rows_are_independent():
    u = torch.as_tensor(near_tie_rows(4, 300, 9))
    batched, _ = tcs.select_topk_plain(u, 40)
    for c in range(4):
        row, _ = tcs.select_topk_plain(u[c], 40)
        assert torch.equal(batched[c].view(torch.int64), row.view(torch.int64))



# ---------------------------------------------------------------------------
# RandSeqK: plain version against the Pallas kernel in interpret mode (CPU)
# ---------------------------------------------------------------------------

RANDSEQK_CASES = {
    # name: (t, k, starts)
    "s_is_0": (300, 24, [0, 0]),
    "s_is_T_minus_1": (300, 24, [299, 299]),
    "wrapping": (300, 24, [290, 280]),
    "k_is_1": (257, 1, [0, 256]),
    "k_is_T": (130, 130, [0, 77]),
    "mixed": (1000, 64, [5, 999, 940, 500]),
}


@pytest.mark.parametrize("case", sorted(RANDSEQK_CASES))
def test_randseqk_plain_bit_exact_vs_pallas(ref, case):
    t, k, starts = RANDSEQK_CASES[case]
    rng = np.random.default_rng(t + k)
    u = rng.standard_normal((len(starts), t))
    u[0, ::5] = -0.0
    s = np.array(starts, dtype=np.int64)
    got, sent = tcs.select_randseqk_plain(torch.as_tensor(u), k, torch.as_tensor(s))
    rolled = tsel.randseqk_dense(torch.as_tensor(u), k, torch.as_tensor(s)).numpy()
    for c in range(len(starts)):
        uj, sj = ref.jnp.asarray(u[c]), ref.jnp.asarray(s[c])
        want, want_sent = ref.randseqk_pallas(uj, k, sj, interpret=True)
        np.testing.assert_array_equal(_bits(got[c].numpy()), _bits(want))
        np.testing.assert_array_equal(_bits(rolled[c]), _bits(ref.sel.randseqk_dense(uj, k, sj)))
        np.testing.assert_array_equal(_bits(rolled[c]), _bits(want))
        assert int(sent[c]) == int(want_sent[0]) == k
        assert np.count_nonzero(got[c].numpy() != 0) <= k


def test_randseqk_window_mask_matches_reference(ref):
    for t, k, s in [(300, 24, 290), (300, 24, -7), (50, 50, 3), (50, 1, 49)]:
        got = tsel.randseqk_window_mask(t, k, torch.tensor(s)).numpy()
        want = np.asarray(ref.sel.randseqk_window_mask(t, k, ref.jnp.asarray(s)))
        np.testing.assert_array_equal(got, want)
        assert got.sum() == k


# ---------------------------------------------------------------------------
# TopLEK: plain version against the Pallas kernel in interpret mode (CPU)
# ---------------------------------------------------------------------------

def _toplek_against_pallas(ref, u, k, unif, exact):
    got, sent = tcs.select_toplek_plain(torch.as_tensor(u), k, torch.as_tensor(unif))
    assert sent.dtype == torch.int32
    want_rows = []
    for c in range(u.shape[0]):
        want, want_sent = ref.toplek_pallas(
            ref.jnp.asarray(u[c]), k, ref.jnp.asarray(unif[c]), interpret=True
        )
        want_rows.append((np.asarray(want), int(want_sent[0])))
    return _check_toplek_rows(got.numpy(), sent.numpy(), want_rows, u, k, unif, exact)


TOPLEK_CASES = {
    # name: (rows, k, exact)
    "dyadic": (lambda: dyadic_rows(4, 600, 1), 48, True),
    "dyadic_k_is_1": (lambda: dyadic_rows(3, 257, 2), 1, True),
    "dyadic_k_is_T": (lambda: dyadic_rows(3, 130, 3), 130, True),
    "near_ties": (lambda: near_tie_rows(4, 512, 4), 100, False),
    "all_zero": (lambda: np.zeros((2, 300)), 24, True),
    "k_is_1": (lambda: near_tie_rows(3, 257, 5), 1, False),
    "k_is_T": (lambda: near_tie_rows(3, 130, 6), 130, False),
    "gaussian": (lambda: np.random.default_rng(7).standard_normal((6, 1000)), 64, False),
}


@pytest.mark.parametrize("case", sorted(TOPLEK_CASES))
def test_toplek_plain_vs_pallas(ref, case):
    make, k, exact = TOPLEK_CASES[case]
    u = make()
    unif = np.random.default_rng(k).uniform(size=u.shape[0])
    unif[0] = 0.0  # always the larger prefix
    boundary = _toplek_against_pallas(ref, u, k, unif, exact)
    assert boundary == 0 or not exact


def test_toplek_plain_vs_pallas_w8a_size(ref):
    """T = 45451, k = 2408: a Gaussian row and a dyadic row at the main path's shape."""
    t, k = triu_size(301), 8 * 301
    u = np.concatenate([np.random.default_rng(8).standard_normal((1, t)), dyadic_rows(1, t, 9)])
    _toplek_against_pallas(ref, u, k, np.array([0.3, 0.6]), exact=False)


def test_toplek_plain_matches_reference_select(ref):
    """Against repro's toplek_from_uniform directly, batched rows at once."""
    u = dyadic_rows(5, 400, 10)
    u[2] = 0.0
    unif = np.linspace(0.0, 0.99, 5)
    got, sent = tsel.toplek_from_uniform(torch.as_tensor(u), 32, torch.as_tensor(unif))
    for c in range(5):
        want, kept = ref.sel.toplek_from_uniform(ref.jnp.asarray(u[c]), 32, ref.jnp.asarray(unif[c]))
        np.testing.assert_array_equal(_bits(got[c].numpy()), _bits(want))
        assert int(sent[c]) == int(kept)
    assert int(sent[2]) == 0 and not got[2].any()


def _heavy_tailed_rows(n_rows, t, seed):
    """N(0, 1) * exp(U(-20, 0)) entries: magnitudes over nine decades."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n_rows, t)) * np.exp(rng.uniform(-20.0, 0.0, (n_rows, t)))


def test_toplek_kept_is_the_reference_at_k_equal_t(ref):
    """k = T: delta = 1, so m* sits where the prefix energy reaches the total
    to its last bit, on most rows.  The plain version sums in the orders of
    XLA's CPU cumsum and sum, so kept (and u_hat) are the reference's on
    every one of 200 heavy-tailed rows, eagerly per row and jitted over the
    batch."""
    t = 210
    u = _heavy_tailed_rows(200, t, seed=0)
    unif = np.random.default_rng(1).uniform(size=200)
    got, kept = tsel.toplek_from_uniform(torch.as_tensor(u), t, torch.as_tensor(unif))
    jax = pytest.importorskip("jax")
    batched = jax.jit(jax.vmap(lambda r, q: ref.sel.toplek_from_uniform(r, t, q)))
    want, want_kept = batched(ref.jnp.asarray(u), ref.jnp.asarray(unif))
    np.testing.assert_array_equal(kept.numpy(), np.asarray(want_kept))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert len(set(kept.tolist())) > 1 and (kept < t).any()  # the boundary is in play
    for c in range(0, 200, 20):
        one, one_kept = ref.sel.toplek_from_uniform(ref.jnp.asarray(u[c]), t, ref.jnp.asarray(unif[c]))
        assert int(kept[c]) == int(one_kept)


@pytest.mark.parametrize("t", [210, 820, 45451])
def test_sum_orders_are_xla_cpus(ref, t):
    """blocked_cumsum is jnp.cumsum's order (base-16 blocked scan) and
    windowed_sum jnp.sum's (windows of 32), bit for bit."""
    x = _heavy_tailed_rows(3, t, seed=t)
    want = np.asarray(ref.jnp.cumsum(ref.jnp.asarray(x), axis=-1))
    np.testing.assert_array_equal(_bits(tsel.blocked_cumsum(torch.as_tensor(x)).numpy()), _bits(want))
    want = np.asarray(ref.jnp.sum(ref.jnp.asarray(x * x), axis=-1))
    np.testing.assert_array_equal(_bits(tsel.windowed_sum(torch.as_tensor(x * x)).numpy()), _bits(want))
    assert (np.cumsum(x, axis=-1) != np.asarray(tsel.blocked_cumsum(torch.as_tensor(x)))).any()


@pytest.mark.parametrize("t,k", [(28, 5), (210, 160), (210, 210), (300, 1)])
def test_index_forms_plain_name_the_kept_set(t, k):
    """idx holds each row's kept indices in index order (zeros after sent),
    kept zeros included; u_hat and sent are the dense forms'."""
    rng = np.random.default_rng(t + k)
    u = rng.standard_normal((4, t))
    u[1, rng.uniform(size=t) < 0.8] = 0.0
    u[2] = np.round(u[2] * 2) / 2
    u[3] = 0.0
    ut = torch.as_tensor(u)
    keys = torch.as_tensor(rng.uniform(size=(4, t)).astype(np.float32))
    unif = torch.as_tensor(rng.uniform(size=4))
    cases = [
        (tcs.select_topk_idx_plain(ut, k), tcs.select_topk_plain(ut, k),
         tsel.topk_indices(ut, k), torch.full((4,), k)),
        (tcs.select_topk_by_keys_idx_plain(ut, keys, k), tcs.select_topk_by_keys_plain(ut, keys, k),
         torch.sort(keys, dim=-1, descending=True, stable=True).indices[:, :k], torch.full((4,), k)),
        (tcs.select_toplek_idx_plain(ut, k, unif), tcs.select_toplek_plain(ut, k, unif),
         tsel.topk_indices(ut, k), tcs.select_toplek_plain(ut, k, unif)[1]),
    ]
    for (u_hat, sent, idx), (want_hat, want_sent), order, kept in cases:
        assert torch.equal(u_hat, want_hat) and torch.equal(sent, want_sent)
        assert idx.dtype == torch.int32 and idx.shape == (4, k)
        for c in range(4):
            n = int(kept[c])
            assert idx[c, :n].tolist() == sorted(order[c, :n].tolist())
            assert not idx[c, n:].any()
    assert int(tcs.select_topk_idx_plain(ut, k)[2][3, -1]) == k - 1  # an all-zero row: 0..k-1


def test_toplek_kept_is_an_ordered_topk_prefix():
    """u_hat keeps the first `kept` entries of the TopK order, and E over
    unif of ||u - u_hat||^2 is (1 - k/T) ||u||^2 (Algorithm 4's equality)."""
    u = torch.as_tensor(np.random.default_rng(12).standard_normal((1, 500)))
    k = 40
    order = tsel.topk_indices(u, k)[0]
    # unif < p keeps m*-1 entries, otherwise m*
    few_hat, few = tsel.toplek_from_uniform(u, k, torch.tensor([0.0]))
    more_hat, more = tsel.toplek_from_uniform(u, k, torch.tensor([1.0 - 2**-53]))
    assert int(more) == int(few) + 1
    for u_hat, kept in ((few_hat, int(few)), (more_hat, int(more))):
        np.testing.assert_array_equal(np.flatnonzero(u_hat[0].numpy()), np.sort(order[:kept].numpy()))
    lo, hi = 0.0, 1.0  # bisect on the uniform for p = P(keep m*-1)
    for _ in range(60):
        mid = (lo + hi) / 2
        kept = int(tsel.toplek_from_uniform(u, k, torch.tensor([mid]))[1])
        lo, hi = (mid, hi) if kept == int(few) else (lo, mid)
    p = lo
    err = lambda h: float(torch.sum((u - h) ** 2))
    total = float(torch.sum(u * u))
    np.testing.assert_allclose(p * err(few_hat) + (1 - p) * err(more_hat), (1 - k / 500) * total, rtol=1e-9)


# ---------------------------------------------------------------------------
# routing and wrapper checks (CPU)
# ---------------------------------------------------------------------------

NO_LAUNCHES = {
    "hessian_syrk_packed": 0, "select_topk": 0, "select_topk_by_keys": 0, "select_randseqk": 0,
    "select_toplek": 0, "flash_attention": 0, "threefry_uniform": 0,
    "select_topk_idx": 0, "select_topk_by_keys_idx": 0, "select_toplek_idx": 0,
    "flash_attention_train": 0, "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkdv": 0,
}


def test_ops_route_cpu_tensors_to_plain_versions():
    tops.reset_launch_counts()
    z, hw = _syrk_inputs(2, 10, 7, seed=1)
    zt, ht = torch.as_tensor(z), torch.as_tensor(hw)
    assert torch.equal(tops.hessian_syrk_packed(zt, ht, 0.1), ths.hessian_syrk_packed_plain(zt, ht, 0.1))
    u = torch.as_tensor(near_tie_rows(2, 28, 0))
    got, sent = tops.select_topk(u, 5)
    assert torch.equal(got, tcs.select_topk_plain(u, 5)[0])
    assert sent.dtype == torch.int32 and sent.tolist() == [5, 5]
    s = torch.tensor([3, 27])
    got, sent = tops.select_randseqk(u, 5, s)
    assert torch.equal(got, tcs.select_randseqk_plain(u, 5, s)[0])
    assert sent.dtype == torch.int32 and sent.tolist() == [5, 5]
    unif = torch.tensor([0.25, 0.75], dtype=torch.float64)
    got, sent = tops.select_toplek(u, 5, unif)
    want, want_sent = tcs.select_toplek_plain(u, 5, unif)
    assert torch.equal(got, want) and torch.equal(sent, want_sent)
    assert sent.dtype == torch.int32
    keys = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    unif32 = tops.threefry_uniform(keys, 28, torch.float32)
    assert torch.equal(unif32, tth.threefry_uniform_plain(keys, 28, torch.float32))
    got, sent = tops.select_topk_by_keys(u, unif32, 5)
    assert torch.equal(got, tcs.select_topk_by_keys_plain(u, unif32, 5)[0])
    assert sent.dtype == torch.int32 and sent.tolist() == [5, 5]
    assert tops.launch_counts() == NO_LAUNCHES
    assert tth.threefry_uniform_cuda.dtype_launches == {"float32": 0, "float64": 0}


def test_reset_launch_counts_clears_the_counts_by_route_and_by_dtype():
    tth.threefry_uniform_cuda.dtype_launches["float64"] = 3
    tops.flash_attention_mod.flash_attention_cuda.route_launches["simt"] = 2
    tops.reset_launch_counts()
    assert tth.threefry_uniform_cuda.dtype_launches == {"float32": 0, "float64": 0}
    assert tops.flash_attention_mod.flash_attention_cuda.route_launches == {"wgmma": 0, "simt": 0}
    assert tops.launch_counts() == NO_LAUNCHES


class _Elsewhere:
    """A stand-in for a tensor on a device with no kernel and no plain
    route: only its device is read before the refusal."""

    device = torch.device("mps")


def test_ops_refuse_other_devices():
    other = _Elsewhere()
    with pytest.raises(ValueError, match="no kernel for device"):
        tops.select_topk(other, 2)
    with pytest.raises(ValueError, match="no kernel for device"):
        tops.select_randseqk(other, 2, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="no kernel for device"):
        tops.select_toplek(other, 2, torch.zeros(2, dtype=torch.float64))
    with pytest.raises(ValueError, match="no kernel for device"):
        tops.select_topk_by_keys(other, torch.zeros(2, 6), 2)
    with pytest.raises(ValueError, match="no kernel for device"):
        tops.threefry_uniform(other, 6, torch.float32)
    with pytest.raises(ValueError, match="no kernel for device"):
        tops.hessian_syrk_packed(other, torch.zeros(1, 3, dtype=torch.float64), 0.0)
    with pytest.raises(ValueError, match="no kernel for device"):
        tops.attention(other, other, other)


def _route_calls(device: str) -> dict:
    """Each op of ``kernels.ops`` on small zero inputs on ``device``."""
    u = torch.zeros(2, 6, dtype=torch.float64, device=device)
    return {
        "select_topk": lambda: tops.select_topk(u, 2),
        "select_randseqk": lambda: tops.select_randseqk(
            u, 2, torch.zeros(2, dtype=torch.int64, device=device)),
        "select_toplek": lambda: tops.select_toplek(
            u, 2, torch.zeros(2, dtype=torch.float64, device=device)),
        "select_topk_by_keys": lambda: tops.select_topk_by_keys(
            u, torch.zeros(2, 6, device=device), 2),
        "threefry_uniform": lambda: tops.threefry_uniform(
            torch.zeros(2, 2, dtype=torch.int32, device=device), 6, torch.float32),
        "hessian_syrk_packed": lambda: tops.hessian_syrk_packed(
            torch.zeros(1, 3, 2, dtype=torch.float64, device=device),
            torch.zeros(1, 3, dtype=torch.float64, device=device), 0.0),
        "attention": lambda: tops.attention(
            *[torch.zeros(1, 8, 2, 16, dtype=torch.bfloat16, device=device)] * 3),
    }


def test_ops_take_the_plain_versions_on_meta():
    """A meta tensor (a step counted without data) takes the plain versions,
    as a CPU tensor does: the same shapes and dtypes, no launch."""
    def outs(call):
        out = call()
        return out if isinstance(out, tuple) else (out,)

    tops.reset_launch_counts()
    cpu, meta = _route_calls("cpu"), _route_calls("meta")
    for name in cpu:
        got, want = outs(meta[name]), outs(cpu[name])
        assert all(o.device.type == "meta" for o in got), name
        assert [(o.shape, o.dtype) for o in got] == [(o.shape, o.dtype) for o in want], name
    assert tops.launch_counts() == NO_LAUNCHES


def test_cuda_wrappers_refuse_before_building():
    """The wrappers check their inputs before touching nvcc or the card."""
    z = torch.zeros(1, 4, 3, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        ths.hessian_syrk_packed_cuda(z, torch.zeros(1, 4, dtype=torch.float64), 0.0)
    with pytest.raises(TypeError):
        ths.hessian_syrk_packed_cuda(z.float(), torch.zeros(1, 4), 0.0)
    with pytest.raises(ValueError, match="CUDA"):
        tcs.select_topk_cuda(torch.zeros(2, 6, dtype=torch.float64), 2)
    with pytest.raises(TypeError):
        tcs.select_topk_cuda(torch.zeros(2, 6), 2)
    u = torch.zeros(2, 6, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        tcs.select_randseqk_cuda(u, 2, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(TypeError):
        tcs.select_randseqk_cuda(u.float(), 2, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="CUDA"):
        tcs.select_toplek_cuda(u, 2, torch.zeros(2, dtype=torch.float64))
    with pytest.raises(TypeError):
        tcs.select_toplek_cuda(u.float(), 2, torch.zeros(2))
    with pytest.raises(ValueError, match="CUDA"):
        tcs.select_topk_by_keys_cuda(u, torch.zeros(2, 6), 2)
    with pytest.raises(TypeError):
        tcs.select_topk_by_keys_cuda(u.float(), torch.zeros(2, 6), 2)
    keys = torch.zeros(2, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tth.threefry_uniform_cuda(keys, 6, torch.float32)
    with pytest.raises(TypeError):
        tth.threefry_uniform_cuda(keys, 6, torch.float16)
    with pytest.raises(ValueError, match="int32"):
        tth.threefry_uniform_cuda(keys.long(), 6, torch.float32)
    assert tops.launch_counts() == NO_LAUNCHES


def test_threefry_cuda_wrapper_refuses_t_past_2_to_32():
    """The CUDA wrapper takes T < 2**32 only (the kernel folds the counter's
    high word, 0 below it) and says so before it looks at the keys' device;
    the plain version keeps the general form (checked at T = 0 here: the
    shape alone)."""
    keys = torch.zeros(2, 2, dtype=torch.int32)
    for t in (2**32, 2**32 + 5, 2**40):
        with pytest.raises(ValueError, match=r"2\*\*32"):
            tth.threefry_uniform_cuda(keys, t, torch.float32)
        with pytest.raises(ValueError, match=r"2\*\*32"):
            tth.threefry_uniform_cuda(keys, t, torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        tth.threefry_uniform_cuda(keys, 2**32 - 1, torch.float32)
    assert tth.threefry_uniform_plain(keys, 0, torch.float64).shape == (2, 0)
    assert tops.launch_counts() == NO_LAUNCHES


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions (on a card)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize(
    "n_clients,n,d",
    [(142, 348, 301), (3, 40, 24), (2, 1, 65), (1, 33, 64), (5, 100, 129),
     # n_i not a multiple of 4 (the phishing and a9a widths), then all 142
     # clients at the phishing and a9a shapes
     (4, 77, 69), (3, 229, 124), (142, 77, 69), (142, 229, 124),
     # d below 8 and at the 8- and 64-boundaries
     (3, 20, 1), (3, 21, 5), (2, 22, 8), (2, 35, 63), (2, 36, 64), (2, 37, 65)],
)
def test_syrk_kernel_matches_plain_cuda(cuda, n_clients, n, d):
    z, hw = _syrk_inputs(n_clients, n, d, seed=n + d)
    zt = torch.as_tensor(z, device=cuda)
    ht = torch.as_tensor(hw, device=cuda)
    before = ths.hessian_syrk_packed_cuda.launches
    got = tops.hessian_syrk_packed(zt, ht, 1e-3)
    assert ths.hessian_syrk_packed_cuda.launches == before + 1
    want = ths.hessian_syrk_packed_plain(zt, ht, 1e-3)
    torch.cuda.synchronize()
    assert got.shape == (n_clients, triu_size(d))
    assert (got - want).abs().max().item() <= SYRK_TOL * _syrk_scale(z, hw)


@pytest.mark.cuda
@pytest.mark.parametrize("n_z,reps,n,d", [(142, 12, 348, 301), (8, 3, 40, 24), (3, 5, 37, 65),
                                          (1, 7, 33, 64)])
def test_syrk_kernel_shared_z_matches_plain_cuda(cuda, n_z, reps, n, d):
    """The shared-z entry (client c reads z[c mod n_z]; a sweep group of
    reps specs on one dataset) against the plain version, and against the
    kernel on z repeated: per client the same work, bit for bit."""
    z, _ = _syrk_inputs(n_z, n, d, seed=n + d)
    _, hw = _syrk_inputs(n_z * reps, n, d, seed=d)
    zt = torch.as_tensor(z, device=cuda)
    ht = torch.as_tensor(hw, device=cuda)
    before = ths.hessian_syrk_packed_cuda.launches
    got = tops.hessian_syrk_packed(zt, ht, 1e-3)
    assert ths.hessian_syrk_packed_cuda.launches == before + 1
    want = ths.hessian_syrk_packed_plain(zt, ht, 1e-3)
    repeated = ths.hessian_syrk_packed_cuda(zt.repeat(reps, 1, 1), ht, 1e-3)
    torch.cuda.synchronize()
    assert got.shape == (n_z * reps, triu_size(d))
    scale = max(_syrk_scale(z, hw[b * n_z:(b + 1) * n_z]) for b in range(reps))
    assert (got - want).abs().max().item() <= SYRK_TOL * scale
    assert torch.equal(got.view(torch.int64), repeated.view(torch.int64))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n_rows,t,k",
    [(142, 45451, 2408), (3, 512, 100), (4, 257, 1), (4, 130, 130), (2, 1025, 1024), (8, 61425, 2800),
     (2, 57820, 2000), (2, 57821, 2000)],
)
def test_topk_kernel_bit_exact_cuda(cuda, n_rows, t, k):
    """Near-ties, a zero row and a row of exact ties; T = 61425 keeps the keys
    in device memory (they do not fit the shared memory of one block), and
    T = 57820 and 57821 sit on either side of that limit."""
    u = near_tie_rows(n_rows, t, seed=t)
    u[0] = 0.0
    u[-1] = np.round(u[-1], 1)
    ut = torch.as_tensor(u, device=cuda)
    before = tcs.select_topk_cuda.launches
    got, sent = tops.select_topk(ut, k)
    assert tcs.select_topk_cuda.launches == before + 1
    want, want_sent = tcs.select_topk_plain(ut, k)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))
    assert torch.equal(sent, want_sent)
    # 1168: the kernel's static shared memory as compiled for sm_90a (32 warp
    # counts, 256 histogram bins, a pass's pick); 232448: the H100's opt-in
    # limit per block
    assert tcs.keys_in_shared_memory(t, cuda) == (t * 4 + 1168 <= 232448)


def tie_rows(n_rows, t, seed):
    """Few distinct magnitudes (+-1, +-2, +-3, +-4, and 0): each key value is
    shared by thousands of indices, so the ties at the threshold exceed the
    number kept and span many tiles and warps."""
    rng = np.random.default_rng(seed)
    return rng.integers(-4, 5, size=(n_rows, t)).astype(np.float64)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "t,k",
    [(45451, 2408), (45451, 1), (45451, 45451), (45451, 30000), (61425, 2800), (1000, 333)],
)
def test_topk_kernel_ties_exceed_need_cuda(cuda, t, k):
    """Rows whose ties at the threshold exceed what is kept: the lowest-index
    ties are kept, bit-exact against the plain version; also k = 1 and k = T,
    and T = 61425 with the keys in device memory."""
    u = tie_rows(4, t, seed=k)
    ut = torch.as_tensor(u, device=cuda)
    keys = np.abs(u).astype(np.float32)
    kth = -np.sort(-keys, axis=1)[:, k - 1]
    n_eq = (keys == kth[:, None]).sum(1)
    n_gt = (keys > kth[:, None]).sum(1)
    assert k == t or np.all(n_eq > k - n_gt)  # the fixture does what it says
    before = tcs.select_topk_cuda.launches
    got, sent = tops.select_topk(ut, k)
    assert tcs.select_topk_cuda.launches == before + 1
    want, want_sent = tcs.select_topk_plain(ut, k)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))
    assert torch.equal(sent, want_sent)


@pytest.mark.cuda
@pytest.mark.parametrize("t,k", [(45451, 2408), (45451, 1), (45451, 45451), (61425, 2800),
                                 (2098176, 16384)])
def test_toplek_kernel_ties_exceed_need_cuda(cuda, t, k):
    """TopLEK on the same tie-heavy rows, whose sums are exact in any order
    (small integers): exact u_hat and kept."""
    u = tie_rows(4, t, seed=k + 1)
    unif = np.random.default_rng(k).uniform(size=4)
    ut = torch.as_tensor(u, device=cuda)
    unif_t = torch.as_tensor(unif, device=cuda)
    got, sent = tops.select_toplek(ut, k, unif_t)
    want, want_sent = tcs.select_toplek_plain(ut, k, unif_t)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))
    assert torch.equal(sent, want_sent)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n_rows,t,k",
    [(142, 45451, 2408), (3, 300, 24), (4, 257, 1), (4, 130, 130), (2, 70000, 4096)],
)
def test_randseqk_kernel_bit_exact_cuda(cuda, n_rows, t, k):
    rng = np.random.default_rng(t)
    u = rng.standard_normal((n_rows, t))
    u[0, ::7] = -0.0
    s = rng.integers(0, t, size=n_rows)
    s[0], s[-1] = 0, t - 1
    ut = torch.as_tensor(u, device=cuda)
    st = torch.as_tensor(s, device=cuda)
    before = tcs.select_randseqk_cuda.launches
    got, sent = tops.select_randseqk(ut, k, st)
    assert tcs.select_randseqk_cuda.launches == before + 1
    want, want_sent = tcs.select_randseqk_plain(ut, k, st)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))
    assert torch.equal(sent, want_sent)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kind,n_rows,t,k,path",
    [
        ("gaussian", 142, 45451, 2408, 0),
        ("dyadic", 142, 45451, 2408, 0),
        ("near_ties", 8, 45451, 2408, 0),
        ("dyadic", 4, 45451, 45451, 2),
        ("dyadic", 8, 61425, 2800, 3),
        ("gaussian", 4, 257, 1, 0),
        ("dyadic", 4, 300, 192, 0),
        ("gaussian", 4, 130, 130, 0),
        # the FedNL probe's T (d = 2,048): the spread route, and path 2 past it
        ("gaussian", 8, 2098176, 16384, 3),
        ("dyadic", 8, 2098176, 16384, 3),
        ("near_ties", 8, 2098176, 16384, 3),
        ("gaussian", 4, 2098176, 1, 3),
        ("gaussian", 1, 2098176, 16384, 3),
        ("dyadic", 2, 2098176, 32768, 2),
    ],
)
def test_toplek_kernel_matches_plain_cuda(cuda, kind, n_rows, t, k, path):
    """Exact on dyadic rows; elsewhere exact but for the stated boundary case.
    The last column is the memory path the kernel takes (0 all in shared
    memory, one block a client; 3 the spread route, many blocks a client;
    2 survivors in device-memory scratch, one block a client)."""
    u = {
        "gaussian": lambda: np.random.default_rng(t).standard_normal((n_rows, t)),
        "dyadic": lambda: dyadic_rows(n_rows, t, t),
        "near_ties": lambda: near_tie_rows(n_rows, t, t),
    }[kind]()
    u[-1] = 0.0
    unif = np.random.default_rng(k).uniform(size=n_rows)
    ut = torch.as_tensor(u, device=cuda)
    unif_t = torch.as_tensor(unif, device=cuda)
    before = tcs.select_toplek_cuda.launches
    got, sent = tops.select_toplek(ut, k, unif_t)
    assert tcs.select_toplek_cuda.launches == before + 1
    want, want_sent = tcs.select_toplek_plain(ut, k, unif_t)
    torch.cuda.synchronize()
    assert tcs.toplek_memory_path(t, k, cuda) == path
    assert int(sent[-1]) == 0 and not got[-1].any()
    want_rows = list(zip(want.cpu().numpy(), want_sent.cpu().numpy()))
    _check_toplek_rows(got.cpu().numpy(), sent.cpu().numpy(), want_rows, u, k, unif,
                       exact=kind == "dyadic")


def _client_keys(n_clients, seed):
    """The clients' threefry keys of a round, as uint32 words and as the
    int32 tensor the kernel takes."""
    from repro_torch import prng

    keys = prng.split(prng.split(prng.prng_key(seed), 2)[1], n_clients)
    return keys, torch.as_tensor(keys.view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_clients,t", [
    (142, 45451), (1, 1), (3, 1), (1, 300), (2, 70001),
    # T mod 4 (the counters a thread) = 1, 2, 3 on the main route
    (142, 45449), (142, 45450), (300, 4099),
    # T below one thread's run of 4: on the small route (a few rows), and on
    # the main route (enough rows), a run and a tail
    (1000, 1), (1000, 2), (1000, 3), (300, 5), (300, 6),
    (200000, 3), (150000, 5), (100000, 6),
    # the sweep's rows; a9a's and phishing's rounds; the star's one client
    (568, 45451), (142, 7750), (142, 2415), (1, 45451),
])
def test_threefry_kernel_bit_exact_cuda(cuda, dtype, n_clients, t):
    """The threefry kernel against its plain version, bit for bit, at w8a's
    round shape, T = 1, one client and a T past 2**16; at T mod 4 = 1, 2, 3
    and T below a thread's run of 4 counters (the rows' heads and tails
    outside the aligned runs); at the sweep's 568 rows, a9a's and
    phishing's T and the star's one-client draw."""
    _, keys = _client_keys(n_clients, seed=t)
    kt = keys.to(cuda)
    before = tth.threefry_uniform_cuda.launches
    by_dtype = dict(tth.threefry_uniform_cuda.dtype_launches)
    got = tops.threefry_uniform(kt, t, dtype)
    assert tth.threefry_uniform_cuda.launches == before + 1
    name = str(dtype).removeprefix("torch.")
    assert tth.threefry_uniform_cuda.dtype_launches == {**by_dtype, name: by_dtype[name] + 1}
    want = tth.threefry_uniform_plain(kt, t, dtype)
    torch.cuda.synchronize()
    assert got.shape == (n_clients, t) and got.dtype == dtype
    bits = torch.int32 if dtype == torch.float32 else torch.int64
    assert torch.equal(got.view(bits), want.view(bits))
    assert bool((got >= 0).all()) and bool((got < 1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_threefry_launch_plan_cuda(cuda, dtype):
    """The launcher's cut on the card: w8a's round on the main route (4
    counters a thread, 16-byte runs, a tail slot for each element a row
    can leave outside its runs), the star's one-client draw on the small
    route (one element a thread, a block per 256 elements), and T below a
    run on the main route where the rows are many enough; the blocks never
    more than the card holds at once on the main route."""
    run = 4 if dtype == torch.float32 else 2
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    w8a = tth.threefry_launch_plan(142, 45451, dtype, cuda)
    assert (w8a["small"], w8a["counters"], w8a["run"]) == (0, 4, run)
    assert w8a["tail_slots"] == 142 * 2 * (run - 1)
    assert w8a["tiles"] == 142 * w8a["tiles_per_row"]
    assert w8a["blocks"] <= sms * w8a["per_sm"]
    one = tth.threefry_launch_plan(1, 45451, dtype, cuda)
    assert (one["small"], one["counters"], one["blocks"]) == (1, 1, -(-45451 // 256))
    tiny = tth.threefry_launch_plan(200000, 3, dtype, cuda)
    assert tiny["small"] == 0 and tiny["tail_slots"] == 200000 * 2 * (run - 1)
    with pytest.raises(ValueError, match="bad draw"):
        tth.threefry_launch_plan(1, 2**32, dtype, cuda)


def quantized_keys(n_rows, t, levels, seed):
    """f32 keys in [0, 1) on ``levels`` values: thousands of exact ties, so
    the ties at the k-th key exceed what is kept."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, levels, size=(n_rows, t)) / levels).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kind,n_rows,t,k",
    [("uniform", 142, 45451, 2408), ("uniform", 4, 257, 1), ("uniform", 4, 300, 300),
     ("ties", 4, 45451, 2408), ("ties", 4, 45451, 1), ("ties", 4, 45451, 45451),
     ("ties", 3, 61425, 2800), ("uniform", 3, 61425, 2800), ("ties", 2, 1000, 333)],
)
def test_topk_by_keys_kernel_bit_exact_cuda(cuda, kind, n_rows, t, k):
    """TopK by keys against its plain version, bit for bit: the round's real
    f32 uniforms, forced ties at the k-th key, k = 1, k = T, and T = 61425
    (the keys read from device memory on every pass)."""
    u = np.random.default_rng(t + k).standard_normal((n_rows, t))
    u[0, ::5] = -0.0
    if kind == "uniform":
        _, keys = _client_keys(n_rows, seed=k)
        kt = tth.threefry_uniform_plain(keys, t, torch.float32).to(cuda)
    else:
        kt = torch.as_tensor(quantized_keys(n_rows, t, 16, seed=k), device=cuda)
        keys = kt.cpu().numpy()
        kth = -np.sort(-keys, axis=1)[:, k - 1]
        n_eq = (keys == kth[:, None]).sum(1)
        n_gt = (keys > kth[:, None]).sum(1)
        assert k == t or np.all(n_eq > k - n_gt)  # the fixture does what it says
    ut = torch.as_tensor(u, device=cuda)
    before = tcs.select_topk_by_keys_cuda.launches
    got, sent = tops.select_topk_by_keys(ut, kt, k)
    assert tcs.select_topk_by_keys_cuda.launches == before + 1
    want, want_sent = tcs.select_topk_by_keys_plain(ut, kt, k)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))
    assert torch.equal(sent, want_sent)


# ---------------------------------------------------------------------------
# the index forms (the wire codecs' selections) on a card
# ---------------------------------------------------------------------------

def _with_kept_zeros(u, seed):
    """Rows of u with 80% of their entries set to 0.0 (kept zeros at k near T)."""
    u = u.copy()
    u[: len(u) // 2, np.random.default_rng(seed).uniform(size=u.shape[1]) < 0.8] = 0.0
    return u


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kind,n_rows,t,k",
    [("gaussian", 142, 45451, 2408), ("near_ties", 8, 45451, 2408), ("gaussian", 1, 45451, 2408),
     ("zeros", 4, 45451, 2408), ("zeros", 4, 300, 290), ("gaussian", 4, 61425, 2800),
     ("gaussian", 3, 130, 130), ("gaussian", 3, 257, 1)],
)
def test_topk_index_forms_bit_exact_cuda(cuda, kind, n_rows, t, k):
    """TopK's and TopK by keys' index forms: u_hat, sent and idx exactly the
    plain versions' (the same set; kept zeros named in idx)."""
    u = {
        "gaussian": lambda: np.random.default_rng(t).standard_normal((n_rows, t)),
        "near_ties": lambda: near_tie_rows(n_rows, t, t),
        "zeros": lambda: _with_kept_zeros(np.random.default_rng(t).standard_normal((n_rows, t)), t),
    }[kind]()
    ut = torch.as_tensor(u, device=cuda)
    keys = torch.as_tensor(np.random.default_rng(k).uniform(size=(n_rows, t)).astype(np.float32),
                           device=cuda)
    before = (tcs.select_topk_idx_cuda.launches, tcs.select_topk_by_keys_idx_cuda.launches)
    got = tops.select_topk_idx(ut, k)
    got_keys = tops.select_topk_by_keys_idx(ut, keys, k)
    assert (tcs.select_topk_idx_cuda.launches, tcs.select_topk_by_keys_idx_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    for g, w in ((got, tcs.select_topk_idx_plain(ut.cpu(), k)),
                 (got_keys, tcs.select_topk_by_keys_idx_plain(ut.cpu(), keys.cpu(), k))):
        np.testing.assert_array_equal(_bits(g[0].cpu().numpy()), _bits(w[0].numpy()))
        assert torch.equal(g[1].cpu(), w[1]) and torch.equal(g[2].cpu(), w[2])


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kind,n_rows,t,k,path",
    [("dyadic", 142, 45451, 2408, 0), ("gaussian", 8, 45451, 2408, 0),
     ("zeros", 4, 45451, 2408, 0), ("dyadic", 4, 45451, 45451, 2), ("dyadic", 8, 61425, 2800, 3),
     ("gaussian", 4, 130, 130, 0), ("zeros", 4, 300, 300, 0), ("gaussian", 4, 257, 1, 0),
     ("dyadic", 8, 2098176, 16384, 3), ("gaussian", 4, 2098176, 16384, 3),
     ("zeros", 2, 2098176, 16384, 3)],
)
def test_toplek_index_form_matches_plain_cuda(cuda, kind, n_rows, t, k, path):
    """TopLEK's index form: u_hat, kept and idx the plain version's, exact on
    dyadic rows, elsewhere but for the stated boundary case; idx is the first
    kept of the rank order, sorted by index, zeros after."""
    u = {
        "gaussian": lambda: np.random.default_rng(t).standard_normal((n_rows, t)),
        "dyadic": lambda: dyadic_rows(n_rows, t, t),
        "zeros": lambda: _with_kept_zeros(dyadic_rows(n_rows, t, t), t),
    }[kind]()
    u[-1] = 0.0
    unif = np.random.default_rng(k).uniform(size=n_rows)
    ut, unif_t = torch.as_tensor(u, device=cuda), torch.as_tensor(unif, device=cuda)
    before = tcs.select_toplek_idx_cuda.launches
    got, sent, idx = tops.select_toplek_idx(ut, k, unif_t)
    assert tcs.select_toplek_idx_cuda.launches == before + 1
    assert tcs.toplek_memory_path(t, k, cuda) == path
    want, want_sent, want_idx = tcs.select_toplek_idx_plain(ut, k, unif_t)
    torch.cuda.synchronize()
    dense, dense_sent = tops.select_toplek(ut, k, unif_t)
    assert torch.equal(got, dense) and torch.equal(sent, dense_sent)
    want_rows = list(zip(want.cpu().numpy(), want_sent.cpu().numpy()))
    _check_toplek_rows(got.cpu().numpy(), sent.cpu().numpy(), want_rows, u, k, unif,
                       exact=kind != "gaussian")
    order = tsel.topk_indices(ut.cpu(), k)
    for c in range(n_rows):
        n = int(sent[c])
        assert idx[c, :n].tolist() == sorted(order[c, :n].tolist()), f"row {c}"
        assert not idx[c, n:].any()
        if n == int(want_sent[c]):
            assert torch.equal(idx[c].cpu(), want_idx[c].cpu())
