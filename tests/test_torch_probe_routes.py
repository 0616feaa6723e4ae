"""The two routes that the FedNL probe's shapes take, on the host: flash's
packed grid for short sequences and TopLEK's spread route for large T.

* The flash forward's launch plan (``flash_fwd_grid``, the host mirror of
  ``pack_shift`` in csrc/flash_attention.cu) at the probe's backbone layer
  and around it; the packed tile's visibility predicate
  (``packed_visibility``, the kernel's mask) against the per-sequence
  causal and window mask for every S that divides 128; and attention under
  that mask over the flat (B S) rows against the JAX reference's dense
  attention, sequence by sequence (f32, 2e-5: sums in another order).
* TopLEK's memory plan (``toplek_plan_for``) at the probe's, w8a's, a9a's
  and phishing's shapes, k = T and the routes' edges; the spread route's
  blocks a client; and the plain model of its candidate stage
  (``spread_candidates_plain``: tallies, bin*, candidates) with the tie
  rule of its finish, held against ``repro.compressors.select.topk_indices``
  at small T: the candidates hold the TopK set, exactly, also on
  all-equal rows and ties at the k-th key, and never outnumber T.

The JAX reference is imported inside a fixture; nothing here needs a card.
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.compressors import select as tsel
from repro_torch.kernels import compressor_select as tcs
from repro_torch.kernels import flash_attention as tfa

# the H100's opt-in shared memory a block (cudaDevAttrMaxSharedMemoryPerBlockOptin)
H100_SMEM_OPTIN = 232_448
H100_SMS = 132
PROBE_T, PROBE_K = 2048 * 2049 // 2, 8 * 2048  # d = 2,048, k = 8 d


# ---------------------------------------------------------------------------
# plain models of the two routes' device code
# ---------------------------------------------------------------------------

def packed_visibility(rows: torch.Tensor, keys: torch.Tensor, seq: int, *, causal: bool,
                      window: int | None, sk: int) -> torch.Tensor:
    """The packed grid's mask as its kernel computes it (``softmax_max``
    with kPack): ``rows`` and ``keys`` are positions in the flat (B S)
    sequence, S = ``seq`` a power of two; key j is visible to row i when
    j < sk (B S), both lie in one sequence (i >> log2 S = j >> log2 S), and
    j <= i (causal), j > i - window (window) -> (len(rows), len(keys)) bool."""
    shift = seq.bit_length() - 1
    i, j = rows[:, None], keys[None, :]
    visible = (j < sk) & (((j ^ i) >> shift) == 0)
    if causal:
        visible = visible & (j <= i)
    if window is not None:
        visible = visible & (j > i - window)
    return visible


def spread_candidates_plain(keys: torch.Tensor, k: int, spread: int) -> dict:
    """The spread route's candidate stage on one row's f32 keys
    (``rank_keys``), as its kernels compute it: each of ``spread``
    contiguous segments tallies its keys' top ``tcs.TALLY_BITS`` bits, bin* is
    the bin that holds the k-th largest key, and the candidates are the keys
    in bin* or above (every key of the TopK set).  Those above bin* go first,
    segment by segment from each segment's first slot among them; those in
    bin* after all of those, the same way.  -> {"bin": bin*, "above": the
    candidates above bin*, "counts": (above, in bin*) a segment,
    "first_slot": each segment's first slot (above, in bin*), "index": the
    candidates' indices in their slots' order}."""
    bits = keys.view(torch.int32).to(torch.int64)
    t = bits.shape[-1]
    bins = bits >> (31 - tcs.TALLY_BITS)
    tally = torch.bincount(bins, minlength=1 << tcs.TALLY_BITS)
    from_top = torch.cumsum(tally.flip(0), 0).flip(0)  # keys in each bin and above
    bin_star = int((from_top >= k).nonzero().max())
    seg = -(-t // spread)
    segments = [slice(j * seg, (j + 1) * seg) for j in range(spread)]
    above, in_bin = bins > bin_star, bins == bin_star
    counts = [(int(above[sl].sum()), int(in_bin[sl].sum())) for sl in segments]
    n_above = sum(c[0] for c in counts)
    first = [(sum(c[0] for c in counts[:j]), n_above + sum(c[1] for c in counts[:j]))
             for j in range(spread)]
    index = torch.cat([above.nonzero().flatten(), in_bin.nonzero().flatten()])
    return {"bin": bin_star, "above": n_above, "counts": counts, "first_slot": first,
            "index": index}


def spread_topk_set_plain(keys: torch.Tensor, cand: torch.Tensor, k: int) -> torch.Tensor:
    """The TopK set as the spread route's finish takes it from the
    candidates' indices ``cand`` (in any order): the k-th largest candidate
    key thr, every key above it, and of the keys equal to it the need = k -
    #{key > thr} lowest indices (the need-th smallest tie index, by the
    kernel's second radix select) -> the kept indices, unordered."""
    ck = keys.view(torch.int32)[cand]
    thr = torch.sort(ck, descending=True).values[k - 1]
    need = k - int((ck > thr).sum())
    ties = torch.sort(cand[ck == thr]).values
    cut = ties[need - 1]
    return cand[(ck > thr) | ((ck == thr) & (cand <= cut))]


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from repro.compressors import select as jsel
    from repro.kernels.ref import flash_attention_ref

    return types.SimpleNamespace(jax=jax, jnp=jnp, sel=jsel, flash_ref=flash_attention_ref)


# ---------------------------------------------------------------------------
# flash: the packed grid
# ---------------------------------------------------------------------------

def test_flash_grid_at_the_probe_is_packed():
    """B 512, S 16, H 32, dh 64: 8 sequences a block, 64 x 32 = 2,048 blocks
    (the other grid: 1 x 32 x 512 = 16,384 blocks of 16 rows)."""
    plan = tfa.flash_fwd_grid(512, 16, 16, 32, 64)
    assert plan == {"packed": True, "grid": (64, 32, 1), "sequences_per_block": 8,
                    "seq_shift": 4}
    assert tfa.flash_fwd_grid(512, 16, 16, 32, 64, train=True)["grid"] == (1, 32, 512)


@pytest.mark.parametrize("seq", [1, 2, 16, 64, 128, 512])
@pytest.mark.parametrize("head_dim", [64, 128, 256])
def test_flash_grid_packs_short_sequences_below_head_dim_256(seq, head_dim):
    """Packed exactly where S divides 128 and is below it, at head_dim 64
    and 128; the grid covers the flat rows in 128-row tiles; elsewhere the
    grid of (query tile, head, batch row), 64-row tiles at head_dim 256."""
    batch, heads = 7, 4
    plan = tfa.flash_fwd_grid(batch, seq, seq, heads, head_dim)
    packed = seq < 128 and head_dim != 256
    assert plan["packed"] is packed
    if packed:
        assert plan["grid"] == (-(-batch * seq // 128), heads, 1)
        assert plan["sequences_per_block"] * seq == 128 and 1 << plan["seq_shift"] == seq
    else:
        rows = 64 if head_dim == 256 else 128
        assert plan["grid"] == (-(-seq // rows), heads, batch) and plan["seq_shift"] == -1


@pytest.mark.parametrize("sq,sk,pos_off,train", [
    (16, 16, 3, False),    # a query chunk at an offset
    (16, 32, 0, False),    # keys beyond the queries
    (1, 4096, 0, False),   # a decode step
    (16, 16, 0, True),     # the training instantiation
    (24, 24, 0, False),    # S that does not divide the tile
])
def test_flash_grid_keeps_other_calls_on_the_tile_grid(sq, sk, pos_off, train):
    plan = tfa.flash_fwd_grid(4, sq, sk, 8, 64, pos_off=pos_off, train=train)
    assert not plan["packed"] and plan["grid"] == (-(-sq // 128), 8, 4)


def _per_sequence_mask(rows, keys, seq, causal, window, sk):
    """The reference's mask, sequence by sequence: row i and key j of the
    flat (B S) rows see each other when they share a sequence and their
    positions within it pass the causal and window tests."""
    i, j = rows[:, None], keys[None, :]
    qi, kj = i % seq, j % seq
    same = (i // seq) == (j // seq)
    mask = same & (j < sk)
    if causal:
        mask = mask & (kj <= qi)
    if window is not None:
        mask = mask & (kj > qi - window)
    return mask


@pytest.mark.parametrize("seq", [1, 2, 4, 8, 16, 32, 64, 128])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 3), (False, 5)])
def test_packed_visibility_is_the_per_sequence_mask(seq, causal, window):
    """Over a 128-row tile (the block's rows and its one key tile) at several
    tile starts, including a last tile past the flat rows' end."""
    batch = 3 * (128 // seq) + max(1, 64 // seq)  # the last tile half full
    sk = batch * seq
    for q0 in range(0, sk, 128):
        rows = torch.arange(q0, q0 + 128)
        got = packed_visibility(rows, rows, seq, causal=causal, window=window, sk=sk)
        want = _per_sequence_mask(rows, rows, seq, causal, window, sk)
        assert torch.equal(got, want), (q0, seq)


@pytest.mark.parametrize("seq,causal,window", [(16, True, None), (8, True, 3), (32, False, None)])
def test_attention_under_the_packed_mask_matches_the_reference(ref, seq, causal, window):
    """Dense attention over the flat (B S) rows under packed_visibility, f32,
    against the reference's dense attention of each sequence alone."""
    batch, heads, dh = 10, 2, 16
    rng = np.random.default_rng(seq)
    q, k, v = (rng.standard_normal((batch * seq, heads, dh)).astype(np.float32)
               for _ in range(3))
    pos = torch.arange(batch * seq)
    mask = packed_visibility(pos, pos, seq, causal=causal, window=window, sk=batch * seq)
    qt, kt, vt = (torch.as_tensor(x) for x in (q, k, v))
    logits = torch.einsum("qhd,khd->hqk", qt, kt) * dh**-0.5
    p = torch.softmax(logits.masked_fill(~mask, float("-inf")), dim=-1)
    got = torch.einsum("hqk,khd->qhd", p, vt).numpy()
    for b in range(batch):
        rows = slice(b * seq, (b + 1) * seq)
        want = ref.flash_ref(ref.jnp.asarray(q[rows]), ref.jnp.asarray(k[rows]),
                             ref.jnp.asarray(v[rows]), causal=causal, window=window)
        np.testing.assert_allclose(got[rows], np.asarray(want), atol=2e-5, rtol=0)


# ---------------------------------------------------------------------------
# TopLEK: the spread route
# ---------------------------------------------------------------------------

def _scratch(t):
    return (tcs.SPREAD_HEAD_BYTES + 8 * t + 15) // 16 * 16


@pytest.mark.parametrize("name,t,k,want", [
    ("probe", PROBE_T, PROBE_K, (3, _scratch(PROBE_T))),
    ("w8a", 301 * 302 // 2, 8 * 301, (0, 0)),
    ("a9a", 124 * 125 // 2, 8 * 124, (0, 0)),
    ("phishing", 69 * 70 // 2, 8 * 69, (0, 0)),
    ("w8a_k_is_T", 301 * 302 // 2, 301 * 302 // 2, (2, 8 * 65_536 + 8 * (301 * 302 // 2))),
    ("d350", 350 * 351 // 2, 8 * 350, (3, _scratch(350 * 351 // 2))),
    ("probe_k_is_1", PROBE_T, 1, (3, _scratch(PROBE_T))),
    ("probe_k_past_16384", PROBE_T, 16_385, (2, 8 * 32_768 + 8 * 16_385)),
    ("probe_k_32768", PROBE_T, 32_768, (2, 8 * 32_768 + 8 * 32_768)),
])
def test_toplek_plan_at_the_datasets_and_the_probe(name, t, k, want):
    assert tcs.toplek_plan_for(t, k, H100_SMEM_OPTIN) == want, name


def test_toplek_plan_edges():
    """Path 0 while the keys and composites fit, then the spread route (its
    shared memory the 8 P bytes of composites: 128 KB at k = 16,384), then
    path 2 once P reaches 32,768 (256 KB of composites)."""
    budget = H100_SMEM_OPTIN - tcs.TOPLEK_STATIC_SMEM
    fits = (budget - 8 * 4096) // 4 // 16 * 16
    assert tcs.toplek_plan_for(fits, 4096, H100_SMEM_OPTIN)[0] == 0
    assert tcs.toplek_plan_for(fits + 16, 4096, H100_SMEM_OPTIN)[0] == 3
    spread_budget = H100_SMEM_OPTIN - tcs.TOPLEK_SPREAD_STATIC_SMEM
    assert 8 * 16_384 <= spread_budget < 8 * 32_768
    for k in (1, 2, 4097, 8192, 12_000, 16_384):
        assert tcs.toplek_plan_for(PROBE_T, k, H100_SMEM_OPTIN)[0] == 3, k


@pytest.mark.parametrize("n_clients,want", [(8, 16), (1, 16), (9, 14), (66, 2), (132, 1),
                                            (142, 1)])
def test_toplek_spread_shares_the_sms(n_clients, want):
    """16 blocks a client at the probe's 8 clients (128 of 132 SMs)."""
    assert tcs.toplek_spread_for(n_clients, H100_SMS) == want


def _tie_rows(n_rows, t, seed):
    """Rows with few distinct magnitudes (small integers), so the k-th key
    is tied across many indices."""
    rng = np.random.default_rng(seed)
    return rng.integers(-3, 4, size=(n_rows, t)).astype(np.float64)


def _rows(kind, n_rows, t, seed):
    rng = np.random.default_rng(seed)
    return {
        "gaussian": lambda: rng.standard_normal((n_rows, t)),
        "ties": lambda: _tie_rows(n_rows, t, seed),
        "all_equal": lambda: np.full((n_rows, t), -0.75),
        "zeros": lambda: np.zeros((n_rows, t)),
        "dyadic": lambda: np.where(rng.random((n_rows, t)) < 0.5, -1.0, 1.0)
        * np.ldexp(1.0, -rng.integers(0, 11, size=(n_rows, t))),
    }[kind]()


@pytest.mark.parametrize("kind", ["gaussian", "ties", "all_equal", "zeros", "dyadic"])
@pytest.mark.parametrize("t,k,spread", [(3001, 40, 16), (5000, 1, 3), (4096, 4096, 5),
                                        (777, 300, 1)])
def test_spread_candidates_hold_the_topk_set(ref, kind, t, k, spread):
    """The candidate stage (tallies of the keys' top 12 bits by segment,
    bin*, the keys in bin* or above) and the finish's tie rule (keys above
    the k-th, and the need lowest-index ties) give exactly the reference's
    TopK index set; the candidates number at most T, fewer than k lie above
    bin* (the threshold is in bin*), and each segment's first slots count the
    candidates of its kind before it (those in bin* after all above it)."""
    u = _rows(kind, 3, t, t + k)
    keys = tsel.rank_keys(torch.as_tensor(u))
    for c in range(u.shape[0]):
        stage = spread_candidates_plain(keys[c], k, spread)
        cand = stage["index"]
        assert k <= len(cand) <= t and stage["above"] < k
        counts = stage["counts"]
        assert stage["first_slot"] == [
            (sum(n for n, _ in counts[:j]), stage["above"] + sum(n for _, n in counts[:j]))
            for j in range(spread)]
        assert len(cand) == stage["above"] + sum(n for _, n in counts)
        kept = spread_topk_set_plain(keys[c], cand, k)
        want = np.asarray(ref.sel.topk_indices(ref.jnp.asarray(u[c]), k))
        assert sorted(kept.tolist()) == sorted(want.tolist()), (kind, c)


def test_spread_candidates_at_the_all_equal_row_are_the_whole_row():
    """Every key in one bin: every entry is a candidate (the scratch holds T
    composites a client for this)."""
    keys = tsel.rank_keys(torch.full((10_000,), 2.5, dtype=torch.float64))
    stage = spread_candidates_plain(keys, 7, 4)
    assert len(stage["index"]) == 10_000 and stage["bin"] == keys.view(torch.int32)[0] >> 19
