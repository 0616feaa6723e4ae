"""The port's kernels: plain versions against the JAX reference (CPU), and
the CUDA kernels against their plain versions (``cuda`` marker, on a card).

Tolerances:
  * SYRK: 1e-13 x max(|Z|^T |h| |Z|) -- FP64 sums of n terms in another order;
  * TopK: bit-exact -- the selected values are copies and the zeros +0.0.

The JAX reference is imported inside a fixture, so the ``cuda`` tests also
collect on a machine without JAX; whether a card is present is decided
inside a fixture too.
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.compressors import select as tsel
from repro_torch.kernels import compressor_select as tcs
from repro_torch.kernels import hessian_syrk as ths
from repro_torch.kernels import ops as tops
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
    from repro.kernels.compressor_select import select_topk_pallas

    return types.SimpleNamespace(jnp=jnp, ops=jops, sel=jsel, topk_pallas=select_topk_pallas)


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


def _bits(a):
    return np.asarray(a, dtype=np.float64).view(np.int64)


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
# routing and wrapper checks (CPU)
# ---------------------------------------------------------------------------

def test_ops_route_cpu_tensors_to_plain_versions():
    tops.reset_launch_counts()
    z, hw = _syrk_inputs(2, 10, 7, seed=1)
    zt, ht = torch.as_tensor(z), torch.as_tensor(hw)
    assert torch.equal(tops.hessian_syrk_packed(zt, ht, 0.1), ths.hessian_syrk_packed_plain(zt, ht, 0.1))
    u = torch.as_tensor(near_tie_rows(2, 28, 0))
    got, sent = tops.select_topk(u, 5)
    assert torch.equal(got, tcs.select_topk_plain(u, 5)[0])
    assert sent.dtype == torch.int32 and sent.tolist() == [5, 5]
    assert tops.launch_counts() == {"hessian_syrk_packed": 0, "select_topk": 0}


def test_ops_refuse_other_devices():
    with pytest.raises(ValueError, match="no kernel for device"):
        tops.select_topk(torch.zeros(2, 6, device="meta", dtype=torch.float64), 2)
    with pytest.raises(ValueError, match="no kernel for device"):
        tops.hessian_syrk_packed(
            torch.zeros(1, 3, 2, device="meta", dtype=torch.float64),
            torch.zeros(1, 3, device="meta", dtype=torch.float64), 0.0,
        )


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
    assert tops.launch_counts() == {"hessian_syrk_packed": 0, "select_topk": 0}


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions (on a card)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize(
    "n_clients,n,d",
    [(142, 348, 301), (3, 40, 24), (2, 1, 65), (1, 33, 64), (5, 100, 129)],
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
@pytest.mark.parametrize(
    "n_rows,t,k",
    [(142, 45451, 2408), (3, 512, 100), (4, 257, 1), (4, 130, 130), (2, 1025, 1024), (8, 61425, 2800)],
)
def test_topk_kernel_bit_exact_cuda(cuda, n_rows, t, k):
    """Near-ties, a zero row and a row of exact ties; T = 61425 keeps the keys
    in device memory (they do not fit the shared memory of one block)."""
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
    assert tcs.keys_in_shared_memory(t, cuda) == (t * 4 + 128 <= 232448)
