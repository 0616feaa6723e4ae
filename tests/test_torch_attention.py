"""The port's attention and layers against the JAX package (CPU), and the
flash kernel against its plain version (``cuda`` marker, on a card).

Tolerances:
  * flash, f32: atol 2e-5, the JAX package's own bound between its Pallas
    kernel and the dense reference (tests/test_kernels.py);
  * every bf16 comparison counts bf16 ulps per element, the ulp taken at
    the larger magnitude of the pair and at no less than
    ``BF16_ULP_FLOOR`` = 2**-14 (``bf16_ulps``): both sides compute in f32
    and round once, so two f32 results a few f32 ulps apart may round to
    neighbouring bf16 values, and near 0 the two f32 sums' own rounding
    (~1e-7 absolute) exceeds a bf16 ulp of the output;
  * flash and chunked attention, bf16: one ulp, on the CPU and on the card;
  * P.V as three bf16-part products (``split_bf16x3``) against one f32
    product: 4 f32 ulps of the largest |v| -- the same exact products,
    summed in another order;
  * rope, rms_norm: f32 rtol/atol 1e-6 (cos, sin, rsqrt may differ by one
    f32 ulp between XLA and PyTorch); bf16 one ulp;
  * mlp_apply in f32: rtol 1e-5 (matrix products summed in another order);
    in bf16 two ulps of the output's largest magnitude (XLA rounds the fused
    activation once, PyTorch after each op);
  * decode_attention, bf16: one bf16 ulp.

The JAX reference is imported inside a fixture; whether a card is present is
decided inside a fixture too.
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as tl

# tests/test_kernels.py's six flash shapes: (sq, sk, heads, dh, causal, window)
FLASH_SHAPES = [
    (128, 128, 2, 64, True, None),
    (256, 256, 4, 64, True, 64),
    (200, 200, 2, 32, True, None),  # padded seq
    (96, 96, 1, 16, False, None),  # bidirectional + padding
    (256, 256, 2, 64, False, 128),
    (64, 256, 1, 32, False, None),  # cross-attention shape
]
# recurrentgemma-2b's head_dim with its one kv head (the Pallas kernel takes
# as many kv heads as query heads)
FLASH_SHAPES_DH256 = [
    (128, 128, 1, 256, True, None),
    (192, 192, 1, 256, True, 64),
]


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from repro.kernels import ops as jops
    from repro.kernels.ref import flash_attention_ref
    from repro.models import layers as jl

    return types.SimpleNamespace(jnp=jnp, ops=jops, layers=jl, flash_ref=flash_attention_ref)


@pytest.fixture
def cuda():
    """The first CUDA device; skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _normal(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _to_np(a):
    return np.asarray(a.astype("float32")) if hasattr(a, "astype") else np.asarray(a)


def _bf16_pair(ref, x):
    """x rounded to bf16 in both frameworks (the same values)."""
    t = torch.as_tensor(x).to(torch.bfloat16)
    return t, ref.jnp.asarray(t.float().numpy()).astype(ref.jnp.bfloat16)


def _ulps(got: torch.Tensor, want: np.ndarray, floor: float = tfa.BF16_ULP_FLOOR) -> float:
    return float(tfa.bf16_ulps(got, torch.as_tensor(np.array(want)), floor).max())


# ---------------------------------------------------------------------------
# flash attention: the plain version against the Pallas kernel (interpret)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sq,sk,hn,dh,causal,window", FLASH_SHAPES)
def test_flash_plain_matches_pallas_f32(ref, sq, sk, hn, dh, causal, window):
    q, k, v = (_normal(s, sq + sk + i) for i, s in enumerate([(sq, hn, dh), (sk, hn, dh), (sk, hn, dh)]))
    want = ref.ops.flash_attention(
        ref.jnp.asarray(q), ref.jnp.asarray(k), ref.jnp.asarray(v), causal=causal,
        window=window, block_q=64, block_k=64, interpret=True)
    got = tops.flash_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                               causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == (sq, hn, dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("sq,sk,hn,dh,causal,window", FLASH_SHAPES + FLASH_SHAPES_DH256)
def test_flash_plain_matches_pallas_bf16(ref, sq, sk, hn, dh, causal, window):
    q, k, v = (_normal(s, 7 * sq + sk + i) for i, s in enumerate([(sq, hn, dh), (sk, hn, dh), (sk, hn, dh)]))
    (qt, qj), (kt, kj), (vt, vj) = (_bf16_pair(ref, x) for x in (q, k, v))
    want = ref.ops.flash_attention(qj, kj, vj, causal=causal, window=window,
                                   block_q=64, block_k=64, interpret=True)
    got = tops.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    assert _ulps(got, _to_np(want)) <= 1.0


@pytest.mark.parametrize("sq,sk,hn,dh,causal,window", FLASH_SHAPES)
def test_port_dense_ref_matches_jax_ref(ref, sq, sk, hn, dh, causal, window):
    q, k, v = (_normal(s, sq + 3 * sk + i) for i, s in enumerate([(sq, hn, dh), (sk, hn, dh), (sk, hn, dh)]))
    want = ref.flash_ref(ref.jnp.asarray(q), ref.jnp.asarray(k), ref.jnp.asarray(v),
                         causal=causal, window=window)
    got = tref.flash_attention_ref(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                                   causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    plain = tfa.flash_attention_plain(torch.as_tensor(q)[None], torch.as_tensor(k)[None],
                                      torch.as_tensor(v)[None], causal=causal, window=window,
                                      q_chunk=48)
    np.testing.assert_allclose(plain[0].numpy(), got.numpy(), atol=2e-5, rtol=0)


def test_flash_plain_gqa_equals_repeated_heads():
    """GQA in the plain version reads kv head h // (H // Kv): the same as
    repeating each kv head H // Kv times."""
    q, k, v = (torch.as_tensor(_normal(s, 11 + i)) for i, s in
               enumerate([(2, 70, 8, 32), (2, 70, 2, 32), (2, 70, 2, 32)]))
    got = tfa.flash_attention_plain(q, k, v, causal=True, window=20, q_chunk=32)
    want = tfa.flash_attention_plain(q, tl._repeat_kv(k, 4), tl._repeat_kv(v, 4),
                                     causal=True, window=20, q_chunk=32)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


def test_flash_plain_fully_masked_rows_are_zero():
    """Queries past Sk with a window see no key: 0, as the kernel writes."""
    q = torch.as_tensor(_normal((1, 12, 2, 16), 3))
    k, v = (torch.as_tensor(_normal((1, 4, 2, 16), s)) for s in (4, 5))
    out = tfa.flash_attention_plain(q, k, v, causal=True, window=3)
    assert torch.equal(out[:, 6:], torch.zeros_like(out[:, 6:]))
    assert bool((out[:, :6].abs().sum(-1) > 0).all())


def test_bf16_ulps_counts_spacing():
    one = torch.tensor([1.0, 1.0, 0.5, 3.0, 0.0])
    nxt = torch.tensor([1.0 + 2**-7, 1.0 - 2**-8, 0.5 + 2**-8, 3.0 + 2**-5, 0.0])
    assert tfa.bf16_ulps(nxt, one).tolist() == [1.0, 0.5, 1.0, 2.0, 0.0]
    assert tfa.bf16_ulps(torch.tensor([2**-20]), torch.tensor([0.0]), floor=2**-12).item() == 2**-20 / 2**-19


# ---------------------------------------------------------------------------
# the wgmma route's function: P.V at f32 p as three bf16 products
# ---------------------------------------------------------------------------

def _split_exact(p: torch.Tensor) -> torch.Tensor:
    parts = tfa.split_bf16x3(p)
    for part in parts:
        assert part.dtype == torch.bfloat16
    return sum(part.double() for part in parts) - p.double()


def test_split_bf16x3_is_exact():
    """p1 + p2 + p3 == p bit for bit over 10**6 f32 values in [2**-110, 1]:
    log-uniform draws, uniform draws, and exp outputs near 0 and near 1."""
    rng = np.random.default_rng(0)
    log_uniform = np.exp2(rng.uniform(-110.0, 0.0, 400_000))
    uniform = rng.uniform(0.0, 1.0, 300_000)
    near_one = np.exp(-rng.uniform(0.0, 1e-3, 150_000))
    near_zero = np.exp(-rng.uniform(70.0, 76.0, 150_000))  # down to about 2**-110
    p = torch.as_tensor(np.concatenate([log_uniform, uniform, near_one, near_zero]).astype(np.float32))
    p = p[p >= 2.0**-110]
    assert p.numel() > 990_000 and float(p.max()) <= 1.0
    assert float(_split_exact(p).abs().max()) == 0.0
    assert float(_split_exact(torch.tensor([1.0, 2.0**-110, 1.0 - 2.0**-24]))
                 .abs().max()) == 0.0


def test_split_bf16x3_below_2_to_minus_110_loses_under_2_to_minus_126():
    rng = np.random.default_rng(1)
    tiny = np.exp2(rng.uniform(-149.0, -110.0, 200_000)).astype(np.float32)
    p = torch.as_tensor(np.concatenate([tiny, np.float32([2.0**-149, 2.0**-126, 2.0**-111])]))
    assert float(p.min()) > 0.0
    assert float(_split_exact(p).abs().max()) < 2.0**-126


def _plain_split_pv(q, k, v, causal, window):
    """flash_attention_plain's function with P.V taken as P1 V + P2 V + P3 V
    (the wgmma kernel's formulation), in f32, before rounding to q's dtype."""
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, kv, h // kv, dh)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) * dh**-0.5
    qpos, kpos = torch.arange(sq)[:, None], torch.arange(sk)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = logits.masked_fill(~mask, tfa.NEG)
    p = torch.where(mask, torch.exp(logits - logits.amax(-1, keepdim=True)), 0.0)
    denom = p.sum(-1, keepdim=True)
    o = sum(torch.einsum("bgrqk,bkgd->bgrqd", part.float(), v.float())
            for part in tfa.split_bf16x3(p))
    o = o / torch.where(denom > 0, denom, 1.0)
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh)


@pytest.mark.parametrize(
    "b,sq,sk,h,kv,dh,causal,window",
    [
        (2, 300, 300, 8, 2, 64, True, None),
        (1, 200, 200, 4, 4, 128, True, 50),
        (1, 64, 256, 4, 1, 64, False, None),
        (1, 130, 130, 8, 1, 64, True, 129),
        (1, 200, 200, 4, 1, 256, True, None),  # recurrentgemma's head_dim, one kv head
        (1, 200, 200, 4, 1, 256, True, 70),
    ],
)
def test_flash_plain_with_split_pv_matches_plain(b, sq, sk, h, kv, dh, causal, window):
    """The function argument of the wgmma route, on the CPU: with bf16 q, k, v,
    P.V at f32 p equals the sum of the three bf16-part products up to f32
    rounding."""
    rng = np.random.default_rng(sq + dh)
    q, k, v = (torch.as_tensor(rng.standard_normal(s).astype(np.float32)).to(torch.bfloat16)
               for s in [(b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh)])
    got = _plain_split_pv(q, k, v, causal, window)
    want = tfa.flash_attention_plain(q.float(), k.float(), v.float(), causal=causal, window=window)
    tol = 4 * float(np.spacing(np.float32(v.float().abs().max())))
    assert float((got - want).abs().max()) <= tol


def test_flash_route_is_a_function_of_dtype_and_head_dim():
    for dtype in (torch.bfloat16, torch.float32):
        for dh in tfa.HEAD_DIMS:
            want = "wgmma" if dtype == torch.bfloat16 and dh in (64, 128, 256) else "simt"
            assert tfa.flash_route(dtype, dh) == want
    assert tfa.WGMMA_HEAD_DIMS == (64, 128, 256)
    assert tfa.flash_route(torch.bfloat16, 256) == "wgmma"
    assert tfa.flash_route(torch.float32, 256) == "simt"


@pytest.mark.parametrize(
    "sq,sk,causal,window",
    [(1, 1, True, None), (37, 37, True, None), (37, 37, True, 5), (50, 20, True, None),
     (20, 50, True, None), (40, 70, False, None), (40, 70, False, 9), (33, 33, True, 100),
     (64, 64, True, 1)],
)
def test_visible_pairs_matches_brute_force(sq, sk, causal, window):
    i, j = np.arange(sq)[:, None], np.arange(sk)[None, :]
    mask = np.ones((sq, sk), dtype=bool)
    if causal:
        mask &= j <= i
    if window is not None:
        mask &= j > i - window
    assert tfa.visible_pairs(sq, sk, causal, window) == int(mask.sum())


# ---------------------------------------------------------------------------
# chunked attention (the models' entry) against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "b,s,h,kv,dh,window,q_chunk",
    [
        (2, 64, 4, 2, 32, None, 16),
        (2, 96, 4, 2, 32, 24, 32),
        (1, 80, 4, 4, 16, 33, 32),  # q_chunk does not divide S: one chunk
        (2, 128, 4, 1, 32, 100, 32),  # window wider than a chunk
        (1, 96, 2, 1, 256, 40, 32),  # recurrentgemma's head_dim and one kv head
    ],
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_attention_matches_reference(ref, b, s, h, kv, dh, window, q_chunk, dtype):
    q, k, v = (_normal(sh, s + h + i) for i, sh in enumerate([(b, s, h, dh), (b, s, kv, dh), (b, s, kv, dh)]))
    if dtype == "float32":
        pairs = [(torch.as_tensor(x), ref.jnp.asarray(x)) for x in (q, k, v)]
    else:
        pairs = [_bf16_pair(ref, x) for x in (q, k, v)]
    (qt, qj), (kt, kj), (vt, vj) = pairs
    want = ref.layers.chunked_attention(qj, kj, vj, causal=True, window=window, q_chunk=q_chunk)
    got = tl.chunked_attention(qt, kt, vt, causal=True, window=window, q_chunk=q_chunk)
    assert got.dtype == qt.dtype and got.shape == (b, s, h, dh)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    else:
        assert _ulps(got, _to_np(want)) <= 1.0
    # the kernel's plain version computes the same function on this causal path
    plain = tops.attention(qt, kt, vt, causal=True, window=window)
    if dtype == "float32":
        np.testing.assert_allclose(plain.numpy(), got.numpy(), atol=2e-5, rtol=0)
    else:
        assert float(tfa.bf16_ulps(plain, got, tfa.BF16_ULP_FLOOR).max()) <= 1.0


# a window without causality: the reference's key slice per query chunk drops
# the keys after the chunk, but where the clip at 0 widens the first chunks'
# slice (window + q_chunk - 1 > q_start + q_chunk)
WINDOW_NONCAUSAL = [
    (2, 96, 4, 2, 32, 24, 32),
    (1, 128, 4, 1, 16, 100, 32),  # the first three chunks' slices widened by the clip
    (2, 64, 2, 2, 32, 8, 16),
    (1, 80, 4, 4, 16, 33, 32),  # q_chunk does not divide S: one chunk
    (1, 60, 2, 1, 32, 200, 20),  # window wider than S: every slice is all keys
]


@pytest.mark.parametrize("b,s,h,kv,dh,window,q_chunk", WINDOW_NONCAUSAL)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_attention_window_without_causality_matches_reference(
    ref, b, s, h, kv, dh, window, q_chunk, dtype
):
    """The CPU path and the card path's chunk loop (``window_chunk_attention``,
    here on the kernel's plain version with the chunks' offsets) both compute
    the reference's function."""
    q, k, v = (_normal(sh, 7 * s + window + i)
               for i, sh in enumerate([(b, s, h, dh), (b, s, kv, dh), (b, s, kv, dh)]))
    if dtype == "float32":
        pairs = [(torch.as_tensor(x), ref.jnp.asarray(x)) for x in (q, k, v)]
    else:
        pairs = [_bf16_pair(ref, x) for x in (q, k, v)]
    (qt, qj), (kt, kj), (vt, vj) = pairs
    want = ref.layers.chunked_attention(qj, kj, vj, causal=False, window=window, q_chunk=q_chunk)
    got = tl.chunked_attention(qt, kt, vt, causal=False, window=window, q_chunk=q_chunk)
    chunks = tl.window_chunk_attention(qt, kt, vt, window, q_chunk)
    for out in (got, chunks):
        assert out.dtype == qt.dtype and out.shape == (b, s, h, dh)
        if dtype == "float32":
            np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-5, rtol=0)
        else:
            assert _ulps(out, _to_np(want)) <= 1.0


def test_window_slices_are_the_reference_slices():
    """(q_start, q_len, k_start, span) as the reference's one_chunk slices."""
    assert tl.window_slices(128, 128, 100, 32) == [
        (0, 32, 0, 131 - 3), (32, 32, 0, 128), (64, 32, 0, 128), (96, 32, 0, 128)]
    assert tl.window_slices(96, 96, 24, 32) == [(0, 32, 0, 55), (32, 32, 9, 55), (64, 32, 41, 55)]
    assert tl.window_slices(80, 80, 33, 32) == [(0, 80, 0, 80)]
    # the kernel's function on whole sequences is the offsets' zero case
    q, k, v = (torch.as_tensor(_normal((1, 40, 2, 16), 90 + i)) for i in range(3))
    whole = tfa.flash_attention_plain(q, k, v, causal=False, window=9)
    # queries from 11 on see no key before 3
    shifted = tfa.flash_attention_plain(q[:, 11:], k[:, 3:], v[:, 3:], causal=False, window=9,
                                        q_offset=11, k_offset=3)
    np.testing.assert_allclose(shifted.numpy(), whole[:, 11:].numpy(), atol=2e-6, rtol=0)


def test_chunked_attention_noncausal_matches_reference(ref):
    q, k, v = (_normal((1, 48, 2, 16), 40 + i) for i in range(3))
    want = ref.layers.chunked_attention(*(ref.jnp.asarray(x) for x in (q, k, v)),
                                        causal=False, q_chunk=16)
    got = tl.chunked_attention(*(torch.as_tensor(x) for x in (q, k, v)), causal=False, q_chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fraction", [1.0, 0.5])
@pytest.mark.parametrize("pos_ndim", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_reference(ref, fraction, pos_ndim, dtype):
    x = _normal((2, 40, 3, 32), 1) * 3
    pos = np.arange(40) * 37 + 5
    if pos_ndim == 2:
        pos = np.stack([pos, pos[::-1] + 1])
    if dtype == "float32":
        xt, xj = torch.as_tensor(x), ref.jnp.asarray(x)
    else:
        xt, xj = _bf16_pair(ref, x)
    want = ref.layers.rope(xj, ref.jnp.asarray(pos, dtype=ref.jnp.int32), fraction, 10000.0)
    got = tl.rope(xt, torch.as_tensor(pos, dtype=torch.int32), fraction, 10000.0)
    assert got.dtype == xt.dtype
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    else:
        assert _ulps(got, _to_np(want)) <= 1.0
    if fraction == 0.5:  # the second half of the head passes through
        assert torch.equal(got[..., 16:], xt[..., 16:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_reference(ref, dtype):
    x = _normal((2, 5, 64), 2) * 4
    scale = _normal((64,), 3) * 0.1  # "1 + scale": zero-initialised scales are the identity
    xt, xj = (torch.as_tensor(x), ref.jnp.asarray(x)) if dtype == "float32" else _bf16_pair(ref, x)
    want = ref.layers.rms_norm(xj, ref.jnp.asarray(scale), 1e-6)
    got = tl.rms_norm(xt, torch.as_tensor(scale), 1e-6)
    assert got.dtype == xt.dtype
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    else:
        assert _ulps(got, _to_np(want)) <= 1.0


@pytest.mark.parametrize("activation", ["silu_glu", "sq_relu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_apply_matches_reference(ref, activation, dtype):
    d, f = 64, 96
    x = _normal((2, 6, d), 4)
    p = {"w1": _normal((d, f), 5) / 8, "w2": _normal((f, d), 6) / 10}
    if activation == "silu_glu":
        p["w1g"] = _normal((d, f), 7) / 8
    xt, xj = (torch.as_tensor(x), ref.jnp.asarray(x)) if dtype == "float32" else _bf16_pair(ref, x)
    want = _to_np(ref.layers.mlp_apply(xj, {k: ref.jnp.asarray(w) for k, w in p.items()}, activation))
    got = tl.mlp_apply(xt, {k: torch.as_tensor(w) for k, w in p.items()}, activation)
    assert got.dtype == xt.dtype
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    else:
        assert _ulps(got, want, floor=float(np.abs(want).max())) <= 2.0


@pytest.mark.parametrize("cur_len,ring", [(1, False), (7, False), (12, True), (5, True)])
def test_decode_attention_matches_reference(ref, cur_len, ring):
    q, kc, vc = (_normal(s, 20 + i) for i, s in enumerate([(2, 1, 4, 32), (2, 9, 2, 32), (2, 9, 2, 32)]))
    (qt, qj), (kt, kj), (vt, vj) = (_bf16_pair(ref, x) for x in (q, kc, vc))
    want = ref.layers.decode_attention(qj, kj, vj, ref.jnp.asarray(cur_len), ring=ring)
    got = tl.decode_attention(qt, kt, vt, cur_len, ring=ring)
    assert got.dtype == torch.bfloat16
    assert _ulps(got, _to_np(want)) <= 1.0


def test_cross_entropy_matches_reference(ref):
    logits = _normal((2, 7, 50), 8) * 3
    labels = np.random.default_rng(9).integers(-1, 50, size=(2, 7))
    want = float(ref.layers.cross_entropy(ref.jnp.asarray(logits), ref.jnp.asarray(labels)))
    got = float(tl.cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels)))
    assert abs(got - want) <= 1e-6 * abs(want)


# ---------------------------------------------------------------------------
# the kernel's wrapper here, and the kernel on a card
# ---------------------------------------------------------------------------

def test_flash_cuda_wrapper_refuses_before_building():
    q = torch.zeros(1, 8, 2, 64)
    before = tops.launch_counts()["flash_attention"]
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_cuda(q, q, q)
    with pytest.raises(TypeError, match="bf16 or f32"):
        tfa.flash_attention_cuda(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="divide"):
        tfa.flash_attention_cuda(torch.zeros(1, 8, 3, 64), q, q)
    assert tops.launch_counts()["flash_attention"] == before


def _card_case(cuda, b, sq, sk, h, kv, dh, dtype, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=cuda).to(dtype)
            for shape in ((b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh))]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,sq,sk,h,kv,dh,causal,window",
    [(1, sq, sk, hn, hn, dh, causal, window) for sq, sk, hn, dh, causal, window in FLASH_SHAPES]
    + [
        (3, 300, 300, 4, 2, 64, True, None),  # B > 1, GQA
        (1, 1024, 1024, 32, 8, 64, True, None),  # granite's heads
        (2, 777, 777, 8, 2, 128, True, 200),  # window, padding, dh 128
        (1, 5, 5, 32, 8, 64, True, None),  # a 5-token prompt
        (2, 64, 256, 4, 4, 32, False, None),  # Sq != Sk
    ],
)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_matches_plain_cuda(cuda, b, sq, sk, h, kv, dh, causal, window, dtype):
    q, k, v = _card_case(cuda, b, sq, sk, h, kv, dh, dtype, sq + sk + dh)
    before = tfa.flash_attention_cuda.launches
    got = tops.attention(q, k, v, causal=causal, window=window)
    assert tfa.flash_attention_cuda.launches == before + 1
    want = tfa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 2e-5
    else:
        assert float(tfa.bf16_ulps(got, want, tfa.BF16_ULP_FLOOR).max()) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,sq,sk,h,kv,dh,causal,window",
    [
        (1, 300, 300, 8, 8, 64, True, None),  # GQA ratio 1
        (2, 300, 300, 8, 2, 64, True, None),  # ratio 4, B > 1
        (1, 777, 777, 16, 2, 64, True, None),  # ratio 8
        (1, 5, 5, 32, 8, 64, True, None),  # a 5-token prompt
        (3, 1000, 1000, 8, 2, 128, True, None),  # dh 128, B > 1
        (1, 1000, 1000, 4, 1, 64, True, 200),  # a window crossing tile edges
        (2, 777, 777, 8, 2, 128, True, 300),
        (1, 1024, 1024, 32, 8, 64, True, None),  # whole tiles
        (2, 64, 256, 4, 4, 64, False, None),  # non-causal, Sq != Sk
        (1, 300, 1000, 8, 4, 128, False, None),
    ],
)
def test_flash_wgmma_route_matches_plain_cuda(cuda, b, sq, sk, h, kv, dh, causal, window):
    """bf16 at head_dim 64 and 128 takes the wgmma kernel, once, within one
    bf16 ulp of the plain version."""
    q, k, v = _card_case(cuda, b, sq, sk, h, kv, dh, torch.bfloat16, 3 * sq + sk + dh)
    tops.reset_launch_counts()
    got = tops.attention(q, k, v, causal=causal, window=window)
    assert tfa.flash_attention_cuda.route_launches == {"wgmma": 1, "simt": 0}
    want = tfa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    assert float(tfa.bf16_ulps(got, want, tfa.BF16_ULP_FLOOR).max()) <= 1.0


@pytest.mark.cuda
def test_flash_simt_route_takes_bf16_dh32_cuda(cuda):
    q, k, v = _card_case(cuda, 2, 300, 300, 8, 2, 32, torch.bfloat16, 32)
    tops.reset_launch_counts()
    got = tops.attention(q, k, v, causal=True, window=100)
    assert tfa.flash_attention_cuda.route_launches == {"wgmma": 0, "simt": 1}
    want = tfa.flash_attention_plain(q, k, v, causal=True, window=100)
    torch.cuda.synchronize()
    assert float(tfa.bf16_ulps(got, want, tfa.BF16_ULP_FLOOR).max()) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,sq,sk,h,kv,dh,causal,window,q_offset,k_offset",
    [
        (1, 1000, 1000, 10, 1, 256, True, 300, 0, 0),  # recurrentgemma's heads, a window
        (2, 300, 300, 4, 2, 256, True, None, 0, 0),
        (1, 64, 200, 4, 4, 256, False, None, 0, 0),  # Sq != Sk
        (2, 1000, 1000, 8, 2, 256, True, 300, 0, 0),  # Kv 2, a window and Sq not multiples of 64
        (1, 300, 700, 4, 1, 256, False, 300, 500, 100),  # a window without causality at an offset
    ],
)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_head_dim_256_takes_simt_cuda(cuda, b, sq, sk, h, kv, dh, causal, window, q_offset,
                                            k_offset, dtype):
    """head_dim 256 runs the wgmma kernel in bf16 and the SIMT kernel in f32,
    once, within one bf16 ulp (f32: 2e-5) of the plain version."""
    q, k, v = _card_case(cuda, b, sq, sk, h, kv, dh, dtype, sq + 2 * sk)
    tops.reset_launch_counts()
    offsets = dict(q_offset=q_offset, k_offset=k_offset)
    got = tops.attention(q, k, v, causal=causal, window=window, **offsets)
    want_routes = {"wgmma": 1, "simt": 0} if dtype == torch.bfloat16 else {"wgmma": 0, "simt": 1}
    assert tfa.flash_attention_cuda.route_launches == want_routes
    want = tfa.flash_attention_plain(q, k, v, causal=causal, window=window, **offsets)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape and bool(torch.isfinite(got).all())
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 2e-5
    else:
        assert float(tfa.bf16_ulps(got, want, tfa.BF16_ULP_FLOOR).max()) <= 1.0


@pytest.mark.cuda
def test_chunked_attention_on_card_is_one_launch(cuda):
    q, k, v = _card_case(cuda, 2, 96, 96, 4, 2, 32, torch.bfloat16, 5)
    before = tfa.flash_attention_cuda.launches
    got = tl.chunked_attention(q, k, v, causal=True, window=40, q_chunk=32)
    assert tfa.flash_attention_cuda.launches == before + 1
    want = tl.chunked_attention(q.cpu(), k.cpu(), v.cpu(), causal=True, window=40, q_chunk=32)
    assert float(tfa.bf16_ulps(got.cpu(), want, tfa.BF16_ULP_FLOOR).max()) <= 1.0
    # a window without causality: one launch per query chunk on its key slice
    before = tfa.flash_attention_cuda.launches
    got = tl.chunked_attention(q, k, v, causal=False, window=40, q_chunk=32)
    assert tfa.flash_attention_cuda.launches == before + 3
    want = tl.chunked_attention(q.cpu(), k.cpu(), v.cpu(), causal=False, window=40, q_chunk=32)
    assert float(tfa.bf16_ulps(got.cpu(), want, tfa.BF16_ULP_FLOOR).max()) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,s,h,kv,dh,window,q_chunk,dtype",
    [
        (1, 2048, 8, 2, 128, 300, 512, torch.bfloat16),  # the wgmma route
        (2, 2048, 8, 2, 32, 300, 512, torch.float32),  # the SIMT route
        (1, 1000, 4, 1, 64, 700, 200, torch.bfloat16),  # widened first slices
        (1, 2048, 10, 1, 256, 300, 512, torch.bfloat16),  # the wgmma route at head_dim 256
    ],
)
def test_window_without_causality_kernel_matches_plain_cuda(cuda, b, s, h, kv, dh, window,
                                                            q_chunk, dtype):
    """Each chunk's launch with its offsets against the plain version on the
    same chunk and offsets."""
    q, k, v = _card_case(cuda, b, s, s, h, kv, dh, dtype, s + window)
    slices = tl.window_slices(s, s, window, q_chunk)
    tops.reset_launch_counts()
    got = tl.chunked_attention(q, k, v, causal=False, window=window, q_chunk=q_chunk)
    route = tfa.flash_route(dtype, dh)
    assert tfa.flash_attention_cuda.route_launches[route] == len(slices)
    want = torch.cat([
        tfa.flash_attention_plain(q[:, q0:q0 + n], k[:, k0:k0 + span], v[:, k0:k0 + span],
                                  causal=False, window=window, q_offset=q0, k_offset=k0)
        for q0, n, k0, span in slices], dim=1)
    torch.cuda.synchronize()
    assert got.shape == q.shape and bool(torch.isfinite(got).all())
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 2e-5
    else:
        assert float(tfa.bf16_ulps(got, want, tfa.BF16_ULP_FLOOR).max()) <= 1.0
