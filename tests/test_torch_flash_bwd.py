"""Flash attention's gradient in the port: the plain backward against
``jax.vjp`` of the reference's ``chunked_attention`` (CPU), the autograd
Function, and the backward kernels against the plain backward (``cuda``
marker, on a card).

Tolerances, each gradient measured against its own scale (its largest
magnitude in the reference):
  * bf16 against ``jax.vjp``: 4 bf16 ulps of the scale.  Both sides take
    f32 logits, f32 p and f32 sums and round each gradient to bf16; they
    differ in where: the port sums dk and dv in f32 over every query chunk
    and every query head of a kv head and rounds once, where XLA rounds dk
    and dv to bf16 per query chunk and sums the repeated kv heads
    (``_repeat_kv``'s transpose) and the chunks in bf16.  Measured worst on
    these fixtures: 1.19 ulps (dv, one kv head under 4 query heads);
  * f32 against ``jax.vjp``: 1e-5 of the scale (the same f32 function, sums
    in other orders);
  * the plain backward against autograd through ``flash_attention_plain``
    in f32: 1e-5 of the scale;
  * the Function on the CPU: its gradient is the plain backward's, bit for
    bit (the same calls);
  * the wgmma route's arithmetic emulated on the CPU (P and dS split into
    three bf16 parts, each part's product bf16 x bf16 in f32, the parts'
    products added in f32) against the plain backward: 2 bf16 ulps of the
    scale, the bound the kernels are held to on the card;
  * the share of each bf16 gradient's nonzero elements that differ from
    the plain backward's (``differ_share``): at most ``BWD_DIFFER_SHARE``
    (0.2) for the split emulation and the kernels, and above it for the
    control, P and dS rounded to bf16 once (``round_p_ds``, SDPA's
    function), which 2 ulps of the scale cannot tell from the split;
  * on the card (``cuda``): the kernels against the plain backward on the
    same O and lse, bf16 within 2 bf16 ulps of the scale (both sum in f32
    and round once) and within the differ share, with the control beyond
    it, f32 within 1e-5 of the scale; the training forward's O
    rounded to bf16 is the inference kernel's output bit for bit.

The JAX reference is imported inside a fixture; whether a card is present is
decided inside a fixture too.
"""

import math
import threading
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.models import layers as tl

BF16_ULPS = 4  # against jax.vjp, of each gradient's scale (see the module docstring)
F32_RTOL = 1e-5
CARD_BF16_ULPS = 2

# (b, sq, sk, h, kv, dh, causal, window, q_chunk)
FIXTURES = {
    "causal_kv2": (2, 64, 64, 4, 2, 32, True, None, 16),
    "causal_window_kv4": (1, 80, 80, 4, 4, 16, True, 24, 16),
    "noncausal_kv1": (2, 48, 48, 4, 1, 32, False, None, 16),
    "cross_sq_ne_sk": (1, 40, 72, 4, 2, 16, False, None, 16),
    "sq_not_multiple_of_chunk": (1, 50, 50, 4, 2, 16, True, None, 16),
    "causal_sq_lt_sk": (1, 32, 48, 4, 1, 16, True, None, 16),
}


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from repro.models import layers as jl

    return types.SimpleNamespace(jax=jax, jnp=jnp, layers=jl)


@pytest.fixture
def cuda():
    """The first CUDA device; skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _inputs(b, sq, sk, h, kv, dh, dtype, seed):
    """q, k, v and the output's gradient do, from numpy draws, in ``dtype``."""
    rng = np.random.default_rng(seed)
    shapes = ((b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh), (b, sq, h, dh))
    return [torch.as_tensor(rng.standard_normal(s).astype(np.float32)).to(dtype) for s in shapes]


def _to_jax(ref, t):
    dtype = ref.jnp.bfloat16 if t.dtype == torch.bfloat16 else ref.jnp.float32
    return ref.jnp.asarray(t.float().numpy()).astype(dtype)


def _ulps_of_scale(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| in bf16 ulps of want's largest magnitude."""
    scale = float(want.float().abs().max())
    ulp = 2.0 ** (math.frexp(scale)[1] - 8)
    return float((got.float() - want.float()).abs().max()) / ulp


def _rel_of_scale(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max()) / float(want.float().abs().max())


def _check(got, want, dtype, ulps=BF16_ULPS):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype == dtype and g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        if dtype == torch.bfloat16:
            assert _ulps_of_scale(g, w) <= ulps, (name, _ulps_of_scale(g, w))
        else:
            assert _rel_of_scale(g, w) <= F32_RTOL, (name, _rel_of_scale(g, w))


def _jax_vjp(ref, q, k, v, do, causal, window, q_chunk):
    """(dq, dk, dv) of the reference's chunked_attention, as torch tensors."""
    def f(q_, k_, v_):
        return ref.layers.chunked_attention(q_, k_, v_, causal=causal, window=window,
                                            q_chunk=q_chunk)

    _, vjp = ref.jax.vjp(f, *(_to_jax(ref, t) for t in (q, k, v)))
    return [torch.as_tensor(np.asarray(g.astype(ref.jnp.float32))).to(q.dtype)
            for g in vjp(_to_jax(ref, do))]


def _plain_grads(q, k, v, do, **kw):
    o, lse = tfa.flash_attention_train_plain(q, k, v, **kw)
    return tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)


# ---------------------------------------------------------------------------
# the plain backward against the reference (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("name", list(FIXTURES))
def test_plain_backward_matches_jax_vjp_of_chunked_attention(ref, name, dtype):
    b, sq, sk, h, kv, dh, causal, window, q_chunk = FIXTURES[name]
    q, k, v, do = _inputs(b, sq, sk, h, kv, dh, dtype, seed=len(name))
    want = _jax_vjp(ref, q, k, v, do, causal, window, q_chunk)
    _check(_plain_grads(q, k, v, do, causal=causal, window=window), want, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_window_without_causality_matches_jax_vjp(ref, dtype):
    """The C4 path: ``window_chunk_attention`` (one Function call per query
    chunk on the reference's key slice, with offsets) under autograd against
    ``jax.vjp`` of ``chunked_attention(causal=False, window=...)``."""
    q, k, v, do = _inputs(2, 64, 64, 4, 2, 16, dtype, seed=3)
    want = _jax_vjp(ref, q, k, v, do, False, 20, 16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tl.window_chunk_attention(*leaves, 20, 16)
    got = torch.autograd.grad(out, leaves, do)
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_fully_masked_rows_have_zero_gradient(ref, dtype):
    """Sq > Sk under a window without causality: queries 23.. see no key.
    The kernel's function gives them 0 (the reference's softmax averages
    every key of the slice), so their gradient is 0 and their do reaches
    nothing; with do zero on them, the reference agrees."""
    sq, sk, window, q_chunk = 64, 16, 8, 16
    q, k, v, do = _inputs(1, sq, sk, 4, 2, 16, dtype, seed=5)
    masked = torch.arange(sq) >= sk + window - 1
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tl.window_chunk_attention(*leaves, window, q_chunk)
    assert bool((out[:, masked] == 0).all())
    dq, dk, dv = torch.autograd.grad(out, leaves, do)
    assert bool((dq[:, masked] == 0).all())
    do_kept = torch.where(masked[None, :, None, None], torch.zeros_like(do), do)
    again = torch.autograd.grad(tl.window_chunk_attention(*leaves, window, q_chunk), leaves,
                                do_kept)
    assert all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again))
    _check(again, _jax_vjp(ref, q, k, v, do_kept, False, window, q_chunk), dtype)


@pytest.mark.parametrize("q_offset,k_offset,causal,window", [
    (0, 0, True, None), (0, 0, False, None), (0, 0, True, 7), (5, 0, False, 9),
    (0, 12, True, None),  # queries 0..11 see no key
    (3, 10, True, 4),
])
def test_plain_backward_matches_autograd_through_plain_forward(q_offset, k_offset, causal,
                                                               window):
    q, k, v, do = _inputs(2, 37, 29, 4, 2, 16, torch.float32, seed=q_offset + k_offset)
    kw = dict(causal=causal, window=window, q_offset=q_offset, k_offset=k_offset)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tfa.flash_attention_plain(*leaves, q_chunk=16, **kw)
    want = torch.autograd.grad(out, leaves, do)
    _check(_plain_grads(q, k, v, do, q_chunk=16, **kw), want, torch.float32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_function_on_the_cpu_is_the_plain_backward(dtype):
    q, k, v, do = _inputs(2, 40, 40, 4, 2, 32, dtype, seed=7)
    kw = dict(causal=True, window=12, q_offset=0, k_offset=0)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tops.attention(*leaves, **kw)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    assert torch.equal(out, tfa.flash_attention_plain(q, k, v, **kw))
    got = torch.autograd.grad(out, leaves, do)
    want = _plain_grads(q, k, v, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_without_grad_attention_is_the_inference_call():
    q, k, v, _ = _inputs(1, 24, 24, 4, 2, 16, torch.bfloat16, seed=9)
    out = tops.attention(q, k, v, causal=True)  # nothing requires grad
    assert out.grad_fn is None
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    with torch.no_grad():
        assert tops.attention(*leaves, causal=True).grad_fn is None
    assert torch.equal(out, tfa.flash_attention_plain(q, k, v, causal=True))


def test_flash_bwd_route():
    """bf16 at head_dim 64, 128 and 256 on the wgmma backward, as on the
    forward; f32 everywhere and bf16 at 16 and 32 on the SIMT one."""
    for dh in tfa.HEAD_DIMS:
        assert tfa.flash_bwd_route(torch.float32, dh) == "simt"
        want = "wgmma" if dh in (64, 128, 256) else "simt"
        assert tfa.flash_bwd_route(torch.bfloat16, dh) == want
    assert tfa.flash_route(torch.bfloat16, 256) == "wgmma"
    assert tfa.flash_bwd_route(torch.bfloat16, 256) == "wgmma"


def _emulated_wgmma_grads(q, k, v, o, lse, do, *, causal, window, q_offset=0, k_offset=0,
                          n_split=1):
    """The wgmma backward's arithmetic on the CPU, head by head: S and dP
    products of bf16 inputs in f32, p = exp(s - lse) on the visible keys, dS
    = p (dP - D) with D = rowsum(dO O); then each of dV, dQ and dK as the sum
    of three products, one per bf16 part of P or dS (``split_bf16x3``), each
    bf16 x bf16 in f32; dk and dv summed over the kv head's query heads in
    f32, each gradient rounded to bf16 once.  At head_dim 256 each 64-key
    tile's dk and dv are summed as the dkdv kernel's cluster of ``n_split``
    blocks sums them (``_cluster_dkdv``); which consumer forms which product (dq's column
    split, dkdv's role split) leaves every element's sum as it is."""
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    rep = h // kv
    s = dh**-0.5
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    qpos = q_offset + torch.arange(sq)[:, None]
    kpos = k_offset + torch.arange(sk)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    dq = torch.zeros(q.shape)
    dk, dv = torch.zeros(k.shape), torch.zeros(v.shape)
    ds_parts, p_parts = {}, {}
    for hh in range(h):
        g = hh // rep
        logits = qf[:, :, hh] @ kf[:, :, g].transpose(1, 2) * s
        p = torch.where(mask, torch.exp(logits - lse[:, hh, :, None]), 0.0)
        dp = dof[:, :, hh] @ vf[:, :, g].transpose(1, 2)
        ds = p * (dp - (dof[:, :, hh] * o[:, :, hh]).sum(-1)[..., None])
        for part in tfa.split_bf16x3(ds):
            dq[:, :, hh] += part.float() @ kf[:, :, g]
        ds_parts[hh], p_parts[hh] = tfa.split_bf16x3(ds), tfa.split_bf16x3(p)
        if dh != 256:
            for part in ds_parts[hh]:
                dk[:, :, g] += part.float().transpose(1, 2) @ qf[:, :, hh]
            for part in p_parts[hh]:
                dv[:, :, g] += part.float().transpose(1, 2) @ dof[:, :, hh]
    if dh == 256:
        dk, dv = _cluster_dkdv(qf, dof, ds_parts, p_parts, kv, n_split, causal=causal,
                               window=window, pos_off=q_offset - k_offset)
    return (dq * s).to(q.dtype), (dk * s).to(k.dtype), dv.to(v.dtype)


def _cluster_dkdv(qf, dof, ds_parts, p_parts, kv, n, *, causal, window, pos_off):
    """dk / scale and dv in f32 as the head_dim-256 dkdv kernel sums them
    with a cluster of n blocks a key tile (the launcher's ``split``): for
    each 64-key tile, the T (query head, 64-query tile) pairs that see it
    in order, rank r summing pairs [r T / n, (r + 1) T / n) from zero, and
    the n partial sums added in rank order."""
    b, sq, h, _ = qf.shape
    sk = ds_parts[0][0].shape[2]
    rep = h // kv
    dk = torch.zeros((b, sk, kv, qf.shape[3]))
    dv = torch.zeros_like(dk)
    for k0 in range(0, sk, 64):
        keys = slice(k0, min(sk, k0 + 64))
        q_begin, q_end = 0, sq
        if causal:
            q_begin = min(sq, max(0, k0 - pos_off))
        if window is not None:
            q_end = max(0, min(sq, k0 - pos_off + 63 + window))
        per_head = -(-(q_end - q_begin) // 64) if q_end > q_begin else 0
        for g in range(kv):
            total = rep * per_head
            sums = []
            for r in range(n):
                part_k, part_v = torch.zeros_like(dk[:, keys, g]), torch.zeros_like(dv[:, keys, g])
                for f in range(r * total // n, (r + 1) * total // n):
                    hh, q0 = g * rep + f // per_head, q_begin + f % per_head * 64
                    rows = slice(q0, q0 + 64)
                    for part in ds_parts[hh]:
                        part_k += part[:, rows, keys].float().transpose(1, 2) @ qf[:, rows, hh]
                    for part in p_parts[hh]:
                        part_v += part[:, rows, keys].float().transpose(1, 2) @ dof[:, rows, hh]
                sums.append((part_k, part_v))
            for part_k, part_v in sums:  # the cluster's partial sums in rank order
                dk[:, keys, g] += part_k
                dv[:, keys, g] += part_v
    return dk, dv


# (b, sq, sk, h, kv, dh, causal, window, q_offset, k_offset): FIXTURES' shapes
# and masks on whole sequences, and rows with no visible key (lse = +inf)
EMULATED = {
    **{name: (*spec[:8], 0, 0) for name, spec in FIXTURES.items()},
    "rows_with_no_key_causal": (1, 48, 40, 4, 2, 16, True, None, 0, 12),
    "rows_with_no_key_window": (2, 64, 16, 4, 2, 32, False, 8, 8, 0),
    # head_dim 256: Kv 1 under a window with Sq off the 64-row tiles, C4's
    # offsets, Sq != Sk without causality, rows with no visible key; the
    # dkdv kernel's cluster of EMULATED_SPLIT blocks a key tile
    "dh256_kv1_window": (1, 100, 100, 10, 1, 256, True, 40, 0, 0),
    "dh256_c4_offsets": (1, 70, 90, 4, 2, 256, False, 30, 40, 20),
    "dh256_noncausal_cross": (2, 40, 72, 4, 1, 256, False, None, 0, 0),
    "rows_with_no_key_dh256": (1, 48, 40, 4, 1, 256, True, None, 0, 12),
    "dh256_kv1_window_split1": (1, 100, 100, 10, 1, 256, True, 40, 0, 0),
    "dh256_kv1_window_split3": (1, 100, 100, 10, 1, 256, True, 40, 0, 0),
    "dh256_c4_offsets_split2": (1, 70, 90, 4, 2, 256, False, 30, 40, 20),
    "dh256_noncausal_cross_split5": (2, 40, 72, 4, 1, 256, False, None, 0, 0),
}
# the cluster size n of each head_dim-256 fixture: 8, what the launcher
# takes on an H100 for so few key tiles, and other n, uneven shares too
EMULATED_SPLIT = {"dh256_kv1_window": 8, "dh256_c4_offsets": 8, "dh256_noncausal_cross": 8,
                  "rows_with_no_key_dh256": 8, "dh256_kv1_window_split1": 1,
                  "dh256_kv1_window_split3": 3, "dh256_c4_offsets_split2": 2,
                  "dh256_noncausal_cross_split5": 5}


@pytest.mark.parametrize("name", list(EMULATED))
def test_split_products_emulation_matches_plain_backward(name):
    """dV, dQ and dK formed as the wgmma kernels form them (three bf16
    parts of P or dS, each part's product exact in f32) are the plain
    backward's within the card's bound; rows with no visible key get 0."""
    b, sq, sk, h, kv, dh, causal, window, q_off, k_off = EMULATED[name]
    q, k, v, do = _inputs(b, sq, sk, h, kv, dh, torch.bfloat16, seed=len(name) + 100)
    kw = dict(causal=causal, window=window, q_offset=q_off, k_offset=k_off)
    o, lse = tfa.flash_attention_train_plain(q, k, v, **kw)
    got = _emulated_wgmma_grads(q, k, v, o, lse, do, n_split=EMULATED_SPLIT.get(name, 1), **kw)
    want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    _check(got, want, torch.bfloat16, ulps=CARD_BF16_ULPS)
    no_key = ~torch.isfinite(lse)  # (b, h, sq)
    assert bool(no_key.any()) == name.startswith("rows_with_no_key")
    assert bool((got[0].permute(0, 2, 1, 3)[no_key] == 0).all())


@pytest.mark.parametrize("name", list(EMULATED))
def test_differ_share_tells_the_split_from_one_rounding(name):
    """The split products round like the plain backward but for a few
    elements; P and dS rounded to bf16 once (SDPA's function, the control)
    change the rounding of many more: the share bound passes the one and
    rejects the other, at every gradient."""
    b, sq, sk, h, kv, dh, causal, window, q_off, k_off = EMULATED[name]
    q, k, v, do = _inputs(b, sq, sk, h, kv, dh, torch.bfloat16, seed=len(name) + 100)
    kw = dict(causal=causal, window=window, q_offset=q_off, k_offset=k_off)
    o, lse = tfa.flash_attention_train_plain(q, k, v, **kw)
    want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    split = _emulated_wgmma_grads(q, k, v, o, lse, do, n_split=EMULATED_SPLIT.get(name, 1),
                                  **kw)
    control = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, round_p_ds=True, **kw)
    for gname, g, c, w in zip(("dq", "dk", "dv"), split, control, want):
        assert tfa.differ_share(g, w) <= tfa.BWD_DIFFER_SHARE, (gname, tfa.differ_share(g, w))
        assert tfa.differ_share(c, w) > tfa.BWD_DIFFER_SHARE, (gname, tfa.differ_share(c, w))


def test_differ_share_counts_nonzero_elements():
    want = torch.tensor([0.0, 0.0, 1.0, 2.0, 3.0, 4.0])
    got = torch.tensor([0.0, 0.5, 1.0, 2.0, 3.0, 4.5])
    assert tfa.differ_share(got, want) == pytest.approx(2 / 5)
    assert tfa.differ_share(torch.zeros(3), torch.zeros(3)) == 0.0


def test_split_bf16x3_is_exact_for_gradients():
    """dS takes both signs and spans many binades: its three bf16 parts add
    back to it exactly in f32 where |dS| >= 2**-110 (split_bf16x3)."""
    rng = np.random.default_rng(13)
    x = torch.as_tensor(rng.standard_normal(4096).astype(np.float32)
                        * np.exp2(rng.integers(-100, 20, 4096)).astype(np.float32))
    p1, p2, p3 = tfa.split_bf16x3(x)
    assert torch.equal((p1.float() + p2.float()) + p3.float(), x)


def test_train_plain_lse_is_the_log_sum_exp_and_inf_where_nothing_is_visible():
    q, k, v, _ = _inputs(1, 20, 16, 2, 1, 16, torch.float32, seed=11)
    o, lse = tfa.flash_attention_train_plain(q, k, v, causal=True, k_offset=4)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k.expand(-1, -1, 2, -1)) * 16**-0.5
    pos_q, pos_k = torch.arange(20)[:, None], torch.arange(16)[None, :] + 4
    want = torch.logsumexp(logits.masked_fill(pos_k > pos_q, -torch.inf), dim=-1)
    assert bool(torch.isinf(lse[:, :, :4]).all()) and bool((o[:, :4] == 0).all())
    torch.testing.assert_close(lse[:, :, 4:], want[:, :, 4:], rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# (b, sq, sk, h, kv, dh, causal, window, q_offset, k_offset, dtype): the
# routes (bf16 wgmma at 64/128/256, SIMT at 16/32 and in f32), GQA, windows,
# Sq != Sk, rows with no visible key, C4's offsets
CARD_FIXTURES = {
    "bf16_dh64_causal_kv8": (2, 300, 300, 32, 8, 64, True, None, 0, 0, torch.bfloat16),
    "bf16_dh128_window_kv2": (1, 257, 257, 8, 2, 128, True, 100, 0, 0, torch.bfloat16),
    "bf16_dh256_window_kv1": (1, 200, 200, 4, 1, 256, True, 64, 0, 0, torch.bfloat16),
    "bf16_dh32_noncausal": (2, 130, 70, 8, 2, 32, False, None, 0, 0, torch.bfloat16),
    "bf16_dh16_offsets": (1, 96, 80, 4, 4, 16, False, 30, 64, 40, torch.bfloat16),
    "bf16_dh64_no_visible_rows": (1, 128, 128, 4, 2, 64, True, None, 0, 20, torch.bfloat16),
    "f32_dh64_causal": (2, 200, 200, 8, 2, 64, True, None, 0, 0, torch.float32),
    "f32_dh256_window": (1, 160, 160, 2, 1, 256, True, 50, 0, 0, torch.float32),
    "f32_dh128_offsets": (1, 100, 150, 4, 2, 128, False, 40, 30, 0, torch.float32),
    # the wgmma backward: Sq != Sk without causality, a window, C4's offsets,
    # Sq not a multiple of the 128-query (dq) or 64-query (dk/dv) tile, and
    # B H Sq rows of lse whose heads start off 16-byte alignment (Sq odd)
    "bf16_dh64_noncausal_cross": (2, 200, 333, 8, 2, 64, False, None, 0, 0, torch.bfloat16),
    "bf16_dh64_window_kv4": (1, 301, 301, 8, 4, 64, True, 77, 0, 0, torch.bfloat16),
    "bf16_dh128_offsets": (1, 100, 150, 4, 2, 128, False, 40, 30, 0, torch.bfloat16),
    "bf16_dh128_sq_not_tile": (2, 190, 190, 4, 1, 128, True, None, 0, 0, torch.bfloat16),
    # ... at head_dim 256 (the dq kernel's 64-query tiles, the dkdv kernel's
    # (query head, query tile) pairs of a key tile split over a cluster)
    "bf16_dh256_noncausal_cross": (2, 200, 333, 10, 2, 256, False, None, 0, 0, torch.bfloat16),
    "bf16_dh256_offsets": (1, 100, 150, 4, 1, 256, False, 40, 30, 0, torch.bfloat16),
    "bf16_dh256_sq_not_tile": (2, 333, 333, 10, 1, 256, True, 64, 0, 0, torch.bfloat16),
    "bf16_dh256_no_visible_rows": (1, 128, 128, 4, 2, 256, True, None, 0, 20, torch.bfloat16),
    # the training layers of seamless (MHA, H = Kv, without causality) and
    # llava (a window below S, S off the 64-query tiles) at head_dim 64 and 128
    "bf16_dh64_mha_noncausal": (2, 200, 200, 8, 8, 64, False, None, 0, 0, torch.bfloat16),
    "bf16_dh128_window_below_s": (1, 300, 300, 8, 2, 128, True, 100, 0, 0, torch.bfloat16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_FIXTURES))
def test_backward_kernels_match_plain_backward_on_card(cuda, name):
    b, sq, sk, h, kv, dh, causal, window, q_off, k_off, dtype = CARD_FIXTURES[name]
    q, k, v, do = (t.to(cuda) for t in _inputs(b, sq, sk, h, kv, dh, dtype, seed=len(name)))
    kw = dict(causal=causal, window=window, q_offset=q_off, k_offset=k_off)
    o, lse = tfa.flash_attention_train_cuda(q, k, v, **kw)
    o_plain, lse_plain = tfa.flash_attention_train_plain(q, k, v, **kw)
    finite = torch.isfinite(lse_plain)
    assert torch.equal(torch.isfinite(lse), finite)
    torch.testing.assert_close(lse[finite], lse_plain[finite], rtol=1e-5, atol=1e-5)
    assert _rel_of_scale(o, o_plain) <= 1e-5
    tops.reset_launch_counts()
    got = tfa.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    _check(got, want, dtype, ulps=CARD_BF16_ULPS)
    if dtype == torch.bfloat16:
        control = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, round_p_ds=True, **kw)
        for gname, g, c, w in zip(("dq", "dk", "dv"), got, control, want):
            assert tfa.differ_share(g, w) <= tfa.BWD_DIFFER_SHARE, (gname, tfa.differ_share(g, w))
            assert tfa.differ_share(c, w) > tfa.BWD_DIFFER_SHARE, (gname, tfa.differ_share(c, w))
    again = tfa.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics
    route = tfa.flash_bwd_route(dtype, dh)
    for fn in (tfa.flash_attention_bwd_dq_cuda, tfa.flash_attention_bwd_dkdv_cuda):
        assert fn.route_launches == {"wgmma": 0, "simt": 0, route: 2}
    if route == "wgmma" and dh == 256:  # dk and dv summed as the launcher's cluster sums
        n = tfa.flash_bwd_dkdv_grid(b, sk, kv)["split"]
        cpu = [t.cpu() for t in (q, k, v, o, lse, do)]
        emulated = _emulated_wgmma_grads(*cpu, n_split=n, **kw)
        _check([g.cpu() for g in got], emulated, dtype, ulps=CARD_BF16_ULPS)
        for gname, g, e in zip(("dq", "dk", "dv"), got, emulated):
            assert tfa.differ_share(g.cpu(), e) <= tfa.BWD_DIFFER_SHARE, gname


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,dh", [(torch.bfloat16, 64), (torch.bfloat16, 256),
                                      (torch.bfloat16, 32), (torch.float32, 64)])
def test_training_forward_rounds_to_the_inference_output(cuda, dtype, dh):
    q, k, v, _ = (t.to(cuda) for t in _inputs(2, 333, 333, 8, 2, dh, dtype, seed=dh))
    for kw in (dict(causal=True), dict(causal=False, window=50, q_offset=100, k_offset=40)):
        o, _ = tfa.flash_attention_train_cuda(q, k, v, **kw)
        assert torch.equal(o.to(dtype), tfa.flash_attention_cuda(q, k, v, **kw))


@pytest.mark.cuda
def test_wgmma_kernels_launch_from_a_fresh_thread(cuda):
    """The tensor maps' encoding reads the thread's current context: a
    thread that has made no CUDA runtime call (an autograd worker; here a
    plain thread, its tensors from PyTorch's cache) launches the wgmma
    forward and backward as the main thread does, to the same bits."""
    q, k, v, do = (t.to(cuda) for t in _inputs(1, 200, 200, 8, 2, 64, torch.bfloat16, seed=3))
    o, lse = tfa.flash_attention_train_cuda(q, k, v, causal=True)
    want = (o, *tfa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True))
    got = []
    worker = threading.Thread(target=lambda: got.extend(
        (tfa.flash_attention_train_cuda(q, k, v, causal=True)[0],
         *tfa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True))))
    worker.start()
    worker.join()
    torch.cuda.synchronize()
    assert len(got) == 4 and all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_function_on_card_launches_training_forward_and_backward(cuda):
    q, k, v, do = (t.to(cuda) for t in _inputs(2, 256, 256, 8, 2, 64, torch.bfloat16, seed=1))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    tops.reset_launch_counts()
    out = tops.attention(*leaves, causal=True)
    got = torch.autograd.grad(out, leaves, do)
    counts = tops.launch_counts()
    assert counts["flash_attention"] == 0 and counts["flash_attention_train"] == 1
    assert counts["flash_attention_bwd_dq"] == counts["flash_attention_bwd_dkdv"] == 1
    assert tfa.flash_attention_train_cuda.route_launches == {"wgmma": 1, "simt": 0}
    assert tfa.flash_attention_bwd_dq_cuda.route_launches == {"wgmma": 1, "simt": 0}
    assert tfa.flash_attention_bwd_dkdv_cuda.route_launches == {"wgmma": 1, "simt": 0}
    o, lse = tfa.flash_attention_train_plain(q, k, v, causal=True)
    _check(got, tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True), torch.bfloat16,
           ulps=CARD_BF16_ULPS)
