"""The port's MoE block (``repro_torch.models.moe``) against
``repro.models.moe`` on the CPU, the same numpy inputs through both.

Tolerances:
  * routing: exact.  The expert of every sorted assignment, its token, its
    place in its expert's queue and whether it is kept are equal to the
    reference's (``lax.top_k``, the stable ``argsort``, ``searchsorted``);
    the router's f32 logits of the two frameworks differ by ~1e-7, far
    below the smallest probability margin of these fixtures, and a forced
    tie (two equal router columns) keeps the lower expert first;
  * f32 outputs: rtol 1e-5 of the output's largest magnitude (f32 products
    and the combine's f32 sum in another order);
  * bf16 outputs: 2 bf16 ulps of the output's largest magnitude (the expert
    MLP rounds its bf16 activations at other places in XLA and PyTorch);
  * the auxiliary loss: f32 rtol 1e-6.
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.models import moe as tmoe

E, K, D, F = 4, 2, 32, 48


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from repro.models import moe as jmoe

    return types.SimpleNamespace(jax=jax, jnp=jnp, moe=jmoe)


def _ref_dispatch(ref, x, router, top_k, capacity_factor):
    """The reference's routing and queue positions (the lines of
    ``repro.models.moe.moe_apply`` before the dispatch)."""
    jnp, jax = ref.jnp, ref.jax
    t = x.shape[0] * x.shape[1]
    capacity = max(1, int(capacity_factor * t * top_k / router.shape[1]))
    logits = x.reshape(t, -1).astype(jnp.float32) @ router.astype(jnp.float32)
    gate_w, gate_i = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), top_k)
    gate_w = gate_w / jnp.sum(gate_w, axis=-1, keepdims=True)
    flat_e = gate_i.reshape(-1)
    order = jnp.argsort(flat_e)
    se = flat_e[order]
    pos = jnp.arange(t * top_k) - jnp.searchsorted(se, se, side="left")
    return {"se": se, "st": jnp.repeat(jnp.arange(t), top_k)[order],
            "sw": gate_w.reshape(-1)[order], "pos": pos, "keep": pos < capacity,
            "capacity": capacity}


def _params(seed, tie=False, glu=True):
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((D, E)).astype(np.float32) / np.sqrt(D),
         "w1": rng.standard_normal((E, D, F)).astype(np.float32) / np.sqrt(D),
         "w2": rng.standard_normal((E, F, D)).astype(np.float32) / np.sqrt(F)}
    if glu:
        p["w1g"] = rng.standard_normal((E, D, F)).astype(np.float32) / np.sqrt(D)
    if tie:  # experts 1 and 2 get the same logit on every token
        p["router"][:, 2] = p["router"][:, 1]
    return p


def _pair(ref, x, p, dtype):
    xt = torch.as_tensor(x).to(getattr(torch, dtype))
    xj = ref.jnp.asarray(xt.float().numpy()).astype(dtype)
    return xt, xj, {k: torch.as_tensor(v) for k, v in p.items()}, {
        k: ref.jnp.asarray(v) for k, v in p.items()}


def _assert_out(got, want, dtype):
    want = np.asarray(want.astype("float32"))
    got = got.float().numpy()
    scale = float(np.abs(want).max())
    if dtype == "float32":
        tol = 1e-5 * scale
    else:
        _, e = np.frexp(np.float32(scale))
        tol = 2 * float(np.ldexp(1.0, int(e) - 8))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


CASES = {  # name: (batch, seq, capacity_factor, tie)
    "no_drops": (2, 24, 4.0, False),
    "drops": (2, 24, 0.5, False),  # capacity 12 for 96 assignments
    "config_capacity": (3, 17, 1.25, False),
    "forced_tie": (2, 24, 1.25, True),
    "one_token": (1, 1, 1.25, False),
}


@pytest.mark.parametrize("case", CASES)
def test_dispatch_matches_reference_exactly(ref, case):
    b, s, cf, tie = CASES[case]
    x = np.random.default_rng(len(case)).standard_normal((b, s, D)).astype(np.float32)
    p = _params(1, tie)
    xt, xj, pt, pj = _pair(ref, x, p, "bfloat16")
    got = tmoe.moe_dispatch(xt, pt["router"], n_experts=E, top_k=K, capacity_factor=cf)
    want = _ref_dispatch(ref, xj, pj["router"], K, cf)
    assert got["capacity"] == want["capacity"]
    for key in ("se", "st", "pos", "keep"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(got["sw"].numpy(), np.asarray(want["sw"]), rtol=1e-6)
    if cf == 0.5:
        assert not bool(got["keep"].all())  # the capacity drops assignments
    if tie:
        _, _, gate_i = tmoe._route(xt.reshape(b * s, D), pt["router"], K)
        both = (gate_i == 1).any(-1) & (gate_i == 2).any(-1)
        one = (gate_i == 1).any(-1) ^ (gate_i == 2).any(-1)
        assert bool(one.any()), "no token has the tied pair at the k-th place"
        assert not bool(((gate_i == 2).any(-1) & ~both).any()), "2 kept before 1 on a tie"


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ["silu_glu", "gelu"])
def test_moe_apply_matches_reference(ref, case, dtype, activation):
    b, s, cf, tie = CASES[case]
    x = np.random.default_rng(len(case) + 7).standard_normal((b, s, D)).astype(np.float32)
    p = _params(2, tie, glu=activation == "silu_glu")
    xt, xj, pt, pj = _pair(ref, x, p, dtype)
    got = tmoe.moe_apply(xt, pt, n_experts=E, top_k=K, capacity_factor=cf, activation=activation)
    want = ref.moe.moe_apply(xj, pj, n_experts=E, top_k=K, capacity_factor=cf,
                             activation=activation)
    assert got.dtype == xt.dtype and tuple(got.shape) == (b, s, D)
    _assert_out(got, want, dtype)


def test_dropped_assignments_add_nothing(ref):
    """At capacity 1 a token whose assignments are all dropped gets 0."""
    x = np.random.default_rng(3).standard_normal((1, 8, D)).astype(np.float32)
    xt, _, pt, _ = _pair(ref, x, _params(3), "float32")
    r = tmoe.moe_dispatch(xt, pt["router"], n_experts=E, top_k=K, capacity_factor=0.1)
    assert r["capacity"] == 1
    kept = torch.zeros(8 * K, dtype=torch.bool)
    kept[r["order"]] = r["keep"]
    none_kept = ~kept.reshape(8, K).any(-1)
    assert bool(none_kept.any())
    out = tmoe.moe_apply(xt, pt, n_experts=E, top_k=K, capacity_factor=0.1, activation="silu_glu")
    assert not bool(out[0, none_kept].any())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tie", [False, True])
def test_moe_apply_dense_matches_reference(ref, dtype, tie):
    x = np.random.default_rng(4).standard_normal((3, 1, D)).astype(np.float32)
    p = _params(5, tie)
    xt, xj, pt, pj = _pair(ref, x, p, dtype)
    got = tmoe.moe_apply_dense(xt, pt, n_experts=E, top_k=K, activation="silu_glu")
    want = ref.moe.moe_apply_dense(xj, pj, n_experts=E, top_k=K, activation="silu_glu")
    _assert_out(got, want, dtype)


def test_dense_form_equals_dispatch_without_drops(ref):
    """With room for every assignment the two forms compute one function."""
    x = np.random.default_rng(6).standard_normal((2, 5, D)).astype(np.float32)
    xt, _, pt, _ = _pair(ref, x, _params(6), "float32")
    a = tmoe.moe_apply(xt, pt, n_experts=E, top_k=K, capacity_factor=float(E), activation="gelu")
    b = tmoe.moe_apply_dense(xt, pt, n_experts=E, top_k=K, activation="gelu")
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5 * float(b.abs().max()))


@pytest.mark.parametrize("tie", [False, True])
def test_moe_aux_loss_matches_reference(ref, tie):
    x = np.random.default_rng(7).standard_normal((2, 24, D)).astype(np.float32)
    p = _params(7, tie)
    xt, xj, pt, pj = _pair(ref, x, p, "float32")
    got = tmoe.moe_aux_loss(xt, pt["router"], n_experts=E, top_k=K)
    want = ref.moe.moe_aux_loss(xj, pj["router"], n_experts=E, top_k=K)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_combine_is_deterministic():
    """The same inputs give the same bits twice (no scatter-add over
    colliding rows)."""
    x = torch.as_tensor(np.random.default_rng(8).standard_normal((2, 24, D)).astype(np.float32))
    p = {k: torch.as_tensor(v) for k, v in _params(8).items()}
    a = tmoe.moe_apply(x, p, n_experts=E, top_k=K, capacity_factor=1.25, activation="silu_glu")
    b = tmoe.moe_apply(x, p, n_experts=E, top_k=K, capacity_factor=1.25, activation="silu_glu")
    assert torch.equal(a, b)
