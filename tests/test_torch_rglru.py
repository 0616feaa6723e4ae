"""The port's RG-LRU block (``repro_torch.models.rglru``) against
``repro.models.rglru`` on the CPU, the same numpy inputs through both.

Tolerances:
  * the log-depth scan against ``jax.lax.associative_scan`` (f32): rtol
    1e-5 of the largest |h|: the same combine applied in another tree, each
    product and sum rounded in f32;
  * the core and the block in f32: rtol 1e-5 of the output's largest
    magnitude; with bf16 inputs, 4 bf16 ulps of it (the LM tests'
    ``LOGIT_ULPS``);
  * decode steps: the same bounds on the outputs and on both state tensors.
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.models import rglru as trg

D_MODEL, LRU = 24, 32


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from repro.models import rglru as jrg

    return types.SimpleNamespace(jax=jax, jnp=jnp, rglru=jrg)


def _params(seed):
    rng = np.random.default_rng(seed)

    def dense(*shape):
        return rng.standard_normal(shape).astype(np.float32) / np.sqrt(shape[0])

    return {
        "w_x": dense(D_MODEL, LRU), "w_gate": dense(D_MODEL, LRU),
        "conv_w": 0.3 * rng.standard_normal((4, LRU)).astype(np.float32),
        "conv_b": 0.1 * rng.standard_normal(LRU).astype(np.float32),
        "w_r": dense(LRU, LRU), "b_r": 0.1 * rng.standard_normal(LRU).astype(np.float32),
        "w_i": dense(LRU, LRU), "b_i": 0.1 * rng.standard_normal(LRU).astype(np.float32),
        "lambda": rng.uniform(-1.0, 1.0, LRU).astype(np.float32),
        "w_out": dense(LRU, D_MODEL),
    }


def _both(ref, p):
    return {k: torch.as_tensor(v) for k, v in p.items()}, {k: ref.jnp.asarray(v) for k, v in p.items()}


def _pair(ref, x, dtype):
    xt = torch.as_tensor(x).to(getattr(torch, dtype))
    return xt, ref.jnp.asarray(xt.float().numpy()).astype(dtype)


def _close(got: torch.Tensor, want, dtype: str = "float32") -> None:
    want = np.asarray(want.astype("float32"))
    assert tuple(got.shape) == want.shape
    scale = float(np.abs(want).max())
    if dtype == "float32":
        tol = 1e-5 * scale
    else:
        _, e = np.frexp(np.float32(scale))
        tol = 4 * float(np.ldexp(1.0, int(e) - 8))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("seq", [1, 2, 7, 64, 1000])
def test_linear_scan_matches_associative_scan(ref, seq):
    rng = np.random.default_rng(seq)
    a = rng.uniform(0.0, 1.0, (2, seq, 5)).astype(np.float32)
    b = rng.standard_normal((2, seq, 5)).astype(np.float32)

    def combine(left, right):
        return left[0] * right[0], right[0] * left[1] + right[1]

    _, want = ref.jax.lax.associative_scan(combine, (ref.jnp.asarray(a), ref.jnp.asarray(b)), axis=1)
    got = trg.linear_scan(torch.as_tensor(a), torch.as_tensor(b))
    _close(got, want)
    # and the plain recurrence
    h, seqd = np.zeros((2, 5), np.float64), []
    for t in range(seq):
        h = a[:, t] * h + b[:, t]
        seqd.append(h)
    np.testing.assert_allclose(got.numpy(), np.stack(seqd, 1), rtol=0,
                               atol=1e-5 * float(np.abs(seqd).max()))


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_core_matches_reference(ref, with_h0):
    p = _params(1)
    pt, pj = _both(ref, p)
    x = np.random.default_rng(2).standard_normal((2, 50, LRU)).astype(np.float32)
    h0 = np.random.default_rng(3).standard_normal((2, LRU)).astype(np.float32) if with_h0 else None
    got, got_last = trg._rglru_core(torch.as_tensor(x), pt, None if h0 is None else torch.as_tensor(h0))
    want, want_last = ref.rglru._rglru_core(ref.jnp.asarray(x), pj,
                                            None if h0 is None else ref.jnp.asarray(h0))
    _close(got, want)
    _close(got_last, want_last)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_apply_matches_reference(ref, dtype):
    pt, pj = _both(ref, _params(4))
    x = np.random.default_rng(5).standard_normal((2, 37, D_MODEL)).astype(np.float32)
    xt, xj = _pair(ref, x, dtype)
    got = trg.rglru_apply(xt, pt)
    assert got.dtype == xt.dtype
    _close(got, ref.rglru.rglru_apply(xj, pj), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_decode_steps_match_reference(ref, dtype):
    """Six steps from a zero state: outputs, conv and h; the port's state
    tensors are updated in place."""
    pt, pj = _both(ref, _params(6))
    x = np.random.default_rng(7).standard_normal((3, 6, D_MODEL)).astype(np.float32)
    xt, xj = _pair(ref, x, dtype)
    state = {"conv": torch.zeros((3, 3, LRU), dtype=xt.dtype), "h": torch.zeros((3, LRU))}
    jstate = {"conv": ref.jnp.zeros((3, 3, LRU), dtype=dtype), "h": ref.jnp.zeros((3, LRU), ref.jnp.float32)}
    conv, h = state["conv"], state["h"]
    for s in range(6):
        got, state = trg.rglru_decode_step(xt[:, s : s + 1], state, pt)
        want, jstate = ref.rglru.rglru_decode_step(xj[:, s : s + 1], jstate, pj)
        _close(got, want, dtype)
        _close(state["conv"], jstate["conv"], dtype)
        _close(state["h"], jstate["h"], dtype)
    assert state["conv"] is conv and state["h"] is h


def test_decode_steps_equal_the_full_sequence():
    """The O(1) recurrence stepped over a prompt gives the scan's outputs
    (f32, rtol 1e-5 of the scale)."""
    p = {k: torch.as_tensor(v) for k, v in _params(8).items()}
    x = torch.as_tensor(np.random.default_rng(9).standard_normal((2, 30, D_MODEL)).astype(np.float32))
    full = trg.rglru_apply(x, p)
    state = {"conv": torch.zeros((2, 3, LRU)), "h": torch.zeros((2, LRU))}
    got = torch.cat([trg.rglru_decode_step(x[:, s : s + 1], state, p)[0] for s in range(30)], dim=1)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=0, atol=1e-5 * float(full.abs().max()))
