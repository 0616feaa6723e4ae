"""The port's SSD mixer (``repro_torch.models.ssm``) against
``repro.models.ssm`` on the CPU, the same numpy inputs through both.

Tolerances:
  * f32 (inputs and params): rtol 2e-5 of the output's largest magnitude:
    the chunked products, the exponentials and the scan over chunks are f32
    in both, summed in other orders;
  * bf16 inputs (the models' case): 4 bf16 ulps of the output's largest
    magnitude, the LM tests' ``LOGIT_ULPS``: the conv, gate and projections
    round bf16 activations at other places in XLA and PyTorch;
  * the decode state (f32) after a prompt: rtol 2e-5 in f32, and in bf16
    4 bf16 ulps of its largest magnitude.
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.models import ssm as tssm

D_MODEL, N, P, EXPAND, CW = 32, 8, 8, 2, 4
DI = EXPAND * D_MODEL
NH = DI // P


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from repro.models import ssm as jssm

    return types.SimpleNamespace(jax=jax, jnp=jnp, ssm=jssm)


def _params(seed):
    rng = np.random.default_rng(seed)
    conv_dim = DI + 2 * N
    return {
        "in_proj": rng.standard_normal((D_MODEL, 2 * DI + 2 * N + NH)).astype(np.float32) / np.sqrt(D_MODEL),
        "conv_w": 0.3 * rng.standard_normal((CW, conv_dim)).astype(np.float32),
        "conv_b": 0.1 * rng.standard_normal(conv_dim).astype(np.float32),
        "dt_bias": 0.5 * rng.standard_normal(NH).astype(np.float32),
        "A_log": 0.5 * rng.standard_normal(NH).astype(np.float32),
        "D": 1.0 + 0.1 * rng.standard_normal(NH).astype(np.float32),
        "gate_norm": 0.1 * rng.standard_normal(DI).astype(np.float32),
        "out_proj": rng.standard_normal((DI, D_MODEL)).astype(np.float32) / np.sqrt(DI),
    }


def _pair(ref, x, dtype):
    xt = torch.as_tensor(x).to(getattr(torch, dtype))
    return xt, ref.jnp.asarray(xt.float().numpy()).astype(dtype)


def _tol(want: np.ndarray, dtype: str) -> float:
    scale = float(np.abs(want).max())
    if dtype == "float32":
        return 2e-5 * scale
    _, e = np.frexp(np.float32(scale))
    return 4 * float(np.ldexp(1.0, int(e) - 8))


def _close(got: torch.Tensor, want, dtype: str) -> None:
    want = np.asarray(want.astype("float32"))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=_tol(want, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_reference(ref, dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 13, 24)).astype(np.float32)
    w, b = 0.3 * rng.standard_normal((CW, 24)).astype(np.float32), rng.standard_normal(24).astype(np.float32)
    xt, xj = _pair(ref, x, dtype)
    got = tssm.causal_conv(xt, torch.as_tensor(w), torch.as_tensor(b))
    want = ref.ssm._causal_conv(xj, ref.jnp.asarray(w), ref.jnp.asarray(b))
    assert got.dtype == xt.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("seq,chunk", [(64, 16), (48, 16), (50, 16), (7, 16)],
                         ids=["4_chunks", "3_chunks", "chunk_does_not_divide", "shorter_than_chunk"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_apply_matches_reference(ref, seq, chunk, dtype):
    p = _params(1)
    x = np.random.default_rng(seq).standard_normal((2, seq, D_MODEL)).astype(np.float32)
    xt, xj = _pair(ref, x, dtype)
    kw = dict(d_state=N, head_dim=P, expand=EXPAND, chunk=chunk)
    got = tssm.ssd_apply(xt, {k: torch.as_tensor(v) for k, v in p.items()}, **kw)
    want = ref.ssm.ssd_apply(xj, {k: ref.jnp.asarray(v) for k, v in p.items()}, **kw)
    assert got.dtype == xt.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("seq,chunk", [(64, 8), (50, 16)], ids=["8_chunks", "chunk_does_not_divide"])
def test_ssd_apply_gradients_match_reference(ref, seq, chunk):
    """The backward through the chunk scan (the states entering each chunk,
    stacked once): the gradients of x and of every leaf against
    ``jax.vjp`` of the reference's mixer on the same cotangent, f32, within
    1e-4 of each gradient's largest magnitude (the f32 sums of the backward's
    products, in other orders, over up to 8 chunks)."""
    p = _params(2)
    rng = np.random.default_rng(seq + chunk)
    x = rng.standard_normal((2, seq, D_MODEL)).astype(np.float32)
    cot = rng.standard_normal((2, seq, D_MODEL)).astype(np.float32)
    kw = dict(d_state=N, head_dim=P, expand=EXPAND, chunk=chunk)
    xt = torch.as_tensor(x).requires_grad_()
    pt = {k: torch.as_tensor(v).requires_grad_() for k, v in p.items()}
    tssm.ssd_apply(xt, pt, **kw).backward(torch.as_tensor(cot))
    grads = ref.jax.jit(lambda xj, pj, c: ref.jax.vjp(
        lambda a, b: ref.ssm.ssd_apply(a, b, **kw), xj, pj)[1](c))
    gx, gp = grads(ref.jnp.asarray(x), {k: ref.jnp.asarray(v) for k, v in p.items()},
                   ref.jnp.asarray(cot))
    for name, got, want in [("x", xt.grad, gx)] + [(k, pt[k].grad, gp[k]) for k in sorted(p)]:
        want = np.asarray(want)
        assert got is not None and tuple(got.shape) == want.shape, name
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()), err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_decode_steps_match_reference(ref, dtype):
    """Six decode steps from a zero state against the reference's steps:
    outputs and both state tensors; the port's state is updated in place."""
    p = _params(2)
    pt, pj = {k: torch.as_tensor(v) for k, v in p.items()}, {k: ref.jnp.asarray(v) for k, v in p.items()}
    x = np.random.default_rng(3).standard_normal((3, 6, D_MODEL)).astype(np.float32)
    xt, xj = _pair(ref, x, dtype)
    tdt = xt.dtype
    state = {"conv": torch.zeros((3, CW - 1, DI + 2 * N), dtype=tdt),
             "ssm": torch.zeros((3, NH, P, N), dtype=torch.float32)}
    jstate = {"conv": ref.jnp.zeros((3, CW - 1, DI + 2 * N), dtype=dtype),
              "ssm": ref.jnp.zeros((3, NH, P, N), dtype=ref.jnp.float32)}
    kw = dict(d_state=N, head_dim=P, expand=EXPAND)
    conv, ssm = state["conv"], state["ssm"]
    for s in range(6):
        got, state = tssm.ssd_decode_step(xt[:, s : s + 1], state, pt, **kw)
        want, jstate = ref.ssm.ssd_decode_step(xj[:, s : s + 1], jstate, pj, **kw)
        _close(got, want, dtype)
        _close(state["conv"], jstate["conv"], dtype)
        _close(state["ssm"], jstate["ssm"], dtype)
    assert state["conv"] is conv and state["ssm"] is ssm


def test_decode_steps_equal_the_full_sequence():
    """The recurrence stepped over a prompt gives the chunked form's
    outputs (f32, rtol 2e-5 of the scale): the two are one function."""
    p = {k: torch.as_tensor(v) for k, v in _params(4).items()}
    x = torch.as_tensor(np.random.default_rng(5).standard_normal((2, 40, D_MODEL)).astype(np.float32))
    full = tssm.ssd_apply(x, p, d_state=N, head_dim=P, expand=EXPAND, chunk=8)
    state = {"conv": torch.zeros((2, CW - 1, DI + 2 * N)), "ssm": torch.zeros((2, NH, P, N))}
    steps = [tssm.ssd_decode_step(x[:, s : s + 1], state, p, d_state=N, head_dim=P, expand=EXPAND)[0]
             for s in range(40)]
    got = torch.cat(steps, dim=1)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=0, atol=2e-5 * float(full.abs().max()))


@pytest.fixture
def cuda():
    """The first CUDA device; skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_tf32_is_refused_on_the_card(cuda):
    x = torch.zeros(1, 4, D_MODEL, device=cuda)
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="TF32"):
            tssm.check_f32_matmul(x)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
