"""LM training in the port against the JAX package (CPU): the synthetic token
stream, AdamW, EF21, ``lm_loss`` and ``encdec_loss`` with their gradients
for every family, rematerialisation, ``make_train_step`` with and without
gradient accumulation, and the training launcher.  Weights are the
reference's (``init_lm_params`` / ``init_encdec_params``), carried over as
numpy; batches are numpy from a seed.

Tolerances:
  * the synthetic batches, EF21's index sets and values, the hybrid's
    untaken-branch gradients (0) and the three remat policies: exact;
  * AdamW against ``repro.train.optimizer``: rtol 1e-6 of each leaf's
    scale (f32 elementwise updates; the global norm sums its leaves'
    squares in another order, and XLA's f32 power may differ by an ulp);
  * loss and gradients per family at reduced configs (B 2, S 64): loss
    within 1e-3 relative, each leaf's gradient within 2e-2 relative L2 and
    the global gradient norm within 2e-2: both compute in bf16 and round at
    other places (XLA fuses elementwise chains and rounds once, PyTorch
    after each op), and the gradient of every leaf carries the forward's
    rounding differences (in f32 compute the two agree to 1e-6).  Measured
    worst leaf: 1.7e-2 (mamba2-2.7b);
  * moe: routing is discontinuous; positions from a near-tie flip of an
    assignment on are taken out of the loss on both sides (their labels
    masked), as tests/test_torch_zoo.py leaves such rows out;
  * three train steps against the reference's jitted step: losses within
    2e-3 relative, grad norms within 2e-2, and after step t params within
    2 lr t absolute: an AdamW step moves an element by lr |m / (sqrt(v) +
    eps)| (bias-corrected), at most lr in these steps, so where a gradient
    element is within rounding of 0 the two runs may move it lr apart in
    opposite directions (measured: 2.0e-3, 3.8e-3, 3.9e-3 at lr 1e-3);
    accumulation 2 and 4 against 1 held to tests/test_train.py:42's own
    bounds, and the port's accumulation 2 against the reference's as the
    three steps.
"""

import contextlib
import dataclasses
import importlib.util
import io
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import train as train_launcher
from repro_torch.models import init_encdec_params, init_lm_params, params_from_numpy
from repro_torch.train import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    load_checkpoint,
    make_train_step,
    synthetic_batch,
    synthetic_token_stream,
)
from repro_torch.train import grad_compress as tgc
from repro_torch.train import optimizer as topt
from repro_torch.train.step import batch_to, loss_for, value_and_grad
from test_torch_zoo import _moe_first_difference, _record_router_inputs

ARCHS = ["granite-3-2b", "granite-moe-1b-a400m", "mamba2-2.7b", "recurrentgemma-2b",
         "llava-next-mistral-7b", "seamless-m4t-large-v2"]
# the dense configs granite-3-2b does not cover: half-dim rotary and Kv 2
# (chatglm3-6b), squared ReLU and an untied head (nemotron-4-15b), 56 heads
# over 8 kv heads at full width (yi-34b)
DENSE = ["chatglm3-6b", "nemotron-4-15b", "yi-34b"]
LOSS_RTOL = 1e-3
GRAD_REL_L2 = 2e-2
ADAMW_RTOL = 1e-6
STEP_LOSS_RTOL = 2e-3
ADAMW_PART = 2  # params of two runs part by up to this many lr a step (see above)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models import encdec as jencdec
    from repro.models import init_lm_params as jinit
    from repro.models import lm as jlm
    from repro.train import data as jdata
    from repro.train import grad_compress as jgc
    from repro.train import optimizer as jopt
    from repro.train import step as jstep

    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=jconfigs, lm=jlm, init=jinit,
                                 init_encdec=jencdec.init_encdec_params, data=jdata, gc=jgc,
                                 opt=jopt, step=jstep)


def _carried(ref, arch, **changes):
    """(reference config, its params from PRNGKey(0) in f32, the port's
    config, the same params as CPU tensors).  The reference draws in f64
    where x64 is enabled, as it is in this process; its f32 params are what
    it trains."""
    jcfg = dataclasses.replace(ref.configs.get_config(arch).reduced(), **changes)
    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    init = ref.init_encdec if cfg.family == "encdec" else ref.init
    jp = ref.jax.tree.map(lambda x: x.astype(ref.jnp.float32),
                          init(ref.jax.random.PRNGKey(0), jcfg))
    return jcfg, jp, cfg, params_from_numpy(ref.jax.tree.map(np.asarray, jp), "cpu")


def _jbatch(ref, batch):
    return {k: ref.jnp.asarray(v) for k, v in batch.items()}


def _named_leaves(ref, tree):
    """(path, leaf) in jax.tree.leaves order."""
    return [("/".join(str(k.key) for k in path), leaf)
            for path, leaf in ref.jax.tree_util.tree_flatten_with_path(tree)[0]]


def _rel_l2(got: torch.Tensor, want: np.ndarray) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got.double().numpy() - want) / max(np.linalg.norm(want), 1e-30))


def _moe_held_batch(ref, jcfg, jp, cfg, tp, batch, monkeypatch):
    """The batch with the labels masked from each row's first near-tie
    routing flip on (checked to be a near tie; tests/test_torch_zoo.py)."""
    tb = batch_to(batch, CPU)
    with _record_router_inputs(ref, monkeypatch) as (port_h, ref_h), torch.no_grad():
        ref.lm.lm_loss(jp, jcfg, _jbatch(ref, batch))
        loss_for(cfg)(tp, tb)
    first = _moe_first_difference(port_h, ref_h, tp, cfg, 0)
    labels = batch["labels"].copy()
    for row, pos in first.items():
        labels[row, pos:] = -1
    assert (labels >= 0).mean() >= 0.5, f"routing differs early in the rows: {first}"
    return dict(batch, labels=labels)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_synthetic_batches_are_the_references_bytes(ref, arch):
    cfg, jcfg = get_config(arch).reduced(), ref.configs.get_config(arch).reduced()
    got = [synthetic_batch(cfg, 3, 20, seed=5)]
    want = [ref.data.synthetic_batch(jcfg, 3, 20, seed=5)]
    port_stream = synthetic_token_stream(cfg, 2, 16, seed=9)
    ref_stream = ref.data.synthetic_token_stream(jcfg, 2, 16, seed=9)
    for _ in range(3):
        got.append(next(port_stream))
        want.append(next(ref_stream))
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            assert g[key].dtype == w[key].dtype and g[key].shape == w[key].shape, key
            assert g[key].tobytes() == w[key].tobytes(), key


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE + ["llava-next-mistral-7b"])
def test_a_stream_without_unigram_signal_is_chatglms(arch):
    """C11: the stream's next token is (a x + b) mod vocab but for 10% noise;
    where a is coprime to the vocab (chatglm3-6b's 65,024) that map is a
    permutation, so the labels are as spread over the vocab as uniform draws
    and a step can lower the loss only by learning the map itself; elsewhere
    the map's image is a fraction of the vocab, which a first step learns
    (the full-width loss at lr 1e-3: chip_smoke.py's TRAIN_LR)."""
    cfg = get_config(arch)
    labels = synthetic_batch(cfg, 16, 4096, seed=0)["labels"]
    labels = labels[labels >= 0]
    share = np.unique(labels).size / cfg.vocab
    uniform = 1 - np.exp(-labels.size / cfg.vocab)  # the expected share of uniform draws
    if arch == "chatglm3-6b":
        assert abs(share - uniform) < 0.01 * uniform, (share, uniform)
    else:
        assert share < 0.6 * uniform, (share, uniform)


def _tree(rng, scale=1.0):
    return {"a": {"w": (scale * rng.standard_normal((3, 4))).astype(np.float32),
                  "b": (scale * rng.standard_normal(5)).astype(np.float32)},
            "z": (scale * rng.standard_normal((2, 2, 3))).astype(np.float32)}


def _close(got, want, name):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=ADAMW_RTOL, atol=ADAMW_RTOL * scale,
                               err_msg=name)


@pytest.mark.parametrize("steps", [1, 10])
@pytest.mark.parametrize("clip", ["active", "inactive"])
def test_adamw_matches_reference(ref, steps, clip):
    rng = np.random.default_rng(steps)
    params = _tree(rng)
    grads = [_tree(rng, 10.0 if clip == "active" else 0.01) for _ in range(steps)]
    cfg = AdamWConfig(lr=0.01)
    jcfg = ref.opt.AdamWConfig(lr=0.01)
    jp = ref.jax.tree.map(ref.jnp.asarray, params)
    jo = ref.opt.adamw_init(jp)
    tp = params_from_numpy(params, "cpu")
    to = adamw_init(tp)
    for g in grads:
        jp, jo, jn = ref.opt.adamw_update(jp, ref.jax.tree.map(ref.jnp.asarray, g), jo, jcfg)
        tp, to, tn = adamw_update(tp, params_from_numpy(g, "cpu"), to, cfg)
        assert (float(tn) > 1.0) == (clip == "active")
        np.testing.assert_allclose(float(tn), float(jn), rtol=ADAMW_RTOL)  # before the clip
    assert to["step"].dtype == torch.int32 and int(to["step"]) == int(jo["step"]) == steps
    for name, got, want in (("params", tp, jp), ("m", to["m"], jo["m"]), ("v", to["v"], jo["v"])):
        for g, (path, w) in zip(topt.tree_leaves(got), _named_leaves(ref, want)):
            _close(g, w, f"{name}/{path}")


def test_adamw_update_in_slices_is_the_whole_update_bit_for_bit(monkeypatch):
    """C12: a leaf larger than UPDATE_SLICE_ELEMS is updated in slices of its
    rows: the same params, m, v and grads bit for bit as the whole update,
    and no temporary larger than a slice (an op's output counted by a
    dispatch mode; the in-place outputs are the slices) but the global
    norm's squares, one a leaf, which keep the reference's sum."""
    from torch.utils._python_dispatch import TorchDispatchMode

    rng = np.random.default_rng(4)

    def state():
        params = {"big": torch.as_tensor(rng.standard_normal((1000, 7)), dtype=torch.float32),
                  "small": torch.as_tensor(rng.standard_normal(5), dtype=torch.float32)}
        grads = topt.tree_map(lambda p: torch.as_tensor(rng.standard_normal(tuple(p.shape)),
                                                        dtype=torch.float32), params)
        return params, grads

    class Largest(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.numel = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if (isinstance(t, torch.Tensor) and t.dim() and not func._schema.is_mutable
                        and func is not torch.ops.aten.pow.Tensor_Scalar):
                    self.numel = max(self.numel, t.numel())
            return out

    cfg = AdamWConfig(lr=1e-2)
    params, grads = state()
    runs = {}
    for limit in (10 ** 9, 64):
        monkeypatch.setattr(topt, "UPDATE_SLICE_ELEMS", limit)
        p, g = topt.tree_map(torch.clone, params), topt.tree_map(torch.clone, grads)
        opt = adamw_init(p)
        for _ in range(2):
            p, opt, _ = adamw_update(p, topt.tree_map(torch.clone, g), opt, cfg)
        args = (topt.tree_map(torch.clone, p), topt.tree_map(torch.clone, g),
                topt.tree_map(torch.clone, opt))
        with Largest() as mode:
            adamw_update(*args, cfg)
        runs[limit] = (p, opt, mode.numel)
    (p1, o1, whole), (p2, o2, sliced) = runs[10 ** 9], runs[64]
    for a, b in zip(topt.tree_leaves(p1) + topt.tree_leaves(o1["m"]) + topt.tree_leaves(o1["v"]),
                    topt.tree_leaves(p2) + topt.tree_leaves(o2["m"]) + topt.tree_leaves(o2["v"])):
        assert torch.equal(a, b)
    assert whole == 7000 and sliced <= 63  # 9 rows of 7 a slice


def test_reference_optimizer_state_carries_over(ref):
    rng = np.random.default_rng(3)
    params, cfg, jcfg = _tree(rng), AdamWConfig(lr=0.01), ref.opt.AdamWConfig(lr=0.01)
    jp = ref.jax.tree.map(ref.jnp.asarray, params)
    jo = ref.opt.adamw_init(jp)
    for _ in range(3):
        jp, jo, _ = ref.opt.adamw_update(jp, ref.jax.tree.map(ref.jnp.asarray, _tree(rng)), jo,
                                         jcfg)
    tp = params_from_numpy(ref.jax.tree.map(np.asarray, jp), "cpu")
    to = topt.opt_state_from_numpy(ref.jax.tree.map(np.asarray, jo), "cpu")
    assert to["step"].dtype == torch.int32 and int(to["step"]) == 3
    g = _tree(rng)
    jp, jo, _ = ref.opt.adamw_update(jp, ref.jax.tree.map(ref.jnp.asarray, g), jo, jcfg)
    tp, to, _ = adamw_update(tp, params_from_numpy(g, "cpu"), to, cfg)
    for got, (path, want) in zip(topt.tree_leaves(tp), _named_leaves(ref, jp)):
        _close(got, want, path)


def test_adamw_minimizes_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = adamw_init(params)
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
    for _ in range(200):
        params, opt, _ = adamw_update(params, {"w": 2 * params["w"].clone()}, opt, cfg)
    assert float(torch.sum(params["w"] ** 2)) < 1e-3


def test_grad_clip_applied():
    params = {"w": torch.tensor([1.0])}
    _, _, gnorm = adamw_update(params, {"w": torch.tensor([100.0])}, adamw_init(params),
                               AdamWConfig(lr=1.0, grad_clip=1.0, weight_decay=0.0))
    assert float(gnorm) == 100.0  # reported pre-clip


# ---------------------------------------------------------------------------
# EF21
# ---------------------------------------------------------------------------

def test_ef21_matches_reference_exactly_on_ties(ref):
    rng = np.random.default_rng(0)
    # small integers: many equal |delta|, so the k-th place is a tie
    grads = {"a": rng.integers(-3, 4, size=(64,)).astype(np.float32),
             "b": rng.integers(-2, 3, size=(4, 8)).astype(np.float32)}
    jest = ref.gc.ef21_init(ref.jax.tree.map(ref.jnp.asarray, grads))
    test = tgc.ef21_init(params_from_numpy(grads, "cpu"))
    for step in range(4):
        g = {k: (v * (step + 1) % 5).astype(np.float32) for k, v in grads.items()}
        jest, japply = ref.gc.ef21_step(ref.jax.tree.map(ref.jnp.asarray, g), jest, frac=0.2)
        before = {k: v.clone() for k, v in test.items()}
        test, tapply = tgc.ef21_step(params_from_numpy(g, "cpu"), test, frac=0.2)
        assert tapply is test
        for key in grads:
            want = np.asarray(jest[key])
            assert np.array_equal(test[key].numpy(), want), (step, key)
            assert np.array_equal(np.nonzero((test[key] - before[key]).numpy())[0],
                                  np.nonzero(want - before[key].numpy())[0])


def test_ef21_estimator_tracks_gradient():
    g = {"w": torch.as_tensor(np.random.default_rng(0).standard_normal(256))}
    est = tgc.ef21_init(g)
    errs = []
    for _ in range(20):
        est, _ = tgc.ef21_step(g, est, frac=0.25)
        errs.append(float(torch.linalg.norm(est["w"] - g["w"])))
    assert errs[-1] < errs[0] * 1e-2
    assert all(b <= a + 1e-12 for a, b in zip(errs, errs[1:]))


def test_ef21_optimizes_quadratic():
    params = {"w": torch.tensor([4.0, -2.0, 1.0])}
    opt = adamw_init(params)
    est = tgc.ef21_init(params)
    cfg = AdamWConfig(lr=0.05, weight_decay=0.0)
    for _ in range(300):
        est, g_hat = tgc.ef21_step({"w": 2 * params["w"]}, est, frac=0.34)
        params, opt, _ = adamw_update(params, {k: v.clone() for k, v in g_hat.items()}, opt, cfg)
    assert float(torch.sum(params["w"] ** 2)) < 1e-2


# ---------------------------------------------------------------------------
# the loss and its gradient, per family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS + DENSE)
def test_loss_and_gradients_match_reference(ref, arch, monkeypatch):
    """Every family at its reduced config.  The hybrid's two layers are both
    RG-LRU layers, so its attention leaves are the untaken branch: 0 on both
    sides."""
    jcfg, jp, cfg, tp = _carried(ref, arch)
    batch = synthetic_batch(cfg, 2, 64, seed=0)
    if cfg.family == "moe":
        batch = _moe_held_batch(ref, jcfg, jp, cfg, tp, batch, monkeypatch)
    jl, jg = ref.jax.jit(ref.jax.value_and_grad(ref.step.loss_for(jcfg)))(jp, _jbatch(ref, batch))
    loss, grads = value_and_grad(loss_for(cfg), tp, [batch_to(batch, CPU)])
    assert abs(float(loss) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    got = topt.tree_leaves(grads)
    want = _named_leaves(ref, jg)
    assert len(got) == len(want)
    for g, (path, w) in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, path
        assert bool(torch.isfinite(g).all()), path
        assert _rel_l2(g, w) <= GRAD_REL_L2, (path, _rel_l2(g, w))
        # a slice the loss does not reach (the hybrid's untaken branch) is 0 on both sides
        slices = range(w.shape[0]) if path.startswith(("blocks", "enc_blocks", "dec_blocks")) \
            else [slice(None)]
        for i in slices:
            assert w[i].any() or not bool(g[i].any()), (path, i)
    norm = float(topt.global_norm(grads))
    jnorm = float(ref.opt._global_norm(jg))
    assert abs(norm - jnorm) <= GRAD_REL_L2 * jnorm


def test_hybrid_untaken_branch_gets_zero_gradient_and_weight_decay():
    """Three layers (rglru, rglru, attn): the attention slices of layers 0
    and 1 and the RG-LRU slices of layer 2 get exactly 0, as under the
    reference's lax.cond, and one AdamW step moves them by weight decay
    alone: p - lr (0 / (sqrt(0) + eps) + wd p), the reference's update with
    m = v = 0."""
    cfg = dataclasses.replace(get_config("recurrentgemma-2b").reduced(), n_layers=3)
    params = init_lm_params(0, cfg, "cpu")
    batch = batch_to(synthetic_batch(cfg, 2, 64, seed=1), CPU)
    _, grads = value_and_grad(loss_for(cfg), params, [batch])
    for name, untaken in (("attn", [0, 1]), ("rglru", [2])):
        for key, g in grads["blocks"][name].items():
            taken = [i for i in range(3) if i not in untaken]
            assert not bool(g[untaken].any()) and bool(g[taken].any()), (name, key)
    opt_cfg = AdamWConfig(lr=1e-3)
    old = params["blocks"]["attn"]["wq"][:2].clone()
    new, _, _ = adamw_update(params, grads, adamw_init(params), opt_cfg)
    zero = torch.zeros_like(old)
    want = old - opt_cfg.lr * (zero / (torch.sqrt(zero) + opt_cfg.eps)
                               + opt_cfg.weight_decay * old)
    assert torch.equal(new["blocks"]["attn"]["wq"][:2], want)
    assert not torch.equal(want, old)


def test_remat_policies_give_the_same_loss_and_gradients():
    _remat_policies_agree("granite-3-2b")


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-2.7b", "recurrentgemma-2b",
                                  "llava-next-mistral-7b"])
def test_remat_policies_give_the_same_loss_and_gradients_every_family(arch):
    """As granite's: chip_smoke.py's train depth cut holds the card's remat
    "full" against the CPU without remat (encdec remats every layer
    whatever the policy).  recurrentgemma-2b at 3 layers, one attention."""
    _remat_policies_agree(arch)


def _remat_policies_agree(arch):
    cfg = get_config(arch).reduced()
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, n_layers=3)
    params = init_lm_params(0, cfg, "cpu")
    batch = batch_to(synthetic_batch(cfg, 2, 64, seed=2), CPU)
    runs = {policy: value_and_grad(loss_for(dataclasses.replace(cfg, remat_policy=policy)),
                                   params, [batch])
            for policy in ("full", "dots", "none")}
    loss, grads = runs["none"]
    for policy in ("full", "dots"):
        assert torch.equal(runs[policy][0], loss), policy
        for g, w in zip(topt.tree_leaves(runs[policy][1]), topt.tree_leaves(grads)):
            assert torch.equal(g, w), policy


def _chip_smoke():
    """chip_smoke.py, loaded by its path (the repo's root is no package)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_calls_of_a_train_step_are_chip_smokes_launches(arch, monkeypatch):
    """One CPU train step (accum 2, remat "full") calls chunked_attention as
    often as chip_smoke.py's expected_train_launches has the card launch
    flash's training forward (each call, and again where its layer is
    recomputed in the backward), and its backward kernels half as often.
    recurrentgemma-2b at 3 layers, so that one is attention."""
    from repro_torch.models import encdec as tencdec
    from repro_torch.models import lm as tlm

    cfg = dataclasses.replace(get_config(arch).reduced(), accum_steps=2)
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, n_layers=3)
    assert cfg.remat_policy == "full"
    calls = []
    plain = tlm.chunked_attention

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return plain(*args, **kwargs)

    monkeypatch.setattr(tlm, "chunked_attention", counted)
    monkeypatch.setattr(tencdec, "chunked_attention", counted)
    init = init_encdec_params if cfg.family == "encdec" else init_lm_params
    params = init(0, cfg, "cpu")
    make_train_step(cfg)(params, adamw_init(params), synthetic_batch(cfg, 4, 32, seed=0))
    want = _chip_smoke().expected_train_launches(cfg, 2)
    assert len(calls) == want["flash_attention_train"], (len(calls), want)
    assert want["flash_attention_bwd_dq"] == want["flash_attention_bwd_dkdv"] == len(calls) // 2
    assert (len(calls) > 0) == (cfg.family != "ssm")


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _copy(tree):
    return topt.tree_map(torch.clone, tree)


def _max_param_diff(ref, tp, jp) -> float:
    return max(float(np.abs(g.numpy() - np.asarray(w)).max())
               for g, (_, w) in zip(topt.tree_leaves(tp), _named_leaves(ref, jp)))


def _three_steps(ref, arch, accum, monkeypatch=None):
    """Three train steps of the port and of the reference's jitted step from
    the same params on batches of B 4, S 32 (moe: each microbatch held by
    _moe_held_batch at the step's params), held to STEP_LOSS_RTOL,
    GRAD_REL_L2 and ADAMW_PART lr a step."""
    jcfg, jp, cfg, tp = _carried(ref, arch, accum_steps=accum)
    lr = 1e-3
    jstep = ref.jax.jit(ref.step.make_train_step(jcfg, ref.opt.AdamWConfig(lr=lr)))
    step = make_train_step(cfg, AdamWConfig(lr=lr))
    jo, to = ref.opt.adamw_init(jp), adamw_init(tp)
    for i in range(3):
        batch = synthetic_batch(cfg, 4, 32, seed=i)
        if cfg.family == "moe":  # each microbatch routes (and fills its queues) alone
            rows = 4 // accum
            parts = [_moe_held_batch(ref, jcfg, jp, cfg, tp,
                                     {k: v[r:r + rows] for k, v in batch.items()}, monkeypatch)
                     for r in range(0, 4, rows)]
            batch = {k: np.concatenate([part[k] for part in parts]) for k in batch}
        jp, jo, jm = jstep(jp, jo, _jbatch(ref, batch))
        tp, to, tm = step(tp, to, batch)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= STEP_LOSS_RTOL * float(jm["loss"])
        jn = float(jm["grad_norm"])
        assert abs(float(tm["grad_norm"]) - jn) <= GRAD_REL_L2 * jn
        assert _max_param_diff(ref, tp, jp) <= ADAMW_PART * lr * (i + 1)
    assert int(to["step"]) == 3


def test_three_train_steps_match_reference(ref):
    _three_steps(ref, "granite-3-2b", 1)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-2.7b",
                                  "seamless-m4t-large-v2", "llava-next-mistral-7b",
                                  "chatglm3-6b", "nemotron-4-15b"])
def test_three_train_steps_match_reference_other_families(ref, arch, monkeypatch):
    """The families first trained at full width on the card, with
    accumulation 2, as the card's full-width runs; and the dense configs'
    half-dim rotary (chatglm3-6b), squared ReLU and untied head
    (nemotron-4-15b) under three steps of AdamW."""
    _three_steps(ref, arch, 2, monkeypatch)


def test_train_step_updates_the_callers_state_in_place():
    """The port's step writes the new params, m and v into the caller's
    tensors and returns those same tensors (the reference's step is pure):
    the same objects at the same addresses, holding what a step from copies
    of the state gives; the step count is a new tensor."""
    _in_place("granite-3-2b")


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "granite-3-2b"])
def test_train_step_updates_the_callers_state_in_place_every_family(arch):
    _in_place(arch)


def _in_place(arch):
    cfg = dataclasses.replace(get_config(arch).reduced(), accum_steps=2)
    init = init_encdec_params if cfg.family == "encdec" else init_lm_params
    params = init(0, cfg, "cpu")
    opt = adamw_init(params)
    before = topt.tree_map(torch.clone, params)
    copies = topt.tree_map(torch.clone, params), topt.tree_map(torch.clone, opt)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3))
    batch = synthetic_batch(cfg, 4, 32, seed=0)

    def state(p, o):
        return topt.tree_leaves(p) + topt.tree_leaves(o["m"]) + topt.tree_leaves(o["v"])

    mine = state(params, opt)
    addresses = [t.data_ptr() for t in mine]
    new_params, new_opt, _ = step(params, opt, batch)
    got = state(new_params, new_opt)
    assert len(got) == len(mine) and all(g is m for g, m in zip(got, mine))
    assert [t.data_ptr() for t in got] == addresses
    want_params, want_opt, _ = step(*copies, batch)
    assert all(torch.equal(g, w) for g, w in zip(got, state(want_params, want_opt)))
    assert any(not torch.equal(g, b) for g, b in zip(topt.tree_leaves(new_params),
                                                     topt.tree_leaves(before)))
    assert int(new_opt["step"]) == 1 and int(opt["step"]) == 0


def test_accumulation_matches_single_batch_and_the_reference(ref):
    """tests/test_train.py:42 for the port (accum 2 and 4 against 1: loss
    rtol 2e-2, the first leaf within 3e-3), and the port's accum 2 against
    the reference's."""
    jcfg, jp, cfg, tp = _carried(ref, "granite-3-2b")
    batch = synthetic_batch(cfg, 8, 16, seed=0)
    out = {}
    for accum in (1, 2, 4):
        step = make_train_step(dataclasses.replace(cfg, accum_steps=accum))
        params = _copy(tp)
        out[accum] = step(params, adamw_init(params), batch)
    for accum in (2, 4):
        np.testing.assert_allclose(float(out[1][2]["loss"]), float(out[accum][2]["loss"]),
                                   rtol=2e-2)
        w1, w = (topt.tree_leaves(out[a][0])[0].double().numpy() for a in (1, accum))
        np.testing.assert_allclose(w1, w, atol=3e-3)
    jstep = ref.jax.jit(ref.step.make_train_step(dataclasses.replace(jcfg, accum_steps=2)))
    jp2, _, jm = jstep(jp, ref.opt.adamw_init(jp), _jbatch(ref, batch))
    tp2, _, tm = out[2]
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= STEP_LOSS_RTOL * float(jm["loss"])
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= GRAD_REL_L2 * float(
        jm["grad_norm"])
    assert _max_param_diff(ref, tp2, jp2) <= ADAMW_PART * AdamWConfig().lr


def test_launcher_lowers_the_loss_and_saves_a_checkpoint(tmp_path):
    """tests/test_train.py:58's bound for the port's launcher."""
    path = str(tmp_path / "ckpt.npz")
    argv = ["--arch", "granite-3-2b", "--reduced", "--steps", "30", "--batch", "8", "--seq",
            "32", "--lr", "1e-3", "--device", "cpu"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        params, losses = train_launcher.main(argv + ["--checkpoint", path])
    assert losses[-1] < losses[0] - 0.5, losses[::6]
    printed = out.getvalue().splitlines()
    assert sum(line.startswith("step ") for line in printed) == 10
    assert any(line.startswith("30 steps in") for line in printed)
    restored = load_checkpoint(path, topt.tree_map(torch.zeros_like, params))
    for g, w in zip(topt.tree_leaves(restored), topt.tree_leaves(params)):
        assert torch.equal(g, w)
    # a process outside any group is a world of one: a 2 x 1 mesh is refused
    with pytest.raises(ValueError, match="2x1 holds 2 ranks; the default process group has 1"):
        train_launcher.main(argv + ["--mesh", "2x1"])
