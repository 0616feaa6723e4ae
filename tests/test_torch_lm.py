"""The port's dense LM path against the JAX package on reduced configs (CPU):
configs, forward, prefill, decode steps with their KV cache, checkpoints,
the serving engine and its launcher.  Weights are the reference's
(``repro.models.init_lm_params``), carried over as numpy.

Tolerance: logits and caches are bf16 computed through bf16 activations
that the two frameworks round at different places (XLA rounds a fused
elementwise chain once, PyTorch after each op), so a value may differ by a
few bf16 ulps of its tensor's scale: ``LOGIT_ULPS`` = 4 ulps of the largest
magnitude of the reference tensor.  A greedy token may differ only where the
reference's top-2 logit margin is under that bound; such steps are counted
and none is allowed on these fixtures.
"""

import dataclasses
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.models import (
    init_decode_cache,
    init_lm_params,
    lm_decode_step,
    lm_forward,
    lm_prefill,
    params_from_numpy,
)
from repro_torch.models.lm import cast_for_compute, layer_types, padded_vocab
from repro_torch.serving import Request, ServeEngine
from repro_torch.train import load_checkpoint, make_prefill_step, make_serve_step, save_checkpoint

ROOT = Path(__file__).resolve().parents[1]
LOGIT_ULPS = 4
DENSE = ["granite-3-2b", "chatglm3-6b", "nemotron-4-15b", "yi-34b"]


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro import models as jmodels
    from repro.models import lm as jlm
    from repro.serving import Request as JRequest
    from repro.serving import ServeEngine as JServeEngine
    from repro.train import checkpoint as jckpt

    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=jconfigs, models=jmodels, lm=jlm,
                                 Request=JRequest, ServeEngine=JServeEngine, ckpt=jckpt)


@pytest.fixture(scope="module")
def carried(ref):
    """arch -> (jax params, the same params as CPU tensors) on the reduced config."""
    out = {}
    for arch in DENSE:
        jp = ref.models.init_lm_params(ref.jax.random.PRNGKey(3), ref.configs.get_config(arch).reduced())
        out[arch] = jp, params_from_numpy(ref.jax.tree.map(np.asarray, jp), "cpu")
    return out


def _np32(a) -> np.ndarray:
    return np.asarray(a.astype("float32")) if hasattr(a, "astype") else np.asarray(a, np.float32)


def _bound(want: np.ndarray) -> float:
    """LOGIT_ULPS bf16 ulps at the largest magnitude of ``want``."""
    _, e = np.frexp(np.float32(np.abs(want).max()))
    return LOGIT_ULPS * float(np.ldexp(1.0, int(e) - 8))


def _assert_close(got: torch.Tensor, want) -> None:
    want = _np32(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=_bound(want))


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=shape)


def test_configs_match_reference(ref):
    assert list_archs() == ref.configs.list_archs()
    names = list_archs() + ["granite-3-2b", "mamba2-2.7b", "chatglm3-6b"]
    for name in names:
        got, want = get_config(name), ref.configs.get_config(name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert dataclasses.asdict(got.reduced()) == dataclasses.asdict(want.reduced())
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_padded_vocab_and_layer_types_match_reference(ref):
    for name in list_archs():
        cfg, jcfg = get_config(name), ref.configs.get_config(name)
        assert padded_vocab(cfg) == ref.lm.padded_vocab(jcfg)
        np.testing.assert_array_equal(layer_types(cfg), ref.lm.layer_types(jcfg))


def test_init_matches_reference_structure(ref):
    for arch in ["granite-3-2b", "nemotron-4-15b"]:
        cfg = get_config(arch).reduced()
        want = ref.models.init_lm_params(ref.jax.random.PRNGKey(0), ref.configs.get_config(arch).reduced())
        got = init_lm_params(0, cfg, "cpu")
        flat_w = {"/".join(str(k.key) for k in path): leaf
                  for path, leaf in ref.jax.tree_util.tree_flatten_with_path(want)[0]}
        flat_g = {"/".join(str(k.key) for k in path): leaf
                  for path, leaf in ref.jax.tree_util.tree_flatten_with_path(got)[0]}
        assert sorted(flat_g) == sorted(flat_w)
        for key, leaf in flat_w.items():
            assert tuple(flat_g[key].shape) == leaf.shape and flat_g[key].dtype == torch.float32
            # the same scale: 0.02 for embeddings, 1/sqrt(fan_in) for matrices, 0 for norms
            assert abs(float(flat_g[key].std()) - float(np.std(np.asarray(leaf)))) <= 0.1 * float(
                np.std(np.asarray(leaf))) + 1e-6
        assert torch.equal(init_lm_params(0, cfg, "cpu")["embed"], got["embed"])


@pytest.mark.parametrize("arch", DENSE)
def test_forward_and_prefill_match_reference(ref, carried, arch):
    cfg, jcfg = get_config(arch).reduced(), ref.configs.get_config(arch).reduced()
    jp, tp = carried[arch]
    toks = _tokens(cfg, (2, 70), 1)  # 70 tokens: q_chunk 32 does not divide it
    want = ref.lm.lm_forward(jp, jcfg, ref.jnp.asarray(toks))
    got = lm_forward(tp, cfg, torch.as_tensor(toks))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 70, padded_vocab(cfg))
    _assert_close(got, want)
    toks = _tokens(cfg, (2, 64), 2)
    want = ref.lm.lm_prefill(jp, jcfg, ref.jnp.asarray(toks))
    got = make_prefill_step(cfg)(tp, {"tokens": torch.as_tensor(toks)})
    _assert_close(got, want)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_steps_match_reference(ref, carried, arch):
    cfg, jcfg = get_config(arch).reduced(), ref.configs.get_config(arch).reduced()
    jp, tp = carried[arch]
    toks = _tokens(cfg, (3, 3), 4)
    jcache = ref.models.init_decode_cache(jcfg, 3, 16)
    cache = init_decode_cache(cfg, 3, 16, "cpu")
    step = make_serve_step(cfg)
    for s in range(3):
        want, jcache = ref.models.lm_decode_step(jp, jcfg, jcache, ref.jnp.asarray(toks[:, s : s + 1]))
        got, cache = step(tp, cache, torch.as_tensor(toks[:, s : s + 1]))
        _assert_close(got, want)
        assert cache["pos"] == int(jcache["pos"]) == s + 1
        _assert_close(cache["k"], jcache["k"])
        _assert_close(cache["v"], jcache["v"])
    assert not bool(cache["k"][:, :, 3:].any())  # slots past pos are untouched


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_agrees_with_sequential_decode(carried, arch):
    """The chunked-attention prefill and five decode steps are one function."""
    cfg = get_config(arch).reduced()
    _, tp = carried[arch]
    toks = torch.as_tensor(_tokens(cfg, (2, 5), 5))
    want = lm_prefill(tp, cfg, toks)
    cache = init_decode_cache(cfg, 2, 8, "cpu")
    for s in range(5):
        got, cache = lm_decode_step(tp, cfg, cache, toks[:, s : s + 1])
    np.testing.assert_allclose(got[:, 0].float().numpy(), want.float().numpy(), rtol=0,
                               atol=_bound(want.float().numpy()))


@pytest.mark.parametrize("arch", DENSE)
def test_cast_for_compute_gives_the_same_logits(carried, arch):
    cfg = get_config(arch).reduced()
    _, tp = carried[arch]
    cast = cast_for_compute(tp)
    assert cast["embed"].dtype == torch.bfloat16 and ("head" in cast) == (not cfg.tie_embeddings)
    assert cast.get("head", cast["embed"]).dtype == torch.bfloat16
    assert cast["blocks"]["mlp"]["w1"].dtype == torch.bfloat16
    assert cast["blocks"]["ln1"].dtype == torch.float32 and cast["final_norm"].dtype == torch.float32
    toks = torch.as_tensor(_tokens(cfg, (1, 9), 6))
    assert torch.equal(lm_forward(cast, cfg, toks), lm_forward(tp, cfg, toks))


def _reference_engine_run(ref, jp, jcfg, reqs, batch, max_len):
    """The reference engine's finished requests, and for each prompt the
    logits from which each of its tokens was taken."""
    engine = ref.ServeEngine(jp, jcfg, batch_size=batch, max_len=max_len)
    step, logits = engine.step, {}

    def recording(params, cache, toks):
        out, cache = step(params, cache, toks)
        rows = np.asarray(out[:, 0, : jcfg.vocab].astype(ref.jnp.float32))
        for i, r in enumerate(engine.slots):
            if r is not None and engine._cursor[i] + 1 >= len(r.prompt):
                logits.setdefault(tuple(r.prompt), []).append(rows[i])
        return out, cache

    engine.step = recording
    for r in reqs:
        engine.submit(ref.Request(prompt=list(r.prompt), max_new_tokens=r.max_new_tokens))
    return engine.run(), logits


def test_serve_engine_tokens_match_reference(ref):
    """tests/test_serving.py's requests: granite reduced, batch 3, 5 requests."""
    cfg, jcfg = get_config("granite-3-2b").reduced(), ref.configs.get_config("granite-3-2b").reduced()
    jp = ref.models.init_lm_params(ref.jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(ref.jax.tree.map(np.asarray, jp), "cpu")
    reqs = [Request(prompt=[1 + i, 2 + i, 3 + i], max_new_tokens=5) for i in range(5)]
    jdone, jlogits = _reference_engine_run(ref, jp, jcfg, reqs, 3, 64)
    engine = ServeEngine(tp, cfg, batch_size=3, max_len=64, device="cpu")
    for r in reqs:
        engine.submit(r)
    done = engine.run()
    assert [r.prompt for r in done] == [r.prompt for r in jdone]
    assert len(done) == 5 and all(r.done and len(r.generated) == 5 for r in done)
    assert engine.steps == 14  # two waves of 3 prompt + 5 new tokens, less the overlap
    differing = 0
    for got, want in zip(done, jdone):
        first = next((j for j, (a, b) in enumerate(zip(got.generated, want.generated)) if a != b), None)
        if first is None:
            continue
        lg = jlogits[tuple(want.prompt)][first]
        top2 = np.sort(lg)[-2:]
        assert top2[1] - top2[0] < _bound(lg), (
            f"prompt {want.prompt}: token {first} differs ({got.generated} vs {want.generated}) "
            f"at a top-2 margin {top2[1] - top2[0]} above the bound {_bound(lg)}")
        differing += 1
    assert differing == 0


def test_checkpoint_crosses_packages(ref, tmp_path):
    """A checkpoint of either package loads in the other; the logits follow."""
    cfg, jcfg = get_config("yi-34b").reduced(), ref.configs.get_config("yi-34b").reduced()
    jp = ref.models.init_lm_params(ref.jax.random.PRNGKey(7), jcfg)
    ref.ckpt.save_checkpoint(str(tmp_path / "jax_ckpt"), jp)
    tp = load_checkpoint(str(tmp_path / "jax_ckpt"), init_lm_params(0, cfg, "cpu"))
    carried = params_from_numpy(ref.jax.tree.map(np.asarray, jp), "cpu")
    assert ref.jax.tree.structure(ref.jax.tree.map(np.asarray, jp)) == ref.jax.tree.structure(
        ref.jax.tree.map(lambda t: t.numpy(), tp))
    # under x64 the reference's matrices are f64 (f32 draws times a numpy
    # scale); the checkpoint keeps them so and the load casts to the f32 init
    for a, b in zip(ref.jax.tree.leaves(ref.jax.tree.map(lambda t: t.numpy(), tp)),
                    ref.jax.tree.leaves(ref.jax.tree.map(lambda t: t.numpy(), carried))):
        np.testing.assert_array_equal(a, b.astype(a.dtype))
    toks = _tokens(cfg, (1, 12), 8)
    _assert_close(lm_prefill(tp, cfg, torch.as_tensor(toks)),
                  ref.lm.lm_prefill(jp, jcfg, ref.jnp.asarray(toks)))
    save_checkpoint(str(tmp_path / "torch_ckpt.npz"), tp)
    back = ref.ckpt.load_checkpoint(str(tmp_path / "torch_ckpt.npz"), jp)
    for a, b in zip(ref.jax.tree.leaves(back), ref.jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b).astype(np.float32))
    with pytest.raises(ValueError, match="mismatch"):
        load_checkpoint(str(tmp_path / "jax_ckpt"), init_lm_params(0, dataclasses.replace(cfg, n_layers=3), "cpu"))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    cfg = get_config("granite-3-2b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_lm_params(0, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_decode_cache(cfg, 1, 8)


def test_serve_launcher_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "granite-3-2b", "--reduced",
         "--device", "cpu"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
    )
    assert out.returncode == 0, out.stderr
    assert "granite-3-2b: served 6 requests, 72 tokens" in out.stdout


def test_serve_step_writes_the_cache_in_place(carried):
    """Unlike the reference's pure step, the port's serve step writes k and v
    into the caller's cache tensors: the returned cache shares them, and a
    second step from the old cache overwrites the slot the first one wrote."""
    cfg = get_config("granite-3-2b").reduced()
    _, tp = carried["granite-3-2b"]
    step = make_serve_step(cfg)
    cache = init_decode_cache(cfg, 2, 4, "cpu")
    _, new = step(tp, cache, torch.as_tensor(_tokens(cfg, (2, 1), 6)))
    assert new["k"] is cache["k"] and new["v"] is cache["v"]
    assert cache["pos"] == 0 and new["pos"] == 1
    assert bool(cache["k"][:, :, 0].any()) and not bool(cache["k"][:, :, 1:].any())
    written = new["k"].clone()
    step(tp, cache, torch.as_tensor(_tokens(cfg, (2, 1), 7)))  # from the old state again
    assert not torch.equal(new["k"][:, :, 0], written[:, :, 0])
    assert torch.equal(new["k"][:, :, 1:], written[:, :, 1:])


def test_decode_past_the_last_slot_matches_reference(ref, carried):
    """A decode step past the cache's last slot does what the reference's
    does: the write is clamped to the last slot (dynamic_update_slice clamps
    its start) and the step attends to every slot.  Logits and the returned
    cache's k and v within LOGIT_ULPS bf16 ulps, as the other decode steps."""
    cfg, jcfg = get_config("granite-3-2b").reduced(), ref.configs.get_config("granite-3-2b").reduced()
    jp, tp = carried["granite-3-2b"]
    assert cfg.window is None
    toks = _tokens(cfg, (1, 3), 8)
    jcache = ref.models.init_decode_cache(jcfg, 1, 2)
    cache = init_decode_cache(cfg, 1, 2, "cpu")
    for s in range(3):  # slots 0, 1, then one step past the last
        want, jcache = ref.models.lm_decode_step(jp, jcfg, jcache, ref.jnp.asarray(toks[:, s : s + 1]))
        got, cache = lm_decode_step(tp, cfg, cache, torch.as_tensor(toks[:, s : s + 1]))
        _assert_close(got, want)
        assert cache["pos"] == int(jcache["pos"]) == s + 1
        _assert_close(cache["k"], jcache["k"])
        _assert_close(cache["v"], jcache["v"])