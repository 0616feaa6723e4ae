"""The port's encoder-decoder (seamless-m4t-large-v2, ``repro_torch.models.
encdec``) against ``repro.models.encdec`` on the reduced config (CPU): init,
encode, prefill, decode steps with their cache, ``cast_for_compute``, the
serving engine, its launcher and checkpoints.  Weights are the reference's
(``repro.models.init_encdec_params``), carried over as numpy.

Tolerance: ``LOGIT_ULPS`` = 4 bf16 ulps of the largest magnitude of the
reference tensor, as in tests/test_torch_lm.py.  Greedy tokens may differ
only where the reference's top-2 logit margin is under that bound.
"""

import contextlib
import dataclasses
import io
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import (
    cast_for_compute,
    encdec_decode_step,
    encdec_prefill,
    encode,
    init_encdec_cache,
    init_encdec_params,
    params_from_numpy,
)
from repro_torch.serving import Request, ServeEngine
from repro_torch.train import load_checkpoint, make_prefill_step, make_serve_step, save_checkpoint

LOGIT_ULPS = 4
ARCH = "seamless-m4t-large-v2"


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models import encdec as jed
    from repro.serving import Request as JRequest
    from repro.serving import ServeEngine as JServeEngine
    from repro.train import checkpoint as jckpt

    return types.SimpleNamespace(jax=jax, jnp=jnp, cfg=jconfigs.get_config(ARCH).reduced(), ed=jed,
                                 Request=JRequest, ServeEngine=JServeEngine, ckpt=jckpt)


@pytest.fixture(scope="module")
def carried(ref):
    jp = ref.ed.init_encdec_params(ref.jax.random.PRNGKey(3), ref.cfg)
    return jp, params_from_numpy(ref.jax.tree.map(np.asarray, jp), "cpu")


CFG = get_config(ARCH).reduced()


def _np32(a) -> np.ndarray:
    return np.asarray(a.astype("float32"))


def _bound(want: np.ndarray) -> float:
    _, e = np.frexp(np.float32(np.abs(want).max()))
    return LOGIT_ULPS * float(np.ldexp(1.0, int(e) - 8))


def _assert_close(got: torch.Tensor, want) -> None:
    want = _np32(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=_bound(want))


def _src(batch, length, seed):
    return np.random.default_rng(seed).standard_normal((batch, length, CFG.d_model)).astype(np.float32)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, CFG.vocab, size=shape)


def test_init_matches_reference_structure(ref):
    want = ref.ed.init_encdec_params(ref.jax.random.PRNGKey(0), ref.cfg)
    got = init_encdec_params(0, CFG, "cpu")
    flat_w = {"/".join(str(k.key) for k in path): leaf
              for path, leaf in ref.jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_g = {"/".join(str(k.key) for k in path): leaf
              for path, leaf in ref.jax.tree_util.tree_flatten_with_path(got)[0]}
    assert sorted(flat_g) == sorted(flat_w)
    for key, leaf in flat_w.items():
        g, w = flat_g[key], np.asarray(leaf)
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, key
        assert abs(float(g.std()) - float(w.std())) <= 0.1 * float(w.std()) + 1e-6, key
        assert abs(float(g.mean()) - float(w.mean())) <= 0.1 * float(w.std()) + 1e-6, key
    assert torch.equal(init_encdec_params(0, CFG, "cpu")["embed"], got["embed"])


@pytest.mark.parametrize("src_len", [50, 64])  # q_chunk 32 does not divide 50
def test_encode_matches_reference(ref, carried, src_len):
    jp, tp = carried
    src = _src(2, src_len, 1)
    _assert_close(encode(tp, CFG, torch.as_tensor(src)), ref.ed.encode(jp, ref.cfg, ref.jnp.asarray(src)))


@pytest.mark.parametrize("src_len,tgt_len", [(50, 40), (64, 64), (16, 70)])
def test_prefill_matches_reference(ref, carried, src_len, tgt_len):
    jp, tp = carried
    src, toks = _src(2, src_len, 2), _tokens((2, tgt_len), 3)
    want = ref.ed.encdec_prefill(jp, ref.cfg, ref.jnp.asarray(src), ref.jnp.asarray(toks))
    got = make_prefill_step(CFG)(tp, {"src_embeds": torch.as_tensor(src), "tokens": torch.as_tensor(toks)})
    assert got.dtype == torch.bfloat16
    _assert_close(got, want)
    assert torch.equal(got, encdec_prefill(tp, CFG, torch.as_tensor(src), torch.as_tensor(toks)))


def test_decode_steps_match_reference(ref, carried):
    """Three steps from a zeroed cache: logits, k and v written in place,
    the zero cross K/V left as it was, pos."""
    jp, tp = carried
    toks = _tokens((3, 3), 4)
    jcache = ref.ed.init_encdec_cache(ref.cfg, 3, 16, 8)
    cache = init_encdec_cache(CFG, 3, 16, 8, "cpu")
    assert sorted(cache) == sorted(jcache)
    leaves = {k: v for k, v in cache.items() if k != "pos"}
    step = make_serve_step(CFG)
    for s in range(3):
        want, jcache = ref.ed.encdec_decode_step(jp, ref.cfg, jcache, ref.jnp.asarray(toks[:, s : s + 1]))
        got, cache = step(tp, cache, torch.as_tensor(toks[:, s : s + 1]))
        _assert_close(got, want)
        assert cache["pos"] == int(jcache["pos"]) == s + 1
        for key, leaf in leaves.items():
            assert cache[key] is leaf
            _assert_close(leaf, jcache[key])
    assert not bool(cache["ck"].any()) and not bool(cache["cv"].any())
    assert not bool(cache["k"][:, :, 3:].any())


def test_decode_cross_attention_reads_the_zero_cache(carried):
    """Nothing fills the cross K/V (the reference's behaviour, ROADMAP C6):
    the cross query's weights change nothing in a decode step."""
    _, tp = carried
    other = dict(tp, dec_blocks=dict(tp["dec_blocks"], cross=dict(
        tp["dec_blocks"]["cross"], wq=-3.0 * tp["dec_blocks"]["cross"]["wq"])))
    toks = torch.as_tensor(_tokens((2, 1), 5))
    a, _ = encdec_decode_step(tp, CFG, init_encdec_cache(CFG, 2, 4, 8, "cpu"), toks)
    b, _ = encdec_decode_step(other, CFG, init_encdec_cache(CFG, 2, 4, 8, "cpu"), toks)
    assert torch.equal(a, b)


def test_cast_for_compute_gives_the_same_logits(carried):
    _, tp = carried
    cast = cast_for_compute(tp)
    assert cast["frontend_proj"].dtype == torch.bfloat16 and cast["enc_norm"].dtype != torch.bfloat16
    assert cast["dec_blocks"]["lnc"] is tp["dec_blocks"]["lnc"]
    src, toks = torch.as_tensor(_src(1, 20, 6)), torch.as_tensor(_tokens((1, 9), 6))
    assert torch.equal(encdec_prefill(cast, CFG, src, toks), encdec_prefill(tp, CFG, src, toks))
    c1, c2 = init_encdec_cache(CFG, 1, 4, 16, "cpu"), init_encdec_cache(CFG, 1, 4, 16, "cpu")
    for s in range(3):
        a, c1 = encdec_decode_step(cast, CFG, c1, toks[:, s : s + 1])
        b, c2 = encdec_decode_step(tp, CFG, c2, toks[:, s : s + 1])
        assert torch.equal(a, b)


def test_serve_engine_tokens_match_reference(ref):
    """tests/test_serving.py's requests on the reference's seed-0 weights,
    the reference's src_len of 16: the same tokens."""
    jp = ref.ed.init_encdec_params(ref.jax.random.PRNGKey(0), ref.cfg)
    tp = params_from_numpy(ref.jax.tree.map(np.asarray, jp), "cpu")
    reqs = [Request(prompt=[1 + i, 2 + i, 3 + i], max_new_tokens=5) for i in range(5)]
    jengine = ref.ServeEngine(jp, ref.cfg, batch_size=3, max_len=64)
    step, logits = jengine.step, {}

    def recording(params, cache, toks):
        out, cache = step(params, cache, toks)
        rows = np.asarray(out[:, 0, : ref.cfg.vocab].astype(ref.jnp.float32))
        for i, r in enumerate(jengine.slots):
            if r is not None and jengine._cursor[i] + 1 >= len(r.prompt):
                logits.setdefault(tuple(r.prompt), []).append(rows[i])
        return out, cache

    jengine.step = recording
    for r in reqs:
        jengine.submit(ref.Request(prompt=list(r.prompt), max_new_tokens=5))
    jdone = jengine.run()
    engine = ServeEngine(tp, CFG, batch_size=3, max_len=64, device="cpu")
    assert engine.cache["ck"].shape[2] == 16
    for r in reqs:
        engine.submit(r)
    done = engine.run()
    assert [r.prompt for r in done] == [r.prompt for r in jdone]
    assert all(r.done and len(r.generated) == 5 for r in done)
    for got, want in zip(done, jdone):
        first = next((j for j, (a, b) in enumerate(zip(got.generated, want.generated)) if a != b), None)
        if first is not None:
            lg = logits[tuple(want.prompt)][first]
            top2 = np.sort(lg)[-2:]
            assert top2[1] - top2[0] < _bound(lg), (want.prompt, got.generated, want.generated)


def test_serve_launcher_runs_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        done = serve_launcher.main(["--arch", ARCH, "--reduced", "--device", "cpu"])
    assert f"{ARCH}: served 6 requests, 72 tokens" in out.getvalue()
    assert all(r.done and len(r.generated) == 12 for r in done)


def test_checkpoint_crosses_packages(ref, tmp_path):
    jp = ref.ed.init_encdec_params(ref.jax.random.PRNGKey(7), ref.cfg)
    ref.ckpt.save_checkpoint(str(tmp_path / "jax_ckpt"), jp)
    tp = load_checkpoint(str(tmp_path / "jax_ckpt"), init_encdec_params(0, CFG, "cpu"))
    assert ref.jax.tree.structure(ref.jax.tree.map(np.asarray, jp)) == ref.jax.tree.structure(
        ref.jax.tree.map(lambda t: t.numpy(), tp))
    src, toks = _src(1, 24, 8), _tokens((1, 12), 8)
    _assert_close(encdec_prefill(tp, CFG, torch.as_tensor(src), torch.as_tensor(toks)),
                  ref.ed.encdec_prefill(jp, ref.cfg, ref.jnp.asarray(src), ref.jnp.asarray(toks)))
    save_checkpoint(str(tmp_path / "torch_ckpt.npz"), tp)
    back = ref.ckpt.load_checkpoint(str(tmp_path / "torch_ckpt.npz"), jp)
    for a, b in zip(ref.jax.tree.leaves(back), ref.jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b).astype(np.float32))
    with pytest.raises(ValueError, match="mismatch"):
        load_checkpoint(str(tmp_path / "jax_ckpt"),
                        init_encdec_params(0, dataclasses.replace(CFG, encoder_layers=3), "cpu"))
