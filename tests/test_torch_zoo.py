"""The LM zoo's moe, ssm, hybrid and vlm families of the port against the
JAX package on reduced configs (CPU): init, forward, prefill, decode steps
with their caches, prefill against sequential decode, ``cast_for_compute``,
the serving engine, its launcher and checkpoints.  Weights are the
reference's (``repro.models.init_lm_params``), carried over as numpy.

Tolerance: ``LOGIT_ULPS`` = 4 bf16 ulps of the largest magnitude of the
reference tensor, as in tests/test_torch_lm.py: bf16 activations rounded at
other places in XLA and PyTorch.  Greedy tokens may differ only where the
reference's top-2 logit margin is under that bound (on these fixtures one
does, at recurrentgemma's exact tie of two bf16 logits); the rest of such a
request follows its own tokens and is not compared.

MoE routing is a discontinuous function of its input: an assignment flips
where the reference's k-th and (k+1)-th router probabilities are within
the two runs' own difference of the probabilities.  So the moe comparisons
record every router input of both runs (``moe_apply``'s argument), route
both with the same function, and allow a token to route otherwise only at
such a near tie (|p_k - p_k+1| <= 2 max |p_port - p_ref|), and a kept flag
to differ only in a call where some assignment flipped (the capacity
queues shift).  Logit rows of the batch row of such a token, from its
position on, are left out of the bound (attention carries the difference
to the later positions); every other row is held to ``LOGIT_ULPS``.
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
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import (
    cast_for_compute,
    init_decode_cache,
    init_lm_params,
    lm_decode_step,
    lm_forward,
    lm_prefill,
    params_from_numpy,
)
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.serving import Request, ServeEngine
from repro_torch.train import load_checkpoint, make_prefill_step, make_serve_step, save_checkpoint

LOGIT_ULPS = 4
ZOO = ["mixtral-8x22b", "granite-moe-1b-a400m", "mamba2-2.7b", "recurrentgemma-2b",
       "llava-next-mistral-7b"]
ONE_PER_FAMILY = ["granite-moe-1b-a400m", "mamba2-2.7b", "recurrentgemma-2b",
                  "llava-next-mistral-7b"]


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
    for arch in ZOO:
        jp = ref.models.init_lm_params(ref.jax.random.PRNGKey(3), ref.configs.get_config(arch).reduced())
        out[arch] = jp, params_from_numpy(ref.jax.tree.map(np.asarray, jp), "cpu")
    return out


def _np32(a) -> np.ndarray:
    return np.asarray(a.astype("float32")) if hasattr(a, "astype") else np.asarray(a, np.float32)


def _bound(want: np.ndarray) -> float:
    """LOGIT_ULPS bf16 ulps at the largest magnitude of ``want``."""
    _, e = np.frexp(np.float32(np.abs(want).max()))
    return LOGIT_ULPS * float(np.ldexp(1.0, int(e) - 8))


def _assert_close(got: torch.Tensor, want, rows=None) -> None:
    """Within the bound; ``rows`` (a boolean mask over the leading axes)
    picks the rows held to it."""
    want = _np32(want)
    got = got.float().numpy()
    assert got.shape == want.shape
    tol = _bound(want)
    if rows is not None:
        got, want = got[rows], want[rows]
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=shape)


def _img(cfg, batch, seed):
    """numpy image embeddings (B, n_frontend_tokens, d_model) for vlm, else None."""
    if cfg.frontend != "vision":
        return None
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)


def _maybe(t, x):
    return None if x is None else t(x)


# ---------------------------------------------------------------------------
# moe: both runs' routing, recorded
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _record_router_inputs(ref, monkeypatch):
    """Record the argument of every ``moe_apply`` call of both packages' LM
    code, in call order: (port's list, reference's list), each entry a
    (B, S, D) bf16 tensor."""
    port, theirs = [], []
    port_fn, ref_fn = tlm.moe_apply, ref.lm.moe_apply

    def port_rec(x, *a, **kw):
        port.append(x.detach().clone())
        return port_fn(x, *a, **kw)

    def ref_rec(x, *a, **kw):
        ref.jax.debug.callback(lambda v: theirs.append(torch.as_tensor(np.array(
            v.astype("float32"))).to(torch.bfloat16)), x, ordered=True)
        return ref_fn(x, *a, **kw)

    with monkeypatch.context() as m:
        m.setattr(tlm, "moe_apply", port_rec)
        m.setattr(ref.lm, "moe_apply", ref_rec)
        yield port, theirs
        ref.jax.effects_barrier()  # the reference's callbacks have run


def _route_table(h, router, cfg):
    """Per token: its experts (sorted), their kept flags, and the router's
    probabilities, from ``moe_dispatch`` (exactly the reference's routing on
    the same input: tests/test_torch_moe.py)."""
    m = cfg.moe
    t = h.shape[0] * h.shape[1]
    r = tmoe.moe_dispatch(h, router, n_experts=m.n_experts, top_k=m.top_k,
                          capacity_factor=m.capacity_factor)
    experts = torch.empty(t * m.top_k, dtype=torch.long)
    kept = torch.empty(t * m.top_k, dtype=torch.bool)
    experts[r["order"]], kept[r["order"]] = r["se"], r["keep"]
    experts, kept = experts.reshape(t, m.top_k), kept.reshape(t, m.top_k)
    idx = experts.argsort(dim=-1)
    probs = torch.softmax(h.reshape(t, -1).float() @ router.float(), dim=-1)
    return experts.gather(-1, idx), kept.gather(-1, idx), probs


def _moe_first_difference(port_h, ref_h, tp, cfg, pos0: int, first=None) -> dict[int, int]:
    """Compare both runs' routing call by call (call c is layer c %
    n_layers, its first position ``pos0``) and check each difference is a
    near tie or, for a kept flag, a shifted queue.  Returns {batch row:
    first position whose routing differed}, starting from ``first``; rows
    past their first difference are not compared."""
    assert len(port_h) == len(ref_h) > 0
    first = dict(first or {})
    k = cfg.moe.top_k
    for c, (hp, hr) in enumerate(zip(port_h, ref_h)):
        router = tp["blocks"]["moe"]["router"][c % cfg.n_layers]
        ep, kp, pp = _route_table(hp, router, cfg)
        er, kr, pr = _route_table(hr, router, cfg)
        b, s = hp.shape[:2]
        pos = pos0 + torch.arange(b * s) % s
        row = torch.arange(b * s) // s
        live = torch.tensor([int(p) < first.get(int(r), 1 << 30) for r, p in zip(row, pos)])
        if not bool(live.any()):
            continue
        delta = float((pp - pr).abs()[live].max())
        top = pr.sort(dim=-1, descending=True).values
        margin = top[:, k - 1] - top[:, k] if top.shape[1] > k else torch.full((b * s,), np.inf)
        flipped = live & (ep != er).any(-1)
        shifted = live & ~flipped & (kp != kr).any(-1)
        assert bool((margin[flipped] <= 2 * delta).all()), (
            f"call {c}: a token routes otherwise at a margin {margin[flipped].min()} "
            f"above twice the runs' probability difference {delta}")
        assert not bool(shifted.any()) or bool(flipped.any()), (
            f"call {c}: a kept flag differs with no assignment flipped")
        for t in torch.nonzero(flipped | shifted).flatten().tolist():
            r_, p_ = int(row[t]), int(pos[t])
            first[r_] = min(first.get(r_, p_), p_)
    return first


def _held_rows(first: dict[int, int], batch: int, length: int) -> np.ndarray:
    """(batch, length) mask of the positions held to the bound."""
    rows = np.ones((batch, length), dtype=bool)
    for r, p in first.items():
        rows[r, p:] = False
    return rows


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ZOO)
def test_init_matches_reference_structure(ref, arch):
    cfg = get_config(arch).reduced()
    want = ref.models.init_lm_params(ref.jax.random.PRNGKey(0), ref.configs.get_config(arch).reduced())
    got = init_lm_params(0, cfg, "cpu")
    flat_w = {"/".join(str(k.key) for k in path): leaf
              for path, leaf in ref.jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_g = {"/".join(str(k.key) for k in path): leaf
              for path, leaf in ref.jax.tree_util.tree_flatten_with_path(got)[0]}
    assert sorted(flat_g) == sorted(flat_w)
    for key, leaf in flat_w.items():
        g, w = flat_g[key], np.asarray(leaf)
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, key
        # the same scale and centre: 0.02 for embeddings, 1/sqrt(fan_in) or
        # 0.3 for matrices, constants for norms, biases, D and lambda
        assert abs(float(g.std()) - float(w.std())) <= 0.1 * float(w.std()) + 1e-6, key
        assert abs(float(g.mean()) - float(w.mean())) <= 0.1 * float(w.std()) + 1e-6, key
    assert torch.equal(init_lm_params(0, cfg, "cpu")["embed"], got["embed"])


@pytest.mark.parametrize("arch", ZOO)
def test_forward_and_prefill_match_reference(ref, carried, arch, monkeypatch):
    cfg, jcfg = get_config(arch).reduced(), ref.configs.get_config(arch).reduced()
    jp, tp = carried[arch]
    img = _img(cfg, 2, 9)
    n_img = 0 if img is None else img.shape[1]
    toks = _tokens(cfg, (2, 70), 1)  # 70 tokens: q_chunk 32 does not divide it
    with _record_router_inputs(ref, monkeypatch) as (port_h, ref_h):
        want = ref.lm.lm_forward(jp, jcfg, ref.jnp.asarray(toks), _maybe(ref.jnp.asarray, img))
        got = lm_forward(tp, cfg, torch.as_tensor(toks), _maybe(torch.as_tensor, img))
    assert got.dtype == torch.bfloat16 and got.shape == (2, n_img + 70, tlm.padded_vocab(cfg))
    rows = None
    if cfg.family == "moe":
        first = _moe_first_difference(port_h, ref_h, tp, cfg, 0)
        rows = _held_rows(first, 2, 70)
        assert rows.mean() >= 0.75, f"routing differs from the start of the rows: {first}"
    _assert_close(got, want, rows)

    toks = _tokens(cfg, (2, 64), 2)
    img = _img(cfg, 2, 10)
    batch = {"tokens": torch.as_tensor(toks)}
    if img is not None:
        batch["img_embeds"] = torch.as_tensor(img)
    with _record_router_inputs(ref, monkeypatch) as (port_h, ref_h):
        want = ref.lm.lm_prefill(jp, jcfg, ref.jnp.asarray(toks), _maybe(ref.jnp.asarray, img))
        got = make_prefill_step(cfg)(tp, batch)
    rows = None
    if cfg.family == "moe":
        rows = _held_rows(_moe_first_difference(port_h, ref_h, tp, cfg, 0), 2, 64)[:, -1]
        assert rows.any()
    _assert_close(got, want, rows)


@pytest.mark.parametrize("arch", ZOO)
def test_decode_steps_match_reference(ref, carried, arch, monkeypatch):
    """Three decode steps from a zeroed cache: logits and every cache leaf
    within the bound, pos, and the port's cache tensors updated in place."""
    cfg, jcfg = get_config(arch).reduced(), ref.configs.get_config(arch).reduced()
    jp, tp = carried[arch]
    toks = _tokens(cfg, (3, 3), 4)
    jcache = ref.models.init_decode_cache(jcfg, 3, 16)
    cache = init_decode_cache(cfg, 3, 16, "cpu")
    assert sorted(cache) == sorted(jcache)
    leaves = {k: v for k, v in cache.items() if k != "pos"}
    step = make_serve_step(cfg)
    first: dict[int, int] = {}
    for s in range(3):
        with _record_router_inputs(ref, monkeypatch) as (port_h, ref_h):
            want, jcache = ref.models.lm_decode_step(jp, jcfg, jcache, ref.jnp.asarray(toks[:, s : s + 1]))
            got, cache = step(tp, cache, torch.as_tensor(toks[:, s : s + 1]))
        held = None
        if cfg.family == "moe":  # a batch row held until its routing differs
            first = _moe_first_difference(port_h, ref_h, tp, cfg, s, first)
            held = np.array([r not in first for r in range(3)])
            assert held.any()
        _assert_close(got, want, held)
        assert cache["pos"] == int(jcache["pos"]) == s + 1
        for key, leaf in leaves.items():
            assert cache[key] is leaf  # written in place
            _assert_close(leaf, jcache[key], None if held is None else (slice(None), held))


# the configs whose attention decodes from a ring cache of its window: the
# sliding-window ones and the hybrid's local attention
RING = ["mixtral-8x22b", "llava-next-mistral-7b", "recurrentgemma-2b"]


def _chip_smoke():
    """chip_smoke.py, loaded by its path (its long_500k_inputs: the card's
    start of the long_500k decode)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _ring_window(cfg) -> int:
    return cfg.window if cfg.window is not None else cfg.hybrid.local_window


def _ring_case(ref, carried, arch):
    """(cfg, jcfg, jax params, the same as CPU tensors): the reduced config;
    the hybrid's at 3 layers, so that one of its (rglru, rglru, attn) layers
    is attention."""
    cfg, jcfg = get_config(arch).reduced(), ref.configs.get_config(arch).reduced()
    if cfg.family != "hybrid":
        return (cfg, jcfg, *carried[arch])
    cfg, jcfg = dataclasses.replace(cfg, n_layers=3), dataclasses.replace(jcfg, n_layers=3)
    jp = ref.models.init_lm_params(ref.jax.random.PRNGKey(3), jcfg)
    return cfg, jcfg, jp, params_from_numpy(ref.jax.tree.map(np.asarray, jp), "cpu")


def _decode_both(ref, case, monkeypatch, cache: dict, toks: np.ndarray) -> dict:
    """One decode step a column of ``toks`` (B, n) from ``cache`` (the
    port's; the reference's the same bits) in both packages (``case``:
    _ring_case's), the reference's step jitted once: the logits and every
    cache leaf within the bound after each step (moe: a batch row held
    until its routing differs), pos exact, the port's leaves written in
    place.  Returns the port's cache and {batch row: first position whose
    routing differed}."""
    cfg, jcfg, jp, tp = case
    jnp = ref.jnp
    jcache = {"pos": jnp.asarray(cache["pos"], dtype=jnp.int32)}
    for key, leaf in cache.items():
        if key != "pos":  # bf16 leaves through f32: exact
            jcache[key] = jnp.asarray(leaf.float().numpy()).astype(
                jnp.bfloat16 if leaf.dtype == torch.bfloat16 else jnp.float32)
    leaves = {k: v for k, v in cache.items() if k != "pos"}
    step, jstep = make_serve_step(cfg), ref.jax.jit(ref.models.lm_decode_step, static_argnums=1)
    pos0, first = cache["pos"], {}
    with _record_router_inputs(ref, monkeypatch) as (port_h, ref_h):
        for s in range(toks.shape[1]):
            calls = len(port_h)
            want, jcache = jstep(jp, jcfg, jcache, jnp.asarray(toks[:, s : s + 1]))
            got, cache = step(tp, cache, torch.as_tensor(toks[:, s : s + 1]))
            held = None
            if cfg.family == "moe":
                ref.jax.effects_barrier()  # this step's router inputs are in
                first = _moe_first_difference(port_h[calls:], ref_h[calls:], tp, cfg, pos0 + s,
                                              first)
                held = np.array([r not in first for r in range(toks.shape[0])])
            _assert_close(got, want, held)
            assert cache["pos"] == int(jcache["pos"]) == pos0 + s + 1
            for key, leaf in leaves.items():
                assert cache[key] is leaf  # written in place
                _assert_close(leaf, jcache[key], None if held is None else (slice(None), held))
    return cache, first


@pytest.mark.parametrize("arch", RING)
def test_ring_cache_decodes_through_its_wrap(ref, carried, arch, monkeypatch):
    """A cache as long as the window (a ring): window + 6 decode steps from
    an empty cache, through the ring's wrap, against the reference's
    lm_decode_step; the moe's rows held until their routing differs, one
    of them past the wrap."""
    case = _ring_case(ref, carried, arch)
    cfg = case[0]
    window = _ring_window(cfg)
    cache = init_decode_cache(cfg, 2, window, "cpu")
    assert cache["k"].shape[2] == window  # the ring: every slot written again past the wrap
    assert 0 in tlm.layer_types(cfg)  # an attention layer reads it
    toks = _tokens(cfg, (2, window + 6), 12)
    cache, first = _decode_both(ref, case, monkeypatch, cache, toks)
    assert cache["pos"] == window + 6
    if cfg.family == "moe":
        assert max(first.get(r, 1 << 30) for r in range(2)) > window, first


@pytest.mark.parametrize("arch", RING)
def test_long_500k_ring_decode_matches_reference(ref, carried, arch, monkeypatch):
    """chip_smoke.long_500k_inputs' cache (a full ring, every leaf a seeded
    numpy draw, pos 524,283: the long_500k shape's last positions), which
    the card's zoo phase decodes from, and 4 decode steps from it against
    the reference's; each step writes slot pos % window and no other."""
    cs = _chip_smoke()
    case = _ring_case(ref, carried, arch)
    cfg = case[0]
    window = _ring_window(cfg)
    cache, toks = cs.long_500k_inputs(cfg)
    assert cache["pos"] == cs.LONG_POS == 524_283 and toks.shape == (1, cs.LONG_STEPS)
    again, toks_again = cs.long_500k_inputs(cfg)  # the same bits from the same seed
    assert all(torch.equal(again[k], cache[k]) for k in cache if k != "pos")
    assert np.array_equal(toks, toks_again)
    start = {k: v.clone() for k, v in cache.items() if k != "pos"}
    cache, _ = _decode_both(ref, case, monkeypatch, cache, toks)
    assert cache["pos"] == cs.LONG_POS + cs.LONG_STEPS
    slots = sorted((cs.LONG_POS + s) % window for s in range(cs.LONG_STEPS))
    attn = [i for i, t in enumerate(tlm.layer_types(cfg)) if t == 0]
    assert attn
    for key in ("k", "v"):
        changed = (cache[key] != start[key]).any(-1).any(-1).any(1)  # (layers, window)
        for layer in range(cfg.n_layers):
            want = slots if layer in attn else []
            assert changed[layer].nonzero().flatten().tolist() == want, (key, layer)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-2b", "llava-next-mistral-7b"])
def test_prefill_agrees_with_sequential_decode(carried, arch):
    """The full-sequence forms (chunked SSD, the log-depth RG-LRU scan,
    chunked attention) and five decode steps are one function (vlm without
    image embeddings, as the reference's smoke test runs it)."""
    cfg = get_config(arch).reduced()
    _, tp = carried[arch]
    toks = torch.as_tensor(_tokens(cfg, (2, 5), 5))
    want = lm_prefill(tp, cfg, toks)
    cache = init_decode_cache(cfg, 2, 8, "cpu")
    for s in range(5):
        got, cache = lm_decode_step(tp, cfg, cache, toks[:, s : s + 1])
    np.testing.assert_allclose(got[:, 0].float().numpy(), want.float().numpy(), rtol=0,
                               atol=_bound(want.float().numpy()))


@pytest.mark.parametrize("arch", ZOO)
def test_cast_for_compute_gives_the_same_logits(carried, arch):
    cfg = get_config(arch).reduced()
    _, tp = carried[arch]
    cast = cast_for_compute(tp)
    blocks = cast["blocks"]
    assert cast["embed"].dtype == torch.bfloat16 and cast["final_norm"].dtype == torch.float32
    for name, group in blocks.items():
        if isinstance(group, dict):
            for key, leaf in group.items():
                if key in tlm.F32_LEAVES or key.endswith("norm"):
                    assert leaf is tp["blocks"][name][key], key  # kept as given
                else:
                    assert leaf.dtype == torch.bfloat16, key
    img = _maybe(torch.as_tensor, _img(cfg, 1, 11))
    toks = torch.as_tensor(_tokens(cfg, (1, 9), 6))
    assert torch.equal(lm_forward(cast, cfg, toks, img), lm_forward(tp, cfg, toks, img))
    c1, c2 = init_decode_cache(cfg, 1, 4, "cpu"), init_decode_cache(cfg, 1, 4, "cpu")
    for s in range(3):
        a, c1 = lm_decode_step(cast, cfg, c1, toks[:, s : s + 1])
        b, c2 = lm_decode_step(tp, cfg, c2, toks[:, s : s + 1])
        assert torch.equal(a, b)


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


@pytest.mark.parametrize("arch", ONE_PER_FAMILY)
def test_serve_engine_tokens_match_reference(ref, arch):
    """tests/test_serving.py's requests (batch 3, 5 requests of 3 prompt and
    5 new tokens) on the reference's seed-0 weights: the same tokens."""
    cfg, jcfg = get_config(arch).reduced(), ref.configs.get_config(arch).reduced()
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
    for got, want in zip(done, jdone):
        first = next((j for j, (a, b) in enumerate(zip(got.generated, want.generated)) if a != b), None)
        if first is None:
            continue
        lg = jlogits[tuple(want.prompt)][first]  # the rest of the request follows its own tokens
        top2 = np.sort(lg)[-2:]
        assert top2[1] - top2[0] < _bound(lg), (
            f"prompt {want.prompt}: token {first} differs ({got.generated} vs {want.generated}) "
            f"at a top-2 margin {top2[1] - top2[0]} above the bound {_bound(lg)}")


@pytest.mark.parametrize("arch", ZOO)
def test_serve_launcher_runs_on_cpu(arch):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        done = serve_launcher.main(["--arch", arch, "--reduced", "--device", "cpu"])
    assert f"{arch}: served 6 requests, 72 tokens" in out.getvalue()
    assert all(r.done and len(r.generated) == 12 for r in done)


def test_hybrid_checkpoint_crosses_packages(ref, tmp_path):
    """A recurrentgemma checkpoint of either package loads in the other; the
    logits follow."""
    arch = "recurrentgemma-2b"
    cfg, jcfg = get_config(arch).reduced(), ref.configs.get_config(arch).reduced()
    jp = ref.models.init_lm_params(ref.jax.random.PRNGKey(7), jcfg)
    ref.ckpt.save_checkpoint(str(tmp_path / "jax_ckpt"), jp)
    tp = load_checkpoint(str(tmp_path / "jax_ckpt"), init_lm_params(0, cfg, "cpu"))
    assert ref.jax.tree.structure(ref.jax.tree.map(np.asarray, jp)) == ref.jax.tree.structure(
        ref.jax.tree.map(lambda t: t.numpy(), tp))
    toks = _tokens(cfg, (1, 12), 8)
    _assert_close(lm_prefill(tp, cfg, torch.as_tensor(toks)),
                  ref.lm.lm_prefill(jp, jcfg, ref.jnp.asarray(toks)))
    save_checkpoint(str(tmp_path / "torch_ckpt.npz"), tp)
    back = ref.ckpt.load_checkpoint(str(tmp_path / "torch_ckpt.npz"), jp)
    for a, b in zip(ref.jax.tree.leaves(back), ref.jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b).astype(np.float32))
    with pytest.raises(ValueError, match="mismatch"):
        load_checkpoint(str(tmp_path / "jax_ckpt"),
                        init_lm_params(0, dataclasses.replace(cfg, n_layers=3), "cpu"))
