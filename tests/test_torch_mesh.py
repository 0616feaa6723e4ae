"""The port's mesh layer (``launch/mesh.py``, ``layers.constrain``,
per-rank ``roofline.step_cost``) against the reference on the CPU.

  * placements: every arch's param specs (both meshes, both serve
    shardings) as DTensor placements give, on rank 0 and on the last rank,
    the shard shape of the reference's sanitized spec;
  * constraints: ``constrain``'s specs, in call order, through every
    family's loss, prefill and decode at reduced configs equal the
    reference's ``with_sharding_constraint`` specs (recorded under
    ``jax.eval_shape`` with its ``set_sharding_axes``); with the axes
    unset, ``constrain`` returns its argument itself;
  * per-rank counts, in a fake world of 256 ranks in a process of its own:
    a product sharded on batch over data times a weight sharded on rows
    over model counts 16,777,216 flops and one all-gather on the 16 x 16
    mesh, a quarter of the 1 x 1 mesh's flops on a 4 x 1 mesh, and the
    no-mesh count with no collective bytes on a 1 x 1 mesh; a reduced
    dense train step on a 1 x 1 mesh counts the no-mesh flops and no
    collective bytes; ``make_production_mesh`` refuses a world of the
    other size, naming both;
  * the probes: ``probe_roofline``'s extrapolation equals a direct count
    at the full reduced depth, in product flops;
  * the FedNL dry run on both meshes: every record ok, its per-rank
    collective bytes equal to the closed form of ``fednl_shard``'s
    messages.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch
import torch.fx.experimental._config as fx_config
from torch.distributed.tensor._utils import _compute_local_shape_and_global_offset

import repro.launch.specs as jspecs
import repro.models.layers as jlayers
import torch_mesh_worker as worker
from repro.configs import get_config as j_get_config
from repro.models import encdec as jencdec
from repro.models import lm as jlm
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import dryrun
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import placements, production_axis_sizes
from repro_torch.models import encdec as tencdec
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm

MESHES = {"16x16": production_axis_sizes(), "2x16x16": production_axis_sizes(multi_pod=True)}


@pytest.fixture(scope="module")
def world256():
    with dryrun.FakeWorld(multi_pod=False) as world:
        yield world


@pytest.fixture(scope="module")
def world512():
    with dryrun.FakeWorld(multi_pod=True) as world:
        yield world


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------

def _spec_leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in _spec_leaves(tree[key], f"{path}/{key}")]
    return [(path, tree)]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("serve_tp2d", [False, True])
@pytest.mark.parametrize("arch", list_archs())
def test_placements_give_the_reference_shard_shapes(arch, serve_tp2d, mesh):
    sizes = MESHES[mesh]
    cfg, jcfg = get_config(arch), j_get_config(arch)
    init, spec_fn = tspecs._init_fn(cfg)
    params = init(0, cfg, "meta")
    got = tspecs.sanitize_specs(params, spec_fn(cfg, serve_tp2d=serve_tp2d), sizes)
    jinit, jspec_fn = jspecs._init_fn(jcfg)
    with jax.enable_x64(False):
        jparams = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), jcfg))
    want = jspecs.sanitize_specs(jparams, jspec_fn(jcfg, serve_tp2d=serve_tp2d), sizes)
    stand_in = types.SimpleNamespace(mesh_dim_names=tuple(sizes))
    mesh_shape = tuple(sizes.values())
    shapes = {path: leaf.shape for path, leaf in _spec_leaves(params)}
    for (path, spec), (jpath, jspec) in zip(_spec_leaves(got), _spec_leaves(want), strict=True):
        assert path == jpath
        shape = shapes[path]
        entries = tuple(jspec) + (None,) * (len(shape) - len(jspec))
        shard = tuple(dim // int(np.prod([sizes[a] for a in (e if isinstance(e, tuple) else (e,))]))
                      if e is not None else dim for dim, e in zip(shape, entries))
        pl = placements(spec, stand_in)
        for coord in ([0] * len(mesh_shape), [n - 1 for n in mesh_shape]):
            local, _ = _compute_local_shape_and_global_offset(shape, mesh_shape, coord, pl)
            assert tuple(local) == shard, (path, coord, spec, jspec)


def test_placements_refuse_an_axis_out_of_the_mesh_order():
    stand_in = types.SimpleNamespace(mesh_dim_names=("data", "model"))
    with pytest.raises(ValueError, match="out of the mesh's order"):
        placements(tspecs.P(("model", "data")), stand_in)


# ---------------------------------------------------------------------------
# constraints
# ---------------------------------------------------------------------------

CONSTRAIN_ARCHS = ["granite-3-2b", "granite-moe-1b-a400m", "mamba2-2.7b", "recurrentgemma-2b",
                   "llava-next-mistral-7b", "seamless-m4t-large-v2"]
SIZES = {"data": 2, "model": 2}
B, S = 2, 32


def _cut(cfg):
    """One layer (recurrentgemma: its pattern, both layer types); the
    reference's scan traces its body once, the port runs each layer."""
    n = len(cfg.hybrid.pattern) if cfg.hybrid else 1
    kw = {"n_layers": n}
    if cfg.encoder_layers:
        kw["encoder_layers"] = 1
    return dataclasses.replace(cfg.reduced(), **kw)


def _ref_specs(monkeypatch, run, args):
    """The specs of the reference's constraints, in call order, tracing
    ``run(*args)`` under jax.eval_shape; its hybrid branches marked."""
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: seen.append(tuple(spec)) or x)
    for mod, name in [(jlm, name) for name in ATTN + REC]:
        fn = getattr(mod, name)

        def marked(*a, _fn=fn, _name=name, **k):
            seen.append(f"<{_name}")
            out = _fn(*a, **k)
            seen.append(f"{_name}>")
            return out

        monkeypatch.setattr(mod, name, marked)
    jlayers.set_sharding_axes("data", "model", SIZES)
    try:
        with jax.enable_x64(False):
            jax.eval_shape(run, *args)
    finally:
        jlayers.clear_sharding_axes()
    return seen


ATTN, REC = ("_attn_apply", "_attn_decode"), ("rglru_apply", "rglru_decode_step")


def _layer_views(seen, cfg, kind):
    """The reference's sequence as the port runs it: the scan body once per
    layer, and in a hybrid body only the branch of the layer's type (the
    loss pins its embeddings before the layers and its logits after)."""
    specs = [i for i, x in enumerate(seen) if not isinstance(x, str)]
    n_pre, n_post = (1, 1) if kind == "loss" else (0, 0)
    lo = specs[n_pre - 1] + 1 if n_pre else 0
    hi = specs[len(specs) - n_post] if n_post else len(seen)
    pre, body, post = seen[:lo], seen[lo:hi], seen[hi:]

    def without(names):
        out, skipping = [], None
        for x in body:
            if isinstance(x, str):
                name = x.strip("<>")
                if x.startswith("<") and name in names:
                    skipping = name
                elif x.endswith(">") and name == skipping:
                    skipping = None
            elif skipping is None:
                out.append(x)
        return out

    layers = [without(REC if t == 0 else ATTN) for t in tlm.layer_types(cfg)]
    if cfg.family != "hybrid":
        layers = [without(())] * cfg.n_layers
    return pre + sum(layers, []) + post


def _port_specs(monkeypatch, run):
    seen = []
    spec_of = tlayers.activation_spec

    def recording(shape, axes):
        spec = spec_of(shape, axes)
        seen.append(tuple(spec))
        return spec

    monkeypatch.setattr(tlayers, "activation_spec", recording)
    tlayers.set_sharding_axes("data", "model", SIZES)
    try:
        with torch.no_grad(), fx_config.patch(meta_nonzero_assume_all_nonzero=True):
            run()
    finally:
        tlayers.clear_sharding_axes()
    return seen


def _inputs(cfg, jcfg, kind):
    """(port call, reference function, its abstract arguments) of one
    forward on meta / abstract inputs."""
    encdec = cfg.family == "encdec"
    tinit = tencdec.init_encdec_params if encdec else tlm.init_lm_params
    jinit = jencdec.init_encdec_params if encdec else jlm.init_lm_params
    params = tinit(0, cfg, "meta")
    with jax.enable_x64(False):
        jparams = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), jcfg))
    tokens = torch.zeros((B, S), dtype=torch.int64, device="meta")
    jtokens = jax.ShapeDtypeStruct((B, S), np.int32)
    extra, jextra = {}, {}
    if cfg.family == "vlm":
        extra["img_embeds"] = torch.zeros((B, cfg.n_frontend_tokens, cfg.d_model), device="meta")
        jextra["img_embeds"] = jax.ShapeDtypeStruct((B, cfg.n_frontend_tokens, cfg.d_model),
                                                    np.float32)
    if encdec:
        extra["src_embeds"] = torch.zeros((B, S, cfg.d_model), device="meta")
        jextra["src_embeds"] = jax.ShapeDtypeStruct((B, S, cfg.d_model), np.float32)
    if kind == "loss":
        batch = {"tokens": tokens, "labels": tokens, **extra}
        jbatch = {"tokens": jtokens, "labels": jtokens, **jextra}
        mod = (tencdec, jencdec, "encdec_loss") if encdec else (tlm, jlm, "lm_loss")
        return (lambda: getattr(mod[0], mod[2])(params, cfg, batch),
                lambda p, b: getattr(mod[1], mod[2])(p, jcfg, b), (jparams, jbatch))
    if kind == "prefill":
        if encdec:
            return (lambda: tencdec.encdec_prefill(params, cfg, extra["src_embeds"], tokens),
                    lambda p, e, t: jencdec.encdec_prefill(p, jcfg, e, t),
                    (jparams, jextra["src_embeds"], jtokens))
        img = extra.get("img_embeds")
        return (lambda: tlm.lm_prefill(params, cfg, tokens, img),
                lambda p, t, *i: jlm.lm_prefill(p, jcfg, t, *i),
                (jparams, jtokens, *([jextra["img_embeds"]] if img is not None else [])))
    one, jone = tokens[:, :1], jax.ShapeDtypeStruct((B, 1), np.int32)
    if encdec:
        cache = tencdec.init_encdec_cache(cfg, B, S, S, "meta")
        jcache = jax.eval_shape(lambda: jencdec.init_encdec_cache(jcfg, B, S, S))
        return (lambda: tencdec.encdec_decode_step(params, cfg, cache, one),
                lambda p, c, t: jencdec.encdec_decode_step(p, jcfg, c, t), (jparams, jcache, jone))
    cache = tlm.init_decode_cache(cfg, B, S, "meta")
    jcache = jax.eval_shape(lambda: jlm.init_decode_cache(jcfg, B, S))
    return (lambda: tlm.lm_decode_step(params, cfg, cache, one),
            lambda p, c, t: jlm.lm_decode_step(p, jcfg, c, t), (jparams, jcache, jone))


@pytest.mark.parametrize("kind", ["loss", "prefill", "decode"])
@pytest.mark.parametrize("arch", CONSTRAIN_ARCHS)
def test_constrain_specs_follow_the_reference(arch, kind, monkeypatch):
    cfg = _cut(get_config(arch))
    jcfg = _cut(j_get_config(arch))
    run, jrun, jargs = _inputs(cfg, jcfg, kind)
    got = _port_specs(monkeypatch, run)
    want = _layer_views(_ref_specs(monkeypatch, jrun, jargs), cfg, kind)
    assert got == want
    if kind != "decode":  # the ssm's decode pins nothing
        assert any(any(e is not None for e in spec) for spec in got)


def test_constrain_without_axes_returns_its_argument():
    x = torch.zeros(4, 8, 16)
    assert tlayers.sharding_axes() is None
    assert tlayers.constrain(x, "dp", None, "tp") is x
    tlayers.set_sharding_axes("data", "model", SIZES)
    try:
        assert tlayers.constrain(x, "dp", None, "tp") is x  # a plain tensor: no mesh
    finally:
        tlayers.clear_sharding_axes()


# ---------------------------------------------------------------------------
# per-rank counts, in fake worlds
# ---------------------------------------------------------------------------

def test_per_rank_counts_of_a_sharded_product(world256):
    flops, coll = world256.call(worker.scratch_case, (16, 16))
    assert flops == 16_777_216
    assert coll["all-gather"] == 2 * 8 * 4096 * 4  # rank 0's (2, 8, 256) f32 gathered over model
    assert sum(coll.values()) == coll["all-gather"]
    flops_4, coll_4 = world256.call(worker.scratch_case, (4, 1))
    flops_1, coll_1 = world256.call(worker.scratch_case, (1, 1))
    assert flops_1 == 2 * 256 * 2048 * 4096  # the whole product, as with no mesh
    assert flops_4 * 4 == flops_1
    assert sum(coll_1.values()) == 0 and sum(coll_4.values()) == 0


def test_a_one_by_one_mesh_counts_the_plain_step(world256):
    on_mesh, plain = world256.call(worker.one_by_one_step, "granite-3-2b", "train_4k", 4)
    assert on_mesh["flops"] == plain["flops"] > 0
    assert sum(on_mesh["coll"].values()) == 0


def test_the_production_mesh_needs_its_world(world256, world512):
    msg = world256.call(worker.wrong_mesh, True)
    assert "512" in msg and "256" in msg
    msg = world512.call(worker.wrong_mesh, False)
    assert "256" in msg and "512" in msg
    assert "256 ranks" in worker.wrong_mesh(False)  # this process's group is not a mesh's


@pytest.mark.parametrize("arch, shape, n_layers, accum, q_chunk", [
    ("granite-3-2b", "train_4k", 6, 4, 4096),  # the probes' own q_chunk
    ("recurrentgemma-2b", "prefill_32k", 9, 1, 4096),
])
def test_probes_extrapolate_to_the_direct_count(world256, arch, shape, n_layers, accum, q_chunk):
    probed, direct = world256.call(worker.probe_and_direct, arch, shape, n_layers, accum, q_chunk)
    assert probed == direct > 0


@pytest.mark.parametrize("multi_pod", [False, True])
def test_fednl_dry_run_moves_its_closed_form(world256, world512, multi_pod):
    world = world512 if multi_pod else world256
    records = world.call(dryrun.run_fednl_dryrun, multi_pod)
    assert [r["arch"] for r in records] == [
        "fednl/dense_psum", "fednl/sparse_allgather", "fednl/sparse_allgather_f32"]
    for rec in records:
        assert rec["status"] == "ok", rec
        assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
        got = {k: v for k, v in rec["collectives"].items() if v}
        assert got == {k: v for k, v in rec["closed_form"].items() if v}
        name = rec["arch"].split("/")[1]
        assert rec["closed_form"] == dryrun.fednl_closed_form(name, 256, 301, 8 * 301)
    dense = records[0]["collectives"]["all-reduce"]
    assert dense == (301 * 302 // 2 + 301 + 2) * 8 + 3 * 8
