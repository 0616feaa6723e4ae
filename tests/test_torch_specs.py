"""The port's dry-run specs (``repro_torch.launch.specs``, the spec functions
of ``models/lm.py`` and ``models/encdec.py``, ``launch/mesh.py``) against
``repro.launch.specs`` on the CPU, every architecture at full size.

  * ``sanitize_specs`` on the 16 x 16 and 2 x 16 x 16 meshes, both
    ``serve_tp2d`` values: the port's tree, each ``P`` as a tuple, equal to
    the reference's;
  * the cache specs for both shapes of tests/test_specs.py: equal;
  * a twin of tests/test_specs.py on the port's meta tensors: every spec
    axis divides its dimension;
  * ``build_dryrun`` for every architecture x shape on the 16 x 16 mesh:
    skip reasons and notes equal, every argument's shape and dtype equal to
    the reference's ``ShapeDtypeStruct`` (the cache's position is a Python
    int in the port, a () int32 in the reference), in and out specs equal.

The reference is traced without x64, as its dry run traces (under x64 its
scaled draws promote to f64).  Its ``NamedSharding`` is replaced, in this
test's process, by the bare spec, and its mesh by a stand-in with the
production axis names and sizes, so that no 256-device mesh is needed.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import repro.launch.specs as jspecs
from repro.configs import get_config as j_get_config
from repro.models.encdec import encdec_cache_specs as j_encdec_cache_specs
from repro.models.lm import cache_specs as j_cache_specs
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import P, data_axes, production_axis_sizes
from repro_torch.models import init_decode_cache, init_encdec_cache
from repro_torch.models.encdec import encdec_cache_specs
from repro_torch.models.lm import cache_specs

MESHES = {"16x16": production_axis_sizes(), "2x16x16": production_axis_sizes(multi_pod=True)}
CACHE_SHAPES = [(128, 32768, "data", None), (1, 524288, None, "data")]  # tests/test_specs.py
# the long shape's cache only where the architecture decodes it (sub-quadratic)
CACHE_CASES = [(arch, *shape) for arch in list_archs() for shape in CACHE_SHAPES
               if shape[1] != 524288 or get_config(arch).sublquadratic]


def _tuples(tree):
    """A spec tree with each P (the port's or jax's) as a plain tuple."""
    if isinstance(tree, dict):
        return {key: _tuples(val) for key, val in tree.items()}
    if isinstance(tree, (P, JP)):
        return tuple(tree)
    if isinstance(tree, tuple):
        return tuple(_tuples(x) for x in tree)
    return tree


def _ref_params(jcfg):
    init, _ = jspecs._init_fn(jcfg)
    with jax.enable_x64(False):
        return jax.eval_shape(lambda: init(jax.random.PRNGKey(0), jcfg))


def test_production_axes_and_data_axes():
    assert MESHES["16x16"] == {"data": 16, "model": 16}
    assert MESHES["2x16x16"] == {"pod": 2, "data": 16, "model": 16}
    for sizes in MESHES.values():
        mesh = types.SimpleNamespace(axis_names=tuple(sizes))
        assert data_axes(sizes) == data_axes(tuple(sizes)) == jspecs.data_axes(mesh)
    assert tuple(P("data", ("pod", "data"), None)) == tuple(JP("data", ("pod", "data"), None))
    assert repr(P(None, "model")) == "P(None, 'model')"


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("serve_tp2d", [False, True])
@pytest.mark.parametrize("arch", list_archs())
def test_sanitized_param_specs_match_the_reference(arch, serve_tp2d, mesh):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    init, spec_fn = tspecs._init_fn(cfg)
    _, j_spec_fn = jspecs._init_fn(jcfg)
    sizes = MESHES[mesh]
    raw = spec_fn(cfg, serve_tp2d=serve_tp2d)
    assert _tuples(raw) == _tuples(j_spec_fn(jcfg, serve_tp2d=serve_tp2d))
    got = tspecs.sanitize_specs(init(0, cfg, "meta"), raw, sizes)
    want = jspecs.sanitize_specs(_ref_params(jcfg), j_spec_fn(jcfg, serve_tp2d=serve_tp2d), sizes)
    assert _tuples(got) == _tuples(want)


@pytest.mark.parametrize("arch,batch,seq,batch_axis,seq_axis", CACHE_CASES)
def test_cache_specs_match_the_reference(arch, batch, seq, batch_axis, seq_axis):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    if cfg.family == "encdec":
        got = encdec_cache_specs(cfg, batch_axis=batch_axis, seq_axis=seq_axis)
        want = j_encdec_cache_specs(jcfg, batch_axis=batch_axis, seq_axis=seq_axis)
    else:
        got = cache_specs(cfg, batch_axis=batch_axis, seq_axis=seq_axis)
        want = j_cache_specs(jcfg, batch_axis=batch_axis, seq_axis=seq_axis)
    assert _tuples(got) == _tuples(want)


# a twin of tests/test_specs.py on the port's meta tensors
AXIS_SIZES = production_axis_sizes(multi_pod=True)


def _axis_size(entry) -> int:
    if entry is None:
        return 1
    return int(np.prod([AXIS_SIZES[e] for e in (entry if isinstance(entry, tuple) else (entry,))]))


def _check_divides(tree_abs, tree_spec, where):
    if isinstance(tree_abs, dict):
        assert tree_abs.keys() == tree_spec.keys(), where
        for key in tree_abs:
            _check_divides(tree_abs[key], tree_spec[key], f"{where}/{key}")
        return
    assert isinstance(tree_spec, P), where
    shape = tuple(tree_abs.shape) if isinstance(tree_abs, torch.Tensor) else ()
    assert len(tree_spec) <= len(shape), (where, shape, tree_spec)
    for dim, entry in zip(shape, tree_spec):
        assert dim % _axis_size(entry) == 0, (where, shape, tree_spec, dim)


@pytest.mark.parametrize("serve_tp2d", [False, True])
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_divide_the_mesh(arch, serve_tp2d):
    cfg = get_config(arch)
    init, spec_fn = tspecs._init_fn(cfg)
    params = init(0, cfg, "meta")
    sizes = {k: v for k, v in AXIS_SIZES.items() if k != "pod"}
    specs = tspecs.sanitize_specs(params, spec_fn(cfg, serve_tp2d=serve_tp2d), sizes)
    _check_divides(params, specs, f"{arch} tp2d={serve_tp2d}")


@pytest.mark.parametrize("arch,batch,seq,batch_axis,seq_axis", CACHE_CASES)
def test_cache_specs_divide_the_mesh(arch, batch, seq, batch_axis, seq_axis):
    cfg = get_config(arch)
    if cfg.family == "encdec":
        cache = init_encdec_cache(cfg, batch, seq, 4096, "meta")
        specs = encdec_cache_specs(cfg, batch_axis=batch_axis, seq_axis=seq_axis)
    else:
        cache = init_decode_cache(cfg, batch, seq, "meta")
        specs = cache_specs(cfg, batch_axis=batch_axis, seq_axis=seq_axis)
    _check_divides(cache, specs, f"{arch} cache {batch}x{seq}")


# build_dryrun against the reference's
def _port_args(tree, path=""):
    """(path, shape, dtype) of every argument leaf, keys sorted (the order
    of jax's tree leaves); the cache's int position as a () int32."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in _port_args(tree[key], f"{path}/{key}")]
    if isinstance(tree, tuple):
        return [x for i, val in enumerate(tree) for x in _port_args(val, f"{path}/{i}")]
    if isinstance(tree, int):
        return [(path, (), "int32")]
    return [(path, tuple(tree.shape), str(tree.dtype).removeprefix("torch."))]


def _ref_args(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    out = []
    for keys, leaf in flat:
        path = "".join(f"/{k.key}" if hasattr(k, "key") else f"/{k.idx}" for k in keys)
        out.append((path, tuple(leaf.shape), jnp.dtype(leaf.dtype).name))
    return out


@pytest.fixture
def ref_mesh(monkeypatch):
    """The reference's build_dryrun on the 16 x 16 axes: NamedSharding
    replaced by the bare spec, the mesh by a stand-in."""
    monkeypatch.setattr(jspecs, "NamedSharding", lambda mesh, spec: spec)
    sizes = MESHES["16x16"]
    return types.SimpleNamespace(axis_names=tuple(sizes), shape=dict(sizes),
                                 devices=np.empty(tuple(sizes.values()), dtype=object))


@pytest.mark.parametrize("shape", list(tspecs.SHAPES))
@pytest.mark.parametrize("arch", list_archs())
def test_build_dryrun_matches_the_reference(arch, shape, ref_mesh):
    assert tspecs.SHAPES[shape] == tspecs.ShapeSpec(*vars(jspecs.SHAPES[shape]).values())
    assert tspecs.ENCDEC_DECODE_SRC == jspecs.ENCDEC_DECODE_SRC
    got = tspecs.build_dryrun(get_config(arch), shape, MESHES["16x16"])
    with jax.enable_x64(False):
        want = jspecs.build_dryrun(j_get_config(arch), shape, ref_mesh)
    assert (got.skip, got.note) == (want.skip, want.note)
    assert (got.step_fn is None) == (want.step_fn is None) == (want.skip is not None)
    if want.skip is not None:
        return
    assert _port_args(got.args) == _ref_args(want.args)
    assert all(leaf.device.type == "meta" for leaf in jax.tree.leaves(
        got.args, is_leaf=lambda x: isinstance(x, torch.Tensor)) if isinstance(leaf, torch.Tensor))
    assert _tuples(got.in_shardings) == _tuples(want.in_shardings)
    assert _tuples(got.out_shardings) == _tuples(want.out_shardings)
