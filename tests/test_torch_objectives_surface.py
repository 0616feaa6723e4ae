"""The port's package surface against the reference's (CPU).

* ``repro_torch.objectives``: ``LogRegProblem``, ``logreg_margin_stats`` and
  the dense ``logreg_oracles`` for every ``hessian`` route against
  ``repro.objectives.logreg`` on seeded inputs: f and grad to 1e-12 relative
  to their largest magnitude, the margins and sigmoid to 1e-14 (different
  BLAS and summation order), the Hessian to 1e-13 x max(|Z|^T |h| |Z|), the
  scale of its FP64 rounding; within the port "fused" and "pallas" are bit
  for bit the packed oracle's Hessian unpacked.
* every name in the ``__all__`` of the reference's ``core``, ``comm``,
  ``compressors``, ``objectives`` and ``api`` resolves in the port, and
  every public function or class of every reference module in its port
  module, but the JAX-only names of ``JAX_ONLY``, each with its reason;
* the compressor registry: ``COMPRESSORS`` maps a name to a
  ``CompressorSpec``, the reference's six built-ins with the reference's
  constants; ``register_compressor`` adds to it and ``get_compressor``
  builds from it; ``make_pp_bits_fn`` and ``core.fednl.make_bits_fn`` are
  the reference's aliases.
"""

import dataclasses
import importlib
import pkgutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.objectives import logreg as jlog
from repro_torch.objectives import logreg as tlog

LAM = 1e-3
PACKAGES = ("core", "comm", "compressors", "objectives", "api")

# reference names the port leaves out, each with why: the reference's
# module -> {name: reason}
JAX_ONLY = {
    "repro.kernels.compat": {
        "*": "a shim over jax versions' Pallas and sharding spellings; the port "
             "has no jax"},
    "repro.kernels.hessian_syrk": {
        "hessian_syrk_pallas": "the Pallas TPU kernel: the port's is the CUDA kernel "
                               "hessian_syrk_packed_cuda (csrc/hessian_syrk.cu)"},
    "repro.kernels.compressor_select": {
        name: "a Pallas TPU kernel: the port's are the CUDA kernels of "
              "csrc/compressor_select.cu (select_*_cuda)"
        for name in ("select_topk_pallas", "select_randseqk_pallas", "select_toplek_pallas")},
    "repro.kernels.flash_attention": {
        "flash_attention_pallas": "the Pallas TPU kernel: the port's is flash_attention_cuda "
                                  "(csrc/flash_attention.cu)"},
    "repro.kernels.ops": {
        "resolve_interpret": "chooses Pallas' interpret mode off the TPU; the port routes on "
                             "the tensor's device",
        "hessian_syrk_xla": "the Pallas kernel's tile schedule as an XLA program for the CPU; "
                            "the port's CPU path is the kernel's plain version",
        "hessian_fused": "routes between the Pallas kernel and hessian_syrk_xla; the port's "
                         "one Hessian kernel is the packed SYRK, which logreg_oracles' "
                         "'fused' route unpacks"},
    "repro.kernels.ref": {
        "hessian_syrk_ref": "the jnp reference of the Pallas kernel's tile body; the port's "
                            "reference is hessian_syrk_packed_plain"},
    "repro.roofline": {
        "hlo_cost": "reads XLA's compiled HLO; the port counts a step with "
                    "roofline.step_cost (FlopCounterMode and aten bytes)",
        "measure_cpu_machine": "the reference's CPU yardstick, removed from the port with "
                               "its one caller; the port measures the card "
                               "(roofline.measure_machine)"},
    "repro.core.fednl": {
        "fednl_round_kernel": "the round body the reference's lax.map batch engine shares; "
                              "the port's batched round (core/fednl_batch.py) has its own "
                              "client phase"},
    "repro.core.fednl_ls": {
        "fednl_ls_round_kernel": "as fednl_round_kernel, for FedNL-LS"},
    "repro.core.fednl_batch": {
        "switched_compressor": "a lax.switch over the group's compressors; the port's "
                               "_make_branches runs each branch's kernel on its rows",
        "switched_bits_fn": "the bit models under that lax.switch; the port prices each "
                            "branch's rows with its own compressor"},
    "repro.compressors.select": {
        "toplek_uniform": "a jax.random draw on the device; the port draws TopLEK's "
                          "uniforms on the host (prng.uniform) and uploads them"},
    "repro.models.layers": {
        "chunked_map": "a lax.map over chunks that bounds XLA's live memory; the port's "
                       "chunked_attention and chunked_loss loop in Python"},
}


def _reference_modules():
    for info in pkgutil.walk_packages(repro.__path__, "repro."):
        yield info.name


def _public_defs(module) -> list[str]:
    return [name for name, obj in vars(module).items()
            if not name.startswith("_") and callable(obj)
            and getattr(obj, "__module__", None) == module.__name__]


# ---------------------------------------------------------------------------
# objectives
# ---------------------------------------------------------------------------

def _inputs(seed: int, lead=()):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((*lead, 40, 24)) / 3.0
    x = rng.standard_normal(24) * 0.5
    return z, x


def _scale(z, x):
    sigma = 1.0 / (1.0 + np.exp(-(z @ x)))
    h = np.abs(sigma * (1.0 - sigma) / z.shape[-2])
    return np.max(np.abs(z).T @ (h[:, None] * np.abs(z)))


def _rel(a, b):
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


@pytest.mark.parametrize("hessian", ["fused", "jnp", "pallas"])
@pytest.mark.parametrize("seed", [0, 1])
def test_logreg_oracles_match_reference(hessian, seed):
    z, x = _inputs(seed)
    f_t, g_t, h_t = tlog.logreg_oracles(torch.as_tensor(z), torch.as_tensor(x), LAM,
                                        hessian=hessian)
    f_j, g_j, h_j = (np.asarray(a) for a in jlog.logreg_oracles(
        jnp.asarray(z), jnp.asarray(x), LAM, hessian=hessian))
    assert h_t.shape == (24, 24) and h_t.dtype == torch.float64
    assert abs(f_t.item() - float(f_j)) <= 1e-12 * abs(float(f_j))
    assert _rel(g_t.numpy(), g_j) <= 1e-12
    assert np.max(np.abs(h_t.numpy() - h_j)) <= 1e-13 * _scale(z, x)
    if hessian != "jnp":  # the kernel's packed triangle, mirrored
        np.testing.assert_array_equal(h_t.numpy(), h_t.numpy().T)


def test_logreg_oracles_kernel_routes_are_the_packed_oracle_unpacked():
    from repro_torch.linalg import unpack_triu

    z, x = _inputs(2, lead=(3,))
    zt, xt = torch.as_tensor(z), torch.as_tensor(x)
    f_p, g_p, h_p = tlog.logreg_oracles_packed(zt, xt, LAM)
    packed = unpack_triu(h_p, 24)
    for kw in ({"hessian": "fused"}, {"hessian": "pallas"}, {"use_kernel": True}, {}):
        f, g, h = tlog.logreg_oracles(zt, xt, LAM, **kw)
        assert h.shape == (3, 24, 24)
        assert torch.equal(f, f_p) and torch.equal(g, g_p)
        assert torch.equal(h.view(torch.int64), packed.view(torch.int64)), kw
    # each client's slice is that client's oracle
    f1, g1, h1 = tlog.logreg_oracles(zt[1], xt, LAM, hessian="jnp")
    f3, g3, h3 = tlog.logreg_oracles(zt, xt, LAM, hessian="jnp")
    torch.testing.assert_close(h3[1], h1, rtol=1e-14, atol=1e-17)
    torch.testing.assert_close(g3[1], g1, rtol=1e-14, atol=1e-17)
    with pytest.raises(ValueError, match="unknown hessian"):
        tlog.logreg_oracles(zt, xt, LAM, hessian="dense")


@pytest.mark.parametrize("seed", [0, 1])
def test_logreg_margin_stats_match_reference(seed):
    z, x = _inputs(seed)
    m_t, s_t = tlog.logreg_margin_stats(torch.as_tensor(z), torch.as_tensor(x))
    m_j, s_j = (np.asarray(a) for a in jlog.logreg_margin_stats(jnp.asarray(z), jnp.asarray(x)))
    assert _rel(m_t.numpy(), m_j) <= 1e-14
    assert _rel(s_t.numpy(), s_j) <= 1e-14
    assert torch.equal(s_t, torch.sigmoid(m_t))


def test_logreg_problem_properties():
    z = np.zeros((5, 7, 3))
    got = tlog.LogRegProblem(torch.as_tensor(z), LAM)
    want = jlog.LogRegProblem(jnp.asarray(z), LAM)
    for name in ("n_clients", "n_i", "dim"):
        assert getattr(got, name) == getattr(want, name)
    assert (got.n_clients, got.n_i, got.dim, got.lam) == (5, 7, 3, LAM)
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    with pytest.raises(dataclasses.FrozenInstanceError):
        got.lam = 1.0


# ---------------------------------------------------------------------------
# the surface
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("package", PACKAGES)
def test_package_all_resolves_in_the_port(package):
    ref = importlib.import_module(f"repro.{package}")
    port = importlib.import_module(f"repro_torch.{package}")
    skipped = JAX_ONLY.get(ref.__name__, {})
    missing = [name for name in ref.__all__ if name not in skipped and not hasattr(port, name)]
    assert not missing, f"repro_torch.{package} lacks {missing}"
    assert set(port.__all__) >= set(ref.__all__) - set(skipped)
    for name in port.__all__:
        assert hasattr(port, name), name


def test_every_public_definition_resolves_in_the_port():
    """Every function and class that a module of the reference defines is in
    the port's module of the same name, but those JAX_ONLY lists; each
    listed name is absent from the port, and really is the reference's."""
    missing, listed_but_ported = [], []
    for name in _reference_modules():
        ref = importlib.import_module(name)
        skipped = JAX_ONLY.get(name, {})
        try:
            port = importlib.import_module("repro_torch" + name[len("repro"):])
        except ModuleNotFoundError:
            if "*" not in skipped:
                missing.append(name)
            continue
        assert "*" not in skipped, f"{name} is listed as JAX-only but has a port"
        for attr in _public_defs(ref):
            if attr in skipped:
                if hasattr(port, attr):
                    listed_but_ported.append(f"{name}.{attr}")
            elif not hasattr(port, attr):
                missing.append(f"{name}.{attr}")
        for attr in skipped:
            assert attr == "*" or attr in _public_defs(ref), f"{name}.{attr} is not the reference's"
    assert not missing, f"the port lacks {missing}"
    assert not listed_but_ported, f"listed as JAX-only but ported: {listed_but_ported}"


def test_surface_imports():
    from repro_torch.comm import make_codec
    from repro_torch.compressors import COMPRESSORS, CompressorSpec
    from repro_torch.core import newton_baseline, run_fednl
    from repro_torch.objectives import LogRegProblem, logreg_oracles

    assert callable(make_codec) and callable(newton_baseline) and callable(run_fednl)
    assert callable(logreg_oracles) and dataclasses.is_dataclass(LogRegProblem)
    assert all(isinstance(spec, CompressorSpec) for spec in COMPRESSORS.values())


# ---------------------------------------------------------------------------
# the compressor registry
# ---------------------------------------------------------------------------

def test_builtin_registry_matches_reference():
    from repro.compressors import COMPRESSORS as JC
    from repro_torch.compressors import COMPRESSORS, CompressorSpec

    builtins = ["topk", "randk", "randseqk", "toplek", "natural", "identity"]
    assert [n for n in COMPRESSORS if n in builtins] == [n for n in JC if n in builtins]
    t, k = 300, 24
    for name in builtins:
        spec = COMPRESSORS[name]
        assert isinstance(spec, CompressorSpec) and spec.name == name
        got, want = spec.make(t, k), JC[name].make(t, k)
        assert got.name == want.name == name
        for field in ("alpha", "delta", "bits_per_elem", "header_bits"):
            assert getattr(got, field) == getattr(want, field), (name, field)
        assert (got.compress_sparse is None) == (want.compress_sparse is None)


def test_register_compressor_adds_to_the_registry():
    from repro_torch.api import register_compressor
    from repro_torch.compressors import COMPRESSORS, get_compressor

    def make(t, k):
        return dataclasses.replace(get_compressor("topk", t, k), name="topk-surface")

    register_compressor("topk-surface", make)
    try:
        assert COMPRESSORS["topk-surface"].name == "topk-surface"
        assert COMPRESSORS["topk-surface"].make is make
        built = get_compressor("topk-surface", 100, 8)
        assert built.name == "topk-surface" and built.k == 8
        with pytest.raises(ValueError, match="already registered"):
            register_compressor("topk-surface", make)
        register_compressor("topk-surface", make, overwrite=True)
    finally:
        COMPRESSORS.pop("topk-surface", None)
    with pytest.raises(KeyError, match="unknown compressor"):
        get_compressor("topk-surface", 100, 8)
    with pytest.raises(ValueError, match="0 < k <= T"):
        get_compressor("topk", 100, 0)


@pytest.mark.parametrize("accounting", ["payload", "wire"])
@pytest.mark.parametrize("name", ["topk", "toplek", "natural"])
def test_bits_aliases_match_reference(accounting, name):
    from repro.compressors import get_compressor as jget
    from repro.core import fednl as jfednl
    from repro.core import make_pp_bits_fn as jpp
    from repro_torch.api import make_bits_fn
    from repro_torch.compressors import get_compressor
    from repro_torch.core import fednl as tfednl
    from repro_torch.core import make_pp_bits_fn

    d = 24
    t = d * (d + 1) // 2
    sent = np.array([0, 5, 17, 192], dtype=np.int32)
    comp, jcomp = get_compressor(name, t, 8 * d), jget(name, t, 8 * d)
    for got_fn, want_fn, pp in ((make_pp_bits_fn(comp, d, accounting), jpp(jcomp, d, accounting),
                                 True),
                                (tfednl.make_bits_fn(comp, d, accounting),
                                 jfednl.make_bits_fn(jcomp, d, accounting), False)):
        got = np.asarray(got_fn(torch.as_tensor(sent)))
        np.testing.assert_array_equal(got, np.asarray(want_fn(jnp.asarray(sent))))
        np.testing.assert_array_equal(
            got, np.asarray(make_bits_fn(comp, d, accounting, pp=pp)(torch.as_tensor(sent))))
    assert repro_torch.core.make_pp_bits_fn is make_pp_bits_fn
