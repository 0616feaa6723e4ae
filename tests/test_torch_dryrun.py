"""The port's dry run (``repro_torch.launch.dryrun``) and ``launch.train
--mesh`` against the reference on the CPU.

  * ``run_one`` on both production meshes, each in a fake world of its
    own, for every arch's prefill_32k and long_500k and one train_4k on
    16 x 16 and five of them on 2 x 16 x 16, at one layer a stack (recurrentgemma: its pattern; depth changes no field
    compared here): status ok where the
    reference does not skip, the reference's record keys (its
    ``compile_s`` named ``meta_step_s``), skip reasons and notes word for
    word, ``n_params`` and ``n_params_active`` equal to the reference's
    (traced without x64, as its dry run); one record with the probes, its
    ``model_flops`` the reference's 6 N D or 2 N D a chip;
  * ``train --mesh 2x2`` over 4 spawned gloo ranks, 3 steps of reduced
    granite-3-2b from the reference's initial params: the losses within
    1e-3 relative of the port's unsharded run and of the reference's own
    ``--mesh 2x2`` on 4 fake XLA devices (a subprocess), every final leaf
    within 2 lr t absolute of both and, where it starts nonzero, within
    2e-2 relative L2; a 2 x 1 mesh in that world of 4 is refused naming
    both sizes, and a malformed ``--mesh`` is refused.
"""

import dataclasses
import multiprocessing
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest

import repro.launch.specs as jspecs
import torch_mesh_worker as worker
from repro import roofline as jrl
from repro.configs import get_config as j_get_config
from repro.models import init_lm_params as j_init_lm_params
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import production_axis_sizes
from repro_torch.launch.train import parse_mesh, train
from repro_torch.models.lm import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
# every arch's prefill (ok everywhere) and long-context decode (skipped by the
# full-attention archs, with the decode's cache note elsewhere), and one
# train step (its accumulation note): a record's other shapes take seconds
JOBS = [(arch, shape) for arch in list_archs() for shape in ("prefill_32k", "long_500k")]
JOBS += [("granite-moe-1b-a400m", "train_4k")]
# the 3-axis mesh's sharding propagation costs ~5 times the 2-axis one's a
# record: a family of each kind there
MULTI_POD_JOBS = [("granite-3-2b", "prefill_32k"), ("granite-3-2b", "long_500k"),
                  ("granite-moe-1b-a400m", "prefill_32k"), ("mamba2-2.7b", "long_500k"),
                  ("seamless-m4t-large-v2", "prefill_32k")]


def _cut(arch: str) -> dict:
    cfg = get_config(arch)
    kw = {"n_layers": len(cfg.hybrid.pattern) if cfg.hybrid else 1, "q_chunk": 32768}
    if cfg.encoder_layers:
        kw["encoder_layers"] = 1
    return kw


OVERRIDES = {name: _cut(arch) for arch in list_archs()
             for name in (arch, get_config(arch).name)}


@pytest.fixture(scope="module", params=[False, True], ids=["16x16", "2x16x16"])
def mesh_records(request):
    """The jobs' records on one mesh, and one record with the probes."""
    multi_pod = request.param
    jobs = MULTI_POD_JOBS if multi_pod else JOBS
    with dryrun.FakeWorld(multi_pod) as world:
        records = world.call(worker.records, multi_pod, jobs, OVERRIDES)
        probed = world.call(dryrun.run_one, "mamba2-2.7b", "decode_32k", multi_pod, False,
                            True, OVERRIDES["mamba2-2.7b"])
    return multi_pod, records, probed


def _ref_record(monkeypatch, arch: str, shape: str, multi_pod: bool) -> dict:
    """The reference's record of run_one up to its compile: the stand-in
    mesh of the production axes, NamedSharding as the bare spec."""
    monkeypatch.setattr(jspecs, "NamedSharding", lambda mesh, spec: spec)
    sizes = production_axis_sizes(multi_pod=multi_pod)
    mesh = types.SimpleNamespace(axis_names=tuple(sizes), shape=dict(sizes),
                                 devices=np.empty(tuple(sizes.values()), dtype=object))
    jcfg = dataclasses.replace(j_get_config(arch), **OVERRIDES[arch])
    chips = 512 if multi_pod else 256
    rec = {"arch": jcfg.name, "shape": shape, "mesh": "2x16x16" if multi_pod else "16x16",
           "chips": chips}
    with jax.enable_x64(False):
        spec = jspecs.build_dryrun(jcfg, shape, mesh)
        if spec.skip:
            return {**rec, "status": "skip", "reason": spec.skip}
        params_abs, _ = jspecs.param_abstract_and_shardings(jcfg, mesh)
    sh = jspecs.SHAPES[shape]
    tokens = sh.batch * (sh.seq if sh.kind != "decode" else 1)
    return {**rec, "status": "ok", "note": spec.note, "compile_s": None,
            "n_params": jrl.count_params(params_abs),
            "n_params_active": jrl.active_params(jcfg, params_abs),
            "memory_analysis": None,
            "model_flops": jrl.model_flops_global(jcfg, params_abs, tokens=tokens,
                                                  kind=sh.kind) / chips}


def test_records_match_the_reference(mesh_records, monkeypatch):
    multi_pod, records, probed = mesh_records
    jobs = MULTI_POD_JOBS if multi_pod else JOBS
    assert len(records) == len(jobs)
    for (arch, shape), rec in zip(jobs, records):
        want = _ref_record(monkeypatch, arch, shape, multi_pod)
        assert rec["status"] == want["status"], (arch, shape, rec.get("error"))
        keys = {"meta_step_s" if k == "compile_s" else k for k in want} - {"model_flops"}
        assert set(rec) == keys, (arch, shape)
        for key in ("arch", "shape", "mesh", "chips", "reason", "note", "n_params",
                    "n_params_active"):
            assert rec.get(key) == want.get(key), (arch, shape, key)
        if rec["status"] == "ok":
            mem = rec["memory_analysis"]
            assert set(mem) == {"argument_bytes", "output_bytes", "temp_bytes"}
            assert all(v > 0 for v in mem.values()), (arch, shape, mem)
    assert probed["status"] == "ok", probed.get("error")
    want = _ref_record(monkeypatch, "mamba2-2.7b", "decode_32k", multi_pod)
    assert probed["roofline"]["model_flops"] == pytest.approx(want["model_flops"], rel=1e-12)
    assert set(probed["roofline"]) == {
        "flops", "hbm_bytes", "coll_bytes", "compute_s", "memory_s", "collective_s",
        "dominant", "model_flops", "useful_fraction"}


# ---------------------------------------------------------------------------
# train --mesh
# ---------------------------------------------------------------------------

ARCH, STEPS, BATCH, SEQ, LR = "granite-3-2b", 3, 8, 32, 1e-3
LOSS_RTOL, LEAF_REL_L2 = 1e-3, 2e-2  # the train fidelity bounds of PERF.md section 2
# tests/test_torch_train.py's bound on params after t steps: an AdamW step moves
# an element by at most ~lr, so two runs may part by 2 lr a step.  The norm
# scales start at 0, so after 3 steps they are their updates, whose relative
# difference is not a fidelity measure (0.11 between the unsharded port and
# the reference): they are held by this bound alone
PARAM_ATOL = 2 * LR * STEPS

# the reference's launcher as it is, but for its mesh: this jax's make_mesh
# defaults to explicit axes (under which the reference's embedding gather asks
# for an out_sharding) and its sharding constraints want the mesh in context;
# the reference was written for GSPMD's auto axes with the mesh set
REF_SCRIPT = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
from jax.sharding import AxisType
_make_mesh = jax.make_mesh

def make_mesh(shape, names, **kw):
    mesh = _make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(names), **kw)
    jax.set_mesh(mesh)
    return mesh

jax.make_mesh = make_mesh
sys.argv = ["train", "--arch", {arch!r}, "--reduced", "--steps", "{steps}", "--batch",
            "{batch}", "--seq", "{seq}", "--lr", "{lr}", "--mesh", "2x2", "--checkpoint",
            {out!r}]
from repro.launch.train import main
main()
"""


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key, val in tree.items():
            out.update(_flat(val, f"{prefix}{key}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def test_train_mesh_2x2_matches_unsharded_and_the_reference(tmp_path):
    jcfg = j_get_config(ARCH).reduced()
    with jax.enable_x64(False):
        init = _flat(jax.device_get(j_init_lm_params(jax.random.PRNGKey(0), jcfg)))
    params_npz = tmp_path / "init.npz"
    np.savez(params_npz, **init)

    ref_out = tmp_path / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("JAX_ENABLE_X64", None)
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT.format(arch=ARCH, steps=STEPS, batch=BATCH, seq=SEQ,
                                                 lr=LR, out=str(ref_out))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    out_npz = tmp_path / "mesh.npz"
    ctx = multiprocessing.get_context("spawn")
    ranks = [ctx.Process(target=worker.train_rank, args=(
        r, 4, str(tmp_path / "rendezvous"), ARCH, str(params_npz), "2x2", "2x1", STEPS, BATCH,
        SEQ, LR, str(out_npz)), daemon=True) for r in range(4)]
    for p in ranks:
        p.start()
    try:
        with jax.enable_x64(False):
            params = params_from_numpy(j_init_lm_params(jax.random.PRNGKey(0), jcfg), "cpu")
        base, base_losses = train(get_config(ARCH).reduced(), params, steps=STEPS, batch=BATCH,
                                  seq=SEQ, lr=LR, log=lambda _: None)
        base = _flat(base)
        for p in ranks:
            p.join(timeout=300)
        stdout, stderr = ref.communicate(timeout=300)
    finally:
        for p in ranks:
            if p.is_alive():
                p.kill()
        if ref.poll() is None:
            ref.kill()
    assert [p.exitcode for p in ranks] == [0, 0, 0, 0]
    assert ref.returncode == 0, stderr[-2000:]

    with np.load(out_npz) as data:
        mesh_losses = data["losses"]
        refused = str(data["refused"])
        mesh = {k[len("params/"):]: data[k] for k in data.files if k.startswith("params/")}
    with np.load(ref_out) as data:
        ref = {k: data[k] for k in data.files}
    ref_losses = [float(x) for x in re.findall(r"^step\s+\d+ loss ([-\d.]+)$", stdout, re.M)]

    assert "2x1" in refused and "2 ranks" in refused and "has 4" in refused
    assert len(mesh_losses) == len(base_losses) == len(ref_losses) == STEPS
    np.testing.assert_allclose(mesh_losses, base_losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(mesh_losses, ref_losses, rtol=LOSS_RTOL)
    assert set(mesh) == set(base) == set(ref)
    for key in mesh:
        for other in (base, ref):
            assert np.abs(mesh[key] - other[key]).max() <= PARAM_ATOL, key
            if np.any(init[key]):
                assert _rel_l2(mesh[key], other[key]) <= LEAF_REL_L2, key


@pytest.mark.parametrize("text", ["2x", "x2", "2x0", "2*2", "2x2x2", "a x b"])
def test_a_malformed_mesh_is_refused(text):
    with pytest.raises(ValueError, match="expected DATAxMODEL"):
        parse_mesh(text)
