"""The port's examples (examples/torch_*.py) on the CPU.

* The FedNL probe (examples/torch_fednl_probe.py) against the reference's
  examples/fednl_probe.py at the reduced granite-3-2b: the reference's
  ``init_lm_params(PRNGKey(0), cfg)`` carried over with
  ``params_from_numpy``, the same numpy draws of tokens and labels; the
  features within FEATURE_ULPS bf16 ulps of the feature scale (both run the
  blocks in bf16, the reference's XLA and the port's plain versions
  rounding otherwise); the port's ``solve`` on the reference's features
  against ``repro.api.solve`` on them: grad norms within rtol 1e-8 where the
  reference's is >= 1e-10, ``sent_bits`` exact but for TopLEK's boundary
  allowance (a round's kept count one off a client), and the same accuracy.
* Each of the other ten examples' ``main`` at a small size (dataset tiny,
  or the smallest flag values), and ``python -m repro_torch.launch.obs_top``
  against a live gateway of the port; its frame against the reference's
  scripts/obs_top.py on the same replies.  The examples that spawn
  processes or open sockets are marked ``net``, as tests/test_torch_comm.py
  marks its own.
"""

import contextlib
import importlib.util
import io
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]
FEATURE_ULPS = 2  # the probe's features, port against reference, bf16 ulps of their scale
GN_RTOL, GN_FLOOR = 1e-8, 1e-10


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _example(name: str):
    return _load(ROOT / "examples" / f"{name}.py", f"example_{name}")


def _quiet(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args)
    return result, out.getvalue()


# ---------------------------------------------------------------------------
# the probe against the reference's example
# ---------------------------------------------------------------------------

def test_probe_matches_reference_example():
    from repro import api as japi
    from repro.configs import get_config as jget_config
    from repro.data import partition_clients as jpartition
    from repro.models import init_lm_params as jinit
    from repro_torch.api import solve
    from repro_torch.configs import get_config
    from repro_torch.models import params_from_numpy

    ref, port = _example("fednl_probe"), _example("torch_fednl_probe")
    cfg_j, cfg_t = jget_config("granite-3-2b").reduced(), get_config("granite-3-2b").reduced()
    clients, samples = 8, 64

    # the reference main's draws, line for line
    rng = np.random.default_rng(0)
    n_total = clients * samples
    labels_j = np.where(rng.random(n_total) < 0.5, 1.0, -1.0)
    lo, hi = cfg_j.vocab // 4, 3 * cfg_j.vocab // 4
    tokens_j = np.where((labels_j[:, None] > 0), rng.integers(0, lo, (n_total, 16)),
                        rng.integers(hi, cfg_j.vocab, (n_total, 16))).astype(np.int32)
    labels, tokens = port.probe_data(cfg_t, clients, samples)
    np.testing.assert_array_equal(labels, labels_j)
    np.testing.assert_array_equal(tokens, tokens_j)

    params_j = jinit(jax.random.PRNGKey(0), cfg_j)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    feats_j = np.asarray(ref.backbone_features(params_j, cfg_j, jnp.asarray(tokens)))
    feats_t = port.backbone_features(params_t, cfg_t, tokens).numpy()
    assert feats_t.shape == feats_j.shape == (n_total, cfg_t.d_model)
    assert feats_t.dtype == np.float64 and np.all(np.isfinite(feats_t))
    scale = float(np.abs(feats_j).max())
    ulp = 2.0 ** (np.frexp(scale)[1] - 8)
    assert float(np.abs(feats_t - feats_j).max()) <= FEATURE_ULPS * ulp

    # FedNL on the reference's features, in both packages
    feats, z = port.probe_problem(feats_j, labels, clients, samples)
    feats_ref = feats_j / (np.linalg.norm(feats_j, axis=1, keepdims=True) + 1e-9)
    np.testing.assert_array_equal(feats, feats_ref)
    np.testing.assert_array_equal(z, jpartition(feats_ref, labels, clients, samples, seed=0,
                                                shuffle=False))
    got = solve(port.probe_spec(), z=z, device="cpu")
    want = japi.solve(japi.ExperimentSpec(
        compressor=japi.CompressorSpec("toplek", k_multiplier=8.0), rounds=100, tol=1e-13),
        z=jnp.asarray(z))
    assert got.rounds >= 10 and want.rounds >= 10
    keep = np.flatnonzero(want.grad_norms[: got.rounds] >= GN_FLOOR)
    rel = np.abs(got.grad_norms[keep] - want.grad_norms[keep]) / want.grad_norms[keep]
    assert float(rel.max()) <= GN_RTOL, rel
    for r in keep:
        if got.sent_bits[r] != want.sent_bits[r]:
            d_elems = abs(got.records[r].sent_elems - want.records[r].sent_elems)
            assert 0 < d_elems <= clients, (r, d_elems)
    assert got.grad_norms[-1] <= 1e-13 or got.rounds == 100
    acc_t = port.probe_accuracy(feats, labels, got.x)
    acc_j = float((feats_ref @ np.asarray(want.x) * labels > 0).mean())
    assert acc_t == acc_j and acc_t > 0.5


def test_probe_main_runs_on_the_cpu():
    port = _example("torch_fednl_probe")
    _, out = _quiet(port.main, ["--samples", "16"] + CPU)
    assert "backbone: granite-3-2b (reduced: 2L d=128) on cpu" in out
    assert "FedNL(B)/toplek head:" in out and "probe train accuracy:" in out


# ---------------------------------------------------------------------------
# the other examples, in-process
# ---------------------------------------------------------------------------

def test_quickstart():
    from repro_torch.api import CompressorSpec, DataSpec, ExperimentSpec, solve

    rep, out = _quiet(_example("torch_quickstart").main, CPU)
    want = solve(ExperimentSpec(data=DataSpec(dataset="tiny", seed=0),
                                compressor=CompressorSpec("topk", 8.0), rounds=60, tol=1e-14),
                 device="cpu")
    assert [g.hex() for g in rep.grad_norms] == [g.hex() for g in want.grad_norms]
    assert "bit-identical to solve(): True" in out


def test_e2e_fednl_w8a(tmp_path):
    summary, _ = _quiet(_example("torch_e2e_fednl_w8a").main,
                        ["--dataset", "tiny", "--rounds", "4", "--fast", "--out", str(tmp_path)]
                        + CPU)
    assert len(summary) == 6
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [f"model_{c}.npz" for c in ("randseqk", "topk", "toplek", "randk", "natural",
                                    "identity")] + ["summary.txt"])
    assert np.load(tmp_path / "model_topk.npz")["x"].shape == (24,)


def test_sweep_grid():
    from repro_torch.api import DataSpec, ExperimentSpec, solve

    report, out = _quiet(_example("torch_sweep_grid").main, CPU)
    assert len(report.reports) == 15 and "1 groups" in out
    spec = ExperimentSpec(data=DataSpec(dataset="tiny", seed=1), rounds=12)
    first = report.reports[0]
    want = solve(spec.replace(compressor=first.spec.compressor, seed=first.spec.seed),
                 device="cpu")
    np.testing.assert_array_equal(first.sent_bits, want.sent_bits)


def test_tree_async_fednl():
    got, out = _quiet(_example("torch_tree_async_fednl").main, CPU)
    assert got["tree_bit_identical"]
    assert (got["cohort_sizes"][0], got["cohort_sizes"][3], got["cohort_sizes"][6]) == (15, 16, 15)
    assert "staleness=0" in out and "== sync barrier bit for bit" in out


def test_serve_lm():
    serve = _example("torch_serve_lm")
    seqs, out = _quiet(serve.main, ["--arch", "granite-3-2b", "--tokens", "6"] + CPU)
    again, _ = _quiet(serve.main, ["--arch", "granite-3-2b", "--tokens", "6"] + CPU)
    assert tuple(seqs.shape) == (4, 6) and bool((seqs >= 0).all())
    assert bool((seqs == again).all())
    assert "granite-3-2b: decoded 4 x 6 tokens" in out


def test_train_lm(tmp_path):
    ckpt = tmp_path / "params.npz"
    losses, out = _quiet(_example("torch_train_lm").main,
                         ["--steps", "20", "--batch", "4", "--seq", "32", "--out", str(ckpt)]
                         + CPU)
    assert len(losses) == 20 and all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.1
    assert ckpt.exists() and "checkpoint saved" in out


# ---------------------------------------------------------------------------
# the examples that spawn processes or open sockets
# ---------------------------------------------------------------------------

@pytest.mark.net
def test_distributed_fednl():
    reports, _ = _quiet(_example("torch_distributed_fednl").main,
                        ["--devices", "2"] + CPU)
    dense, sparse = reports["dense_psum"], reports["sparse_allgather"]
    assert dense.rounds == sparse.rounds and dense.grad_norms[-1] <= 1e-14
    assert [r.sent_elems for r in dense.records] == [r.sent_elems for r in sparse.records]
    np.testing.assert_allclose(dense.grad_norms, sparse.grad_norms, rtol=1e-8)


@pytest.mark.net
def test_multinode_tcp_fednl():
    same, out = _quiet(_example("torch_multinode_tcp_fednl").main,
                       ["--clients", "2", "--compressors", "topk"] + CPU)
    assert same and "rounds over TCP" in out


@pytest.mark.net
def test_multinode_pp_fednl():
    finals, _ = _quiet(_example("torch_multinode_pp_fednl").main, ["--clients", "3"] + CPU)
    assert set(finals) == {"partial", "resample"}
    assert all(v < 1e-9 for v in finals.values())


@pytest.mark.net
def test_gateway_client():
    code, out = _quiet(_example("torch_gateway_client").main, CPU)
    assert code == 0 and "bit-identical to local solve: True" in out


@pytest.mark.net
def test_obs_top_against_a_live_gateway():
    """``python -m repro_torch.launch.obs_top --once`` and ``--prom`` against
    a port gateway started with --obs, after one tenant ran."""
    from repro_torch.api import DataSpec, ExperimentSpec
    from repro_torch.gateway import GatewayClient

    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src"), *filter(None, [os.environ.get("PYTHONPATH")])])}
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.gateway_serve", "--port", "0", "--obs",
         "--device", "cpu"], stdout=subprocess.PIPE, text=True, cwd=ROOT, env=env)
    try:
        _, host, port = proc.stdout.readline().split()
        with GatewayClient(host, int(port), connect_retry_s=30) as gwc:
            gwc.submit(ExperimentSpec(data=DataSpec(dataset="tiny"), rounds=3)).result()
        once = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.obs_top", "--host", host, "--port", port,
             "--once"], capture_output=True, text=True, cwd=ROOT, env=env, timeout=120)
        prom = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.obs_top", "--host", host, "--port", port,
             "--prom"], capture_output=True, text=True, cwd=ROOT, env=env, timeout=120)
    finally:
        proc.kill()
        proc.wait(10)
    assert once.returncode == 0 and prom.returncode == 0, (once.stderr, prom.stderr)
    assert once.stdout.startswith("FedNL gateway — obs_top")
    assert "engine: tick" in once.stdout and "finished 1" in once.stdout
    assert "recorder disabled" not in once.stdout
    assert "# TYPE" in prom.stdout


def test_obs_top_frame_is_the_reference_scripts():
    """The port's frame against scripts/obs_top.py's on the same STATUS and
    METRICS replies: a recorder's snapshot, and a gateway without one."""
    from repro_torch.launch import obs_top
    from repro_torch.obs import Recorder

    ref = _load(ROOT / "scripts" / "obs_top.py", "reference_obs_top")
    rec = Recorder()
    rec.add("engine.ticks", 3)
    rec.gauge("engine.resident", 2)
    rec.observe("engine.tick_s", 0.002)
    with rec.span("engine.tick"):
        pass
    status = {"ticks": 3, "tenants": 2, "finished": 1, "failed": 0, "queued": 1, "spills": 0,
              "backlog": {"normal": 1, "high": 0}, "batch_occupancy": 0.5, "batch_launches": 4,
              "compiles": 1, "connections": 2, "subscriptions": 1}
    for reply in ({"enabled": True, "metrics": rec.snapshot()}, {"enabled": False}):
        assert obs_top.render(status, reply) == ref.render(status, reply)
        assert obs_top.render({}, reply, width=60) == ref.render({}, reply, width=60)
