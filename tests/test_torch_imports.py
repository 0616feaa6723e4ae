"""The port stands alone: no module of src/repro_torch/, no example of the
port (examples/torch_*.py) and not chip_smoke.py imports jax or repro;
importing the package loads no kernel."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
              + sorted((ROOT / "examples").glob("torch_*.py")) + [ROOT / "chip_smoke.py"])
FORBIDDEN = ("jax", "repro", "jaxlib")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_scan_covers_the_package():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert "src/repro_torch/core/fednl.py" in names
    assert "src/repro_torch/kernels/ops.py" in names
    assert "src/repro_torch/kernels/threefry.py" in names
    assert "src/repro_torch/core/fednl_ls.py" in names
    assert "src/repro_torch/core/fednl_pp.py" in names
    assert "src/repro_torch/baselines/numpy_reference.py" in names
    assert "src/repro_torch/models/lm.py" in names
    for module in ("moe", "ssm", "rglru", "encdec"):
        assert f"src/repro_torch/models/{module}.py" in names
    for module in ("api/registry", "api/session", "api/backends", "api/sweep", "api/batch",
                   "core/fednl_batch", "comm/transport", "comm/wire", "comm/protocol",
                   "comm/cost", "comm/star", "comm/star_pp", "comm/topology",
                   "launch/multiproc", "obs/__init__", "obs/core", "obs/export",
                   "api/specwire", "serve_fednl/__init__", "serve_fednl/engine",
                   "serve_fednl/scheduler", "serve_fednl/spill", "serve_fednl/tenant",
                   "gateway/__init__", "gateway/protocol", "gateway/server", "gateway/client",
                   "launch/gateway_serve", "distributed/__init__", "distributed/fednl_shard",
                   "distributed/world", "launch/mesh", "train/data", "train/optimizer",
                   "train/grad_compress", "train/step", "launch/train", "roofline",
                   "launch/specs", "launch/obs_top"):
        assert f"src/repro_torch/{module}.py" in names
    for example in ("quickstart", "e2e_fednl_w8a", "sweep_grid", "distributed_fednl",
                    "multinode_tcp_fednl", "multinode_pp_fednl", "tree_async_fednl",
                    "gateway_client", "serve_lm", "train_lm", "fednl_probe"):
        assert f"examples/torch_{example}.py" in names
    assert "chip_smoke.py" in names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_repro_imports(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_importing_the_port_loads_no_jax_and_no_kernel():
    """Importing every module, the sharded backend's included, loads no jax,
    no repro, no kernel and sets up no process group."""
    code = (
        "import sys, repro_torch, repro_torch.api, repro_torch.core.runner, "
        "repro_torch.kernels.ops, repro_torch.launch.fednl_run, repro_torch.models, "
        "repro_torch.core.fednl_ls, repro_torch.core.fednl_pp, repro_torch.numerics, "
        "repro_torch.baselines, repro_torch.objectives.quadratic, "
        "repro_torch.serving, repro_torch.launch.serve, repro_torch.train, "
        "repro_torch.api.session, repro_torch.api.sweep, repro_torch.api.batch, "
        "repro_torch.api.backends, repro_torch.core.fednl_batch, repro_torch.comm.transport, "
        "repro_torch.obs, repro_torch.comm.topology, repro_torch.launch.multiproc, "
        "repro_torch.api.specwire, repro_torch.serve_fednl, repro_torch.gateway, "
        "repro_torch.launch.gateway_serve, repro_torch.distributed, repro_torch.launch.mesh, "
        "repro_torch.models.moe, repro_torch.models.ssm, repro_torch.models.rglru, "
        "repro_torch.models.encdec, repro_torch.train.data, repro_torch.train.optimizer, "
        "repro_torch.train.grad_compress, repro_torch.launch.train\n"
        "from repro_torch.core.fednl_batch import BatchRoundTable\n"
        "assert repro_torch.api.encode_spec is repro_torch.api.specwire.encode_spec\n"
        "assert repro_torch.api.TopologySpec is repro_torch.comm.topology.TopologySpec\n"
        "assert repro_torch.api.list_backends() == "
        "['local', 'sharded', 'star-loopback', 'star-tcp']\n"
        "from repro_torch.kernels import build\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
        "assert not bad, bad\n"
        "assert build._library.cache_info().currsize == 0\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
    )
    subprocess.run(
        [sys.executable, "-c", code], check=True, cwd=ROOT, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
    )
