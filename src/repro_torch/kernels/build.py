"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/repro_torch_kernels/<name>-<hash>.so``
in the checkout, where the hash covers the source text, the headers beside it
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt and
an unchanged one is loaded as it is.  The build
happens at the first launch of any kernel (or on an explicit
:func:`build_all`): one nvcc per source, all started together.  The sources
have plain ``extern "C"`` launchers and include no PyTorch header, which
keeps a build to seconds.  A failed build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("hessian_syrk", "compressor_select", "flash_attention", "flash_attention_bwd",
           "threefry")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_build_lock = threading.Lock()


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then $PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "$PATH): the CUDA kernels cannot be built on this machine"
        )
    return found


def library_path(name: str) -> Path:
    """Where the shared library of ``csrc/<name>.cu`` is (or will be) built.
    The hash covers every ``csrc/*.cuh`` too, so an edited header rebuilds
    the sources that may include it."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(b"\0" + header.name.encode() + b"\0" + header.read_bytes())
    digest.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all() -> dict[str, str]:
    """Compile every source whose library is missing, in parallel.

    Returns nvcc's report (ptxas registers, shared memory, spills) for each
    source it compiled; a source already built is not in the result.
    """
    with _build_lock:
        todo = [n for n in SOURCES if not library_path(n).exists()]
        if not todo:
            return {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        exe = nvcc()
        jobs = []
        for name in todo:
            out = library_path(name)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
            )
            jobs.append((name, out, tmp, proc))
        reports, errors = {}, []
        for name, out, tmp, proc in jobs:
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{name}.cu: nvcc exited {proc.returncode}\n{stderr}")
                tmp.unlink(missing_ok=True)
                continue
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
            reports[name] = stdout + stderr
        if errors:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
        return reports


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    build_all()
    return ctypes.CDLL(str(library_path(name)))


@functools.cache
def function(name: str, symbol: str, argtypes: tuple, restype=ctypes.c_int):
    """The C launcher ``symbol`` of ``csrc/<name>.cu``, built and loaded at
    first use, with its ctypes signature set (every pointer and the stream
    as ``c_void_p``, so ctypes never narrows them to 32 bits)."""
    fn = getattr(_library(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


def check_launch(kernel: str, code: int) -> None:
    """Raise if a launcher's ``cudaGetLastError()`` was not cudaSuccess."""
    if code != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {code}")


def ptxas_entries(report: str) -> dict[str, list[str]]:
    """nvcc's ``-Xptxas=-v`` report by kernel: each entry function's mangled
    name and its lines on registers, spills and wgmma, as ptxas printed them
    (a wgmma warning names its function)."""
    entries: dict[str, list[str]] = {}
    name = None
    for line in report.splitlines():
        found = re.search(r"Compiling entry function '([^']+)'", line)
        if found:
            name = found.group(1)
            entries[name] = []
        elif "warning" in line and "wgmma" in line:
            named = re.search(r"function '([^']+)'", line)
            entries.setdefault(named.group(1) if named else str(name), []).append(line.strip())
        elif name is not None and ("registers" in line or "spill" in line):
            entries[name].append(line.strip())
    return entries
