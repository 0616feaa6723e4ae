#!/usr/bin/env python3
"""Time the FNLS1 write of one w8a-sized tenant (d = 301, 142 clients: a
52 MB file) three ways, in turns, in one directory:

  save_state        the port's atomic write: a hidden temporary file,
                    flush, fsync, rename onto the final name
  in_place          the same bytes written in place, no fsync (the write
                    before the atomic one)
  in_place_fsync    the same bytes written in place, then fsync

    python3 scripts/spill_fsync_probe.py [--reps 20] [--dir DIR]

DIR defaults to the system's temporary directory, where the serving engine
spills without a ``spill_dir`` (``chip_smoke.py`` phase 12).  Prints one
JSON line: the median and total ms of each way, the file's bytes, the
directory and its file system.  Imports ``repro_torch`` from ``src/`` and
nothing of ``repro`` or JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def fs_type(path: Path) -> str:
    """The file system of ``path``'s mount (the longest mount point that
    holds it, from /proc/mounts)."""
    best, kind = "", "unknown"
    try:
        for line in Path("/proc/mounts").read_text().splitlines():
            _, mount, fstype, *_ = line.split()
            if str(path).startswith(mount) and len(mount) > len(best):
                best, kind = mount, fstype
    except OSError:
        pass
    return kind


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import DataSpec, ExperimentSpec
    from repro_torch.api.session import SessionState, save_state
    from repro_torch.linalg import triu_size

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--dir", default=None)
    args = ap.parse_args(argv)

    spec = ExperimentSpec(data=DataSpec(dataset="w8a"))
    d, n_clients, _ = spec.data.dims()
    t = triu_size(d)
    rng = np.random.default_rng(0)
    h_local = rng.standard_normal((n_clients, t))
    state = SessionState(
        spec=spec, algorithm="fednl", backend="local", round=3, meta={"kind": "full"},
        arrays={"state.x": rng.standard_normal(d), "state.h_local": h_local,
                "state.h_global": h_local.mean(0), "state.key": np.zeros(2, np.uint32),
                "state.round": np.asarray(3, np.int64)},
        records=(),
    )
    with tempfile.TemporaryDirectory(prefix="spill-probe-", dir=args.dir) as where:
        where = Path(where)
        path = where / "t0000.r3.fnlsess"
        save_state(state, path)
        raw = path.read_bytes()

        def in_place(sync: bool) -> None:
            with open(path, "wb") as f:
                f.write(raw)
                if sync:
                    f.flush()
                    os.fsync(f.fileno())

        ways = {
            "save_state": lambda: save_state(state, path),
            "in_place": lambda: in_place(False),
            "in_place_fsync": lambda: in_place(True),
        }
        ms: dict[str, list[float]] = {name: [] for name in ways}
        for _ in range(args.reps):
            for name, fn in ways.items():
                t0 = time.perf_counter()
                fn()
                ms[name].append((time.perf_counter() - t0) * 1e3)
        print(json.dumps({
            "bytes": len(raw), "reps": args.reps, "dir": str(where.parent),
            "fs_type": fs_type(where),
            "median_ms": {name: statistics.median(v) for name, v in ms.items()},
            "total_ms": {name: sum(v) for name, v in ms.items()},
            "min_ms": {name: min(v) for name, v in ms.items()},
            "max_ms": {name: max(v) for name, v in ms.items()},
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
