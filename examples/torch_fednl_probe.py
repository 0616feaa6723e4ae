"""FedNL-probe on the PyTorch port: federated Newton training of a
logistic-regression head on top of a frozen backbone of the LM zoo
(DESIGN.md §4); the port of ``examples/fednl_probe.py``.

Each client holds private token sequences; the frozen backbone (the reduced
granite-3-2b by default) maps them to mean-pooled features, and FedNL trains
the binary classifier head on them with TopLEK-compressed Hessians.  The
backbone runs through the port's flash kernel on the card, the head's round
through its SYRK and TopLEK kernels.

    PYTHONPATH=src python examples/torch_fednl_probe.py [--arch granite-3-2b] [--device cpu]

The functions below take the config and the params, so that a caller can
run the probe at a published width (``chip_smoke.py``'s probe phase runs
granite-3-2b's, d = 2,048).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.api import CompressorSpec, ExperimentSpec, solve
from repro_torch.configs import get_config
from repro_torch.data import partition_clients
from repro_torch.device import resolve_device
from repro_torch.models import init_lm_params
from repro_torch.models.layers import COMPUTE_DTYPE
from repro_torch.models.lm import _run_blocks

SEQ = 16  # tokens a sample


def probe_data(cfg, clients: int, samples: int, seed: int = 0):
    """Synthetic private data, the reference's numpy draws: the class decides
    the token distribution.  Returns labels (n,) of +-1 and tokens (n, SEQ)."""
    rng = np.random.default_rng(seed)
    n_total = clients * samples
    labels = np.where(rng.random(n_total) < 0.5, 1.0, -1.0)
    lo, hi = cfg.vocab // 4, 3 * cfg.vocab // 4
    tokens = np.where(
        labels[:, None] > 0, rng.integers(0, lo, (n_total, SEQ)),
        rng.integers(hi, cfg.vocab, (n_total, SEQ)),
    ).astype(np.int32)
    return labels, tokens


def backbone_features(params, cfg, tokens) -> torch.Tensor:
    """Frozen-backbone mean-pooled features (B, d_model) in f64, on the params'
    device: the blocks in the compute dtype, then an f64 mean over the
    sequence."""
    embed = params["embed"]
    tokens = torch.as_tensor(np.asarray(tokens), device=embed.device).long()
    with torch.no_grad():
        x = embed.to(COMPUTE_DTYPE)[tokens]
        h = _run_blocks(x, params, cfg, torch.arange(tokens.shape[1], device=embed.device))
        return h.to(torch.float64).mean(dim=1)


def probe_problem(feats: np.ndarray, labels: np.ndarray, clients: int, samples: int):
    """The features normalised to unit rows, and the clients' label-absorbed
    problem z (clients, samples, d_model) in sample order."""
    feats = feats / (np.linalg.norm(feats, axis=1, keepdims=True) + 1e-9)
    return feats, partition_clients(feats, labels, clients, samples, seed=0, shuffle=False)


def probe_spec() -> ExperimentSpec:
    """FedNL (Option B) with TopLEK at k = 8 d, to tol 1e-13 or 100 rounds."""
    return ExperimentSpec(
        compressor=CompressorSpec("toplek", k_multiplier=8.0),
        rounds=100,
        tol=1e-13,
    )


def probe_accuracy(feats: np.ndarray, labels: np.ndarray, x: np.ndarray) -> float:
    """The probe's train-set accuracy."""
    return float(((feats @ x * labels) > 0).mean())


def run_probe(params, cfg, clients: int = 8, samples: int = 64, device=None) -> dict:
    """The whole probe on ``device`` (None: the card): features, the FedNL
    solve on them, the accuracy."""
    labels, tokens = probe_data(cfg, clients, samples)
    feats = backbone_features(params, cfg, tokens).cpu().numpy()
    feats, z = probe_problem(feats, labels, clients, samples)
    rep = solve(probe_spec(), z=z, device=device)
    return {"feats": feats, "labels": labels, "z": z, "report": rep,
            "accuracy": probe_accuracy(feats, labels, rep.x)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--samples", type=int, default=64)
    ap.add_argument("--device", default=None, help="cpu, or the card (the default)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    params = init_lm_params(0, cfg, dev)
    print(f"backbone: {cfg.name} (reduced: {cfg.n_layers}L d={cfg.d_model}) on {dev}")

    out = run_probe(params, cfg, args.clients, args.samples, dev)
    rep = out["report"]
    print(f"FedNL(B)/toplek head: {rep.rounds} rounds, ||grad|| = {rep.grad_norms[-1]:.2e}")
    print(f"probe train accuracy: {out['accuracy']:.3f}")


if __name__ == "__main__":
    main()
