"""Synthetic token pipeline for the LM zoo (port of ``repro.train.data``, a
numpy copy of it).

Deterministic, seedable next-token-predictable streams (a noisy order-2
Markov chain over the vocab), so that short training runs show a real loss
decrease.  The batches are numpy arrays, byte for byte the reference's for
every family (``src_embeds`` for encdec, ``img_embeds`` for vlm); the train
step moves them to its device.
"""

from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ArchConfig


def synthetic_batch(cfg: ArchConfig, batch: int, seq: int, seed: int = 0) -> dict:
    """One training batch matching the family's input contract."""
    rng = np.random.default_rng(seed)
    v = cfg.vocab

    def stream(n, s):
        # x_{t} = (a * x_{t-1} + b) mod v with occasional noise: learnable
        a, b = 6364136223846793005 % v or 7, 1442695040888963407 % v or 11
        x = rng.integers(0, v, size=(n, 1))
        cols = [x]
        for _ in range(s - 1):
            nxt = (cols[-1] * a + b) % v
            noise = rng.random((n, 1)) < 0.1
            nxt = np.where(noise, rng.integers(0, v, size=(n, 1)), nxt)
            cols.append(nxt)
        return np.concatenate(cols, axis=1).astype(np.int32)

    if cfg.family == "encdec":
        tokens = stream(batch, seq)
        return {
            "src_embeds": rng.standard_normal((batch, seq, cfg.d_model)).astype(
                np.float32
            ),
            "tokens": tokens,
            "labels": np.concatenate(
                [tokens[:, 1:], np.full((batch, 1), -1, np.int32)], axis=1
            ),
        }
    tokens = stream(batch, seq)
    out = {
        "tokens": tokens,
        "labels": np.concatenate(
            [tokens[:, 1:], np.full((batch, 1), -1, np.int32)], axis=1
        ),
    }
    if cfg.family == "vlm":
        out["img_embeds"] = rng.standard_normal(
            (batch, cfg.n_frontend_tokens, cfg.d_model)
        ).astype(np.float32)
    return out


def synthetic_token_stream(cfg: ArchConfig, batch: int, seq: int, seed: int = 0):
    """Infinite iterator of batches (fresh seed per step)."""
    step = 0
    while True:
        yield synthetic_batch(cfg, batch, seq, seed=seed + step)
        step += 1
