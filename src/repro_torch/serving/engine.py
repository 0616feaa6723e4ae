"""Batched LM *token* serving engine over the serve step (port of
``repro.serving.engine``).

The reference's shape, slot for slot: fixed-batch slots, greedy sampling,
per-slot stop conditions, prompt consumption through the same decode step
(sequential prefill, right for every family's state), one shared monotone
cache position, so one engine serves one wave of requests.  The decode step
runs no kernel: decoding attends with a plain einsum against the KV cache,
as in the reference.  An encdec engine decodes against a cross K/V of
``src_len`` zero positions, as the reference's does (ROADMAP C6).

The engine holds the params with their matrices cast to bf16 once
(``cast_for_compute``; the leaves read in f32 stay f32); the reference
casts f32 weights at each use.  The numbers are the same and a step reads
half the weight bytes; the copy costs two bytes per parameter on top of the
caller's f32 params.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.encdec import init_encdec_cache
from repro_torch.models.lm import cast_for_compute, init_decode_cache
from repro_torch.train.step import make_serve_step


@dataclasses.dataclass
class Request:
    prompt: list[int]
    max_new_tokens: int = 16
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, params, cfg: ArchConfig, batch_size: int = 4,
                 max_len: int = 256, src_len: int = 16, eos_id: int | None = None,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.params = cast_for_compute(params)
        self.cfg = cfg
        self.batch = batch_size
        self.max_len = max_len
        self.eos = eos_id
        self.step = make_serve_step(cfg)
        if cfg.family == "encdec":
            self.cache = init_encdec_cache(cfg, batch_size, max_len, src_len, self.device)
        else:
            self.cache = init_decode_cache(cfg, batch_size, max_len, self.device)
        self.slots: list[Request | None] = [None] * batch_size
        self._pending: list[Request] = []
        self._cursor = np.zeros(batch_size, dtype=np.int64)  # prompt position
        self.steps = 0

    def submit(self, req: Request) -> None:
        self._pending.append(req)

    def _fill_slots(self) -> None:
        for i in range(self.batch):
            if self.slots[i] is None and self._pending:
                self.slots[i] = self._pending.pop(0)
                self._cursor[i] = 0

    def _next_inputs(self) -> np.ndarray:
        toks = np.zeros((self.batch, 1), dtype=np.int64)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            c = self._cursor[i]
            if c < len(req.prompt):
                toks[i, 0] = req.prompt[c]
            elif req.generated:
                toks[i, 0] = req.generated[-1]
            else:
                toks[i, 0] = req.prompt[-1]
        return toks

    def run(self, max_steps: int = 512) -> list[Request]:
        """Drive all submitted requests to completion; returns them in the
        order they finished."""
        finished: list[Request] = []
        self._fill_slots()
        steps = 0
        with torch.inference_mode():
            while any(s is not None for s in self.slots) or self._pending:
                toks = torch.as_tensor(self._next_inputs(), device=self.device)
                logits, self.cache = self.step(self.params, self.cache, toks)
                # argmax returns the first index of a tie, as jnp.argmax does
                nxt = torch.argmax(logits[:, 0, : self.cfg.vocab], dim=-1).cpu().numpy()
                for i, req in enumerate(self.slots):
                    if req is None:
                        continue
                    self._cursor[i] += 1
                    if self._cursor[i] >= len(req.prompt):
                        req.generated.append(int(nxt[i]))
                        hit_eos = self.eos is not None and nxt[i] == self.eos
                        if len(req.generated) >= req.max_new_tokens or hit_eos:
                            req.done = True
                            finished.append(req)
                            self.slots[i] = None
                self._fill_slots()
                steps += 1
                self.steps += 1
                if steps >= max_steps:
                    break
        return finished
