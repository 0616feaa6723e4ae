"""LM *token* serving engine (port of ``repro.serving``): fixed-batch decode
slots, greedy sampling, per-slot stop conditions."""

from repro_torch.serving.engine import Request, ServeEngine

__all__ = ["ServeEngine", "Request"]
