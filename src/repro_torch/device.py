"""Device resolution for the port's entry points.

``device=None`` means the card.  Nothing here falls back to the CPU quietly:
a caller that wants the CPU (the parity tests) says ``device="cpu"``.  A
caller that counts a step without running it (``roofline.step_cost``) says
``device="meta"``: tensors with shapes and no storage, which take the
kernels' plain versions.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a card raises; ``cpu``
    and ``meta`` as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda', 'cpu' or 'meta'")
    return dev


def device_name(device: torch.device) -> str:
    """Human name of the device a result ran on."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
