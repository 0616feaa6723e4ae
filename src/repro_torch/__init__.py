"""FedNL in PyTorch, with hand-written CUDA kernels for Hopper (sm_90a).

The port of ``repro`` (JAX/Pallas), module for module: ``linalg``, ``data``,
``objectives``, ``compressors``, ``kernels``, ``core``, ``api``, ``launch``.
It never imports ``jax`` or ``repro``; the parity tests hold each module
against its counterpart there.

Entry points (``repro_torch.api.solve``, ``repro_torch.core.runner.run_fednl``,
``python -m repro_torch.launch.fednl_run``) run on the card unless the caller
passes ``device="cpu"``; without a card they raise.  Importing this package
builds and loads no kernel: ``repro_torch.kernels.build`` compiles the CUDA
sources at their first launch.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
