"""The LM zoo's models (port of ``repro.models``): the dense decoder family.

``encdec`` and the moe, ssm, hybrid and vlm families are ROADMAP A14.
"""

from repro_torch.models.lm import (
    cast_for_compute,
    init_decode_cache,
    init_lm_params,
    lm_decode_step,
    lm_forward,
    lm_prefill,
    params_from_numpy,
)

__all__ = [
    "cast_for_compute",
    "init_lm_params",
    "lm_forward",
    "lm_prefill",
    "init_decode_cache",
    "lm_decode_step",
    "params_from_numpy",
]
