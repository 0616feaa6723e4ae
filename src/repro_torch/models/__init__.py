"""The LM zoo's models (port of ``repro.models``): the decoder families
(dense, moe, ssm, hybrid, vlm) and the encoder-decoder."""

from repro_torch.models.encdec import (
    encdec_decode_step,
    encdec_loss,
    encdec_prefill,
    encode,
    init_encdec_cache,
    init_encdec_params,
)
from repro_torch.models.lm import (
    cast_for_compute,
    init_decode_cache,
    init_lm_params,
    lm_decode_step,
    lm_forward,
    lm_loss,
    lm_prefill,
    params_from_numpy,
)
from repro_torch.models.moe import moe_apply, moe_apply_dense, moe_aux_loss
from repro_torch.models.rglru import rglru_apply, rglru_decode_step
from repro_torch.models.ssm import ssd_apply, ssd_decode_step

__all__ = [
    "cast_for_compute",
    "init_lm_params",
    "lm_forward",
    "lm_loss",
    "lm_prefill",
    "init_decode_cache",
    "lm_decode_step",
    "params_from_numpy",
    "init_encdec_params",
    "encode",
    "encdec_prefill",
    "encdec_loss",
    "init_encdec_cache",
    "encdec_decode_step",
    "moe_apply",
    "moe_apply_dense",
    "moe_aux_loss",
    "ssd_apply",
    "ssd_decode_step",
    "rglru_apply",
    "rglru_decode_step",
]
