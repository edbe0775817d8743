"""Optimizer of the port: AdamW with fp32 master weights, the warmup-cosine
schedule and int8 error-feedback gradient compression (the port of
``repro.optim``)."""
from repro_torch.optim.adamw import adamw_init, adamw_update  # noqa: F401
from repro_torch.optim.compression import (  # noqa: F401
    ef_int8_roundtrip,
    int8_dequant,
    int8_quant,
)
from repro_torch.optim.schedule import warmup_cosine  # noqa: F401
