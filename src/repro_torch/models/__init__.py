from repro_torch.models.lm import (
    RuntimeConfig,
    backbone,
    cache_axes,
    chunked_ce_loss,
    decode_step,
    init_caches,
    init_params,
    loss_fn,
    param_axes,
    prefill_step,
)

__all__ = [
    "RuntimeConfig", "backbone", "cache_axes", "chunked_ce_loss",
    "decode_step", "init_caches", "init_params", "loss_fn", "param_axes",
    "prefill_step",
]
