from repro_torch.models.lm import (
    RuntimeConfig,
    backbone,
    chunked_ce_loss,
    decode_step,
    init_caches,
    init_params,
    loss_fn,
    prefill_step,
)

__all__ = [
    "RuntimeConfig", "backbone", "chunked_ce_loss", "decode_step",
    "init_caches", "init_params", "loss_fn", "prefill_step",
]
