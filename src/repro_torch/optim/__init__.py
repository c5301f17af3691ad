from repro_torch.optim.adamw import (
    AdamWConfig,
    apply_updates,
    dequantize_blockwise,
    global_norm,
    init_opt_state,
    quantize_blockwise,
    schedule,
    tree_leaves,
)

__all__ = [
    "AdamWConfig", "apply_updates", "init_opt_state", "schedule",
    "global_norm", "quantize_blockwise", "dequantize_blockwise",
    "tree_leaves",
]
