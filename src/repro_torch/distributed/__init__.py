from repro_torch.distributed.api import (
    Axes,
    current_mesh,
    named_sharding,
    resolve_spec,
    shard,
    sharding_ctx,
    tree_shardings,
    DEFAULT_RULES,
)

__all__ = [
    "Axes", "current_mesh", "named_sharding", "resolve_spec", "shard",
    "sharding_ctx", "tree_shardings", "DEFAULT_RULES",
]
