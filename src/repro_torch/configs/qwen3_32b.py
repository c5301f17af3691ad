"""qwen3-32b — qk_norm, GQA, head_dim=128 (64H*128 != d_model).

[hf:Qwen/Qwen3-8B; hf]
64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_ff=25600,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1000000.0,
    source="hf:Qwen/Qwen3-8B; hf",
)
