"""mamba2-2.7b — SSD (state-space duality), attention-free.

[arXiv:2405.21060; unverified]
64L d_model=2560, d_ff=0 (pure Mamba2 blocks), vocab=50280, ssm_state=128.
d_inner = 2*2560 = 5120, headdim 64 -> 80 SSD heads.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_chunk=256,
    ssm_ngroups=1,
    tie_embeddings=True,
    norm_eps=1e-5,
    source="arXiv:2405.21060; unverified",
)
