"""jamba-v0.1-52b — Mamba + attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887; hf]
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.
Period-8 blocks: attention at in-block offset 3 (4 attn layers of 32),
MoE every 2nd layer.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    n_experts=16,
    top_k=2,
    moe_every=2,
    attn_every=8,
    attn_offset=3,
    ssm_state=16,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_chunk=256,
    ssm_ngroups=1,
    source="arXiv:2403.19887; hf",
)
