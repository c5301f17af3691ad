"""llama4-maverick-400b-a17b — MoE 128e top-1, early fusion.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048.

Following the released Maverick wiring, MoE layers interleave with dense
layers (moe_every=2) and each MoE layer carries one always-on shared expert;
this reproduces the ~400B total / ~17B active split that "400b-a17b" names
(128e top-1 on every layer would be ~770B total). Noted in DESIGN.md.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    n_experts=128,
    top_k=1,
    moe_every=2,
    n_shared_experts=1,
    rope_theta=500000.0,
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
