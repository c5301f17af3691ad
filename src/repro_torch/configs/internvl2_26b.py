"""internvl2-26b — InternViT + InternLM2 backbone. [arXiv:2404.16821; hf]

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.
VLM: the InternViT frontend is a STUB per the assignment — input_specs()
provides precomputed patch embeddings for train/prefill; decode is ordinary
token decode against the prefused cache.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    input_mode="embeddings",
    rope_theta=1000000.0,
    source="arXiv:2404.16821; hf",
)
