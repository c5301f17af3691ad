"""hubert-xlarge — encoder-only audio transformer. [arXiv:2106.07447; unverified]

48L d_model=1280 16H (kv=16, i.e. MHA) d_ff=5120 vocab=504.
Audio: the conv waveform frontend is a STUB per the assignment —
input_specs() provides precomputed frame embeddings. Encoder-only:
no decode shapes (skipped per the assignment).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    input_mode="embeddings",
    norm_eps=1e-5,
    source="arXiv:2106.07447; unverified",
)
