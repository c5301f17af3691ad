"""The LM scaffold's layers: ``layers`` (norms, RoPE, embeddings),
``mlp`` (SwiGLU), ``attention`` (GQA attention, the flash path, KV-cache
decode), ``moe`` (the MoE MLP's dense path) and ``mamba2`` (the Mamba2
mixer: chunked SSD prefill, one-token decode), counterparts of the
modules of ``repro.nn``. The expert-parallel MoE waits for sharding
(ROADMAP.md queue 1, device sharding)."""
