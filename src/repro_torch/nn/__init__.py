"""The LM scaffold's layers: ``layers`` (norms, RoPE, embeddings),
``mlp`` (SwiGLU) and ``attention`` (GQA attention, the flash path, KV-cache
decode), counterparts of the modules of ``repro.nn``. The MoE and Mamba2
mixers are not ported yet (ROADMAP queue 1, the LM MoE MLP and Mamba2
mixer)."""
