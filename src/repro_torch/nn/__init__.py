"""The LM scaffold's layers: ``layers`` (norms, RoPE, embeddings),
``mlp`` (SwiGLU), ``attention`` (GQA attention, the flash path, KV-cache
decode), ``moe`` (the MoE MLP: dense, and expert-parallel over a mesh's
'model' axis with ``all_to_all``) and ``mamba2`` (the Mamba2 mixer:
chunked SSD prefill, one-token decode), counterparts of the modules of
``repro.nn``. Each init has an ``*_axes`` beside it (the JAX package's
logical axes); with DTensor parameters under a mesh the layers run
tensor-parallel, with the JAX package's ``shard`` calls."""
