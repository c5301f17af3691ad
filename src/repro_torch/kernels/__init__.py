"""Stream-engine kernels (CUDA, csrc/), their wrappers and plain versions."""
