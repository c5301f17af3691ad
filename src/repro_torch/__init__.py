"""PyTorch/CUDA port of the DGNN-Booster stream engine and of the LM
scaffold's serving path (see README.md).

The JAX package ``repro`` is the reference; this package imports torch and
numpy only. Its entry points run on the CUDA card unless the caller passes
``device="cpu"``, which runs the plain PyTorch versions of the kernels.
"""
