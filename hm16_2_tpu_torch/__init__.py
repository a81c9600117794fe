"""PyTorch + CUDA port of the all-intra encode's device work.

The JAX package `hm16_2_tpu` is the reference.  This package imports torch
and never jax; it reuses the reference's jax-free host modules (headers,
CABAC, the decoder, the native commit engine) unchanged.
"""
