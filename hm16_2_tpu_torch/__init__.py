"""PyTorch + CUDA port of the encoder's device work.

The JAX package `hm16_2_tpu` is the reference.  This package imports torch
and never jax, nor any module of the reference: it keeps its own copy of
the host code it runs (headers, CABAC, the decoder, the native commit
engine, the encoder top level, the CLIs), each equal to its original after
the import rewrite, and ports every device program to a plain PyTorch
version beside a hand-written CUDA kernel.
"""
