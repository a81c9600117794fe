"""Frozen plain reference of the benchmark's `correct` check.

A copy of the plain code of `hm16_2_tpu_torch` (the package under test) as
it stood when the benchmark was defined: the HEVC decoder with its headers,
CABAC, intra/inter prediction, transforms, deblocking and SAO in numpy,
and the plain PyTorch versions of the intra (K1-K4) and inter (K1, K2,
K4-K8) frame plans.  Imports were renamed to this package, the kernel
dispatch was removed (every wrapper runs its plain version, on whatever
device its tensors live), and the native C++ helpers were replaced by a
stub that reports them absent, so every path is plain Python, numpy and
PyTorch.  Later changes to the package under test do not reach this copy.
"""
