"""Kernels of the port's paths, each beside its plain PyTorch version.

A wrapper given CPU tensors computes the plain version; given CUDA tensors it
launches its Hopper kernel or raises. When an input needs a gradient the
wrapper runs as an autograd Function whose backward is again a kernel on
CUDA tensors and the plain version on CPU tensors. `flash_attention`,
`temporal_attention` and `temporal_block_attention` (each forward and
backward), `group_norm`, `group_stats` and `layer_norm` are CUDA C++
(`csrc/`, built by `build.py`). The norms have plain fp32 backwards.
"""
