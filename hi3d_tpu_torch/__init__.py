"""hi3d_tpu_torch — the PyTorch/CUDA port of hi3d_tpu for one NVIDIA H100.

The JAX package `hi3d_tpu` is the reference; this package mirrors its module
names (config, registry, engine, conditioners, diffusion/, models/, ops/,
pipelines/, utils/) in PyTorch idiom: `nn.Module`s with NCHW convolutions, an
explicit `device` everywhere, explicit `torch.Generator`s, and a plain Python
sampler loop. The kernels the JAX package wrote in Pallas are hand-written for
Hopper in CUDA C++ (`csrc/*.cu`, built by `ops/build.py`).

Importing this package imports neither `jax` nor `hi3d_tpu`.
"""

__version__ = "0.1.0"
