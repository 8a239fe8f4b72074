"""nerf_tpu_torch: the PyTorch + CUDA port of nerf_tpu for NVIDIA Hopper.

Mirrors the JAX package's module paths and public names (the counterpart of
``nerf_tpu/ops/volume.py`` is ``nerf_tpu_torch/ops/volume.py``) and keeps its
tensor layouts at every public function. Kernels written by hand for Hopper
live in ``kernels/`` (wrappers) and ``csrc/`` (CUDA sources). The package
imports torch and numpy only.
"""

__version__ = "0.1.0"
