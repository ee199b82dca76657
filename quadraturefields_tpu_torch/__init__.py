"""quadraturefields_tpu_torch: the PyTorch / CUDA port of quadraturefields_tpu.

A second package beside the JAX one, which stays the reference. It
renders stage-1 NGP views (train/stage1_ngp.py) on an NVIDIA H100; the
three kernels of that path are hand-written CUDA C++ under csrc/, built
with nvcc for sm_90a at first use, each beside its plain PyTorch
version, which CPU tensors take. Modules keep the JAX package's names.
The package imports torch and never jax.
"""

__version__ = "0.1.0"
