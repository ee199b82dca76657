"""quadraturefields_tpu_torch: the PyTorch / CUDA port of quadraturefields_tpu.

A second package beside the JAX one, which stays the reference. It
trains and renders stage-1 NGP models (train/stage1_ngp.py), distils
them into the stage-2 quadrature field (train/stage2_field.py),
extracts the stage-3 mesh (geometry/extract.py) and finetunes both
fields at ray-mesh quadrature points (train/stage4_finetune.py) on an
NVIDIA H100; the kernels of those paths are hand-written CUDA C++ under
csrc/, built with nvcc for sm_90a at first use, each beside its plain
PyTorch version, which CPU tensors take. Modules keep the JAX package's names.
The package imports torch and never jax.
"""

__version__ = "0.1.0"
