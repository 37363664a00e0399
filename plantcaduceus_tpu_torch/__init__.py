"""PyTorch/CUDA port of plantcaduceus_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's subpackages (models, ops, engine, train, io,
compat, utils, cli). Imports torch and never jax, and nothing of the JAX
package. The kernels of the scoring and training paths are hand-written
CUDA C++ (``csrc/``), built with nvcc for sm_90a at first use.
"""

__version__ = "0.1.0"
