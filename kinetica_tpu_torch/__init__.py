"""kinetica_tpu_torch: the PyTorch/CUDA port of kinetica_tpu.

The port runs the batched variable-temperature BDF sweep of
``kinetica_tpu`` on one NVIDIA GPU: host layer copied from the JAX package,
solver written in PyTorch, and the two hot kernels of that path (the fused
mass-action RHS and the batched Gauss-Jordan inverse) as CUDA C++ under
``csrc/``. It never imports jax.

Importing the package sets the float32 matmul precision policy (see
:mod:`kinetica_tpu_torch.precision`): every f32 product the solver makes
is a full-f32 product, as the JAX package's ``Precision.HIGHEST``.
"""
from .precision import set_precision_policy

set_precision_policy()

__version__ = "0.1.0"
