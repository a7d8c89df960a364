"""PyTorch + CUDA port of prifit_tpu for NVIDIA Hopper.

The JAX package ``prifit_tpu`` is the reference; this package imports
nothing from it and nothing of JAX.  Its kernels (``kernels/``) are
hand-written CUDA built with nvcc at first use; on CPU tensors every op
runs its plain PyTorch version.
"""

from prifit_torch import clustering, geometry, kernels, models, nn, ops, \
    train, utils

__all__ = ["clustering", "geometry", "kernels", "models", "nn", "ops",
           "train", "utils"]
