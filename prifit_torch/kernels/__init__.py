"""Hand-written CUDA kernels of the port, one per TPU kernel on its path,
plus two that have no TPU kernel (in the JAX package each is an XLA
fusion): the stochastic-rounding cast of the mixed-precision region, and
the eval-mode epilogue of a PointNet++ dense layer (:mod:`.bn_eval`,
launched only by eval forwards).

Each module here holds a kernel's wrapper and its plain PyTorch version.
The wrapper launches the kernel for CUDA tensors (building all sources
with nvcc at first use, :mod:`prifit_torch.kernels.build`) and counts the
launch; it takes the plain version only for tensors on the CPU.  Nothing
is compiled or imported from CUDA when this package is imported.
"""

from prifit_torch.kernels import bandwidth, bn_eval, fps, gather, \
    max_bwd, mean_shift, nms, stochastic_round
from prifit_torch.kernels.build import build_all

KERNELS = {k.name: k for k in (
    fps.KERNEL, gather.KERNEL, bandwidth.KERNEL, mean_shift.KERNEL,
    mean_shift.BWD_KERNEL, nms.KERNEL, max_bwd.CNT_GSM_KERNEL,
    max_bwd.DZ_KERNEL, stochastic_round.KERNEL, bn_eval.KERNEL)}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


__all__ = ["KERNELS", "build_all", "launch_counts", "reset_launch_counts"]
