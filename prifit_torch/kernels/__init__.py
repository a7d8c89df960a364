"""Hand-written CUDA kernels of the port, one per TPU kernel on its path.

Each module here holds a kernel's wrapper and its plain PyTorch version.
The wrapper launches the kernel for CUDA tensors (building all sources
with nvcc at first use, :mod:`prifit_torch.kernels.build`) and counts the
launch; it takes the plain version only for tensors on the CPU.  Nothing
is compiled or imported from CUDA when this package is imported.
"""

from prifit_torch.kernels import bandwidth, fps, gather, mean_shift, nms
from prifit_torch.kernels.build import build_all

KERNELS = {k.name: k for k in (
    fps.KERNEL, gather.KERNEL, bandwidth.KERNEL, mean_shift.KERNEL,
    mean_shift.BWD_KERNEL, nms.KERNEL)}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


__all__ = ["KERNELS", "build_all", "launch_counts", "reset_launch_counts"]
