# Frozen copy of prifit_torch/utils/device.py at commit 0adee2a, for the
# benchmark's reference; see benchmark/reference/__init__.py.
"""Where the port's entry points run."""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  With no device given and no GPU present this raises; it
    never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "prifit_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch path")
        return torch.device("cuda")
    return torch.device(device)
