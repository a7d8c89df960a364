"""Stand-in for ``prifit_torch/native`` in the benchmark's frozen copy: the
point files are parsed by ``np.loadtxt``, as the port does where its
native parser does not build."""

import numpy as np


def fast_loadtxt(path: str, ncols: int | None = None) -> np.ndarray:
    out = np.loadtxt(path).astype(np.float32)
    return out.reshape(-1, ncols if ncols else out.shape[-1])
