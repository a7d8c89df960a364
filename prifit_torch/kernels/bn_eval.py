"""The eval-mode epilogue of a PointNet++ dense layer (dense bias, batch
norm with running statistics, the cast to the storage dtype, relu and
optionally the max over axis -2) as one CUDA kernel
(``csrc/bn_relu_eval.cu``), and its plain PyTorch version.

The plain version is the op chain that ``prifit_torch/nn/pointnet2.py``
runs in training mode and runs as PyTorch ops wherever the kernel does
not apply: :func:`~prifit_torch.nn.pointnet2.dense`'s bias add,
:class:`~prifit_torch.nn.norm.BatchNorm`'s eval forward, ``torch.relu``
and ``torch.amax``.  The kernel computes the same values bit for bit (see
its source note).  It replaces no TPU kernel: in the JAX package the
chain is an XLA fusion.
"""

import torch
from torch.profiler import record_function

from prifit_torch.kernels.build import I32, I64, P, Kernel, check_cuda, \
    stream_handle
from prifit_torch.utils.profiling import count

KERNEL = Kernel("bn_relu_eval", None, {"bn_relu_eval": (
    P, P, P, P, P, P, P, I64, I32, I32, I32, I32, I32, P)})

# the (input, storage) pairs the kernel takes: a bf16 product, a grouped
# first layer's f32 pre-activation rounded to bf16, and f32 throughout
PAIRS = ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
         (torch.float32, torch.float32))
# its widest row: F / VEC <= 256, VEC 8 where it divides F, else 4
MAX_COLUMNS = 256


def bn_relu_eval_plain(z, mean, inv, weight, bias, dense_bias=None,
                       storage=None, kmax: bool = False) -> torch.Tensor:
    """``relu(BN(round(z) (+ dense_bias)))`` with the running statistics
    ``mean`` and ``inv = rsqrt(running_var + eps)``, in the storage dtype
    ``storage`` (default ``z.dtype``; an f32 ``z`` with a bf16 storage is
    rounded first, as ``grouped_first_layer`` casts its pre-activation);
    with ``kmax`` the max over axis -2."""
    x = z.to(storage or z.dtype)
    if dense_bias is not None:
        x = x + dense_bias.to(x.dtype)
    y = (x - mean) * inv
    x = torch.relu((y * weight + bias).to(x.dtype))
    return torch.amax(x, dim=-2) if kmax else x


def bn_relu_eval(z, mean, var, eps: float, weight, bias, dense_bias=None,
                 storage=None, kmax: bool = False) -> torch.Tensor:
    """:func:`bn_relu_eval_plain` with ``inv = torch.rsqrt(var + eps)``:
    the kernel for a CUDA ``z`` (contiguous, one of :data:`PAIRS` with the
    storage dtype), the plain version for a CPU one.  Runs in the range
    ``bn_eval``; each launch counts in ``bn_eval.calls`` (and
    ``bn_eval.max_calls`` with ``kmax``) beside the kernel's own launch
    count."""
    storage = storage or z.dtype
    with record_function("bn_eval"):
        inv = torch.rsqrt(var + eps)
        if z.device.type == "cpu":
            return bn_relu_eval_plain(z, mean, inv, weight, bias, dense_bias,
                                      storage, kmax)
        return _launch(z, mean, inv, weight, bias, dense_bias, storage, kmax)


def _launch(z, mean, inv, weight, bias, dense_bias, storage, kmax):
    if (z.dtype, storage) not in PAIRS:
        raise ValueError(f"bn_relu_eval: takes the input and storage dtypes "
                         f"{PAIRS}, got {z.dtype} and {storage}")
    F = z.shape[-1]
    if F % 4:
        raise ValueError(f"bn_relu_eval: {F} features, not a multiple of 4")
    vec = 8 if F % 8 == 0 else 4
    check_cuda("bn_relu_eval z", z, align=min(16, vec * z.element_size()))
    params = [mean, inv, weight, bias] + (
        [] if dense_bias is None else [dense_bias])
    for t in params:
        check_cuda("bn_relu_eval parameter", t, torch.float32, 1, align=4)
        if t.shape[0] != F or t.device != z.device:
            raise ValueError(f"bn_relu_eval: a parameter of {tuple(t.shape)} "
                             f"on {t.device} for {F} features on {z.device}")
    if F // vec > MAX_COLUMNS:
        raise ValueError(f"bn_relu_eval: {F} features is more than "
                         f"{MAX_COLUMNS} columns of {vec}")
    if kmax:
        if z.dim() < 2 or z.shape[-2] == 0:
            raise ValueError(f"bn_relu_eval: no axis -2 to take the max "
                             f"over in {tuple(z.shape)}")
        K, shape = z.shape[-2], z.shape[:-2] + (F,)
    else:
        K, shape = 1, z.shape
    out = torch.empty(shape, dtype=storage, device=z.device)
    if z.numel() == 0:
        return out
    count("bn_eval.calls")
    if kmax:
        count("bn_eval.max_calls")
    KERNEL.launch(
        "bn_relu_eval", z.data_ptr(), out.data_ptr(), mean.data_ptr(),
        inv.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        None if dense_bias is None else dense_bias.data_ptr(),
        z.numel() // F, K, F, int(z.dtype == torch.float32),
        int(storage == torch.bfloat16), int(kmax), stream_handle(z))
    return out
