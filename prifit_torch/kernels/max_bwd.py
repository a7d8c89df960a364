"""The closed-form BN + relu + K-max backward: two CUDA kernels
(``csrc/max_bwd_cnt_gsm.cu``, ``csrc/max_bwd_dz.cu``) and their plain
PyTorch versions.

For the last layer ``relu(a * z + c)`` of a K-max region, with the K-max
ties all sharing the selected value ``zsel`` exactly:

  1. :func:`cnt_gsm`: ``cnt = #{k : z == zsel}`` and ``gsm = relu'(out) g
     / cnt`` per row and feature;
  2. (the caller) ``dbias``, ``dscale``, ``c1`` and ``c2`` from those over
     all rows;
  3. :func:`dz`: ``dz = a [z == zsel] gsm - c1 - (z - mean) c2``.

The storage (``z``, ``zsel``, ``out_bf``) is bf16 (the ``mx``/``mxsr``
regions), or f32 (the f32-storage K-max region of an f32 encoder).  A
``key`` (two uint32 words) rounds ``gsm`` and ``dz`` to bf16
stochastically (:mod:`prifit_torch.kernels.stochastic_round`), as the
``mxsr`` region does, and only at bf16 storage; without one they stay f32
(``mx`` and f32 storage).  ``offset`` shifts the flat index of the
rounding bits (a data-parallel shard's first global element), as in
:func:`~prifit_torch.kernels.stochastic_round.sr_bf16`.  The plain
versions are the jnp branch of ``nn/mixed.py::_max_bwd_core`` in the JAX
package, operation for operation.
"""

import torch

from prifit_torch.kernels import stochastic_round
from prifit_torch.kernels.build import I32, I64, P, U32, Kernel, \
    check_cuda, stream_handle

CNT_GSM_KERNEL = Kernel(
    "max_bwd_cnt_gsm", "prifit_tpu/ops/pallas/max_bwd.py:181",
    {"max_bwd_cnt_gsm": (P, P, P, I32, P, P, P, I32, I32, I64, I32, I32,
                         U32, I32, P)})
DZ_KERNEL = Kernel(
    "max_bwd_dz", "prifit_tpu/ops/pallas/max_bwd.py:221",
    {"max_bwd_dz": (P, P, P, P, P, P, P, P, I32, I32, I64, I32, I32, U32,
                    I32, P)})
STORAGE = (torch.bfloat16, torch.float32)


def cnt_gsm_plain(z, zsel, g_rows, out_bf, key, offset: int = 0):
    """``z [rows*K, F]``, ``zsel / g_rows / out_bf [rows, F]`` -> ``(cnt
    [rows, F] f32, gsm [rows, F])``, gsm bf16 with a key, else f32."""
    rows, F = zsel.shape
    cnt = (z.view(rows, -1, F) == zsel[:, None, :]).sum(1).float()
    gsm = torch.where(out_bf > 0, g_rows.float(), 0.0) / cnt
    if key is not None:
        gsm = stochastic_round.sr_bf16_plain(key, gsm, offset)
    return cnt, gsm


def dz_plain(z, zsel, gsm, a, c1, mean, c2, key, offset: int = 0):
    """``dz [rows*K, F]``, bf16 with a key, else f32; ``a, c1, mean, c2
    [F]`` f32."""
    rows, F = zsel.shape
    zk = z.view(rows, -1, F)
    sel = torch.where(zk == zsel[:, None, :], gsm.float()[:, None, :], 0.0)
    dz = (a * sel - c1 - (zk.float() - mean) * c2).reshape(-1, F)
    if key is not None:
        dz = stochastic_round.sr_bf16_plain(key, dz, offset)
    return dz


def _vec8(F, *ts) -> int:
    """Whether the kernels may take 8 features per thread (16-byte
    accesses)."""
    return int(F % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in ts))


def _storage(name, z, zsel, *rest, sr: bool):
    """Check ``z``, ``zsel`` and ``rest`` (CUDA, 2-D, contiguous, one
    storage dtype of :data:`STORAGE`); returns whether it is f32."""
    if z.dtype not in STORAGE:
        raise ValueError(f"{name}: storage {z.dtype} is not bf16 or f32")
    if sr and z.dtype != torch.bfloat16:
        raise ValueError(f"{name}: stochastic rounding needs bf16 storage")
    for what, t in (("z", z), ("zsel", zsel), *rest):
        check_cuda(f"{name} {what}", t, z.dtype, 2, align=2)
    return z.dtype == torch.float32


def _shapes(z, zsel, *rows_f):
    rows, F = zsel.shape
    if z.shape[0] % max(rows, 1) or z.shape[1] != F or any(
            t.shape != zsel.shape for t in rows_f):
        raise ValueError(f"max_bwd: unsupported shapes z {tuple(z.shape)}, "
                         f"rows {[tuple(t.shape) for t in (zsel, *rows_f)]}")
    return rows, z.shape[0] // max(rows, 1), F


def cnt_gsm(z, zsel, g_rows, out_bf, key, offset: int = 0):
    """Pass 1 (:func:`cnt_gsm_plain`): the kernel for CUDA tensors (z,
    zsel and out_bf all bf16 or all f32; g_rows bf16 or f32), the plain
    version for CPU tensors."""
    if z.device.type == "cpu":
        return cnt_gsm_plain(z, zsel, g_rows, out_bf, key, offset)
    sr = key is not None
    z_f32 = _storage("max_bwd_cnt_gsm", z, zsel, ("out_bf", out_bf), sr=sr)
    check_cuda("max_bwd_cnt_gsm g", g_rows, ndim=2, align=2)
    if g_rows.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"max_bwd_cnt_gsm: g is {g_rows.dtype}")
    rows, K, F = _shapes(z, zsel, g_rows, out_bf)
    cnt = torch.empty((rows, F), dtype=torch.float32, device=z.device)
    gsm = torch.empty((rows, F), dtype=torch.bfloat16 if sr else
                      torch.float32, device=z.device)
    CNT_GSM_KERNEL.launch(
        "max_bwd_cnt_gsm", z.data_ptr(), zsel.data_ptr(), g_rows.data_ptr(),
        int(g_rows.dtype == torch.float32), out_bf.data_ptr(), cnt.data_ptr(),
        gsm.data_ptr(), int(sr), int(z_f32), rows, K, F,
        stochastic_round.hash_seed(key, offset) if sr else 0,
        _vec8(F, z, zsel, g_rows, out_bf, cnt, gsm), stream_handle(z))
    return cnt, gsm


def dz(z, zsel, gsm, a, c1, mean, c2, key, offset: int = 0):
    """Pass 2 (:func:`dz_plain`): the kernel for CUDA tensors (z and zsel
    both bf16 or both f32; gsm bf16 with a key, f32 without; the vectors
    f32), the plain version for CPU tensors."""
    if z.device.type == "cpu":
        return dz_plain(z, zsel, gsm, a, c1, mean, c2, key, offset)
    sr = key is not None
    z_f32 = _storage("max_bwd_dz", z, zsel, sr=sr)
    check_cuda("max_bwd_dz gsm", gsm,
               torch.bfloat16 if sr else torch.float32, 2, align=2)
    rows, K, F = _shapes(z, zsel, gsm)
    for name, t in (("a", a), ("c1", c1), ("mean", mean), ("c2", c2)):
        check_cuda(f"max_bwd_dz {name}", t, torch.float32, 1, align=4)
        if t.shape[0] != F:
            raise ValueError(f"max_bwd_dz: {name} {tuple(t.shape)}, F={F}")
    out = torch.empty((rows * K, F), dtype=torch.bfloat16 if sr else
                      torch.float32, device=z.device)
    DZ_KERNEL.launch(
        "max_bwd_dz", z.data_ptr(), zsel.data_ptr(), gsm.data_ptr(),
        a.data_ptr(), c1.data_ptr(), mean.data_ptr(), c2.data_ptr(),
        out.data_ptr(), int(sr), int(z_f32), rows, K, F,
        stochastic_round.hash_seed(key, offset) if sr else 0,
        _vec8(F, z, zsel, gsm, out), stream_handle(z))
    return out
