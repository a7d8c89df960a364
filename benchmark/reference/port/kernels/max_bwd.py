# The plain versions of prifit_torch/kernels/max_bwd.py at commit
# 0adee2a, for the benchmark's reference (the kernels' launches left
# out); see benchmark/reference/__init__.py.
"""The closed-form BN + relu + K-max backward, plain (the program runs
two kernels).

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

from benchmark.reference.port.kernels import stochastic_round


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


def cnt_gsm(z, zsel, g_rows, out_bf, key, offset: int = 0):
    """Pass 1 (:func:`cnt_gsm_plain`)."""
    return cnt_gsm_plain(z, zsel, g_rows, out_bf, key, offset)


def dz(z, zsel, gsm, a, c1, mean, c2, key, offset: int = 0):
    """Pass 2 (:func:`dz_plain`)."""
    return dz_plain(z, zsel, gsm, a, c1, mean, c2, key, offset)
