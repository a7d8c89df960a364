"""Mixed-precision training region of the SA and FP chains (``mx``,
``mxsr``).

Port of ``prifit_tpu/nn/mixed.py``.  A region is one SA scale (grouped
first layer's batch norm, the MLP chain and the K-max), the group-all SA
chain with its max, or an FP chain.  Its forward runs the real bf16 chain
(bf16 activations, f32 batch-norm statistics from the unrounded f32
matmul accumulator); its backward is written by hand, holding every
cotangent in f32 (``mx``) or rounding them to bf16 STOCHASTICALLY
(``mxsr``, the default encoder dtype), so that no cast is biased.  Only
bf16 residuals are kept for the backward, never the f32 accumulator.

Stochastic rounding takes its bits from a key of two uint32 words (plain
Python ints), folded per use with the JAX package's ``fold_in``
(threefry-2x32, reproduced here bit for bit) at the same places, so that
the same key gives the same bits as ``jax.random.fold_in`` would.  The
K-max backward runs as two CUDA kernels for CUDA tensors
(:mod:`prifit_torch.kernels.max_bwd`), and every other rounding cast as
the ``sr_bf16`` kernel (:mod:`prifit_torch.kernels.stochastic_round`).

Products with an f32 result (:func:`mm_f32`): bf16 operands are exact in
f32, so on the CPU they are multiplied as f32; on the card a bf16 product
with an f32 output (cuBLAS accumulates in f32).  A plain bf16 product
would round its output to bf16 first, which changes the statistics and,
for ``dx``, brings back the biased rounding ``mxsr`` removes.

The storage dtype is bf16, or f32 (``mx_chain(..., storage=float32)``):
the JAX package's f32-storage K-max region, an opt-in of its f32 path
(``PRIFIT_MAX_REGION=on``), the same hand backward with f32 values
everywhere and no rounding.

Under data parallelism (``group``, the data axis's process group) a
region computes the statistics of the GLOBAL batch, as the JAX package's
regions do under its partitioner: the forward sums each batch norm's
moments over the group, the backward sums ``dbias`` and ``dscale`` over
it before forming the input cotangent (the returned parameter gradients
stay this rank's share), and the row count is global.  The rounding bits
are those of the global tensors: a shard's flat indices start at its
rank times its element count (the shards are equal and contiguous).
"""

import torch
from torch.profiler import record_function

from prifit_torch.kernels import max_bwd
from prifit_torch.kernels.stochastic_round import hash_bits16, sr_bf16
from prifit_torch.parallel.collectives import all_reduce_, group_rank, \
    group_size

MX = "mx"
MXSR = "mxsr"
MXDT = torch.bfloat16
_EPS = 1e-5
_MASK32 = 0xFFFFFFFF

__all__ = ["MX", "MXSR", "bf16_affine", "fold_in", "hash_bits16",
           "mm_f32", "mx_chain", "sr_bf16", "threefry_2x32"]


# ------------------------------------------------------------- key helpers

def _rotl(x: int, d: int) -> int:
    return ((x << d) | (x >> (32 - d))) & _MASK32


def threefry_2x32(key, data):
    """Threefry-2x32 (20 rounds) of the two words ``data`` under ``key``,
    as ``jax.random``'s default generator computes it; all values are
    uint32 as Python ints."""
    k0, k1 = int(key[0]) & _MASK32, int(key[1]) & _MASK32
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0 = (int(data[0]) + ks[0]) & _MASK32
    x1 = (int(data[1]) + ks[1]) & _MASK32
    for i in range(5):
        for r in rotations[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK32
    return x0, x1


def fold_in(key, data: int):
    """``jax.random.fold_in(key, data)`` for a key of two uint32 words."""
    return threefry_2x32(key, (0, int(data) & _MASK32))


def _fold(key, data):
    return None if key is None else fold_in(key, data)


# ------------------------------------------------------------ arithmetic

def bf16_affine(x, a, c, sdt=MXDT) -> torch.Tensor:
    """``x * a + c`` rounded once to bf16: the f32 product of bf16 values
    is exact, so the only roundings are the f32 add and the cast.  With
    ``sdt`` f32 (f32 storage) the cast is a no-op."""
    return (x.float() * a.float() + c.float()).to(sdt)


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with an f32 result, summed in f32 (see the module
    docstring)."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _stats(x32: torch.Tensor, group):
    """Batch mean and ``max(E[x^2] - E[x]^2, 0)`` over the rows of every
    rank of ``group``, f32; and the global row count as an f32 tensor."""
    size = group_size(group)
    n_t = torch.full((), x32.shape[0] * size, dtype=torch.float32,
                     device=x32.device)
    if size > 1:
        s = all_reduce_(torch.stack([x32.sum(0), (x32 * x32).sum(0)]), group)
        mean = s[0] / n_t
        var = torch.clamp_min(s[1] / n_t - mean * mean, 0.0)
    else:
        mean = x32.sum(0) / n_t
        var = torch.clamp_min((x32 * x32).sum(0) / n_t - mean * mean, 0.0)
    return mean, var, n_t


def _global(t: torch.Tensor, shard) -> torch.Tensor:
    """``t`` summed over the data group of ``shard = (group, rank)`` (a
    copy; ``t`` itself when there is no group)."""
    if shard is None or group_size(shard[0]) == 1:
        return t
    return all_reduce_(t.clone(), shard[0])


def _offset(shard, t: torch.Tensor) -> int:
    """The global flat index of ``t``'s first element on this shard."""
    return 0 if shard is None else shard[1] * t.numel()


def _sr(key, x: torch.Tensor, shard) -> torch.Tensor:
    """``sr_bf16`` of ``x`` with the bits of its place in the global
    tensor."""
    return sr_bf16(key, x, _offset(shard, x))


# ---------------------------------------------------------------- layers

def _bn_affine(mean, var, scale, bias, sdt=MXDT):
    """``(a, c, inv)``: the BN affine ``y = a x + c`` of f32 stats, in the
    storage dtype ``sdt``."""
    inv = torch.rsqrt(var + _EPS)
    a = (scale * inv).to(sdt)
    c = (bias - mean * scale * inv).to(sdt)
    return a, c, inv


def _layer_fwd(xf, w, b, scale, bias, sdt=MXDT, group=None):
    """One dense + BN + relu layer on ``sdt`` storage (``_layer_fwd`` in
    the JAX package).  ``xf [n, Fi]`` in ``sdt``, ``w [Fo, Fi]`` (torch
    layout).  Statistics reduce over the UNROUNDED f32 product (over the
    ranks of ``group``); the dense bias only shifts the reported running
    mean (BN's mean subtraction cancels it).  Returns ``(y [n, Fo],
    (mean, var), residual)``."""
    z32 = mm_f32(xf, w.to(sdt).t())
    mean_z, var, n_t = _stats(z32, group)
    a, c, inv = _bn_affine(mean_z, var, scale, bias, sdt)
    z = z32.to(sdt)
    del z32
    y = torch.relu(bf16_affine(z, a, c, sdt))
    res_bn = (z, a, c, scale, mean_z, inv, n_t)
    return y, (mean_z + b.float(), var), (xf, w, res_bn)


def _prebn_fwd(xf, scale, bias, sdt=MXDT, group=None):
    """BN + relu on an externally computed pre-activation ``xf [n, F]``
    (the grouped first layer's); only ``xf`` is kept."""
    mean, var, n_t = _stats(xf.float(), group)
    a, c, inv = _bn_affine(mean, var, scale, bias, sdt)
    y = torch.relu(bf16_affine(xf, a, c, sdt))
    return y, (mean, var), (xf, a, c, scale, mean, inv, n_t)


def _prebn_bwd(res, g, shard=None):
    """Batch-norm + relu backward from stored residuals; ``g`` f32 or
    bf16, ``dx`` f32.  ``dbias``/``dscale`` enter ``dx`` summed over the
    data group of ``shard``.  Returns ``(dx, (dscale, dbias))``, this
    rank's share of the parameter gradients."""
    xf, a, c, scale, mean, inv, n = res
    y = bf16_affine(xf, a, c, a.dtype)   # the relu's sign, recomputed
    gb = torch.where(y > 0, g, torch.zeros((), dtype=g.dtype,
                                           device=g.device)).float()
    xhat = (xf.float() - mean) * inv
    dbias = gb.sum(0)
    dscale = (gb * xhat).sum(0)
    dbias_g, dscale_g = _global(torch.stack([dbias, dscale]), shard)
    dxhat = gb * scale
    dx = inv * (dxhat - dbias_g * scale / n - xhat * (dscale_g * scale / n))
    return dx, (dscale, dbias)


def _max_bwd_core(res_bn, g_rows, out_bf, zsel, sr_key, shard=None):
    """The closed-form BN + relu + K-max backward at ``[rows, F]``
    granularity (the K-max ties all share ``zsel`` exactly): kernels #7
    and #8 with the per-feature reductions between them (summed over the
    data group of ``shard``).  Returns ``(dz [n, F]`` -- already rounded
    to bf16 under ``sr_key`` --, ``(dscale, dbias))``, this rank's share
    of the parameter gradients."""
    z, a, c, scale, mean, inv, n = res_bn
    cnt, gsm = max_bwd.cnt_gsm(z, zsel, g_rows, out_bf, _fold(sr_key, 255),
                               _offset(shard, zsel))
    gsm32 = gsm.float()
    xhat_sel = (zsel.float() - mean) * inv
    dbias = (gsm32 * cnt).sum(0)
    dscale = (gsm32 * cnt * xhat_sel).sum(0)
    dbias_g, dscale_g = _global(torch.stack([dbias, dscale]), shard)
    c1 = inv * scale * dbias_g / n
    c2 = inv * inv * scale * dscale_g / n
    dz = max_bwd.dz(z, zsel, gsm, (inv * scale).contiguous(), c1, mean, c2,
                    _fold(sr_key, 0), _offset(shard, z))
    return dz, (dscale, dbias)


def _layer_bwd(res, g, sr_key=None, sr_out=True, max_ctx=None, shard=None):
    """Transpose of :func:`_layer_fwd`.  ``g [n, Fo]`` f32 (mx) or bf16
    (mxsr).  With ``sr_key`` the cotangents ``dz`` and (unless
    ``sr_out`` is False) ``dx`` are rounded to bf16 stochastically; every
    reduction stays f32.  ``max_ctx = (g_rows, out_bf, zsel)`` marks the
    K-max layer, whose backward is :func:`_max_bwd_core` (``g`` unused).
    Returns ``(dx [n, Fi], (dw [Fo, Fi], db, dscale, dbias))``; ``db`` is
    exactly 0.  ``shard``: see :func:`_prebn_bwd`."""
    xf, w, res_bn = res
    if max_ctx is not None:
        dz, (dscale, dbias) = _max_bwd_core(res_bn, *max_ctx, sr_key=sr_key,
                                            shard=shard)
    else:
        dz, (dscale, dbias) = _prebn_bwd(res_bn, g, shard)
        if sr_key is not None:
            dz = _sr(fold_in(sr_key, 0), dz, shard)
    if sr_key is not None:
        # bf16 values in dz's dtype: bf16 for the real rounding; f32 when a
        # test replaces the rounding with the identity (the expectation)
        x_in, w_in = xf.to(dz.dtype), w.to(MXDT).to(dz.dtype)
    else:
        x_in, w_in = xf.float(), w.float()
    dx = mm_f32(dz, w_in)
    if sr_key is not None and sr_out:
        dx = _sr(fold_in(sr_key, 1), dx, shard)
    dw = mm_f32(dz.t(), x_in)
    return dx, (dw, w.new_zeros(w.shape[0]), dscale, dbias)


# ---------------------------------------------------------------- region

def _mx_impl(cfg, pre, pre_bn, chain, group=None):
    """The region's forward: ``(out, stats, (residuals, max_res,
    shape))``."""
    has_pre_bn, has_max, sr, exit_low, sdt = cfg
    shape = pre.shape
    xf = pre.to(sdt).reshape(-1, shape[-1])
    stats, residuals = [], []
    if has_pre_bn:
        xf, st, res = _prebn_fwd(xf, *pre_bn, sdt, group)
        stats.append(st)
        residuals.append(res)
    for layer in chain:
        xf, st, res = _layer_fwd(xf, *layer, sdt, group)
        stats.append(st)
        residuals.append(res)
    # mxsr regions hand bf16 stage outputs to the next stage, as the JAX
    # package does; mx and f32 storage keep f32 outputs
    out_dtype = sdt if (sr or exit_low) else torch.float32
    if has_max:
        # the K-max of relu(a z + c) is the affine of max_K z (a > 0) or
        # min_K z (a < 0), bit for bit: both maps are monotone per feature
        B, S, K = shape[0], shape[1], shape[2]
        z_last, a_last, c_last = (residuals[-1][2] if chain
                                  else residuals[-1])[:3]
        zk = z_last.view(B * S, K, -1)
        zsel = torch.where(a_last > 0, zk.amax(1), zk.amin(1))
        out_bf = torch.relu(bf16_affine(zsel, a_last, c_last, sdt))
        out = out_bf.to(out_dtype).reshape(B, S, -1)
        max_res = (out_bf, zsel)
    else:
        out = xf.to(out_dtype).reshape(*shape[:-1], xf.shape[-1])
        max_res = None
    return out, stats, (residuals, max_res, shape)


class _MxChain(torch.autograd.Function):
    """The region with its hand-derived backward (``_mx_chain``'s custom
    VJP in the JAX package).  Inputs: ``cfg = (has_pre_bn, has_max, sr,
    exit_low, storage dtype)``, the key, ``shard`` (``(data group, rank)``
    or None), ``pre`` and the flat parameters; outputs: ``out`` and the
    flat (mean, var) statistics, which take no gradient."""

    @staticmethod
    def forward(ctx, cfg, key, shard, pre, *flat):
        has_pre_bn = cfg[0]
        pre_bn = flat[:2] if has_pre_bn else None
        rest = flat[2:] if has_pre_bn else flat
        chain = [rest[i:i + 4] for i in range(0, len(rest), 4)]
        out, stats, res = _mx_impl(cfg, pre, pre_bn, chain,
                                   None if shard is None else shard[0])
        # residuals live on ctx and are dropped at the start of backward
        ctx.cfg, ctx.key, ctx.shard, ctx.res = cfg, key, shard, res
        stats = [t for st in stats for t in st]
        ctx.mark_non_differentiable(*stats)
        return (out, *stats)

    @staticmethod
    def backward(ctx, g_out, *_stats_grads):
        # the encoder regions' backward on the profiler's timeline
        # (read by the benchmark's bwd_regions_ms)
        with record_function("bwd.regions"):
            has_pre_bn, has_max, sr, exit_low, _ = ctx.cfg
            key, shard = ctx.key, ctx.shard
            (residuals, max_res, shape) = ctx.res
            del ctx.res
            layers = residuals[1 if has_pre_bn else 0:]
            max_ctx, g = None, None
            if has_max:
                out_bf, zsel = max_res
                max_ctx = (g_out.reshape(out_bf.shape).contiguous(), out_bf,
                           zsel)
            else:
                g = g_out.reshape(-1, g_out.shape[-1]).float().contiguous()
                if sr:
                    g = _sr(fold_in(key, 255), g, shard)
            d_chain = []
            for j, res in enumerate(reversed(layers)):
                at_exit = j == len(layers) - 1 and not has_pre_bn
                g, grads = _layer_bwd(
                    res, g, sr_key=fold_in(key, j) if sr else None,
                    sr_out=not at_exit or exit_low,
                    max_ctx=max_ctx if j == 0 else None, shard=shard)
                d_chain.append(grads)
            d_chain.reverse()
            d_pre_bn = ()
            if has_pre_bn:
                if has_max and not layers:
                    # max right over the pre-BN output: dz is dx, already final
                    g, (dscale, dbias) = _max_bwd_core(
                        residuals[0], *max_ctx,
                        sr_key=fold_in(key, 254) if sr else None, shard=shard)
                else:
                    g, (dscale, dbias) = _prebn_bwd(residuals[0], g, shard)
                if sr and exit_low and g.dtype != MXDT:
                    g = _sr(fold_in(key, 254), g, shard)
                d_pre_bn = (dscale, dbias)
            dpre = g.to(MXDT if exit_low else torch.float32).reshape(shape)
            return (None, None, None, dpre, *d_pre_bn,
                    *(t for grads in d_chain for t in grads))


def mx_chain(cfg, pre, params, key=None, storage=MXDT, group=None):
    """The storage-dtype chain region with a hand-derived backward.

    ``cfg = (has_pre_bn, has_max[, sr])``; ``pre`` the region input
    (``[B, S, K, F]`` grouped pre-activation with ``has_max``, else
    ``[..., F]``); ``params = (pre_bn, ((w, b, scale, bias), ...))`` with
    ``pre_bn = (scale, bias)`` or None and ``w [Fo, Fi]``; ``key`` the SR
    key (two uint32 words), required when ``sr``.  ``storage``: bf16 (the
    ``mx``/``mxsr`` modes) or f32 (the f32-storage K-max region; ``sr``
    implies bf16).  A ``pre`` in bf16 storage makes the region's input
    cotangent bf16 too (stochastically rounded under ``sr``).  ``group``:
    the data-parallel process group (module docstring).  Returns ``(out,
    ((mean, var), ...))``: one pair of batch statistics per batch norm
    (global under ``group``), for the running-stat update."""
    has_pre_bn, has_max = cfg[0], cfg[1]
    sr = len(cfg) > 2 and bool(cfg[2])
    if sr and key is None:
        raise ValueError("mx_chain: sr mode needs an rng key")
    if sr and storage != MXDT:
        raise ValueError("mx_chain: sr implies bf16 storage")
    if has_max and not has_pre_bn and not params[1]:
        raise ValueError("mx_chain: has_max needs a BN or layer")
    pre_bn, chain = params
    flat = ([*pre_bn] if has_pre_bn else []) + [t for layer in chain
                                               for t in layer]
    exit_low = storage != torch.float32 and pre.dtype == storage
    cfg5 = (bool(has_pre_bn), bool(has_max), sr, exit_low, storage)
    shard = None if group_size(group) == 1 else (group, group_rank(group))
    out, *stats = _MxChain.apply(cfg5, key, shard, pre, *flat)
    return out, tuple(zip(stats[0::2], stats[1::2]))
