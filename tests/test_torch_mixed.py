"""The port's mixed-precision training region (``prifit_torch/nn/mixed.py``
and the K-max backward kernels' plain versions) against the JAX package's
``nn/mixed.py`` on the CPU, and the ``mxsr`` train step against the JAX
model's.

Both sides get the same inputs (made with numpy from a seed) and the same
key words.  On the CPU the JAX package runs the jnp branch of
``_max_bwd_core``; its Pallas kernels are run in interpret mode.

Two facts set what can be bit-equal.  XLA's CPU compiler contracts
``a * b - c`` into a fused multiply-add, while PyTorch rounds the product
first (as the CUDA kernels do, on purpose); and f32 sums come out in
another order.  Both vanish where every product and sum is exact, so the
tests that demand equal bits use dyadic inputs (small multiples of powers
of two, with power-of-two tie counts); Gaussian inputs get the stated
tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import prifit_torch.nn.pointnet2 as tpn2
import prifit_tpu.nn.pointnet2 as jpn2
from prifit_torch.convert import params_from_jax, state_dict_from_jax
from prifit_torch.kernels import max_bwd as KM
from prifit_torch.kernels import stochastic_round
from prifit_torch.models.pointnet2_part_seg_msg import get_loss, get_model
from prifit_torch.nn import mixed as M
from prifit_torch.train.state import create_train_state
from prifit_torch.train.steps import make_selfsup_step, make_supervised_step
from prifit_tpu.models import get_module
from prifit_tpu.nn import mixed as JM
from prifit_tpu.ops.pallas.max_bwd import cnt_gsm_pallas, dz_pallas
from test_torch_train import XYZ_GAIN, _zero_grad_bias

torch.set_num_threads(1)

KEY = (0x1234ABCD, 0x9E3779B9)


def _jkey(key):
    return jnp.asarray(key, jnp.uint32)


def _bits(t):
    """Bit patterns of a torch tensor or JAX array (bf16 or f32)."""
    if isinstance(t, torch.Tensor):
        t = t.contiguous()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16
                else t.view(torch.int32)).numpy()
    return np.asarray(jax.lax.bitcast_convert_type(
        t, jnp.int16 if t.dtype == jnp.bfloat16 else jnp.int32))


def _t(a):
    """A JAX array as a torch tensor of the same dtype (bf16 or f32)."""
    bf = a.dtype == jnp.bfloat16
    out = torch.from_numpy(np.array(a.astype(jnp.float32)))
    return out.bfloat16() if bf else out


# ------------------------------------------------------------- the bits

@pytest.mark.parametrize("key", [(0, 0), (1, 2), (0xFFFFFFFF, 123456789),
                                 (42, 0x80000000)])
def test_fold_in_matches_jax(key):
    for d in (0, 1, 2, 254, 255, 256, 123456, 0xFFFFFFFF):
        ref = np.asarray(jax.random.fold_in(_jkey(key), d)).tolist()
        assert list(M.fold_in(key, d)) == ref, (key, d)
    ref = np.asarray(jax.random.fold_in(
        jax.random.fold_in(_jkey(key), 3), 255)).tolist()
    assert list(M.fold_in(M.fold_in(key, 3), 255)) == ref


@pytest.mark.parametrize("shape", [(1000,), (37, 24), (5, 16, 64),
                                   (2, 3, 8, 24), (3, 2, 5, 64)])
def test_hash_and_sr_bits_match_jax(shape):
    """``hash_bits16`` and ``sr_bf16`` bit for bit, with negative values,
    values that bf16 represents exactly (which never move) and zeros."""
    rng = np.random.default_rng(len(shape))
    x = (rng.normal(size=shape) * 3).astype(np.float32)
    flat = x.reshape(-1)
    flat[::7] = np.asarray(jnp.asarray(flat[::7]).astype(jnp.bfloat16)
                           .astype(jnp.float32))
    flat[::11] = 0.0
    for key in (KEY, (0, 0), (0xFFFFFFFF, 0xFFFFFFFF)):
        ref = np.asarray(JM._hash_bits16(_jkey(key), shape)).astype(np.int64)
        np.testing.assert_array_equal(M.hash_bits16(key, shape).numpy(), ref)
        got = M.sr_bf16(key, torch.from_numpy(x))
        assert got.dtype == torch.bfloat16 and got.shape == shape
        np.testing.assert_array_equal(
            _bits(got), _bits(JM.sr_bf16(_jkey(key), jnp.asarray(x))))
        exact = flat[::7]
        np.testing.assert_array_equal(got.float().numpy().reshape(-1)[::7],
                                      exact)


# --------------------------------------------------- the K-max backward

def _max_inputs(rng, rows, K, F, dyadic, sr):
    """bf16 ``z [rows*K, F]`` with planted K-max ties and the region's
    residuals.  Dyadic: z on a 1/4 grid, every tie count 1, 2, 4 or 8,
    g on a 1/2 grid, power-of-two inv and scale, so that every product
    and sum of the closed form is exact in f32."""
    a_sign = np.where(rng.random(F) < 0.5, -1.0, 1.0).astype(np.float32)
    if dyadic:
        # K distinct grid values per (row, feature)
        grid = np.arange(-16, 17, dtype=np.float32) / 4
        pick = rng.random((rows, len(grid), F)).argsort(1)[:, :K]
        z = grid[pick]
        g = rng.integers(-4, 5, size=(rows, F)).astype(np.float32) / 2
        inv = 2.0 ** rng.integers(-1, 2, size=F).astype(np.float32)
        scale = 2.0 ** rng.integers(-1, 2, size=F).astype(np.float32)
        mean = rng.integers(-4, 5, size=F).astype(np.float32) / 4
    else:
        z = rng.normal(size=(rows, K, F)).astype(np.float32)
        g = rng.normal(size=(rows, F)).astype(np.float32)
        inv = rng.uniform(0.5, 2.0, F).astype(np.float32)
        scale = rng.uniform(0.5, 1.5, F).astype(np.float32)
        mean = (rng.normal(size=F) * 0.1).astype(np.float32)
    z = np.array(jnp.asarray(z).astype(jnp.bfloat16).astype(jnp.float32))
    # plant ties: per (row, feature), 0, 1, 3 or 7 other neighbours (in
    # random order, the extreme one excluded) take the extreme value
    zsel = np.where(a_sign > 0, z.max(1), z.min(1))
    at = np.where(a_sign > 0, z.argmax(1), z.argmin(1))
    order = rng.random(z.shape)
    np.put_along_axis(order, at[:, None, :], 2.0, axis=1)
    rank = order.argsort(1).argsort(1)
    n_ties = rng.choice([1, 2, 4, 8], size=(rows, 1, F))
    z = np.where(rank < n_ties - 1, zsel[:, None, :], z)
    a = jnp.asarray(a_sign * rng.uniform(0.5, 1.0, F).astype(np.float32))
    c = jnp.asarray((rng.normal(size=F) * 0.5).astype(np.float32))
    zb = jnp.asarray(z.reshape(-1, F)).astype(jnp.bfloat16)
    zselb = jnp.asarray(zsel).astype(jnp.bfloat16)
    ab, cb = a.astype(jnp.bfloat16), c.astype(jnp.bfloat16)
    out_bf = jax.nn.relu(JM.bf16_affine(zselb, ab, cb))
    gj = jnp.asarray(g).astype(jnp.bfloat16 if sr else jnp.float32)
    res = (zb, ab, cb, jnp.asarray(scale), jnp.asarray(mean),
           jnp.asarray(inv), jnp.asarray(rows * K, jnp.float32))
    return res, gj, out_bf, zselb


@pytest.mark.parametrize("sr", [False, True], ids=["mx", "mxsr"])
@pytest.mark.parametrize("F", [24, 64])
def test_max_bwd_core_matches_jax_bit_exact(F, sr):
    """Dyadic inputs: the port's ``_max_bwd_core`` (its plain kernels on
    the CPU) against the jnp branch of JAX's, bit for bit: dz and the
    (dscale, dbias) reductions; cnt and gsm against the interpret-mode
    ``cnt_gsm_pallas``."""
    rng = np.random.default_rng(F + sr)
    res, g, out_bf, zsel = _max_inputs(rng, 64, 16, F, True, sr)
    jkey = _jkey(KEY) if sr else None
    jdz, (jds, jdb) = JM._max_bwd_core(res, g, out_bf, zsel, jkey)
    tres = tuple(_t(r) for r in res[:6]) + (torch.tensor(64.0 * 16),)
    tdz, (tds, tdb) = M._max_bwd_core(tres, _t(g), _t(out_bf), _t(zsel),
                                      KEY if sr else None)
    assert tdz.dtype == (torch.bfloat16 if sr else torch.float32)
    np.testing.assert_array_equal(_bits(tdz), _bits(jdz))
    np.testing.assert_array_equal(_bits(tds), _bits(jds))
    np.testing.assert_array_equal(_bits(tdb), _bits(jdb))
    pc, pg = cnt_gsm_pallas(res[0], zsel, g, out_bf,
                            jax.random.fold_in(jkey, 255) if sr else None,
                            sr, interpret=True)
    tc, tg = KM.cnt_gsm_plain(_t(res[0]), _t(zsel), _t(g), _t(out_bf),
                              M.fold_in(KEY, 255) if sr else None)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(pc))
    assert set(np.unique(tc.numpy())) == {1.0, 2.0, 4.0, 8.0}
    np.testing.assert_array_equal(_bits(tg), _bits(pg))


@pytest.mark.parametrize("sr", [False, True], ids=["mx", "mxsr"])
def test_max_bwd_plain_matches_pallas_interpret(sr):
    """Gaussian inputs with planted ties: cnt and gsm bit-equal to
    ``cnt_gsm_pallas(interpret=True)``; dz against ``dz_pallas`` on the
    same constants, where XLA's fused multiply-adds move the f32 value by
    about an ulp of the largest term: within 2^-21 of the largest |dz|
    in f32, and in bf16 at most one bf16 step apart on under 1% of the
    elements (a moved value crosses a rounding carry rarely)."""
    rng = np.random.default_rng(7)
    rows, K, F = 32, 16, 64
    res, g, out_bf, zsel = _max_inputs(rng, rows, K, F, False, sr)
    k255 = jax.random.fold_in(_jkey(KEY), 255) if sr else None
    pc, pg = cnt_gsm_pallas(res[0], zsel, g, out_bf, k255, sr,
                            interpret=True)
    tc, tg = KM.cnt_gsm_plain(_t(res[0]), _t(zsel), _t(g), _t(out_bf),
                              M.fold_in(KEY, 255) if sr else None)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(pc))
    assert (tc.numpy() > 1).mean() > 0.5
    np.testing.assert_array_equal(_bits(tg), _bits(pg))
    vec = [np.array(v) for v in (res[5] * res[3], res[4])]
    c1 = (rng.normal(size=F) * 1e-2).astype(np.float32)
    c2 = (rng.normal(size=F) * 1e-2).astype(np.float32)
    pdz = dz_pallas(res[0], zsel, pg, jnp.asarray(vec[0]), jnp.asarray(c1),
                    jnp.asarray(vec[1]), jnp.asarray(c2),
                    jax.random.fold_in(_jkey(KEY), 0) if sr else None, sr,
                    interpret=True)
    tdz = KM.dz_plain(_t(res[0]), _t(zsel), tg, torch.from_numpy(vec[0]),
                      torch.from_numpy(c1), torch.from_numpy(vec[1]),
                      torch.from_numpy(c2), M.fold_in(KEY, 0) if sr else None)
    a, b = tdz.float().numpy(), np.asarray(pdz.astype(jnp.float32))
    if not sr:
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=2.0 ** -21 * np.abs(b).max())
        return
    step = np.abs(b) * 2.0 ** -7 + 1e-30
    assert np.all(np.abs(a - b) <= step)
    assert np.mean(a != b) < 1e-2


# ---------------------------------------------------------- the region

def _chain_inputs(rng, cfg, dyadic, B=2, S=8, K=16, F=24, dims=(24, 32, 48)):
    """``pre``, ``(pre_bn, chain)`` with JAX-layout weights ``[Fi, Fo]``,
    and an output cotangent.  Dyadic: ``pre`` in [-2, 2] and the weights
    in [-1, 1], both on a 1/2 grid, so that the first batch norm's sums
    are exact in f32 in any order (z on a 1/4 grid, |z| <= 48, and the
    sum of 256 z^2 under 2^24 sixteenths)."""
    has_pre_bn, has_max = cfg
    shape = (B, S, K, F) if has_max else (B, S * K, F)
    if dyadic:
        pre = rng.integers(-4, 5, size=shape).astype(np.float32) / 2
    else:
        pre = rng.normal(size=shape).astype(np.float32)
    chain = []
    for fi, fo in zip(dims[:-1], dims[1:]):
        w = (rng.integers(-2, 3, size=(fi, fo)).astype(np.float32) / 2
             if dyadic else
             (rng.normal(size=(fi, fo)) / np.sqrt(fi)).astype(np.float32))
        chain.append((w, (rng.normal(size=fo) * 0.1).astype(np.float32),
                      rng.uniform(0.5, 1.5, fo).astype(np.float32),
                      (rng.normal(size=fo) * 0.1).astype(np.float32)))
    pre_bn = ((rng.uniform(0.5, 1.5, F).astype(np.float32),
               (rng.normal(size=F) * 0.1).astype(np.float32))
              if has_pre_bn else None)
    out_shape = (shape[:2] if has_max else shape[:-1]) + (dims[-1],)
    g = rng.normal(size=out_shape).astype(np.float32)
    return pre, (pre_bn, chain), g


def _jax_chain(cfg, sr, pre, params, g, key):
    pre_bn, chain = params
    jparams = (None if pre_bn is None else tuple(map(jnp.asarray, pre_bn)),
               tuple(tuple(map(jnp.asarray, layer)) for layer in chain))

    def f(p, pr):
        out, stats = JM.mx_chain((*cfg, sr), pr, p, key=key)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(g)), (out, stats)

    (_, (out, stats)), (gp, gpre) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jparams, jnp.asarray(pre))
    grads = {"pre": np.asarray(gpre)}
    if pre_bn is not None:
        grads["pre_scale"], grads["pre_bias"] = map(np.asarray, gp[0])
    for i, layer in enumerate(gp[1]):
        for name, v in zip(("w", "b", "scale", "bias"), layer):
            grads[f"{name}{i}"] = np.asarray(v)
    return out, stats, grads


def _port_chain(cfg, sr, pre, params, g, key):
    pre_bn, chain = params
    leaves = {"pre": torch.tensor(pre, requires_grad=True)}
    if pre_bn is not None:
        leaves["pre_scale"] = torch.tensor(pre_bn[0], requires_grad=True)
        leaves["pre_bias"] = torch.tensor(pre_bn[1], requires_grad=True)
    tchain = []
    for i, (w, b, s, bb) in enumerate(chain):
        for name, v in (("w", w.T.copy()), ("b", b), ("scale", s),
                        ("bias", bb)):
            leaves[f"{name}{i}"] = torch.tensor(v, requires_grad=True)
        tchain.append(tuple(leaves[f"{n}{i}"] for n in ("w", "b", "scale",
                                                         "bias")))
    tpre_bn = ((leaves["pre_scale"], leaves["pre_bias"])
               if pre_bn is not None else None)
    out, stats = M.mx_chain((*cfg, sr), leaves["pre"], (tpre_bn, tchain),
                            key)
    (out.float() * torch.from_numpy(g)).sum().backward()
    grads = {k: v.grad.numpy() for k, v in leaves.items()}
    for i in range(len(chain)):
        grads[f"w{i}"] = grads[f"w{i}"].T
    return out, stats, grads


CONFIGS = [(True, True), (False, True), (False, False)]


def _dense_bias(name):
    """``b0``, ``b1``, ...: the dense biases, whose gradient is exactly 0
    (BN's mean subtraction cancels them)."""
    return name[0] == "b" and name[1:].isdigit()


@pytest.mark.parametrize("dyadic", [True, False], ids=["dyadic", "gauss"])
@pytest.mark.parametrize("sr", [False, True], ids=["mx", "mxsr"])
@pytest.mark.parametrize("cfg", CONFIGS,
                         ids=["prebn_max", "max", "chain"])
def test_mx_chain_matches_jax(cfg, sr, dyadic):
    """``mx_chain`` forward and backward against JAX's with the same key,
    for the three configurations the model uses (SA scale, group-all SA,
    FP) in ``mx`` and ``mxsr``.

    The output is bit-equal (each z is rounded to bf16 before the affine,
    which absorbs the f32 sum order).  With dyadic inputs the first batch
    norm's statistics are bit-equal too (exact sums); later ones, and all
    of them on Gaussian inputs, within 2^-17 of the largest statistic
    (f32 sums of 256 rows in another order, and the cancellation in
    E[z^2] - E[z]^2; measured at most 1.5e-6).  Every gradient is within
    1e-5 of its norm in ``mx`` (measured at most 4.6e-7) and 1e-3 in
    ``mxsr``, where an f32 value that moved by an ulp can move a
    stochastic-rounding carry by one bf16 step, and the moved step feeds
    every layer below (measured at most 2.9e-4, in the SA-scale region's
    pre-BN gradients; a draw under another key is 4e-3 to 1.2e-2 away, so
    a wrong key or fold fails).  The dense biases' gradients are exactly
    0 on both sides."""
    rng = np.random.default_rng(CONFIGS.index(cfg) * 4 + sr * 2 + dyadic)
    pre, params, g = _chain_inputs(rng, cfg, dyadic)
    key = KEY if sr else None
    jout, jstats, jgrads = _jax_chain(cfg, sr, pre, params, g,
                                      _jkey(KEY) if sr else None)
    out, stats, grads = _port_chain(cfg, sr, pre, params, g, key)
    assert out.dtype == (torch.bfloat16 if sr else torch.float32)
    np.testing.assert_array_equal(_bits(out), _bits(jout))
    assert len(stats) == len(jstats)
    for i, (st, jst) in enumerate(zip(stats, jstats)):
        for a, b in zip(st, jst):
            if dyadic and i == 0:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            else:
                b = np.asarray(b)
                np.testing.assert_allclose(
                    a.numpy(), b, rtol=0, atol=2.0 ** -17 * np.abs(b).max())
    tol = 1e-3 if sr else 1e-5
    for name, ref in jgrads.items():
        got = grads[name]
        if _dense_bias(name):
            assert not got.any() and not ref.any(), name
            continue
        err = np.linalg.norm(got - ref) / np.linalg.norm(ref)
        assert err <= tol, (name, err)


def test_bf16_pre_gives_bf16_exit_cotangent():
    """A bf16 region input (the ``mxsr`` boundary): the input cotangent
    is bf16, SR'd with fold 254 as JAX's is: bit-equal on all but a few
    elements, and those one bf16 step apart (an f32 value that moved by
    an ulp in the layers above moves a carry; measured on 0.07% of the
    elements)."""
    rng = np.random.default_rng(3)
    pre, params, g = _chain_inputs(rng, (True, True), True)
    pre_bf = np.array(jnp.asarray(pre).astype(jnp.bfloat16)
                      .astype(jnp.float32))
    pre_bn, chain = params
    jparams = (tuple(map(jnp.asarray, pre_bn)),
               tuple(tuple(map(jnp.asarray, layer)) for layer in chain))
    jgrad = jax.grad(lambda pr: jnp.sum(JM.mx_chain(
        (True, True, True), pr, jparams, key=_jkey(KEY))[0]
        .astype(jnp.float32) * jnp.asarray(g)))(
            jnp.asarray(pre_bf).astype(jnp.bfloat16))
    tpre = torch.from_numpy(pre_bf).bfloat16().requires_grad_()
    tparams = ((torch.from_numpy(pre_bn[0]), torch.from_numpy(pre_bn[1])),
               [(torch.from_numpy(w.T.copy()), *map(torch.from_numpy, r))
                for w, *r in chain])
    out, _ = M.mx_chain((True, True, True), tpre, tparams, KEY)
    (out.float() * torch.from_numpy(g)).sum().backward()
    assert tpre.grad.dtype == torch.bfloat16
    a = tpre.grad.float().numpy()
    b = np.asarray(jgrad.astype(jnp.float32))
    moved = _bits(tpre.grad) != _bits(jgrad)
    assert moved.mean() < 1e-2
    assert np.all(np.abs(a - b) <= 2.0 ** -7 * np.abs(b))


def test_sr_needs_a_key():
    pre = torch.ones((2, 8, 4))
    layer = (torch.ones(8, 4), torch.zeros(8), torch.ones(8), torch.zeros(8))
    with pytest.raises(ValueError, match="rng key"):
        M.mx_chain((False, False, True), pre, (None, [layer]))


def test_sr_expectation_matches_jax_and_draws_are_unbiased(monkeypatch):
    """With ``sr_bf16`` replaced by the identity on both sides, the region's
    backward computes the expectation of the ``mxsr`` gradients (it is
    linear in the cotangents): the port's matches JAX's within 1e-5 of
    each norm (f32 sums in another order).  The mean of 24 draws with
    other keys tightens toward it (under 0.45 of one draw's error: an
    unbiased cast's mean shrinks like 1/sqrt(24) = 0.2), as
    ``tests/test_mixed.py::test_grads_unbiased`` checks for JAX."""
    rng = np.random.default_rng(11)
    cfg = (True, True)
    pre, params, g = _chain_inputs(rng, cfg, False)
    monkeypatch.setattr(JM, "sr_bf16", lambda k, x: x)
    _, _, jexp = _jax_chain(cfg, True, pre, params, g, _jkey(KEY))
    monkeypatch.setattr(stochastic_round, "sr_bf16_plain",
                        lambda k, x, *a: x)
    _, _, texp = _port_chain(cfg, True, pre, params, g, KEY)
    monkeypatch.undo()
    for name, ref in jexp.items():
        if _dense_bias(name):
            continue
        err = np.linalg.norm(texp[name] - ref) / np.linalg.norm(ref)
        assert err <= 1e-5, (name, err)
    draws = [_port_chain(cfg, True, pre, params, g, (100 + s, 7))[2]
             for s in range(24)]
    for name, ref in texp.items():
        if _dense_bias(name):
            continue
        one = np.linalg.norm(draws[0][name] - ref)
        if one < 1e-7 * np.linalg.norm(ref):
            continue
        mean = np.mean([d[name] for d in draws], axis=0)
        assert np.linalg.norm(mean - ref) < 0.45 * one, name


# ----------------------------------------------------------- the model

B, N, PARTS = 2, 512, 50
BASE = (12345, 0xCAFEBABE)
SS_KW = dict(quantile=0.05, msc_iterations=1, max_num_clusters=6,
             n_per_prim=32, num_bandwidth_candidates=2)
DELTA = 2.0 ** -20


def test_region_keys_follow_forward_call_order(monkeypatch):
    """The nine regions of an ``mxsr`` training forward get
    ``fold_in(base, i)`` in call order (sa1 scales, sa2 scales, sa3, fp3,
    fp2, fp1); in ``mx`` they get no key; without a key or a generator
    ``mxsr`` training raises."""
    calls = []
    real = tpn2.mx_chain

    def record(cfg, pre, params, key=None, **k):
        calls.append((cfg[:2], pre.dtype, key))
        return real(cfg, pre, params, key, **k)

    monkeypatch.setattr(tpn2, "mx_chain", record)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(1, N, 3)).astype(np.float32))
    cls = torch.zeros((1, 16))
    for dtype in ("mxsr", "mx"):
        calls.clear()
        model = get_model(num_parts=PARTS, compute_dtype=dtype,
                          dropout_rate=0.0, device="cpu").train()
        model(x, cls, sr_key=BASE)
        assert [c[0] for c in calls] == [(True, True)] * 5 + [
            (False, True)] + [(False, False)] * 3
        want = ([M.fold_in(BASE, i) for i in range(9)] if dtype == "mxsr"
                else [None] * 9)
        assert [c[2] for c in calls] == want
        assert {c[1] for c in calls} == (
            {torch.bfloat16} if dtype == "mxsr" else {torch.float32})
    model = get_model(num_parts=PARTS, dropout_rate=0.0, device="cpu").train()
    with pytest.raises(ValueError, match="generator"):
        model(x, cls)


@pytest.fixture(scope="module")
def model_runs():
    """The JAX ``pointnet2_part_seg_msg`` in ``mxsr`` (dropout 0, FPS start
    pinned) under one jit: the supervised loss and gradients, and the
    self-sup loss of a forward on a 3-blob cloud; run on the data and on
    the data scaled by 1 +- 2^-20, with ``_mx_key`` patched to hand the
    regions ``fold_in(BASE, i)`` in call order, the port's scheme.  And
    the port's supervised and self-sup steps from the same weights."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PRIFIT_DET_FPS", "1")
        calls = [0]

        def mx_key(mod):
            i = calls[0]
            calls[0] += 1
            return _jkey(M.fold_in(BASE, i))

        mp.setattr(jpn2, "_mx_key", mx_key)
        rng = np.random.default_rng(21)
        x = rng.normal(size=(B, N, 3)).astype(np.float32)
        cls = np.zeros((B, 16), np.float32)
        cls[:, 2] = 1.0
        target = rng.integers(0, PARTS, size=(B, N))
        lab = np.arange(N) % 3
        blobs = np.stack([np.eye(3)[rng.permutation(lab)] * 4.0
                          + rng.normal(size=(N, 3)) * 0.3
                          for _ in range(B)]).astype(np.float32)
        mod = get_module("pointnet2_part_seg_msg")
        model = mod.get_model(num_parts=PARTS, compute_dtype="mxsr",
                              dropout_rate=0.0)
        xs = jnp.asarray(x[:, :256])
        v = jax.jit(lambda r: model.init(
            r, xs, jnp.asarray(cls), chamfer_points=xs, train=False,
            include_convex_loss=True, quantile=0.5, msc_iterations=1,
            max_num_clusters=2, n_per_prim=4))(
            {"params": jax.random.PRNGKey(0),
             "sampling": jax.random.PRNGKey(1),
             "dropout": jax.random.PRNGKey(2),
             "selfsup": jax.random.PRNGKey(3)})

        def randomize(path, a):
            if str(path[-1].key).endswith("mean"):
                return rng.normal(size=a.shape).astype(np.float32) * 0.1
            return rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32)

        params = jax.tree_util.tree_map(np.array, v["params"])
        params["fp1"]["PointMLP_0"]["w0"][16:22] *= XYZ_GAIN
        variables = {"params": params,
                     "batch_stats": jax.tree_util.tree_map_with_path(
                         randomize, v["batch_stats"])}
        rngs = {"sampling": jax.random.PRNGKey(4),
                "dropout": jax.random.PRNGKey(5),
                "selfsup": jax.random.PRNGKey(6)}
        cj = jnp.asarray(cls)

        def both(params, stats, xx, bb):
            calls[0] = 0
            out, upd = model.apply(
                {"params": params, "batch_stats": stats}, xx, cj,
                train=True, bn_momentum=0.1, rngs=rngs,
                mutable=["batch_stats"])
            loss = mod.get_loss(out.seg_logits, jnp.asarray(target))
            calls[0] = 0
            ss, _ = model.apply(
                {"params": params, "batch_stats": stats,
                 "selfsup_state": {"beta": jnp.ones((), jnp.float32)}},
                bb, cj, chamfer_points=bb, train=True, bn_momentum=0.1,
                rngs=rngs, mutable=["batch_stats", "selfsup_state"],
                include_convex_loss=True, **SS_KW)
            return loss, (upd["batch_stats"], jnp.mean(ss.total_loss),
                          ss.chamfer_loss)

        fn = jax.jit(jax.value_and_grad(both, has_aux=True))
        jax_runs = []
        for s in (1.0, 1.0 + DELTA, 1.0 - DELTA):
            (loss, (stats, ss, cham)), grads = fn(
                variables["params"], variables["batch_stats"],
                jnp.asarray(x * np.float32(s)),
                jnp.asarray(blobs * np.float32(s)))
            jax_runs.append(dict(
                loss=float(loss), ss=float(ss), cham=float(cham),
                grads=params_from_jax(grads),
                stats=state_dict_from_jax({"params": params,
                                           "batch_stats": stats})))

    def port_state():
        m = get_model(num_parts=PARTS, dropout_rate=0.0, device="cpu")
        m.load_state_dict(state_dict_from_jax(variables), strict=True)
        return create_train_state(m)

    state = port_state()
    _, sm = make_supervised_step(get_loss)(
        state, torch.from_numpy(x), torch.from_numpy(cls),
        torch.from_numpy(target), 1e-3, 0.1, sr_key=BASE)
    port = dict(loss=sm["loss"].item(),
                grads={n: p.grad.clone()
                       for n, p in state.model.named_parameters()},
                stats=dict(state.model.named_buffers()))
    ss_state = port_state()
    bt = torch.from_numpy(blobs)
    _, ssm = make_selfsup_step(**SS_KW)(
        ss_state, bt, torch.from_numpy(cls), bt, 1e-3, 0.1, 1.0,
        sr_key=BASE)
    port.update(ss=ssm["ss_loss"].item(), cham=ssm["chamfer_loss"].item())
    return port, jax_runs


def _spread(jax_runs, get):
    """The largest change of ``get(run)`` (a float or tensor) between
    JAX's run on the data and its runs on the data scaled by 1 +- 2^-20."""
    ref = get(jax_runs[0])
    return max(float(np.abs(np.asarray(get(r)) - np.asarray(ref)).max())
               for r in jax_runs[1:])


def test_mxsr_supervised_step_matches_jax(model_runs):
    """One ``mxsr`` supervised step from the same weights and key words.

    bf16 storage makes the model's gradient at this size chaotic: JAX's
    own gradients move by 30-60% of their norm when the input is scaled
    by 1 + 2^-20 (ties in the bf16 K-max and relu boundaries flip), and
    the port and JAX sum in other orders, which is a change of that size.
    So each quantity is held within twice JAX's own spread under that
    input change (``_spread``), plus a floor: the loss (+1e-6 relative);
    each gradient relative to its norm (+5e-2, the f32 limit; measured
    at 0.7 to 1.0 of JAX's spread); each running statistic (+1e-5).  A
    wiring fault is far outside these; the region itself is held tightly
    by ``test_mx_chain_matches_jax``."""
    port, jax_runs = model_runs
    ref = jax_runs[0]
    assert abs(port["loss"] - ref["loss"]) <= 2 * _spread(
        jax_runs, lambda r: r["loss"]) + 1e-6 * abs(ref["loss"])
    checked = 0
    for name, r in ref["grads"].items():
        g = port["grads"][name]
        if _zero_grad_bias(name):
            continue
        if not bool(r.any()):
            assert not bool(g.any()), name
            continue
        err = float((g - r).norm() / r.norm())
        own = max(float((j["grads"][name] - r).norm() / r.norm())
                  for j in jax_runs[1:])
        assert err <= 2 * own + 5e-2, (name, err, own)
        checked += 1
    assert checked > 60
    for name, buf in port["stats"].items():
        if name.endswith(("running_mean", "running_var")):
            spread = _spread(jax_runs, lambda j: j["stats"][name].numpy())
            np.testing.assert_allclose(buf.numpy(), ref["stats"][name],
                                       rtol=0, atol=2 * spread + 1e-5,
                                       err_msg=name)


def test_mxsr_selfsup_step_matches_jax(model_runs):
    """One ``mxsr`` self-sup step (1 mean-shift step, 6 slots) on a cloud
    of 3 blobs: ss_loss and chamfer within twice JAX's own spread under
    the input scaled by 1 +- 2^-20, plus 1e-4 relative (the f32 step's
    limit)."""
    port, jax_runs = model_runs
    ref = jax_runs[0]
    for k in ("ss", "cham"):
        assert abs(port[k] - ref[k]) <= 2 * _spread(
            jax_runs, lambda r: r[k]) + 1e-4 * abs(ref[k]), k
