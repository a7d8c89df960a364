"""The f32-storage K-max region (``PRIFIT_MAX_REGION=on`` in the JAX
package, ``max_region=True`` in the port) against the JAX package on the
CPU: the plain versions of kernels #7 and #8 at f32 storage against the
jnp branch of ``nn/mixed.py::_max_bwd_core``, and an MSG SA layer (the
flagship's sa1, B=2) training with the region at f32 and bf16 storage
against the JAX layer with ``PRIFIT_MAX_REGION=on``, and against the
port's layer without it.

Dyadic inputs (small multiples of powers of two, power-of-two tie counts)
make every product and sum of the closed form exact, so the two sides
must agree bit for bit there; gaussian inputs get the tolerances stated
in each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import prifit_tpu.nn.pointnet2 as jpn2
from prifit_torch.convert import SA_CFG, _convert, _msg_rows
from prifit_torch.kernels import max_bwd as KM
from prifit_torch.nn import mixed as M
from prifit_torch.nn.pointnet2 import SetAbstractionMsg
from prifit_tpu.nn import mixed as JM
from test_torch_mixed import _bits, _max_inputs

torch.set_num_threads(1)


def _f32_storage(res, g, out_bf, zsel):
    """``_max_inputs``' residuals in f32 storage: the same values (bf16
    ones are exact in f32), the BN affine and the K-max output in f32,
    and ``g`` f32."""
    z, a, c, scale, mean, inv, n = res
    f = jnp.float32
    a32, c32 = a.astype(f), c.astype(f)
    zsel32 = zsel.astype(f)
    out = jax.nn.relu(JM.bf16_affine(zsel32, a32, c32, f))
    return (z.astype(f), a32, c32, scale, mean, inv, n), g.astype(f), out, \
        zsel32


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("dyadic", [True, False], ids=["dyadic", "gauss"])
@pytest.mark.parametrize("F", [24, 64])
def test_max_bwd_f32_storage_matches_jax(F, dyadic):
    """The port's ``_max_bwd_core`` at f32 storage (kernels #7 and #8's
    plain versions on the CPU) against the jnp branch of JAX's: dz and
    the (dscale, dbias) reductions bit for bit on dyadic inputs; on
    gaussian ones within 2e-6 of the largest entry (XLA's CPU compiler
    contracts ``a * b - c`` into a fused multiply-add, the port rounds
    the product first, as the CUDA kernel does).  ``cnt`` counts exact
    ties in f32 as in bf16, and ``gsm`` is f32 (no rounding at f32
    storage); the wrappers refuse a key there."""
    rng = np.random.default_rng(F + dyadic)
    res, g, out, zsel = _f32_storage(*_max_inputs(rng, 64, 16, F, dyadic,
                                                  False))
    if not dyadic:
        # off the bf16 grid: f32 storage holds values bf16 cannot
        noise = jnp.asarray(rng.normal(size=res[0].shape) * 1e-3, jnp.float32)
        z = res[0] + noise * (res[0] != jnp.repeat(zsel, 16, axis=0))
        res = (z,) + res[1:]
    jdz, (jds, jdb) = JM._max_bwd_core(res, g, out, zsel, None)
    tres = tuple(_t(r) for r in res[:6]) + (torch.tensor(64.0 * 16),)
    tdz, (tds, tdb) = M._max_bwd_core(tres, _t(g), _t(out), _t(zsel), None)
    assert tdz.dtype == torch.float32
    if dyadic:
        for t, j in ((tdz, jdz), (tds, jds), (tdb, jdb)):
            np.testing.assert_array_equal(_bits(t), _bits(j))
    else:
        for t, j in ((tdz, jdz), (tds, jds), (tdb, jdb)):
            j = np.asarray(j)
            assert np.abs(t.numpy() - j).max() <= 2e-6 * np.abs(j).max()
    cnt, gsm = KM.cnt_gsm_plain(tres[0], _t(zsel), _t(g), _t(out), None)
    assert gsm.dtype == torch.float32
    zk = np.asarray(res[0]).reshape(64, 16, F)
    np.testing.assert_array_equal(
        cnt.numpy(), (zk == np.asarray(zsel)[:, None]).sum(1))
    with pytest.raises(ValueError, match="sr implies bf16"):
        M.mx_chain((False, True, True), torch.zeros(1, 2, 4, 3),
                   (None, ()), key=(1, 2), storage=torch.float32)


# ------------------------------------------------------ the SA layer

B, N = 2, 512
MLPS = SA_CFG[0][1]
SCALES = (1 + 2.0 ** -20, 1 - 2.0 ** -20)


def _layer_inputs():
    rng = np.random.default_rng(3)
    xyz = rng.normal(size=(B, N, 3)).astype(np.float32)
    return rng, xyz


def _jax_layer(dtype, rng, xyz):
    """The JAX sa1 (``PRIFIT_DET_FPS=1``, ``PRIFIT_MAX_REGION=on`` set by
    the caller): its variables (batch-norm statistics from ``rng``), and
    for the input and the input scaled by ``SCALES`` the output, the
    gradients of ``sum(out * g)`` in the parameters and the input features
    (the FPS and ball-query coordinates take none), and the new
    statistics."""
    mod = jpn2.SetAbstractionMsg(512, [0.1, 0.2, 0.4], [32, 64, 128], MLPS,
                                 dtype=dtype)
    xj = jnp.asarray(xyz)
    v = mod.init(jax.random.PRNGKey(0), xj, xj, train=False)

    def randomize(path, a):
        if str(path[-1].key).endswith("mean"):
            return rng.normal(size=a.shape).astype(np.float32) * 0.1
        return rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32)

    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = jax.tree_util.tree_map_with_path(randomize, v["batch_stats"])
    g = jnp.asarray(rng.normal(size=(B, 512, 320)).astype(np.float32))

    def f(p, x):
        (_, out), upd = mod.apply({"params": p, "batch_stats": stats},
                                  jax.lax.stop_gradient(x), x, train=True,
                                  bn_momentum=0.1, mutable=["batch_stats"])
        return jnp.sum(out.astype(jnp.float32) * g), (out, upd)

    fn = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))
    runs = []
    for s in (1.0,) + SCALES:
        (_, (out, upd)), (gp, gx) = fn(params, xj * np.float32(s))
        runs.append(dict(
            out=np.asarray(out.astype(jnp.float32)), gx=np.asarray(gx),
            grads={k: v.numpy() for k, v in _convert(
                {"sa1": gp}, None, _msg_rows("sa1", MLPS)).items()},
            stats={k: v.numpy() for k, v in _convert(
                {"sa1": params}, {"sa1": upd["batch_stats"]},
                _msg_rows("sa1", MLPS)).items()}))
    return params, stats, np.asarray(g), runs


def _port_layer(sd, dtype, max_region, xyz, g):
    layer = SetAbstractionMsg(512, [0.1, 0.2, 0.4], [32, 64, 128], 3, MLPS,
                              dtype=dtype, max_region=max_region)
    layer.load_state_dict({k[len("sa1."):]: v for k, v in sd.items()},
                          strict=True)
    layer.train()
    x = torch.from_numpy(xyz).requires_grad_()
    _, out = layer(x.detach(), x, 0.1)
    (out.float() * torch.tensor(g)).sum().backward()
    return dict(out=out.float().detach().numpy(), gx=x.grad.numpy(),
                grads={"sa1." + n: p.grad.numpy()
                       for n, p in layer.named_parameters()},
                stats={"sa1." + n: b.numpy()
                       for n, b in layer.named_buffers()})


def _zero_grad_bias(name):
    """A dense bias a batch norm follows: analytically zero gradient
    (exactly 0 in the region), rounding noise elsewhere."""
    return name.endswith(".bias") and ".conv_blocks." in name


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_sa_layer_max_region_matches_jax(dtype, monkeypatch):
    """sa1 training with the K-max region (its last layer and max over the
    neighbours in ``mx_chain(storage=...)``, kernels #7/#8's plain
    versions here) against JAX's ``PointMLP.call_max`` region on the same
    weights and input: the output, the input and parameter gradients of
    ``sum(out * g)`` and the running statistics.

    f32: output within 1e-5 of its largest entry, gradients within 2e-3
    of each norm, statistics within 1e-5 (f32 sums in another order;
    XLA contracts into FMAs).  bf16 storage: twice JAX's own change under
    the input scaled by 1 +- 2^-20 (a bf16 rounding of the chain's
    products flips with the sum order and moves K-max ties and relu
    boundaries) plus the same floors, but 5e-2 for the gradients, the
    floor of ``test_torch_dtypes.py``: the first two layers are the
    explicit bf16 chain, whose autodiff rounds its cotangents to bf16 on
    both sides in other orders (measured 1.6e-2 at sa1's first layer).  And the port's layer without the region (the
    autodiff max) agrees with it: f32 outputs within 1e-5 and gradients
    within 1e-3; at bf16 the explicit chain takes its last batch norm's
    statistics from the bf16-rounded product (the region from the f32
    one) and rounds its cotangents to bf16 (the region keeps them f32),
    so the outputs are held to 2^-7 of the largest (a bf16 ulp of it)
    and the gradients' directions (cosine > 0.9)."""
    jdt, tdt = (None, None) if dtype == "f32" else (jnp.bfloat16,
                                                    torch.bfloat16)
    rng, xyz = _layer_inputs()
    with monkeypatch.context() as mp:
        mp.setenv("PRIFIT_DET_FPS", "1")
        mp.setenv("PRIFIT_MAX_REGION", "on")
        params, stats, g, runs = _jax_layer(jdt, rng, xyz)
    sd = _convert({"sa1": params}, {"sa1": stats}, _msg_rows("sa1", MLPS))
    calls = {"cnt_gsm": 0, "dz": 0}
    for name in calls:
        real = getattr(KM, name + "_plain")

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(KM, name + "_plain", counted)
    port = _port_layer(sd, tdt, True, xyz, g)
    assert calls == {"cnt_gsm": 3, "dz": 3}      # one region a scale
    ref, others = runs[0], runs[1:]

    def spread(get):
        return 0.0 if dtype == "f32" else max(
            float(np.abs(get(o) - get(ref)).max()) for o in others)

    def spread_rel(get):
        return 0.0 if dtype == "f32" else max(_rel(get(o), get(ref))
                                              for o in others)

    top = np.abs(ref["out"]).max()
    assert np.abs(port["out"] - ref["out"]).max() <= 1e-5 * top + 2 * spread(
        lambda r: r["out"])
    floor = 2e-3 if dtype == "f32" else 5e-2
    assert _rel(port["gx"], ref["gx"]) <= floor + 2 * spread_rel(
        lambda r: r["gx"])
    checked = 0
    for n, r in ref["grads"].items():
        if _zero_grad_bias(n):
            continue
        lim = floor + 2 * spread_rel(lambda o: o["grads"][n])
        assert _rel(port["grads"][n], r) <= lim, (n, _rel(port["grads"][n],
                                                          r))
        checked += 1
    assert checked == 27
    for n, r in ref["stats"].items():
        if n.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(
                port["stats"][n], r, rtol=1e-5,
                atol=1e-5 + 2 * spread(lambda o: o["stats"][n]), err_msg=n)

    off = _port_layer(sd, tdt, False, xyz, g)
    assert np.abs(off["out"] - port["out"]).max() <= (
        1e-5 if dtype == "f32" else 2.0 ** -7) * top
    for n, r in port["grads"].items():
        if _zero_grad_bias(n):
            continue
        if dtype == "f32":
            assert _rel(off["grads"][n], r) <= 1e-3, n
        else:
            cos = (off["grads"][n] * r).sum() / (
                np.linalg.norm(off["grads"][n]) * np.linalg.norm(r))
            assert cos > 0.9, (n, cos)
