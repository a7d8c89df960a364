"""The convex loss's options in the port against the JAX package on the
CPU: the cuboid SDF, lattice and sampling, the entropy, intersection and
pruning terms (and the intersection variants the JAX package exports
beside them), ``convex_loss`` with each flag alone and all together, the
model's use of the draws, and one B=2 f32 self-sup step with every option
for ellipsoids and for cuboids, from a JAX state whose entropy weight
``beta`` has decayed to 0.5.

Tolerances: f32 values within 1e-5 relative (1e-5 absolute near 0) and
gradients within 1e-5 of their largest entry (the same sums in another
order); the lattice, the ``prune_mask`` bits and the intersection's
owner indices exactly.  ``sdf_cuboid`` takes ``|local|``, whose gradient
at 0 is 1 in JAX and 0 under ``torch.abs``: the port reproduces JAX's, and
the SDF tests put points at exact zeros of the local frame to hold it.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prifit_torch.clustering import mean_shift as T
from prifit_torch.convert import params_from_jax, state_dict_from_jax
from prifit_torch.entry import init_weights
from prifit_torch.geometry import convex_loss as t_convex_loss
from prifit_torch.geometry import fitting as TF
from prifit_torch.geometry import losses as TL
from prifit_torch.geometry import sampling as TS
from prifit_torch.geometry import sdf as TD
from prifit_torch.models.pointnet2_part_seg_msg import get_model
from prifit_torch.train.steps import make_selfsup_step
from prifit_tpu.clustering import mean_shift as J
from prifit_tpu.geometry import create_synthetic_dataset
from prifit_tpu.geometry import losses as JL
from prifit_tpu.geometry import sampling as JS
from prifit_tpu.geometry import sdf as JD
from prifit_tpu.geometry.convex_loss import convex_loss as j_convex_loss
from prifit_tpu.geometry.fitting import PrimitiveParams as JParams
from prifit_tpu.models import get_module
import prifit_tpu.models.pointnet2_part_seg_msg as j_msg
from test_torch_grad import _center_ids, align_eigh_signs, jax_eigh
from test_torch_train import (B, BN_MOMENTUM, F64_RTOL, JAX_RTOL, LMBDA, LR,
                              PARTS, SS_KW, _assert_grads_match, _f64_grads,
                              _grads, _port_state, blob_cloud, jax_variables,
                              with_xyz_gain)

torch.set_num_threads(1)

K = 6
OPTIONS = dict(include_entropy_loss=True, include_intersect_loss=True,
               include_pruning=True)
FLAGS = {"entropy": dict(include_entropy_loss=True),
         "intersect": dict(include_intersect_loss=True),
         "pruning": dict(include_pruning=True),
         "cuboid": dict(if_cuboid=True),
         "all": OPTIONS,
         "all_cuboid": dict(OPTIONS, if_cuboid=True)}
KEY = jax.random.PRNGKey(7)


def _rotations(rng, n):
    Q = np.linalg.qr(rng.normal(size=(n, 3, 3)))[0]
    Q[:, :, 0] *= np.sign(np.linalg.det(Q))[:, None]
    return Q.astype(np.float32)


def _params(seed=0):
    """``[2, K]`` primitives: slot 0 invalid (so the first valid slot is
    1), slot 1 the axis-aligned box ``r = 1`` at the origin, slot 3 a copy
    of slot 2 (equal SDFs to the bit), the others random; returned as
    numpy ``(r, V, center, valid)``."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(0.4, 1.5, size=(2, K, 3)).astype(np.float32)
    V = _rotations(rng, 2 * K).reshape(2, K, 3, 3)
    c = rng.normal(size=(2, K, 3)).astype(np.float32) * 0.8
    r[:, 1], V[:, 1], c[:, 1] = 1.0, np.eye(3), 0.0
    r[:, 3], V[:, 3], c[:, 3] = r[:, 2], V[:, 2], c[:, 2]
    valid = np.ones((2, K), bool)
    valid[:, 0] = False
    return r, V, c, valid


def _points(seed, params, cuboid, m=200):
    """``[2, m + 7 (+ 1 + K), 3]`` queries: spread points; points on slot
    1's faces, edges and planes of symmetry (zeros of its local frame, ties
    of ``max q``); for cuboids also the origin and every center, where a
    local frame is all zeros.  (There the ellipsoid SDF's gradient is NaN
    in JAX, the norm of a zero vector, so ellipsoids do without them.)"""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(2, m, 3)) * 1.5
    special = np.array([[0.5, 0.5, 0], [1, 0, 0], [0, -1, 0], [1, 1, 0],
                        [0.5, 0, 0.5], [2, 0, 0], [0, 0, 1]])
    parts = [pts, np.broadcast_to(special, (2, 7, 3))]
    if cuboid:
        parts += [np.zeros((2, 1, 3)), params[2]]
    return np.concatenate(parts, axis=1).astype(np.float32)


def _jp(p):
    return JParams(*(jnp.asarray(a) for a in p))


def _tp(p, grad=False):
    r, V, c, valid = (torch.from_numpy(np.array(a)) for a in p)
    if grad:
        r, V, c = (t.requires_grad_() for t in (r, V, c))
    return TF.PrimitiveParams(r, V, c, valid)


def _close(got, ref, rtol=1e-5, atol=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=atol * max(1.0, np.abs(ref).max()))


def _grads_close(got, ref, tol=1e-5):
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r,
                                   atol=tol * max(np.abs(r).max(), 1e-30))


def _check_fn(jfn, tfn, p, args_j, args_t, tol=1e-5):
    """``jfn(JParams, *args_j)`` against ``tfn(PrimitiveParams,
    *args_t)``: the value and its gradients in r, V, center and the float
    ``args``; returns the port's value."""
    grad_args = [i for i, a in enumerate(args_t)
                 if isinstance(a, torch.Tensor) and a.is_floating_point()]

    def jloss(r, V, c, *a):
        full = list(args_j)
        for i, x in zip(grad_args, a):
            full[i] = x
        return jfn(JParams(r, V, c, jnp.asarray(p[3])), *full)

    jp = _jp(p)
    jval, jg = jax.value_and_grad(jloss, argnums=tuple(
        range(3 + len(grad_args))))(jp.r, jp.V, jp.center,
                                    *(args_j[i] for i in grad_args))
    tp = _tp(p, grad=True)
    targs = [a.clone().requires_grad_() if i in grad_args else a
             for i, a in enumerate(args_t)]
    val = tfn(tp, *targs)
    val.backward()
    _close(val.item(), float(jval), tol, tol)
    # an argument the loss does not read has no gradient here, zeros in JAX
    _grads_close([tp.r.grad, tp.V.grad, tp.center.grad] + [
        torch.zeros_like(targs[i]) if targs[i].grad is None
        else targs[i].grad for i in grad_args], jg, tol)
    return val.item()


@pytest.mark.parametrize("cuboid", [False, True])
def test_sdf_primitives_matches_jax(cuboid):
    """``sdf_primitives`` (and so ``sdf_cuboid``) values, and the gradient
    of a weighted sum in the points and the primitives, including points
    at exact zeros of a local frame and on ties of ``max q``."""
    p = _params(1)
    q = _points(2, p, cuboid)
    w = np.random.default_rng(3).normal(size=(2, q.shape[1], K)).astype(
        np.float32) * p[3][:, None, :]
    jfn = jax.vmap(lambda pts, r, V, c: JD.sdf_primitives(pts, r, V, c,
                                                          cuboid))
    ref = jfn(jnp.asarray(q), *_jp(p)[:3])
    out = TD.sdf_primitives(torch.from_numpy(q), *_tp(p)[:3], cuboid)
    _close(out.numpy(), ref)
    _check_fn(lambda jp, x: jnp.sum(jfn(x, jp.r, jp.V, jp.center) * w),
              lambda tp, x: torch.sum(TD.sdf_primitives(
                  x, tp.r, tp.V, tp.center, cuboid) * torch.from_numpy(w)),
              p, [jnp.asarray(q)], [torch.from_numpy(q)])


@pytest.mark.parametrize("n", [1, 5, 6, 66, 256, 400])
def test_box_surface_lattice_matches_jax(n):
    """Points, face axes and the count ``6 isqrt(max(n // 6, 1))^2`` (216
    for the main path's 256) exactly."""
    pts, axis = TS.box_surface_lattice(n)
    jpts, jaxis = JS.box_surface_lattice(n)
    assert len(pts) == 6 * math.isqrt(max(n // 6, 1)) ** 2
    np.testing.assert_array_equal(pts.numpy(), np.asarray(jpts))
    np.testing.assert_array_equal(axis.numpy(), np.asarray(jaxis))
    assert axis.dtype == torch.int64


@pytest.mark.parametrize("n", [66, 256])
def test_cuboid_sampling_matches_jax(n):
    """``sample_primitives_batch(cuboid=True)``: points and area weights
    (zero for the invalid slot), and the gradient of a weighted sum of the
    points in the primitives."""
    p = _params(4)
    rp, rw = JS.sample_primitives_batch(_jp(p), n_per_prim=n, cuboid=True)
    op, ow = TS.sample_primitives_batch(_tp(p), n, cuboid=True)
    assert op.shape == (2, K * 6 * math.isqrt(n // 6) ** 2, 3)
    _close(op.numpy(), rp)
    _close(ow.numpy(), rw)
    assert not ow.reshape(2, K, -1)[:, 0].any()
    wt = np.random.default_rng(5).normal(size=rp.shape).astype(np.float32)
    _check_fn(lambda jp: jnp.sum(JS.sample_primitives_batch(
        jp, n_per_prim=n, cuboid=True)[0] * wt),
        lambda tp: torch.sum(TS.sample_primitives_batch(
            tp, n, cuboid=True)[0] * torch.from_numpy(wt)), p, [], [])


@pytest.mark.parametrize("spread", [0.3, 3.0])
def test_entropy_loss_matches_jax(spread):
    """Value and gradient on unit rows around 2 directions: tight
    (``spread`` 0.3, the relu active) and loose (3.0, the relu at 0)."""
    rng = np.random.default_rng(6)
    X = rng.normal(size=(2, 2, 16))[:, rng.integers(0, 2, 96)] \
        + spread * rng.normal(size=(2, 96, 16))
    X = (X / np.linalg.norm(X, axis=-1, keepdims=True)).astype(np.float32)
    jval, jg = jax.value_and_grad(JL.entropy_loss)(jnp.asarray(X))
    Xt = torch.from_numpy(X).requires_grad_()
    val = TL.entropy_loss(Xt)
    val.backward()
    assert (float(jval) > 0) == (spread < 1)
    _close(val.item(), float(jval))
    _grads_close([Xt.grad], [jg])


@pytest.mark.parametrize("cuboid", [False, True])
def test_analytic_chamfer_matches_jax(cuboid):
    """Fed the same primitives, samples and target: the value and its
    gradient in the primitives and the target."""
    p = _params(7)
    samples, sw = JS.sample_primitives_batch(_jp(p), n_per_prim=66,
                                             cuboid=cuboid)
    tgt = _points(8, p, cuboid)
    st, swt = torch.from_numpy(np.array(samples)), torch.from_numpy(
        np.array(sw))
    _check_fn(lambda jp, t: JL.analytic_chamfer(jp, samples, sw, t, cuboid),
              lambda tp, t: TL.analytic_chamfer(tp, st, swt, t, cuboid),
              p, [jnp.asarray(tgt)], [torch.from_numpy(tgt)])


def _j_owner(p, q, cuboid, clamp=-1e-3):
    """JAX's ``own`` of ``intersection_loss`` (``prifit_tpu/geometry/
    losses.py``), per shape."""
    jp = _jp(p)

    def one(r, V, c, valid, pts):
        sdf = jnp.minimum(JD.sdf_primitives(pts, r, V, c, cuboid), clamp)
        return jnp.argmin(jnp.where(valid[None, :], sdf, jnp.inf), axis=1)

    return np.asarray(jax.vmap(one)(*jp, jnp.asarray(q)))


@pytest.mark.parametrize("cuboid", [False, True])
def test_intersection_loss_matches_jax(cuboid):
    """On points where the clamped SDFs tie (outside every slot all valid
    slots read -1e-3; inside slots 2 and 3, equal to the bit): the owner
    of every point equal to JAX's (the first valid slot of a tie), then
    the loss and its gradient in the primitives and the points."""
    p = _params(9)
    q = _points(10, p, cuboid)
    sdf, own = TL.clamped_sdf_owner(_tp(p), torch.from_numpy(q), cuboid)
    np.testing.assert_array_equal(own.numpy(), _j_owner(p, q, cuboid))
    valid = torch.from_numpy(p[3])[:, None, :]
    ties = ((sdf == sdf.masked_fill(~valid, np.inf).amin(-1, keepdim=True))
            & valid).sum(-1)
    assert int((ties > 1).sum()) > 20 and int((own == 1).sum()) > 20
    assert bool((own == 2).any()) and not bool((own == 3).any())
    val = _check_fn(lambda jp, x: JL.intersection_loss(jp, x, cuboid),
                    lambda tp, x: TL.intersection_loss(tp, x, cuboid),
                    p, [jnp.asarray(q)], [torch.from_numpy(q)])
    assert val > 0


@pytest.mark.parametrize("cuboid", [False, True])
def test_prune_mask_matches_jax(cuboid):
    """The mask bits exactly on the primitives' own surface samples and
    on the tie-heavy queries, both values present; no gradient."""
    p = _params(11)
    samples, _ = JS.sample_primitives_batch(_jp(p), n_per_prim=66,
                                            cuboid=cuboid)
    q = np.concatenate([np.asarray(samples), _points(12, p, cuboid)], axis=1)
    ref = np.asarray(JL.prune_mask(jnp.asarray(q), _jp(p), cuboid))
    out = TL.prune_mask(torch.from_numpy(q), _tp(p, grad=True), cuboid)
    assert out.dtype == torch.bool and not out.requires_grad
    np.testing.assert_array_equal(out.numpy(), ref)
    assert ref.any() and not ref.all()


def test_sample_axis_matches_jax():
    p = _params(13)
    jp = jax.vmap(jax.vmap(lambda r, V, c: JL.sample_axis(r, V, c, 12)))(
        *_jp(p)[:3])
    out = TL.sample_axis(*_tp(p)[:3], 12)
    _close(out[0].numpy(), jp[0])
    _close(out[1].numpy(), jp[1])
    wt = np.random.default_rng(14).normal(size=jp[0].shape).astype(
        np.float32)
    _check_fn(
        lambda q: jnp.sum(jax.vmap(jax.vmap(lambda r, V, c: JL.sample_axis(
            r, V, c, 12)[0]))(q.r, q.V, q.center) * wt),
        lambda q: torch.sum(TL.sample_axis(q.r, q.V, q.center, 12)[0]
                            * torch.from_numpy(wt)), p, [], [])


VARIANTS = {
    "surface": lambda L, cub: lambda p, s, w, q: L.intersection_loss_surface(
        p, s, w, cub),
    "volume": lambda L, cub: lambda p, s, w, q: L.intersection_loss_volume(
        p, 12),
    "v2": lambda L, cub: lambda p, s, w, q: L.intersection_loss_v2(p, q, cub),
    "v4": lambda L, cub: lambda p, s, w, q: L.intersection_loss_v4(p, q),
}


@pytest.mark.parametrize("variant,cuboid", [
    ("surface", False), ("surface", True), ("volume", False),
    ("v2", False), ("v2", True), ("v4", False)])
def test_intersection_variants_match_jax(variant, cuboid):
    """The exported variants, on the tie-heavy primitives and queries
    (surface: the primitives' own samples): value and gradient in the
    primitives and the query points."""
    p = _params(15)
    samples, sw = JS.sample_primitives_batch(_jp(p), n_per_prim=66,
                                             cuboid=cuboid)
    q = _points(16, p, cuboid)
    jfn, tfn = VARIANTS[variant](JL, cuboid), VARIANTS[variant](TL, cuboid)
    st, swt = torch.from_numpy(np.array(samples)), torch.from_numpy(
        np.array(sw))
    val = _check_fn(lambda jp, x: jfn(jp, samples, sw, x),
                    lambda tp, x: tfn(tp, st, swt, x), p,
                    [jnp.asarray(q)], [torch.from_numpy(q)])
    assert val != 0


@pytest.fixture(scope="module")
def scenes():
    """Two ``create_synthetic_dataset`` scenes of 3 ellipsoids (150 points
    each), and 32-wide embeddings around one direction per ellipsoid
    (magnitude 4, noise 0.25): memberships soft enough that the loss's
    gradient in them is not rounding noise (with the scenes' one-hot
    embeddings, or 8 wide at noise 0.2, it is about 1e-6 and the two
    packages differ by 1e-2 of it), and clusters tight enough that the
    entropy term is above its margin."""
    scene = create_synthetic_dataset(2, seed=11, points_per_ellipsoid=150)
    rng = np.random.default_rng(12)
    lab = scene.weights.argmax(-1)
    emb = 4.0 * np.eye(32)[lab] + 0.25 * rng.normal(size=lab.shape + (32,))
    return scene.points.astype(np.float32), emb.astype(np.float32)


# one mean-shift step: after two, each cluster's modes agree to f32
# rounding, and which of them becomes its center is a rounding tie
CL_KW = dict(quantile=0.05, iterations=1, max_num_clusters=8, n_per_prim=66)


def jax_draws(key, N, shape):
    """The JAX ``convex_loss``'s draws from ``key``: the entropy
    subsample and the jitter."""
    k_ent, k_jit = jax.random.split(key)
    sub = jax.random.permutation(k_ent, N)[: N // 4]
    jit = jax.random.uniform(k_jit, shape) * 0.2
    return (torch.from_numpy(np.array(sub)).long(),
            torch.from_numpy(np.array(jit)))


@pytest.mark.parametrize("keyed", [True, False], ids=["key", "no_key"])
@pytest.mark.parametrize("flags", list(FLAGS))
def test_convex_loss_options_match_jax(scenes, monkeypatch, flags, keyed):
    """``convex_loss`` on the synthetic scenes with each flag alone and all
    together, with JAX's draws from one key passed to the port, or with no
    key and no generator (both take the deterministic fallbacks): equal
    cluster counts, every component within 1e-4 relative and dLoss/dX
    within 1e-3 of its largest entry, with the eigenvector signs aligned
    (the tolerances of ``test_torch_grad.py``'s structured case), once
    both sides chose the same center ids."""
    pts, emb = scenes
    kw = dict(CL_KW, **FLAGS[flags])
    key = KEY if keyed else None

    def jloss(x):
        out = j_convex_loss(jnp.asarray(pts), jnp.asarray(pts), x, key=key,
                            **kw)
        return out.total, out

    (_, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(emb))
    draws = {}
    if keyed:
        draws = dict(zip(("entropy_sub", "jitter"),
                         jax_draws(KEY, pts.shape[1], pts.shape)))
    align_eigh_signs(monkeypatch, jax_eigh)
    Xt = torch.from_numpy(emb).requires_grad_()
    out = t_convex_loss(torch.from_numpy(pts), torch.from_numpy(pts), Xt,
                        **kw, **draws)
    out.total.backward()
    np.testing.assert_array_equal(out.clusters.num_clusters.numpy(),
                                  np.asarray(jout.clusters.num_clusters))
    assert out.clusters.num_clusters.tolist() == [3, 3]
    Xn = emb / np.linalg.norm(emb, axis=-1, keepdims=True)
    bw = out.clusters.bandwidth
    args = (CL_KW["iterations"], CL_KW["max_num_clusters"])
    with torch.no_grad():
        modes = T.mean_shift_iterations(torch.from_numpy(Xn), bw, args[0])
        tids = T.nms_fixed_slots(modes, bw, args[1])[0]
    np.testing.assert_array_equal(tids.numpy(), np.stack(_center_ids(
        J.mean_shift_iterations, J.nms_fixed_slots, jnp.asarray(Xn),
        jnp.asarray(bw.numpy()), *args)))
    for name in ("total", "chamfer", "entropy", "intersection"):
        _close(getattr(out, name).item(), float(getattr(jout, name)), 1e-4,
               1e-7)
    for name, flag in (("entropy", "include_entropy_loss"),
                       ("intersection", "include_intersect_loss")):
        assert (getattr(out, name).item() != 0) == kw.get(flag, False)
    ref = np.asarray(jg)
    np.testing.assert_allclose(Xt.grad.numpy(), ref,
                               atol=1e-3 * np.abs(ref).max())


def test_convex_loss_draws_from_the_generator(scenes):
    """With a generator, the entropy subsample is ``randperm(N)[:N // 4]``
    and then the jitter ``U[0, 1) * 0.2`` from it, in that order."""
    pts, emb = scenes
    p, X = torch.from_numpy(pts), torch.from_numpy(emb)
    kw = dict(CL_KW, **OPTIONS)
    out = t_convex_loss(p, p, X, generator=torch.Generator().manual_seed(3),
                        **kw)
    g = torch.Generator().manual_seed(3)
    sub = torch.randperm(p.shape[1], generator=g)[:p.shape[1] // 4]
    jit = torch.rand(p.shape, generator=g) * 0.2
    ref = t_convex_loss(p, p, X, entropy_sub=sub, jitter=jit, **kw)
    for name in ("total", "entropy", "intersection"):
        assert getattr(out, name).item() == getattr(ref, name).item()
    fixed = t_convex_loss(p, p, X, **kw)
    assert fixed.intersection.item() != ref.intersection.item()


def test_eval_forward_takes_the_deterministic_draws():
    """As the JAX model passes no key to the convex loss in eval, the
    port's eval forward ignores the generator (and given draws): the
    same outputs as without, the generator untouched."""
    model = get_model(num_parts=PARTS, compute_dtype="f32", device="cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    model.eval()
    x = torch.from_numpy(np.random.default_rng(17).normal(
        size=(1, 512, 3)).astype(np.float32))
    cls = torch.zeros((1, 16))
    kw = dict(SS_KW, include_convex_loss=True, **OPTIONS)
    g = torch.Generator().manual_seed(5)
    state = g.get_state()
    with torch.no_grad():
        a = model(x, cls, chamfer_points=x, **kw)
        b = model(x, cls, chamfer_points=x, generator=g,
                  jitter=torch.ones(()), **kw)
    assert torch.equal(g.get_state(), state)
    for t, u in ((a.total_loss, b.total_loss),
                 (a.convex.intersection, b.convex.intersection)):
        assert torch.equal(t, u)


def test_beta_is_carried_into_the_state_dict(ss_setup):
    """``state_dict_from_jax`` maps ``selfsup_state["beta"]`` to the
    port's ``beta``, 1.0 without a ``selfsup_state`` (as at the JAX
    model's init); ``beta`` is part of the port's state_dict, so a saved
    state_dict keeps it."""
    v = ss_setup["variables"]
    assert state_dict_from_jax(v)["beta"].item() == 0.5
    plain = {k: v[k] for k in ("params", "batch_stats")}
    assert state_dict_from_jax(plain)["beta"].item() == 1.0
    model = get_model(num_parts=PARTS, device="cpu")
    assert "beta" in model.state_dict()
    model.load_state_dict(state_dict_from_jax(v), strict=True)
    fresh = get_model(num_parts=PARTS, device="cpu")
    fresh.load_state_dict(model.state_dict(), strict=True)
    assert fresh.beta.item() == 0.5


@pytest.fixture(scope="module")
def ss_setup():
    """JAX variables (fp1's xyz weights scaled, so a cloud of 3 blobs
    gives several clusters), the blob cloud and the category."""
    rng = np.random.default_rng(31)
    cls = np.zeros((B, 16), np.float32)
    cls[:, 5] = 1.0
    model = get_module("pointnet2_part_seg_msg").get_model(
        num_parts=PARTS, compute_dtype="f32", dropout_rate=0.0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PRIFIT_DET_FPS", "1")
        variables = jax_variables(model, rng, blob_cloud(rng), cls)
    return dict(model=model, cls=cls, blobs=blob_cloud(rng),
                variables={"params": with_xyz_gain(variables["params"]),
                           "batch_stats": variables["batch_stats"],
                           "selfsup_state": {"beta": np.float32(0.5)}})


@pytest.mark.parametrize("cuboid", [False, True])
def test_selfsup_step_with_every_option_matches_jax(ss_setup, monkeypatch,
                                                    cuboid):
    """One B=2 f32 self-sup step with entropy, intersection and pruning
    (``alpha`` 0.01, the recipe's), from a JAX state whose ``beta`` is
    0.5, carried by ``state_dict_from_jax``; the JAX model's ``selfsup``
    key pinned and its draws passed to the port.  Every cluster count is
    above 1, so the intersection term lives; ss_loss and chamfer within
    1e-4 relative, every gradient within ``JAX_RTOL`` of JAX's and
    ``F64_RTOL`` of the float64 port step's (``test_torch_train.py``), and
    ``beta`` decayed to JAX's 0.495."""
    d = ss_setup
    kw = dict(SS_KW, alpha=0.01, if_cuboid=cuboid, **OPTIONS)
    orig = j_msg.convex_loss
    monkeypatch.setattr(j_msg, "convex_loss", lambda *a, key=None, **k: orig(
        *a, key=None if key is None else KEY, **k))
    monkeypatch.setenv("PRIFIT_DET_FPS", "1")
    bj, cj = jnp.asarray(d["blobs"]), jnp.asarray(d["cls"])
    v = d["variables"]

    def compute(params):
        out, upd = d["model"].apply(
            dict(v, params=params), bj, cj, chamfer_points=bj, train=True,
            bn_momentum=BN_MOMENTUM, rngs={
                "sampling": jax.random.PRNGKey(4),
                "dropout": jax.random.PRNGKey(5),
                "selfsup": jax.random.PRNGKey(6)},
            mutable=["batch_stats", "selfsup_state"],
            include_convex_loss=True, **kw)
        return jnp.mean(out.total_loss) * LMBDA, (
            upd, out.chamfer_loss, out.convex.intersection,
            out.convex.entropy, out.convex.clusters.num_clusters)

    (jl, (upd, jcham, jint, jent, nc)), grads = jax.jit(
        jax.value_and_grad(compute, has_aux=True))(v["params"])
    sub, jit = jax_draws(KEY, d["blobs"].shape[1], d["blobs"].shape)
    monkeypatch.undo()
    align_eigh_signs(monkeypatch, jax_eigh)
    state = _port_state(v)
    assert state.model.beta.item() == 0.5
    x, cls = torch.from_numpy(d["blobs"]), torch.from_numpy(d["cls"])
    step = make_selfsup_step(**kw, entropy_sub=sub, jitter=jit)
    state, metrics = step(state, x, cls, x, LR, BN_MOMENTUM, LMBDA)

    assert min(np.asarray(nc).tolist()) > 1 and float(jint) > 0
    assert float(jent) > 0
    np.testing.assert_allclose(metrics["ss_loss"].item(), float(jl),
                               rtol=1e-4)
    np.testing.assert_allclose(metrics["chamfer_loss"].item(), float(jcham),
                               rtol=1e-4)
    _assert_grads_match(_grads(state.model), params_from_jax(grads),
                        JAX_RTOL)
    _assert_grads_match(_grads(state.model), _f64_grads(
        v, step, (x, cls, x), (LR, BN_MOMENTUM, LMBDA)), F64_RTOL)
    jbeta = np.asarray(upd["selfsup_state"]["beta"], np.float32)
    assert jbeta == np.float32(0.495)
    np.testing.assert_array_equal(state.model.beta.numpy(), jbeta)
