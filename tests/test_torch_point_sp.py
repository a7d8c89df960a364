"""The port's point-axis parallelism (``prifit_torch/parallel/point_sp.py``)
on 2 and 4 gloo ranks against the JAX package's on a matching ``(data,
points)`` mesh of its 8 virtual CPU devices (which ``tests/test_point_sp.py``
holds against JAX's unsharded pipeline), and against the port's
unsharded pipeline; and ``train_partseg --sp_points 2`` on 2 ranks.

Inputs are the JAX test's (``tests/test_point_sp.py``): blob embeddings
``[2, 128, 16]``, points and a chamfer target from numpy seeds.  Slot
order depends on argmin tie-breaks among numerically identical converged
modes, so clusters are compared after matching slots (as the JAX test
does); losses are slot-permutation invariant.  The ranks take JAX's
eigenvector signs (a flipped axis mirrors the sample lattice and moves the
chamfer by 2e-3 here).

A rank holds its data shard with every point and returns its point
slice's weights and labels, the replicated fit, and its input gradients,
which under the replicated-loss convention
(:mod:`prifit_torch.parallel.collectives`) are the number of ranks that
replicate the loss times its share: the fit loss is replicated over every
rank, a scalar of one shard's fit over its ``points`` group.
"""

import os
import os.path as osp

import numpy as np
import pytest
import torch

from test_torch_parallel import _eigh_like_jax, _np, spawn_run

torch.set_num_threads(1)

KW = dict(quantile=0.1, iterations=5, max_num_clusters=25)
N_PER_PRIM = 16


def _blob_embeddings(rng, B=2, N=128, D=16, G=4):
    protos = rng.normal(size=(B, G, D))
    assign = rng.integers(0, G, size=(B, N))
    X = (protos[np.arange(B)[:, None], assign]
         + 0.15 * rng.normal(size=(B, N, D))).astype(np.float32)
    return X / np.linalg.norm(X, axis=2, keepdims=True)


def _data():
    rng = np.random.default_rng(2)
    X = _blob_embeddings(rng)
    pts = rng.normal(scale=2.0, size=(2, 128, 3)).astype(np.float32)
    target = np.random.default_rng(7).normal(
        scale=2.0, size=(2, 256, 3)).astype(np.float32)
    return X, pts, target


def _fit_loss(params):
    """The JAX test's scalar of a fit: sum of valid radii and squared
    centers (slot-permutation invariant)."""
    m = params.valid.float()[..., None]
    return (params.r * m).sum() + (params.center ** 2 * m).sum()


def _task_point_sp(rank, world, payload):
    from prifit_torch.parallel.point_sp import (
        cluster_and_fit_point_sharded,
        convex_fit_loss_point_sharded,
        make_dp_sp_mesh,
    )

    # the fit samples along the eigenvectors, whose signs are the solver's
    # choice: take JAX's, as test_torch_grad.align_eigh_signs does
    _eigh_like_jax()
    out = []
    for n_data, n_points, what in payload["meshes"]:
        mesh = make_dp_sp_mesh(n_data, n_points)
        d = mesh.coords["data"]
        b = payload["X"].shape[0] // n_data
        part = slice(d * b, (d + 1) * b)
        X = torch.from_numpy(payload["X"][part]).requires_grad_()
        pts = torch.from_numpy(payload["pts"][part]).requires_grad_()
        r = {"coords": (d, mesh.coords["points"])}
        if "fit" in what:
            res, params = cluster_and_fit_point_sharded(X, pts, mesh=mesh,
                                                        **KW)
            _fit_loss(params).backward()
            r.update(weights=_np(res.weights), labels=_np(res.labels),
                     valid=_np(res.valid), bw=_np(res.bandwidth),
                     nc=_np(res.num_clusters), r=_np(params.r),
                     center=_np(params.center), gX=_np(X.grad),
                     gp=_np(pts.grad))
            X.grad = pts.grad = None
        if "loss" in what:
            target = torch.from_numpy(payload["target"][part])
            loss, _ = convex_fit_loss_point_sharded(
                X, pts, target, mesh=mesh, n_per_prim=N_PER_PRIM, **KW)
            loss.backward()
            r.update(loss=loss.item(), loss_gp=_np(pts.grad))
        out.append(r)
    if payload.get("dryrun"):
        from prifit_torch.entry import dryrun_multichip

        run = dryrun_multichip("cpu", batch=2, compute_dtype="f32",
                               sp_points=2)
        out.append({k: run[k] for k in ("sup_loss", "ss_loss", "sp_loss",
                                        "sp_clusters", "sp_mesh")})
    return out


def _task_cli(rank, world, payload):
    from prifit_torch.cli import train_partseg as T
    from prifit_torch.cli.args_parser import parse_args

    args = parse_args(payload["argv"])
    metrics = T.main(args, device="cpu")
    exp = osp.join(args.experiment_root, T.experiment_name(args))
    return {"metrics": metrics, "exp": exp}



# ------------------------------------------------------------- references

def _jax_refs(X, pts, target, meshes):
    """JAX's sharded results on each ``(n_data, n_points)`` mesh of its
    virtual devices: clustering, fit, the JAX test's fit scalar's
    gradients, the fit loss and its gradient in the points (JAX's own
    test holds these against its unsharded pipeline)."""
    import jax
    import jax.numpy as jnp

    from prifit_tpu.parallel.point_sp import (
        cluster_and_fit_point_sharded,
        convex_fit_loss_point_sharded,
        make_dp_sp_mesh,
    )

    Xj, pj, tj = jnp.asarray(X), jnp.asarray(pts), jnp.asarray(target)

    def scalar(params):
        m = params.valid.astype(jnp.float32)
        return (jnp.sum(params.r * m[..., None])
                + jnp.sum(params.center ** 2 * m[..., None]))

    refs = {}
    for n_data, n_points, what in meshes:
        mesh = make_dp_sp_mesh(n_data, n_points)

        def fit(x, p, mesh=mesh):
            return cluster_and_fit_point_sharded(x, p, mesh=mesh, **KW)

        def loss(p, mesh=mesh):
            return convex_fit_loss_point_sharded(
                Xj, p, tj, mesh=mesh, n_per_prim=N_PER_PRIM, **KW)[0]

        r = {}
        if "fit" in what:
            r["res"], r["params"] = fit(Xj, pj)
            r["grads"] = jax.grad(lambda x, p: scalar(fit(x, p)[1]),
                                  argnums=(0, 1))(Xj, pj)
        if "loss" in what:
            r["loss"] = float(loss(pj))
            r["loss_gp"] = np.asarray(jax.grad(loss)(pj))
        refs[(n_data, n_points)] = r
    return refs


def _port_unsharded(X, pts, target):
    """The port's unsharded pipeline (one bandwidth candidate, JAX's
    eigenvector signs): clustering, fit, the fit scalar's gradients, the
    fit loss and its points gradient."""
    from types import SimpleNamespace

    from prifit_torch.clustering.mean_shift import cluster_batch
    from prifit_torch.geometry.fitting import fit_ellipsoids_batch
    from prifit_torch.geometry.losses import analytic_chamfer
    from prifit_torch.geometry.sampling import sample_primitives_batch

    def fit(x, p):
        res = cluster_batch(x, num_candidates=1, **KW)
        return res, fit_ellipsoids_batch(p, res.weights, res.valid)

    Xt = torch.from_numpy(X).requires_grad_()
    pt = torch.from_numpy(pts).requires_grad_()
    orig = _eigh_like_jax()
    try:
        res, params = fit(Xt, pt)
        _fit_loss(params).backward()
        p2 = torch.from_numpy(pts).requires_grad_()
        _, params2 = fit(torch.from_numpy(X), p2)
        samples, w = sample_primitives_batch(params2, N_PER_PRIM)
        loss = analytic_chamfer(params2, samples, w,
                                torch.from_numpy(target))
        loss.backward()
    finally:
        torch.linalg.eigh = orig
    return dict(
        res=SimpleNamespace(**{k: _np(v) for k, v in res._asdict().items()}),
        params=SimpleNamespace(r=_np(params.r), center=_np(params.center)),
        grads=(_np(Xt.grad), _np(pt.grad)), loss=loss.item(),
        loss_gp=_np(p2.grad))


def _assemble(ranks, idx, n_data, n_points):
    """The global weights and labels from each rank's point slice, and
    the global input gradients of the sum over data shards of the fit
    scalar: a rank's scalar is its shard's, replicated over its
    ``points`` group, so its gradient is ``n_points`` times its share."""
    B, N = 2, 128
    b, n = B // n_data, N // n_points
    weights = np.zeros((B, N, 25), np.float32)
    labels = np.zeros((B, N), np.int64)
    gX = np.zeros((B, N, 16), np.float32)
    gp = np.zeros((B, N, 3), np.float32)
    for r in ranks:
        res = r[idx]
        d, p = res["coords"]
        rows, cols = slice(d * b, (d + 1) * b), slice(p * n, (p + 1) * n)
        weights[rows, cols] = res["weights"]
        labels[rows, cols] = res["labels"]
        gX[rows] += res["gX"] / n_points
        gp[rows] += res["gp"] / n_points
    return weights, labels, gX, gp


def _match(gw, rw):
    gn = gw / (np.linalg.norm(gw, axis=0, keepdims=True) + 1e-12)
    rn = rw / (np.linalg.norm(rw, axis=0, keepdims=True) + 1e-12)
    perm = np.argmax(gn.T @ rn, axis=0)
    assert len(set(perm.tolist())) == len(perm)
    return perm


def _check_fit(got, ref_res, ref_params):
    """Slot counts exactly, the bandwidth within 1e-6 relative, weights
    (1e-5), radii and centers (1e-4) after slot matching, and labels
    after relabeling: the JAX test's limits."""
    weights, labels, valid = got["weights"], got["labels"], got["valid"]
    np.testing.assert_array_equal(got["nc"], np.asarray(
        ref_res.num_clusters))
    if "bw" in got:
        np.testing.assert_allclose(got["bw"], np.asarray(ref_res.bandwidth),
                                   rtol=1e-6)
    for b in range(2):
        gv, rv = valid[b], np.asarray(ref_res.valid[b])
        assert gv.sum() == rv.sum()
        gw, rw = weights[b][:, gv], np.asarray(ref_res.weights[b])[:, rv]
        perm = _match(gw, rw)
        np.testing.assert_allclose(gw[:, perm], rw, atol=1e-5)
        np.testing.assert_allclose(got["r"][b][gv][perm],
                                   np.asarray(ref_params.r[b])[rv],
                                   atol=1e-4)
        np.testing.assert_allclose(got["center"][b][gv][perm],
                                   np.asarray(ref_params.center[b])[rv],
                                   atol=1e-4)
        if labels is not None:
            gidx, ridx = np.flatnonzero(gv), np.flatnonzero(rv)
            relabel = {int(gidx[perm[j]]): int(ridx[j])
                       for j in range(len(perm))}
            np.testing.assert_array_equal(
                np.vectorize(relabel.get)(labels[b]),
                np.asarray(ref_res.labels[b]))


def _check_grads(gX, gp, ref):
    """The JAX test's limits: the X gradient (through 5 mean-shift steps,
    where sum-order differences amplify) in direction (cosine > 0.999)
    and within 5e-2 of its largest entry; the points gradient within
    3e-3."""
    for g, r, atol in zip((gX, gp), (np.asarray(ref[0]), np.asarray(ref[1])),
                          (5e-2, 3e-3)):
        cos = (g * r).sum() / (np.linalg.norm(g) * np.linalg.norm(r)
                               + 1e-12)
        assert cos > 0.999, cos
        np.testing.assert_allclose(g, r, atol=atol * np.abs(r).max())


@pytest.fixture(scope="module")
def unsharded():
    """The port's unsharded pipeline's results, shared by the mesh
    cases."""
    return _port_unsharded(*_data())


@pytest.mark.parametrize("world,meshes", [
    (2, [(1, 2, ("fit", "loss"))]),
    (4, [(1, 4, ("fit",)), (2, 2, ("fit", "loss"))]),
], ids=["2ranks", "4ranks"])
def test_point_sharded_pipeline_matches_jax(world, meshes, unsharded):
    """Clustering, fit, the fit scalar's gradients, the fit loss and its
    points gradient on each mesh against JAX's on the same mesh (which
    JAX's own test holds against its unsharded pipeline) and against the
    port's unsharded pipeline; every rank of a ``points`` group holds the
    same replicated fit.  On 2 ranks the dry run
    (:func:`prifit_torch.entry.dryrun_multichip`) runs too: finite
    losses and at least 3 clusters of its 4 blobs."""
    X, pts, target = _data()
    payload = dict(X=X, pts=pts, target=target, meshes=meshes,
                   dryrun=world == 2)
    ranks = spawn_run(world, _task_point_sp, payload)
    refs = _jax_refs(X, pts, target, meshes)
    unsh = unsharded

    for idx, (n_data, n_points, what) in enumerate(meshes):
        ref = refs[(n_data, n_points)]
        for o in ranks:
            first = ranks[o[idx]["coords"][0] * n_points][idx]
            for k in ("valid", "r", "center", "nc", "bw", "loss"):
                if k in first:
                    np.testing.assert_array_equal(o[idx][k], first[k])
        if "fit" in what:
            weights, labels, gX, gp = _assemble(ranks, idx, n_data,
                                                n_points)
            got = dict(weights=weights, labels=labels,
                       valid=np.concatenate(
                           [ranks[d * n_points][idx]["valid"]
                            for d in range(n_data)]),
                       nc=np.concatenate([ranks[d * n_points][idx]["nc"]
                                          for d in range(n_data)]),
                       bw=np.concatenate([ranks[d * n_points][idx]["bw"]
                                          for d in range(n_data)]),
                       r=np.concatenate([ranks[d * n_points][idx]["r"]
                                         for d in range(n_data)]),
                       center=np.concatenate(
                           [ranks[d * n_points][idx]["center"]
                            for d in range(n_data)]))
            for res, params in ((ref["res"], ref["params"]),
                                (unsh["res"], unsh["params"])):
                _check_fit(got, res, params)
            for grads in (ref["grads"], unsh["grads"]):
                _check_grads(gX, gp, grads)
        if "loss" in what:
            loss = ranks[0][idx]["loss"]
            assert all(o[idx]["loss"] == loss for o in ranks)
            gp = sum(o[idx]["loss_gp"] for o in ranks) / world
            if n_data > 1:
                gp = np.concatenate(
                    [sum(o[idx]["loss_gp"] for o in ranks
                         if o[idx]["coords"][0] == d) / world
                     for d in range(n_data)])
            for r in (ref, unsh):
                np.testing.assert_allclose(loss, r["loss"], rtol=2e-4)
                np.testing.assert_allclose(
                    gp, r["loss_gp"], atol=3e-3 * np.abs(r["loss_gp"]).max())
    if world == 2:
        dry = [o[-1] for o in ranks]
        assert dry[0] == dry[1]
        assert dry[0]["sp_mesh"] == {"data": 1, "points": 2}
        assert np.isfinite([dry[0][k] for k in ("sup_loss", "ss_loss",
                                                "sp_loss")]).all()
        assert max(dry[0]["sp_clusters"]) >= 3


def test_train_partseg_sp_points_on_two_ranks(tmp_path):
    """``train_partseg --sp_points 2`` for one iteration on 2 ranks on a
    fixture tree: the point-SP mesh is logged, both ranks end with the
    same finite evaluation, and rank 0 alone wrote the run's files."""
    from tests.fixtures import make_acd_fixture, make_shapenet_fixture

    sn = make_shapenet_fixture(str(tmp_path / "sn"), n_per_cat=4,
                               n_points=64)
    acd = make_acd_fixture(str(tmp_path / "acd"), n_shapes=4, n_points=96)
    argv = ["--epoch", "1", "--epoch_iters", "1", "--batch_size", "2",
            "--npoint", "48", "--k_shot", "2", "--data_root", sn,
            "--ss_path", acd, "--chamfer_npoints", "96", "--quantile", "0.2",
            "--msc_iterations", "2", "--max_num_clusters", "4",
            "--n_per_prim", "16", "--num_workers", "0",
            "--encoder_dtype", "f32", "--selfsup", "--sp_points", "2",
            "--experiment_root", str(tmp_path / "runs")]
    r0, r1 = spawn_run(2, _task_cli, {"argv": argv})
    assert r0["metrics"] == r1["metrics"]
    assert np.isfinite(r0["metrics"]["instance_avg_iou"])
    with open(osp.join(r0["exp"], "train.log")) as f:
        log = f.read()
    assert "Point-SP mesh: data=1 x points=2" in log
    assert log.count("PARAMETERS") == 1
    assert sorted(os.listdir(osp.join(r0["exp"], "checkpoints"))) == [
        "best_model", "last_model", "model_001"]
