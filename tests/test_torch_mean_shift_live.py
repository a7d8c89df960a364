"""The mean-shift backward over the live rows of its cotangent (the rows
with a nonzero entry), on the CPU: the live-row index the backward kernel
takes (``kernels/mean_shift.py::live_rows``), the plain backward run on
those rows only against the dense plain backward and the JAX package, and
the premise that makes the kernel skip the other rows: on the self-sup
path every cotangent the mean-shift backward gets is live only at the
cluster centers."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prifit_torch.clustering import mean_shift as T
from prifit_torch.entry import SELFSUP_OPTIONS
from prifit_torch.geometry.convex_loss import convex_loss
from prifit_torch.kernels import mean_shift as KM
from prifit_tpu.ops.pallas.mean_shift import _ref_step, mean_shift_step_pallas

torch.set_num_threads(1)

B, N, D = 2, 256, 128


def _unit_rows(rng, shape):
    X = rng.normal(size=shape).astype(np.float32)
    return X / np.linalg.norm(X, axis=-1, keepdims=True)


def _cotangent(rng, live):
    """``[B, N, D]`` with ``live`` nonzero rows per shape at random ids."""
    g = np.zeros((B, N, D), np.float32)
    for b in range(B):
        rows = rng.choice(N, size=live, replace=False)
        g[b, rows] = rng.normal(size=(live, D))
    return g


@functools.lru_cache(maxsize=None)
def _inputs(bw2):
    rng = np.random.default_rng(11)
    q, X = _unit_rows(rng, (B, N, D)), _unit_rows(rng, (B, N, D))
    bt = torch.full((B,), bw2, dtype=torch.float32)
    m, s = KM.mean_shift_step_plain(torch.from_numpy(q), torch.from_numpy(X),
                                    bt)
    return q, X, bt, m, s


@functools.lru_cache(maxsize=None)
def _jax_vjps(bw2):
    """Per shape, the VJPs of ``_ref_step`` and of the interpret-mode
    Pallas step."""
    q, X = _inputs(bw2)[:2]
    bj = jnp.float32(bw2)
    out = []
    for b in range(B):
        qj, Xj = jnp.asarray(q[b]), jnp.asarray(X[b])
        _, ref = jax.vjp(lambda a, c: _ref_step(a, c, bj), qj, Xj)
        _, pal = jax.vjp(lambda a, c: mean_shift_step_pallas(a, c, bj, True),
                         qj, Xj)
        out.append((ref, pal))
    return out


def bwd_on_live_rows(q, X, bw2, m, s, g):
    """The dense plain backward run on each shape's live rows only
    (:func:`live_rows`): dq of the other rows is 0, and they add nothing
    to dX."""
    order, count = KM.live_rows(g)
    dq, dX = torch.zeros_like(q), torch.zeros_like(X)
    for b in range(q.shape[0]):
        idx = order[b, :int(count[b])].long()
        dqb, dXb = KM.mean_shift_step_bwd_plain(
            q[b:b + 1, idx], X[b:b + 1], bw2[b:b + 1], m[b:b + 1, idx],
            s[b:b + 1, idx], g[b:b + 1, idx])
        dq[b, idx] = dqb[0]
        dX[b] = dXb[0]
    return dq, dX


@pytest.mark.parametrize("live", [0, 1, 25, N])
def test_live_rows_index(live):
    """``order`` is a permutation of each shape's rows with the live rows
    first in ascending id and the rest after in ascending id, ``count`` the
    number of live rows; both int32."""
    g = torch.from_numpy(_cotangent(np.random.default_rng(live), live))
    order, count = KM.live_rows(g)
    assert order.dtype == count.dtype == torch.int32
    assert order.shape == (B, N) and count.shape == (B,)
    for b in range(B):
        rows = torch.nonzero(g[b].abs().amax(-1) > 0)[:, 0]
        dead = torch.nonzero(g[b].abs().amax(-1) == 0)[:, 0]
        assert int(count[b]) == live == len(rows)
        assert torch.equal(order[b].long(), torch.cat([rows, dead]))


@pytest.mark.parametrize("bw2", [0.3, 0.07])
@pytest.mark.parametrize("live", [0, 1, 25, N])
def test_backward_on_live_rows_matches_dense_and_jax(live, bw2):
    """The plain backward on the live rows only against the dense plain
    backward and ``_ref_step``'s VJP within 2e-5 of the largest gradient
    entry (the tolerance of ``test_torch_grad.py::
    test_mean_shift_backward_matches_jax``: f32 products summed in another
    order, here ``<g, x>`` by another BLAS routine for fewer rows, and
    ``<g, x> - c`` cancels), and against the interpret-mode Pallas
    backward (bf16 operands) within ``1.5 * 2^-8 / bw2`` of it.  At
    ``bw2 = 0.07`` many exponents clamp at -13 (the gradient cutoff)."""
    q, X, bt, m, s = _inputs(bw2)
    g = _cotangent(np.random.default_rng(100 + live), live)
    gt = torch.from_numpy(g)
    qt, Xt = torch.from_numpy(q), torch.from_numpy(X)
    got = bwd_on_live_rows(qt, Xt, bt, m, s, gt)
    dense = KM.mean_shift_step_bwd_plain(qt, Xt, bt, m, s, gt)
    vjps = _jax_vjps(bw2)
    for b in range(B):
        ref = [np.asarray(t) for t in vjps[b][0](jnp.asarray(g[b]))]
        pal = [np.asarray(t) for t in vjps[b][1](jnp.asarray(g[b]))]
        scale = max(np.abs(r).max() for r in ref)
        assert (scale == 0) == (live == 0)
        for a, d, r, p in zip(got, dense, ref, pal):
            np.testing.assert_allclose(a[b].numpy(), d[b].numpy(),
                                       atol=2e-5 * scale, rtol=0)
            np.testing.assert_allclose(a[b].numpy(), r, atol=2e-5 * scale,
                                       rtol=0)
            np.testing.assert_allclose(a[b].numpy(), p,
                                       atol=1.5 * 2 ** -8 / bw2 * scale,
                                       rtol=0)


@pytest.mark.parametrize("bw2", [0.3, 0.07])
def test_zero_cotangent_gives_exact_zeros(bw2):
    """An all-zero cotangent has no live row, and both the dense plain
    backward and the backward on live rows give exact zeros."""
    q, X, bt, m, s = _inputs(bw2)
    qt, Xt = torch.from_numpy(q), torch.from_numpy(X)
    g = torch.zeros((B, N, D))
    assert KM.live_rows(g)[1].tolist() == [0] * B
    for out in (KM.mean_shift_step_bwd_plain(qt, Xt, bt, m, s, g),
                bwd_on_live_rows(qt, Xt, bt, m, s, g)):
        for t in out:
            assert not bool(t.any())


class LiveRowRecorder:
    """While active, records for every mean-shift backward on the CPU the
    live rows of its cotangent per shape, and for every clustering
    candidate the valid center ids per shape; the two are matched by the
    candidate's embeddings and squared bandwidths, which the backward
    saves."""

    def __init__(self, monkeypatch):
        self.calls, self.centers, nms_out = [], {}, []
        plain, run, nms = (KM.mean_shift_step_bwd_plain, T._run_candidate,
                           T.nms_fixed_slots)

        def bwd(q, X, bw2, m, s, g):
            live = [set(torch.nonzero(gb.abs().amax(-1) > 0)[:, 0].tolist())
                    for gb in g]
            self.calls.append(((X.data_ptr(), tuple(bw2.tolist())), live))
            return plain(q, X, bw2, m, s, g)

        def nms_fixed_slots(modes, bw, max_num_clusters):
            out = nms(modes, bw, max_num_clusters)
            nms_out.append(out)
            return out

        def run_candidate(X, bw, *args):
            out = run(X, bw, *args)
            ids, valid, _ = nms_out[-1]
            key = (X.data_ptr(), tuple((bw ** 2).float().tolist()))
            self.centers[key] = [set(i[v].tolist())
                                 for i, v in zip(ids, valid)]
            return out

        monkeypatch.setattr(KM, "mean_shift_step_bwd_plain", bwd)
        monkeypatch.setattr(T, "nms_fixed_slots", nms_fixed_slots)
        monkeypatch.setattr(T, "_run_candidate", run_candidate)

    def check(self, iterations, max_num_clusters):
        """Every backward's live rows are valid center ids of its
        candidate's shape, so at most ``max_num_clusters``; each candidate
        that ran took ``iterations`` backwards; some row was live."""
        assert len(self.calls) == iterations * len(self.centers)
        assert any(any(rows) for _, rows in self.calls)
        for key, live in self.calls:
            for rows, ids in zip(live, self.centers[key]):
                assert rows <= ids, (rows, ids)
                assert len(rows) <= max_num_clusters


@pytest.mark.parametrize("options", [
    {}, SELFSUP_OPTIONS, dict(SELFSUP_OPTIONS, if_cuboid=True)],
    ids=["default", "options", "options_cuboid"])
@pytest.mark.parametrize("iterations", [1, 3])
def test_convex_loss_cotangents_live_at_centers_only(monkeypatch,
                                                     iterations, options):
    """The convex loss on embeddings with 3 clusters per shape (B=2,
    N=256, ``test_torch_grad.py``'s structured case), with its default
    terms and with every option on (entropy, intersection, pruning), for
    ellipsoids and for cuboids: every cotangent of a mean-shift step is
    live only at the shape's valid center ids, as the backward kernel's
    row skipping assumes.  (The entropy term reaches the embeddings
    directly; intersection and cuboid reach the modes through the fitted
    primitives, as the chamfer does.)"""
    from test_torch_grad import STRUCT_KW, _structured  # imports JAX too
    rec = LiveRowRecorder(monkeypatch)
    X = torch.from_numpy(_structured(5, B, N)).requires_grad_()
    pts = torch.from_numpy(np.random.default_rng(6).normal(
        size=(B, N, 3)).astype(np.float32))
    kw = dict(STRUCT_KW, iterations=iterations)
    out = convex_loss(pts, pts, X, generator=torch.Generator().manual_seed(
        iterations), **kw, **options)
    out.total.backward()
    assert out.clusters.num_clusters.tolist() == [3, 3]
    if options:
        assert out.intersection.item() > 0
    rec.check(iterations, kw["max_num_clusters"])
    assert all(len(rows) == 3 for _, live in rec.calls for rows in live)


def test_cluster_batch_retry_cotangents_live_at_centers_only(monkeypatch):
    """``cluster_batch``'s centers and weights on the retry batch of
    ``test_torch_clustering.py`` (some shapes overflow 3 slots at the
    first bandwidth and take a later candidate): in every backward, of
    every candidate, the live rows are valid center ids of that
    candidate's shape."""
    rng = np.random.default_rng(10)
    parts = []
    for i in range(4):
        if i % 2 == 0:
            parts.append(rng.normal(size=(128, 16)))
        else:
            parts.append(rng.normal(size=(1, 16)) * 4.0
                         + rng.normal(size=(128, 16)) * 0.01)
    rec = LiveRowRecorder(monkeypatch)
    X = torch.from_numpy(np.stack(parts).astype(np.float32)
                         ).requires_grad_()
    out = T.cluster_batch(X, quantile=0.01, iterations=4, max_num_clusters=3,
                          num_candidates=3)
    wc = torch.from_numpy(rng.normal(size=out.centers.shape)
                          .astype(np.float32))
    ww = torch.from_numpy(rng.normal(size=out.weights.shape)
                          .astype(np.float32))
    ((out.centers * wc).sum() + (out.weights * ww).sum()).backward()
    assert len(rec.centers) == 3          # the first candidate and 2 retries
    rec.check(4, 3)
