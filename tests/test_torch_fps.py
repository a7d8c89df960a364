"""Farthest point sampling: the port's ``(idx, new_xyz)`` against the JAX
package on the CPU, and the CUDA kernel's design checked in numpy.

The port's plain version (what a CPU tensor runs) is held EXACTLY against
the JAX scan and the Pallas kernel in interpret mode, on ragged point
counts, start 0 and random starts, ``npoint == N``, and clouds full of
ties (duplicated points, one point repeated, an integer lattice); its
coordinates are exactly ``xyz[idx]``.  A numpy copy of ``csrc/fps.cu``'s
step (points ``k*T + t`` in thread ``t``, the tail at distance 0 with an
index past ``N``, the thread's strict-``>`` sweep, each warp's max of the
distance bits then min index, the same over the warps' slots) gives the
same indices at several ``(T, P)``, including the warp-first reduction
of 512 and 1024 threads.  The launch-shape picker covers every
``N`` up to its limit.  ``SetAbstractionMsg`` (which takes its centroids
from FPS) matches the JAX layer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prifit_torch.convert import state_dict_from_jax
from prifit_torch.kernels import fps as KF
from prifit_torch.models.pointnet2_part_seg_msg import get_model
from prifit_torch.ops import sampling as tsamp
from prifit_tpu.models import get_module
from prifit_tpu.ops import sampling as jsamp
from prifit_tpu.ops.pallas.fps import farthest_point_sample_pallas
from test_torch_model import make_variables

torch.set_num_threads(1)

NO_INDEX = np.uint32(0xFFFFFFFF)


def _cloud(kind, seed, B, N):
    rng = np.random.default_rng(seed)
    if kind == "gauss":
        x = rng.normal(size=(B, N, 3))
    elif kind == "duplicates":   # each point about 4 times, scattered
        base = rng.normal(size=(B, max(N // 4, 1), 3))
        x = base[:, rng.integers(0, base.shape[1], N)]
    elif kind == "identical":    # every distance 0 after the first step
        x = np.broadcast_to(rng.normal(size=(B, 1, 3)), (B, N, 3))
    else:                        # integer lattice: many equal distances
        x = rng.integers(-3, 4, size=(B, N, 3))
    return np.ascontiguousarray(x, dtype=np.float32)


def _jax_fps(x, npoint, seed):
    """The JAX scan and the interpret-mode Pallas kernel, and the start
    they used (None: start 0)."""
    xj = jnp.asarray(x)
    if seed is None:
        kw = dict(deterministic=True)
        start = None
    else:
        key = jax.random.PRNGKey(seed)
        kw = dict(key=key)
        start = np.asarray(jax.random.randint(
            key, (x.shape[0],), 0, x.shape[1], dtype=jnp.int32))
    ref = np.asarray(jsamp.farthest_point_sample(xj, npoint, **kw))
    pal = np.asarray(farthest_point_sample_pallas(xj, npoint,
                                                  interpret=True, **kw))
    return ref, pal, start


CASES = [  # (N, npoint, cloud, start seed or None for start 0)
    (50, 50, "gauss", None),
    (50, 17, "gauss", 3),
    (77, 77, "gauss", 4),
    (500, 100, "gauss", None),
    (500, 128, "gauss", 5),
    (200, 200, "duplicates", 6),
    (500, 160, "duplicates", None),
    (64, 64, "identical", None),
    (100, 30, "identical", 7),
    (343, 343, "lattice", 8),
    (500, 200, "lattice", None),
]


@pytest.mark.parametrize("n,npoint,kind,seed", CASES)
def test_fps_exact_against_jax(n, npoint, kind, seed):
    """Indices exactly the JAX scan's and the Pallas kernel's; the
    coordinates exactly ``xyz[idx]``; the index-only op agrees."""
    x = _cloud(kind, n + npoint, 3, n)
    ref, pal, start = _jax_fps(x, npoint, seed)
    st = None if start is None else torch.tensor(start, dtype=torch.int64)
    idx, new_xyz = KF.farthest_point_sample(torch.from_numpy(x), npoint, st)
    assert idx.dtype == torch.int64 and idx.shape == (3, npoint)
    np.testing.assert_array_equal(idx.numpy(), ref)
    np.testing.assert_array_equal(idx.numpy(), pal)
    want = np.take_along_axis(x, ref[..., None].astype(np.int64), axis=1)
    assert new_xyz.dtype == torch.float32
    np.testing.assert_array_equal(new_xyz.numpy().view(np.uint32),
                                  want.view(np.uint32))
    np.testing.assert_array_equal(tsamp.farthest_point_sample(
        torch.from_numpy(x), npoint, st).numpy(), ref)


def _argmax_groups(d, ix, size):
    """Per group of ``size`` consecutive entries (last axis): the greatest
    distance and the least index at it (a warp's two ``redux.sync``, or a
    lane's trees over its entries)."""
    d = d.reshape(-1, size)
    ix = ix.reshape(-1, size)
    m = d.max(1)
    return m, np.where(d == m[:, None], ix, NO_INDEX).min(1)


def _kernel_in_numpy(x, npoint, start, T, P):
    """``csrc/fps.cu``'s algorithm, step for step, in numpy: thread ``t``
    holds points ``k*T + t``; with 128 or 256 threads each writes its entry
    and every lane reduces ``T / 32`` consecutive ones, then the warp; from
    512 threads each warp reduces its own 32 threads first and the lanes
    read one entry each (dummies past the warps)."""
    B, N, _ = x.shape
    j = np.arange(P)[:, None] * T + np.arange(T)[None]         # [P, T]
    real = j < N
    out = np.empty((B, npoint), np.int64)
    for b in range(B):
        pts = np.zeros((P, T, 3), np.float32)
        pts[real] = x[b, j[real]]
        md = np.where(real, np.float32(1e10), np.float32(0))
        far = int(start[b])
        out[b, 0] = far
        for i in range(1, npoint):
            d = pts - x[b, far]
            dist = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
                + d[..., 2] * d[..., 2]
            md = np.minimum(md, dist)
            # each thread: its maximum and lowest index there
            m, at = _argmax_groups(md.T, j.T.astype(np.uint32), P)
            if T <= 256:
                m, at = _argmax_groups(m, at, T // 32)    # a lane's entries
            else:
                m, at = _argmax_groups(m, at, 32)         # each warp first
                m = np.concatenate([m, np.zeros(32 - m.size, np.float32)])
                at = np.concatenate([at, np.full(32 - at.size, NO_INDEX)])
            _, far = _argmax_groups(m, at, 32)            # the warp
            far = int(far[0])
            out[b, i] = far
    return out


@pytest.mark.parametrize("kind", ["gauss", "duplicates", "identical",
                                  "lattice"])
@pytest.mark.parametrize("n,T,P", [(50, 128, 1), (77, 128, 1),
                                   (500, 128, 4), (500, 256, 2),
                                   (900, 256, 4), (500, 512, 1),
                                   (1500, 1024, 2)])
def test_kernel_design_in_numpy(kind, n, T, P):
    """The kernel's layout and its argmax in three levels, tail points
    (and whole warps of them) included, give the plain version's
    indices."""
    x = _cloud(kind, n, 2, n)
    start = np.random.default_rng(n).integers(0, n, 2)
    npoint = min(n, 60)
    idx = _kernel_in_numpy(x, npoint, start, T, P)
    ref, _ = KF.fps_plain(torch.from_numpy(x), npoint,
                          torch.from_numpy(start))
    np.testing.assert_array_equal(idx, ref.numpy())


def test_launch_shape_covers_every_count():
    """Every N from 1 to the limit gets a block size the kernel has and
    1..16 points a thread with T * P >= N and no spare thread row; the
    limit + 1 and 0 raise."""
    n = np.arange(1, KF.MAX_POINTS + 1)
    shapes = np.array([KF.launch_shape(int(k)) for k in n])
    T, P = shapes[:, 0], shapes[:, 1]
    assert set(T.tolist()) <= set(KF.THREADS)
    assert P.min() >= 1 and P.max() <= KF.MAX_PER_THREAD
    assert (T * P >= n).all() and (T * (P - 1) < n).all()
    for bad in (0, KF.MAX_POINTS + 1):
        with pytest.raises(ValueError, match=str(KF.MAX_POINTS)):
            KF.launch_shape(bad)


def test_wrapper_refuses_xyz_that_needs_a_gradient():
    x = torch.zeros((1, 8, 3), requires_grad=True)
    with pytest.raises(ValueError, match="gradient"):
        KF.farthest_point_sample(x, 4)


def test_set_abstraction_msg_matches_jax():
    """sa1 and sa2 of the f32 flagship in eval mode (FPS from index 0),
    each fed the JAX layer's own input: the centroids bit for bit, the
    features within 1e-4 (f32 matmuls summed in another order)."""
    rng = np.random.default_rng(12)
    B, N = 2, 512
    x = rng.normal(size=(B, N, 3)).astype(np.float32)
    cls = np.zeros((B, 16), np.float32)
    cls[:, 1] = 1.0
    model = get_module("pointnet2_part_seg_msg").get_model(
        num_parts=50, compute_dtype="f32")
    xj, cj = jnp.asarray(x), jnp.asarray(cls)
    v = make_variables((x, cls))
    _, state = jax.jit(lambda v, p, c: model.apply(
        v, p, c, train=False, capture_intermediates=True,
        mutable=["intermediates"]))(v, xj, cj)
    inter = jax.tree_util.tree_map(np.asarray, state["intermediates"])
    port = get_model(num_parts=50, compute_dtype="f32", device="cpu")
    port.load_state_dict(state_dict_from_jax(v), strict=True)
    port.eval()
    inputs = (x, x)
    for name in ("sa1", "sa2"):
        ref_xyz, ref_points = inter[name]["__call__"][0]
        with torch.no_grad():
            new_xyz, new_points = getattr(port, name)(
                *(torch.tensor(np.asarray(a)) for a in inputs))
        np.testing.assert_array_equal(new_xyz.numpy(), ref_xyz)
        np.testing.assert_allclose(new_points.numpy(), ref_points,
                                   atol=1e-4)
        inputs = (ref_xyz, ref_points)
