"""The closed form that the bandwidth kernel (``csrc/bandwidth.cu``) rests
on, on the CPU: the counting bisection's result is the K-th smallest
distance rounded up to the grid 2^-22 and clamped,

    hi = clamp(ceil(d_(K) 2^22), 1, 2^24) 2^-22,

bit for bit, against ``kernels/bandwidth.py::kth_smallest_bisect`` and the
JAX package's ``_kth_smallest_bisect``; the kernel's select over the keys
``u = clamp(ceil(d 2^22), 1, 2^24) - 1``, written here in numpy, against
the same; and ``kth_nn_distance`` with more than 4 ranks
(the wrapper launches the kernel once for every 4) against JAX."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prifit_torch.kernels import bandwidth as KB
from prifit_tpu.clustering import mean_shift as J

torch.set_num_threads(1)

GRID = np.float32(2.0 ** 22)


def closed_form(dist: np.ndarray, ks) -> np.ndarray:
    """``[N, M]`` f32 distances -> ``[C, N]``: the K-th smallest of each
    row rounded up to the grid 2^-22, clamped to [2^-22, 4]."""
    kth = np.sort(dist, axis=-1)[:, np.asarray(ks) - 1].T       # [C, N]
    key = np.clip(np.ceil(kth * GRID), 1.0, 2.0 ** 24).astype(np.float32)
    return key / GRID


def radix_select(dist: np.ndarray, ks) -> np.ndarray:
    """The kernel's select, in numpy, over the keys ``u`` of a row: the bin
    of the K-th key in a histogram of ``u >> 16``; then, when that bin
    holds at most 256 keys, the low 16 bits of the answer from the top
    down, each bit from one count of the bin's keys at or below a probe;
    else the bins of the next 8 and the last 8 bits among the keys of the
    chosen bins.  Returns ``(u + 1) 2^-22``."""
    u = (np.clip(np.ceil(dist * GRID), 1.0, 2.0 ** 24) - 1).astype(np.int64)
    out = np.empty((len(ks), dist.shape[0]), np.float32)
    for c, K in enumerate(ks):
        for i, row in enumerate(u):
            if K < 1:
                v = 0
            elif K > row.size:
                v = 2 ** 24 - 1
            else:
                h = np.bincount(row >> 16, minlength=256)
                b1 = int(np.searchsorted(np.cumsum(h), K))
                k = K - int(h[:b1].sum())
                keep = row[(row >> 16) == b1]
                if keep.size <= 256:
                    low = 0
                    for bit in range(15, -1, -1):
                        probe = (b1 << 16) | low | ((1 << bit) - 1)
                        if int((keep <= probe).sum()) < k:
                            low |= 1 << bit
                    v = (b1 << 16) | low
                else:
                    v = b1 << 16
                    for shift in (8, 0):
                        h = np.bincount((keep >> shift) & 255, minlength=256)
                        b = int(np.searchsorted(np.cumsum(h), k))
                        k -= int(h[:b].sum())
                        v |= b << shift
                        keep = keep[((keep >> shift) & 255) == b]
            out[c, i] = np.float32(v + 1) / GRID
    return out


def _unit_rows(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _dist(kind: str, seed: int) -> np.ndarray:
    """``[40, 64]`` f32 distances of one kind."""
    rng = np.random.default_rng(seed)
    if kind == "chordal":          # 2 - 2 <x_i, x_j> of unit rows, in f32
        x = _unit_rows(rng, 64, 16)
        return (2.0 - 2.0 * (x @ x.T)).astype(np.float32)[:40]
    if kind == "ties":             # few distinct values, many exact ties
        return rng.choice(np.float32([0.3, 0.7, 1.25, 2.0]), size=(40, 64))
    if kind == "on_grid":          # every value a multiple of 2^-22
        k = rng.integers(0, 2 ** 24 + 1, size=(40, 64))
        return (k.astype(np.float32) / GRID).astype(np.float32)
    if kind == "grid_neighbours":  # a grid point and its f32 neighbours
        g = rng.integers(1, 2 ** 24, size=(40, 1)).astype(np.float32) / GRID
        steps = rng.integers(-2, 3, size=(40, 64))
        return np.where(steps < 0, np.nextafter(g, np.float32(0)),
                        np.where(steps > 0, np.nextafter(g, np.float32(5)),
                                 g)).astype(np.float32)
    if kind == "negative":         # rounding below 0, as d_ii can be
        return rng.uniform(-1e-6, 0.5, size=(40, 64)).astype(np.float32)
    if kind == "above_four":       # past the bisection's range
        return rng.uniform(3.0, 6.0, size=(40, 64)).astype(np.float32)
    if kind == "all_equal":        # every distance of a row the same
        return np.repeat(rng.uniform(0.0, 4.0, size=(40, 1)), 64,
                         axis=1).astype(np.float32)
    raise ValueError(kind)


KINDS = ["chordal", "ties", "on_grid", "grid_neighbours", "negative",
         "above_four", "all_equal"]
RANKS = [[1], [64], [1, 7, 32, 63, 64]]


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("ks", RANKS, ids=["first", "last", "several"])
def test_closed_form_equals_bisection(kind, ks):
    dist = _dist(kind, KINDS.index(kind))
    want = closed_form(dist, ks)
    port = KB.kth_smallest_bisect(torch.from_numpy(dist)[None], ks)[0]
    jax_ = J._kth_smallest_bisect(jnp.asarray(dist), ks)
    np.testing.assert_array_equal(_bits(port.numpy()), _bits(want))
    np.testing.assert_array_equal(_bits(jax_), _bits(want))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("width", [64, 600])
def test_radix_select_equals_bisection(kind, width):
    """With ranks out of range too: K = 0 gives 2^-22 and K > M gives 4,
    as the bisection does.  Rows of 600 put more than 256 keys in one bin
    (ties, all equal), the counted route."""
    dist = _dist(kind, 10 + KINDS.index(kind))
    if width > dist.shape[1]:
        dist = np.tile(dist[:4], (1, -(-width // dist.shape[1])))[:, :width]
    ks = [0, 1, 7, 32, 64, width - 1, width, width + 1]
    want = KB.kth_smallest_bisect(torch.from_numpy(dist)[None], ks)[0]
    np.testing.assert_array_equal(_bits(radix_select(dist, ks)),
                                  _bits(want.numpy()))


def test_more_ranks_than_a_launch_takes():
    """Six ranks (two kernel launches on the card) against JAX's
    ``_kth_smallest_bisect`` within 1e-6 (f32 distance rounding against
    the 2.4e-7 grid), and bit for bit against the closed form over the
    port's own distances."""
    rng = np.random.default_rng(3)
    X = np.stack([_unit_rows(rng, 96, 13) for _ in range(2)])
    ks = [1, 2, 5, 9, 48, 96]
    out = KB.kth_nn_distance(torch.from_numpy(X), ks).numpy()
    for b in range(2):
        xj = jnp.asarray(X[b])
        ref = J._kth_smallest_bisect(J._chordal_sqdist(xj, xj), ks)
        np.testing.assert_allclose(out[b], np.asarray(ref), atol=1e-6)
        own = KB.chordal_sqdist(torch.from_numpy(X[b]),
                                torch.from_numpy(X[b])).numpy()
        np.testing.assert_array_equal(_bits(out[b]),
                                      _bits(closed_form(own, ks)))
