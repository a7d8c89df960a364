"""The compacted form of mode NMS that the CUDA kernels compute (passes 2
and 3 over the occupied modes and the centers only,
``kernels/nms.py::nms_passes_compact_plain``) against the dense plain
passes and the JAX package's Pallas kernels in interpret mode, on the
CPU.  The inputs keep every distance comparison far from a rounding tie
(or make it an exact one), so the bf16 operands of the Pallas kernels and
the f32 ones here give the same flags."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prifit_torch.clustering import mean_shift as T
from prifit_torch.kernels import nms as KN
from prifit_tpu.clustering import mean_shift as J
from prifit_tpu.ops.pallas.nms import nms_passes_pallas

torch.set_num_threads(1)

N, D = 256, 128


def _unit(rng, n):
    x = rng.normal(size=(n, D)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _modes(kind, seed):
    """``[N, D]`` modes and the bandwidth of one test input."""
    rng = np.random.default_rng(seed)
    if kind == "distinct":      # every mode occupied and its own center
        return _unit(rng, N), 0.35
    if kind == "single_anchor":  # one mode repeated N times
        return np.repeat(_unit(rng, 1), N, axis=0), 0.35
    # exact copies of well-separated anchors: every tie is exact
    modes = _unit(rng, 7)[rng.integers(0, 7, N)]
    if kind == "rep_zero":
        # bw below every d_ii, so every score is 0 and rep is 0; mode 0 at
        # half length is nearer to its copies than to itself and nobody's
        # nearest, so rep 0 is not an occupied mode
        modes[0] *= 0.5
        return modes, -1.0
    return modes, 0.35


KINDS = ["duplicates", "distinct", "single_anchor", "rep_zero"]


def _torch(modes, bw):
    return torch.from_numpy(np.asarray(modes))[None], torch.tensor([bw])


@pytest.mark.parametrize("kind", KINDS)
def test_compact_equals_dense_plain(kind):
    modes, bw = _modes(kind, 1)
    got = KN.nms_passes_compact_plain(*_torch(modes, bw))
    ref = KN.nms_passes_plain(*_torch(modes, bw))
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        assert torch.equal(g, r)


@pytest.mark.parametrize("kind", KINDS)
def test_compact_equals_pallas_interpret(kind):
    modes, bw = _modes(kind, 2)
    counts, is_center, used = KN.nms_passes_compact_plain(
        *_torch(modes, bw))
    pc, pi, pu = nms_passes_pallas(jnp.asarray(modes),
                                   jnp.asarray(np.float32(bw)),
                                   interpret=True)
    np.testing.assert_array_equal(counts[0].numpy(), np.asarray(pc))
    np.testing.assert_array_equal(is_center[0].numpy(), np.asarray(pi))
    np.testing.assert_array_equal(used[0].numpy(), np.asarray(pu))
    if kind == "rep_zero":
        assert counts[0, 0] == 0
        assert is_center[0].nonzero().tolist() == [[0]]


def test_compact_batched_kinds():
    """One batch of every kind, each shape with its own bandwidth: the
    per-shape lists do not leak between shapes."""
    modes, bws = zip(*(_modes(kind, 3 + i) for i, kind in enumerate(KINDS)))
    X = torch.from_numpy(np.stack(modes))
    bw = torch.tensor(bws, dtype=torch.float32)
    got = KN.nms_passes_compact_plain(X, bw)
    ref = KN.nms_passes_plain(X, bw)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("max_num_clusters", [25, 4])
def test_compact_slots_match_jax(max_num_clusters):
    """The slots that ``nms_tail`` makes of the compacted passes equal
    the JAX package's ``nms_fixed_slots``, including the truncation to
    fewer slots than surviving modes."""
    modes = np.stack([_modes("duplicates", s)[0] for s in (4, 5)])
    bw = np.array([0.35, 0.35], np.float32)
    ids, valid, n_distinct = T.nms_tail(
        *KN.nms_passes_compact_plain(torch.from_numpy(modes),
                                     torch.from_numpy(bw)),
        max_num_clusters)
    for b in range(2):
        ri, rv, rn = J.nms_fixed_slots(jnp.asarray(modes[b]),
                                       jnp.asarray(bw[b]), max_num_clusters)
        np.testing.assert_array_equal(ids[b].numpy(), np.asarray(ri))
        np.testing.assert_array_equal(valid[b].numpy(), np.asarray(rv))
        assert int(n_distinct[b]) == int(rn)
