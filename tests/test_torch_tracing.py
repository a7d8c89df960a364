"""The port's own spans and counters (``prifit_torch.utils.profiling``):
the profiler ranges of the host syncs, the encoder stages, the data
wait and the hand-written backwards appear once per call, the counters
count what a step did, and nothing is recorded while no profiler runs.
Plain PyTorch on the CPU: no JAX."""

import collections
import importlib

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from prifit_torch import entry
from prifit_torch.clustering import mean_shift as ms
from prifit_torch.data import prefetch_to_device
from prifit_torch.kernels.mean_shift import MeanShiftStep
from prifit_torch.models.dgcnn import get_model as dgcnn_model
from prifit_torch.models.pointnet2_part_seg_msg import get_loss
from prifit_torch.nn.mixed import _MxChain
from prifit_torch.train.steps import make_selfsup_step, make_supervised_step
from prifit_torch.utils import profiling

# the module, which the package's function of the same name shadows
cl = importlib.import_module("prifit_torch.geometry.convex_loss")
ENCODER = [f"encoder.{s}" for s in ("sa1", "sa2", "sa3", "fp3", "fp2",
                                    "fp1")]
# a bandwidth at the nearest neighbour and one slot: every shape
# overflows the first candidate and is clustered again
SS_KW = dict(quantile=0.02, msc_iterations=2, max_num_clusters=1,
             n_per_prim=8, num_bandwidth_candidates=2)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _ranges(prof) -> collections.Counter:
    return collections.Counter(e.name for e in prof.events())


def _counting(monkeypatch, cls, calls: list):
    orig = cls.backward

    def backward(ctx, *grads):
        calls.append(1)
        return orig(ctx, *grads)

    monkeypatch.setattr(cls, "backward", staticmethod(backward))


def test_mxsr_steps_open_each_range_per_call_and_count_their_work(
        monkeypatch):
    B, N = 2, 64
    state, points, cls, target = entry.train_flagship(B, N, device="cpu")
    gen = torch.Generator().manual_seed(0)
    sup, ss = make_supervised_step(get_loss), make_selfsup_step(**SS_KW)
    region_bwd, ms_bwd, shapes, clusters = [], [], [], []
    _counting(monkeypatch, _MxChain, region_bwd)
    _counting(monkeypatch, MeanShiftStep, ms_bwd)
    orig_iters, orig_cluster = ms.mean_shift_iterations, cl.cluster_batch

    def iterations(X, bandwidth, iterations, kernel_type="gaussian"):
        shapes.append((*X.shape, iterations))
        return orig_iters(X, bandwidth, iterations, kernel_type)

    def cluster_batch(X, **kw):
        out = orig_cluster(X, **kw)
        clusters.append(out.num_clusters)
        return out

    monkeypatch.setattr(ms, "mean_shift_iterations", iterations)
    monkeypatch.setattr(cl, "cluster_batch", cluster_batch)
    with _cpu_profile() as prof:
        sup(state, points, cls, target, 1e-3, 0.1, gen)
        ss(state, points, cls, points, 1e-3, 0.1, 1.0, gen)
    seen = _ranges(prof)
    # one key read a forward; one overflow read and one fit's
    # eigendecomposition a clustering
    assert seen["sync.sr_key"] == 2
    assert len(clusters) == 1 and seen["sync.cluster_retry"] == 1
    assert seen["sync.eigh"] == 1
    assert all(seen[name] == 2 for name in ENCODER), seen
    # nine regions a forward: sa1's three scales, sa2's two, sa3, fp3-fp1
    assert seen["bwd.regions"] == len(region_bwd) == 18
    # each mean-shift step of both candidates
    assert len(shapes) == 2
    assert seen["bwd.mean_shift"] == len(ms_bwd) == sum(
        it for *_, it in shapes) == 2 * 2

    got = profiling.counters()
    assert got["cluster.shapes"] == B
    assert 0 < got["cluster.retry_shapes"] <= B
    assert got["cluster.clusters"] == sum(int(c.sum()) for c in clusters)


def test_counters_record_nothing_without_a_profiler():
    with _cpu_profile():
        assert profiling.recording()    # clears the last session's
    X = torch.nn.functional.normalize(torch.randn(2, 32, 8), dim=-1)
    ms.cluster_batch(X, quantile=0.05, iterations=2, max_num_clusters=1)
    profiling.count("x")
    profiling.add_seconds("y", 1.0)
    profiling.keep("z", torch.ones(3))
    assert not profiling.recording()
    assert profiling.counters() == {}
    assert profiling._counts == {} and profiling._kept == {}


def test_a_new_session_starts_from_zero():
    for _ in range(2):
        with _cpu_profile():
            profiling.count("x", 2)
            profiling.keep("z", torch.arange(4))
        profiling.count("x")        # outside: not recorded
        assert profiling.counters() == {"x": 2, "z": 6}


class _Flag:
    """The profiler's process-wide flag, read as ``reads`` gives."""

    def __init__(self, reads):
        self.reads = iter(reads)

    @property
    def _is_profiler_enabled(self):
        return next(self.reads)


def test_a_thread_that_saw_no_session_keeps_the_new_ones_counts(
        monkeypatch):
    """A producer reads the flag off, and the session starts (and clears
    the counters) before it marks them stale: its mark must not clear
    the new session's counts."""
    monkeypatch.setattr(profiling, "_stale", True)
    monkeypatch.setattr(profiling, "_autograd_profiler",
                        _Flag([True, True, False, True, True, True]))
    profiling.count("x")            # the session's first count
    assert not profiling.recording()    # off, then on under the lock
    profiling.count("x")
    assert profiling.counters() == {"x": 2}


def test_prefetch_producer_counts_its_work_under_the_profiler():
    arrays = [np.full((4, 3), i, np.float32) for i in range(16)]
    stream = prefetch_to_device(iter(arrays), transform=lambda a: a * 2,
                                device="cpu")
    try:
        # the producer thread starts before the session, so the
        # profiler's per-thread state reads off on it
        with _cpu_profile() as prof:
            got = [next(stream) for _ in arrays]
    finally:
        stream.close()
    assert [float(g[0, 0]) for g in got] == [2.0 * i for i in range(16)]
    assert _ranges(prof)["data.wait"] == len(arrays)
    counted = profiling.counters()
    assert counted["data.place_s"] > 0 and counted["data.transform_s"] > 0
    # the batches placed in the session: those placed ahead of it are not
    assert 0 < counted["data.batches"] <= len(arrays)


def test_dgcnn_forward_opens_its_encoder_range_once():
    model = dgcnn_model(num_parts=3, nn_nb=4, device="cpu").eval()
    xyz = torch.randn(1, 32, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad(), _cpu_profile() as prof:
        model(xyz)
    assert _ranges(prof)["encoder.dgcnn"] == 1
