"""The readers of what the program records of itself
(:mod:`benchmark.program`): the arithmetic of ``sync_idle_ms`` on a
synthetic trace, and every such metric the CPU can give read in a traced
tiny run."""

import json
import os.path as osp
import subprocess
import sys
from types import SimpleNamespace

from torch.autograd import DeviceType

ROOT = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402
from benchmark.traced import ITERATION_RANGE, Trace  # noqa: E402

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def _event(name, side, a, b):
    return SimpleNamespace(name=name, device_type=side,
                           time_range=SimpleNamespace(start=a, end=b))


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_sync_idle_counts_each_gap_a_sync_ends_in_once():
    # busy: [0, 10] [20, 30] [50, 60] [100, 110]; gaps of 10, 20 and 40 us
    kernels = [(0, 10), (20, 25), (22, 30), (50, 60), (100, 110)]
    events = [_event(ITERATION_RANGE, CPU, 0, 55),
              _event(ITERATION_RANGE, CPU, 55, 110),
              # the iterations' device mirrors
              _event(ITERATION_RANGE, CUDA, 0, 110)]
    events += [_event("k", CUDA, a, b) for a, b in kernels]
    events += [
        # two syncs that end in the gap (30, 50): counted once
        _event("sync.a", CPU, 26, 33), _event("sync.b", CPU, 35, 40),
        # one that ends inside the busy interval [50, 60]: no gap
        _event("sync.a", CPU, 45, 52),
        # one that ends in the gap (10, 20)
        _event("sync.c", CPU, 5, 12),
        # a range that is no sync, ending in the gap (60, 100)
        _event("data.wait", CPU, 58, 70)]
    from benchmark.metrics import sync_idle_ms, sync_wait_ms
    run = SimpleNamespace(trace=Trace(_Prof(events), "cuda"))
    assert run.trace.n_iterations == 2
    # gaps (10, 20) and (30, 50); the gap (60, 100) holds no sync's end
    assert sync_idle_ms.read(run) == (10 + 20) / 1e3 / 2
    assert sync_wait_ms.read(run) == (7 + 5 + 7 + 7) / 1e3 / 2


def test_a_program_without_its_records_reads_nothing():
    events = [_event(ITERATION_RANGE, CPU, 0, 10),
              _event(ITERATION_RANGE, CUDA, 0, 10), _event("k", CUDA, 0, 5)]
    run = SimpleNamespace(trace=Trace(_Prof(events), "cuda"))
    for name in ("sync_wait_ms", "sync_idle_ms", "prefetch_wait_ms",
                 "bwd_regions_ms", "bwd_mean_shift_ms"):
        assert harness.reader(name).read(run) is None


DRY = """
import json, sys
sys.path[0] = {root!r}
from benchmark.tests.tiny import dry_run
result, _ = dry_run("msg.semisup_convex", trace=True,
                    params={{"quantile": 0.02}})
print(json.dumps(result))
"""


def test_a_traced_tiny_run_reads_the_programs_records():
    """Every such metric but the device's (``sync_idle_ms`` and the
    backwards' device ms), on the CPU; the quantile at the nearest
    neighbour makes the clustering retry."""
    p = subprocess.run([sys.executable, "-c", DRY.format(root=ROOT)],
                       capture_output=True, text=True, timeout=600,
                       cwd=ROOT)
    assert p.returncode == 0, p.stderr[-4000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    got = {k: v["value"] for k, v in result["metrics"].items()}
    for name in ("sync_wait_ms", "prefetch_wait_ms", "produce_ms"):
        assert got[name] > 0, name
    assert 0 < got["retry_share"] <= 100
    assert got["clusters_per_shape"] >= 1
    assert result["correct"] is True
