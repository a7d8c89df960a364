"""``bn_eval_roofline``: its bytes, reckoned from the configuration's
widths, against the calls the port's eval forward makes at a small size,
and its reading on synthetic traces (None without the program's
range)."""

import json
import os.path as osp
import sys
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

ROOT = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.frozen.roofline import PEAK_BYTES  # noqa: E402
from benchmark.metrics import bn_eval_roofline as metric  # noqa: E402
from benchmark.traced import ITERATION_RANGE, Trace  # noqa: E402

CONFIG = json.load(open(osp.join(ROOT, "benchmark", "configs",
                                 "pointnet2_msg.json")))


def _call_bytes(args, out) -> int:
    z, mean, var, _, weight, bias, dense_bias, _, _ = args
    params = [mean, var, weight, bias] + (
        [] if dense_bias is None else [dense_bias])
    return sum(t.numel() * t.element_size() for t in [z, out, *params])


@pytest.mark.parametrize("B,N", [(2, 256), (1, 192)])
def test_bytes_equal_the_eval_forwards_calls(B, N, monkeypatch):
    from prifit_torch import entry
    from prifit_torch.nn import pointnet2 as p2
    calls = []
    real = p2.bn_relu_eval

    def record(*args):
        out = real(*args)
        calls.append(_call_bytes(args, out))
        return out

    monkeypatch.setattr(p2, "bn_relu_eval", record)
    model, points, cls = entry.flagship(B, N, device="cpu")
    with torch.no_grad():
        model(points, cls)
    assert len(calls) == 24
    assert metric.forward_bytes(CONFIG["architecture"], B, N, 2) \
        == sum(calls)


def test_the_config_at_its_batch_moves_3_77_gb():
    # 1.058 G elements out of the 24 layers, 239.1 M of them entering as
    # f32, 481.3 M feeding the max
    byt = metric.forward_bytes(CONFIG["architecture"], 24, 2048, 2)
    assert abs(byt / 1e9 - 3.757) < 1e-3
    assert abs(byt / PEAK_BYTES * 1e3 - 1.1217) < 1e-4


def _event(name, side, a, b):
    return SimpleNamespace(name=name, device_type=side,
                           time_range=SimpleNamespace(start=a, end=b))


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _run(names):
    """Two iterations; per iteration a 'bn_eval' range holding a kernel of
    500 us, besides a kernel outside it."""
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [_event(ITERATION_RANGE, cpu, 0, 2000),
              _event(ITERATION_RANGE, cpu, 2000, 4000),
              _event(ITERATION_RANGE, cuda, 0, 4000)]
    for t0 in (0, 2000):
        events += [_event("k", cuda, t0 + 10, t0 + 900)]
        for name in names:
            events += [_event(name, cpu, t0 + 1000, t0 + 1600),
                       _event(name, cuda, t0 + 1000, t0 + 1500),
                       _event("epilogue", cuda, t0 + 1000, t0 + 1500)]
    cell = SimpleNamespace(config=CONFIG,
                           params={"batch_size": 24, "npoint": 2048})
    return SimpleNamespace(trace=Trace(_Prof(events), "cuda"), cell=cell)


def test_reads_the_bound_over_the_ranges_device_time():
    want = 100.0 * 1.1217055952238806 / 0.5
    assert metric.read(_run(["bn_eval"])) == pytest.approx(want, rel=1e-9)


def test_a_program_without_the_range_reads_none():
    assert metric.read(_run([])) is None
    assert metric.read(_run(["other"])) is None
    assert metric.read(SimpleNamespace(trace=None)) is None
