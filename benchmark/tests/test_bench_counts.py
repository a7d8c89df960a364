"""The configurations' operation counts against PyTorch's flop counter
on the reference at a small size, and the mean-shift bound against a
hand count."""

import os.path as osp
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, osp.dirname(osp.dirname(osp.dirname(
    osp.abspath(__file__)))))

from benchmark import weights  # noqa: E402
from benchmark.counts import dgcnn, pointnet2_msg  # noqa: E402
from benchmark.frozen.roofline import mean_shift_bound_ms  # noqa: E402
from benchmark.reference.train import build_model  # noqa: E402

CASES = [
    ({"model": "pointnet2_part_seg_msg", "num_parts": 50,
      "encoder_dtype": "f32"}, pointnet2_msg),
    ({"model": "pointnet2_part_seg_msg", "num_parts": 50,
      "encoder_dtype": "auto"}, pointnet2_msg),
    ({"model": "dgcnn", "num_parts": 50, "dgcnn_k": 20}, dgcnn),
]


@pytest.mark.parametrize("p,counts", CASES,
                         ids=["msg_f32", "msg_auto", "dgcnn"])
@pytest.mark.parametrize("B,N", [(2, 256), (1, 160)])
def test_encoder_count_equals_the_flop_counter(p, counts, B, N):
    model = build_model(p, "cpu")
    weights.init_(model, 3, "cpu")
    model.eval()
    x = torch.randn(B, N, 3, generator=torch.Generator().manual_seed(0))
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model(x, torch.zeros(B, 16))
    assert counts.encoder_flops(B, N) == fc.get_total_flops()


def test_mean_shift_bound_by_hand():
    # 10 steps of B=24 shapes of 2048 rows of width 128: two products of
    # 2 N^2 D flops a step, each three TF32 passes, at 495 TFLOP/s
    tf32 = 10 * 2 * (2 * 2048 * 2048 * 128) * 24 * 3
    ms, by = mean_shift_bound_ms(24, 2048, 128, 10)
    assert by == "operations"
    assert ms == pytest.approx(tf32 / 495e12 * 1e3 + 10 * 24 * 2048 ** 2
                               / 67e12 * 1e3, rel=1e-12)
    assert ms == pytest.approx(3.1386, abs=1e-3)
