"""Per-sample mean IoU over a fixed class count.

Rebuilds ``src/eval_utils.py:3-14`` exactly (eps-smoothed IoU averaged
over ALL C classes, present or not) — distinct from the category-masked
protocol in :mod:`prifit_torch.eval.miou`.  The port's copy of
``prifit_tpu/eval/eval_utils.py``.
"""

import numpy as np

_EPS = np.finfo(np.float32).eps


def mean_IOU_one_sample(pred: np.ndarray, gt: np.ndarray, C: int) -> float:
    iou = 0.0
    for label_idx in range(C):
        in_gt = gt == label_idx
        in_pred = pred == label_idx
        i = np.sum(np.logical_and(in_gt, in_pred)) + _EPS
        u = np.sum(np.logical_or(in_gt, in_pred)) + _EPS
        iou += i / u
    return iou / C
