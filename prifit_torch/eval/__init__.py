"""Part-segmentation evaluation (port of ``prifit_tpu/eval``: ``miou`` and
``eval_utils``; the SVM probe is not ported yet)."""

from prifit_torch.eval.eval_utils import mean_IOU_one_sample
from prifit_torch.eval.miou import (
    batch_shape_ious,
    category_masked_argmax,
    evaluation,
    make_eval_forward,
    mean_iou_one_sample,
)

__all__ = [
    "batch_shape_ious",
    "category_masked_argmax",
    "evaluation",
    "make_eval_forward",
    "mean_IOU_one_sample",
    "mean_iou_one_sample",
]
