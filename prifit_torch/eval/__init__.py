"""Evaluation (port of ``prifit_tpu/eval``): part-segmentation mIoU
(``miou``, ``eval_utils``) and the ModelNet40 linear-SVM probe
(``svm_probe``)."""

from prifit_torch.eval.eval_utils import mean_IOU_one_sample
from prifit_torch.eval.miou import (
    batch_shape_ious,
    category_masked_argmax,
    evaluation,
    make_eval_forward,
    mean_iou_one_sample,
)
from prifit_torch.eval.svm_probe import (
    LinearSVC,
    extract_global_features,
    make_feature_forward,
    svm_probe,
)

__all__ = [
    "LinearSVC",
    "batch_shape_ious",
    "category_masked_argmax",
    "evaluation",
    "extract_global_features",
    "make_eval_forward",
    "make_feature_forward",
    "mean_IOU_one_sample",
    "mean_iou_one_sample",
    "svm_probe",
]
