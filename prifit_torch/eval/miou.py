"""Part-segmentation evaluation: accuracy + instance/class mIoU.

Port of ``prifit_tpu/eval/miou.py`` (reference ``testing.py:49-254`` and
``src/eval_utils.py:3``):

  - per-shape argmax restricted to the shape's own category's part labels
    (``testing.py:144-147``), a precomputed [16, num_parts] mask applied
    on the device;
  - per-shape part IoU with the absent-part rule: a part that appears in
    neither the label nor the prediction counts as IoU 1
    (``testing.py:189-201``), in numpy on the host;
  - instance mIoU = mean over shapes; class mIoU = mean of per-category
    means (``:219-233``); accuracy + per-class accuracy (``:166-174``);
  - best-metric update keyed on class-avg mIoU (``:234-243``).
"""

import numpy as np
import torch

from prifit_torch.data.shapenet import SEG_CLASSES
from prifit_torch.utils.device import resolve_device

CATEGORY_NAMES = sorted(SEG_CLASSES.keys())


def _category_tables(num_parts: int = 50):
    """(cat_of_part [num_parts], part_mask [16, num_parts])."""
    # the PartNormalDataset class id order is dataset dependent;
    # evaluation only needs the part->category grouping, which is fixed
    # by SEG_CLASSES.  Categories here are indexed alphabetically.
    cat_of_part = np.zeros(num_parts, np.int32)
    mask = np.zeros((len(CATEGORY_NAMES), num_parts), bool)
    for ci, cat in enumerate(CATEGORY_NAMES):
        for l in SEG_CLASSES[cat]:
            cat_of_part[l] = ci
            mask[ci, l] = True
    return cat_of_part, mask


def category_masked_argmax(seg_logits: torch.Tensor,
                           first_label: torch.Tensor,
                           num_parts: int = 50) -> torch.Tensor:
    """Argmax restricted to the parts of each shape's category, on
    ``seg_logits``' device.

    The category is identified from the first ground-truth label exactly
    like the reference (``testing.py:143-147`` uses ``target[i, 0]``).
    Ties go to the lowest part id, as ``jnp.argmax``'s do.

    Args:
        seg_logits: ``[B, N, num_parts]``.
        first_label: ``[B]`` any ground-truth part label of each shape.
    Returns:
        ``[B, N]`` int32 predictions in the category's label range.
    """
    cat_of_part, mask = _category_tables(num_parts)
    dev = seg_logits.device
    cat = torch.as_tensor(cat_of_part, device=dev)[first_label.long()]
    m = torch.as_tensor(mask, device=dev)[cat]                  # [B, P]
    masked = torch.where(m[:, None, :], seg_logits,
                         torch.full_like(seg_logits, -float("inf")))
    return torch.argmax(masked, dim=-1).to(torch.int32)


def mean_iou_one_sample(pred: np.ndarray, target: np.ndarray,
                        cat: str) -> float:
    """Per-shape mean part IoU with the absent-part => IoU 1 rule
    (``testing.py:189-201``, ``src/eval_utils.py:3``)."""
    parts = SEG_CLASSES[cat]
    ious = []
    for l in parts:
        in_l, in_p = target == l, pred == l
        if not in_l.any() and not in_p.any():
            ious.append(1.0)
        else:
            ious.append(float((in_l & in_p).sum()) /
                        float((in_l | in_p).sum()))
    return float(np.mean(ious))


def _bincount_rows(labels: np.ndarray, num_parts: int) -> np.ndarray:
    """Per-row bincount: ``[B, N]`` int labels -> ``[B, num_parts]``."""
    B = labels.shape[0]
    off = np.arange(B)[:, None] * num_parts
    return np.bincount((labels + off).ravel(),
                       minlength=B * num_parts).reshape(B, num_parts)


def batch_shape_ious(pred: np.ndarray, target: np.ndarray,
                     num_parts: int = 50):
    """Vectorized per-shape mean part IoU (``testing.py:189-201``), the
    same math as :func:`mean_iou_one_sample` including the absent-part
    => IoU 1 rule, as one ``[B, num_parts]`` masked computation.

    Returns:
        (per_shape_iou [B], cat_idx [B], inter [B, P], cnt_tgt [B, P])
        — the count matrices feed the running accuracy counters.
    """
    cat_of_part, part_mask = _category_tables(num_parts)
    cnt_t = _bincount_rows(target, num_parts)
    cnt_p = _bincount_rows(pred, num_parts)
    match = np.where(pred == target, target, num_parts)
    inter = _bincount_rows(match, num_parts + 1)[:, :num_parts]
    union = cnt_t + cnt_p - inter
    iou = np.where(union > 0, inter / np.maximum(union, 1), 1.0)
    cat_idx = cat_of_part[target[:, 0]]
    m = part_mask[cat_idx]                                  # [B, P] bool
    per_shape = (iou * m).sum(1) / m.sum(1)
    return per_shape, cat_idx, inter, cnt_t


def make_eval_forward(model):
    """``forward(points, cls_onehot) -> seg log-probs``: ``model`` in eval
    mode under ``torch.no_grad``."""

    def forward(points, cls_onehot):
        model.eval()
        with torch.no_grad():
            return model(points, cls_onehot).seg_logits

    return forward


def _onehot(cls, num_classes: int = 16) -> np.ndarray:
    return np.eye(num_classes, dtype=np.float32)[np.asarray(cls).ravel()]


def evaluation(forward, data_loader, *, num_parts: int = 50,
               metrics: dict | None = None, epoch: int = 0,
               chamfer_values=(), device=None,
               pad_to: int | None = None, log=print) -> dict:
    """Full test-set evaluation (reference ``evaluation``, testing.py:49).

    Args:
        forward: ``(points [B, N, C], cls_onehot [B, 16]) -> logits``
            tensors.
        data_loader: yields ``(points, cls, target)`` numpy batches.
        metrics: running best-metric dict, updated in place keyed on
            class-avg mIoU (``testing.py:237``); pass {} or None for a
            standalone run.
        chamfer_values: optional per-batch chamfer losses to average into
            the metrics (the reference model returns 0 in eval mode).
        device: where the forward's inputs go (CUDA unless named;
            raises without a GPU).
        pad_to: pad short tail batches (``drop_last=False``) up to this
            size by repeating the last shape, so the forward sees one
            shape; padded rows are dropped from every metric.
    Returns:
        metrics dict with accuracy / class_avg_accuracy / class_avg_iou /
        instance_avg_iou / chamfer_loss (+ best_* when tracking).
    """
    device = resolve_device(device)
    total_correct = 0
    total_seen = 0
    total_seen_class = np.zeros(num_parts)
    total_correct_class = np.zeros(num_parts)
    shape_ious = {cat: [] for cat in SEG_CLASSES}

    for points, cls, target in data_loader:
        b0 = points.shape[0]
        padded = pad_to is not None and b0 < pad_to
        if padded:
            rep = [1] * (b0 - 1) + [pad_to - b0 + 1]
            points = np.repeat(points, rep, axis=0)
            cls = np.repeat(np.asarray(cls), rep, axis=0)
        points = np.ascontiguousarray(points, np.float32)
        logits = forward(torch.as_tensor(points, device=device),
                         torch.as_tensor(_onehot(cls), device=device))
        first = np.repeat(target[:, 0], rep, axis=0) if padded \
            else target[:, 0]
        pred = category_masked_argmax(
            logits, torch.as_tensor(first.astype(np.int64),
                                    device=logits.device), num_parts)
        pred = pred.cpu().numpy()[:b0]

        per_shape, cat_idx, inter, cnt_t = batch_shape_ious(
            pred, target, num_parts)
        total_correct += int((pred == target).sum())
        total_seen += target.size
        total_seen_class += cnt_t.sum(0)
        total_correct_class += inter.sum(0)
        for ci in np.unique(cat_idx):
            shape_ious[CATEGORY_NAMES[ci]].extend(
                per_shape[cat_idx == ci].tolist())

    all_shape_ious = [iou for v in shape_ious.values() for iou in v]
    cat_means = {cat: float(np.mean(v)) for cat, v in shape_ious.items()
                 if v}

    test_metrics = {
        "accuracy": total_correct / max(float(total_seen), 1.0),
        "class_avg_accuracy": float(np.mean(
            total_correct_class[total_seen_class > 0]
            / total_seen_class[total_seen_class > 0]))
        if (total_seen_class > 0).any() else 0.0,
        "class_avg_iou": float(np.mean(list(cat_means.values())))
        if cat_means else 0.0,
        "instance_avg_iou": float(np.mean(all_shape_ious))
        if all_shape_ious else 0.0,
        "chamfer_loss": float(np.mean(chamfer_values))
        if len(chamfer_values) else 0.0,
    }
    for cat in sorted(cat_means):
        log("eval mIoU of %s %f" % (cat + " " * (14 - len(cat)),
                                    cat_means[cat]))

    if metrics:
        if metrics.get("best_class_avg_miou", -1.0) \
                <= test_metrics["class_avg_iou"]:
            metrics["best_chamfer_loss"] = test_metrics["chamfer_loss"]
            metrics["best_epoch"] = epoch + 1
            metrics["best_acc"] = test_metrics["accuracy"]
            metrics["best_class_avg_miou"] = test_metrics["class_avg_iou"]
            metrics["best_instance_avg_miou"] = \
                test_metrics["instance_avg_iou"]
        metrics.update({k: v for k, v in test_metrics.items()})
        log("Best test Accuracy: {:.6f}, Best Epoch: {}, Best Class avg "
            "mIOU: {:.6f}, Best Instance avg mIOU: {:.6f}".format(
                metrics["best_acc"], metrics["best_epoch"],
                metrics["best_class_avg_miou"],
                metrics["best_instance_avg_miou"]))
        return metrics

    log("Test Accuracy: %f,  Class avg mIOU: %f,  Instance avg mIOU: %f"
        % (test_metrics["accuracy"], test_metrics["class_avg_iou"],
           test_metrics["instance_avg_iou"]))
    return test_metrics
