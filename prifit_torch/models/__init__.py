"""Models of the port and their registry.

``get_module`` keeps the JAX package's registry rule
(``prifit_tpu/models/__init__.py``): a name is one of ``MODEL_NAMES``, and
any name containing ``"dgcnn"`` means ``dgcnn``; an unknown name raises
``ValueError``.  Ported are the six part-seg models the JAX trainers
build: ``pointnet2_part_seg_msg`` (with its ``extra_layers`` and
``reconstruct`` variants), ``pretrain_pointnet2_part_seg_msg``,
``pointnet2_part_seg_ssg``, ``pointnet_part_seg``, ``dgcnn`` and
``reconstruction``.  The classification and semantic-segmentation names
raise ``NotImplementedError`` (ROADMAP.md §1 item 4).
"""

import importlib

from prifit_torch.models import (
    common,
    dgcnn,
    pointnet2_part_seg_msg,
    pointnet2_part_seg_ssg,
    pointnet_part_seg,
    pretrain_pointnet2_part_seg_msg,
    reconstruction,
)
from prifit_torch.models.common import (
    SegOutput,
    nll_loss,
    pairwise_contrastive_loss,
)

MODEL_NAMES = (
    "pointnet2_part_seg_msg",
    "pretrain_pointnet2_part_seg_msg",
    "pointnet2_part_seg_ssg",
    "pointnet_part_seg",
    "pointnet_cls",
    "pointnet2_cls_ssg",
    "pointnet2_cls_msg",
    "pointnet_sem_seg",
    "pointnet2_sem_seg",
    "dgcnn",
    "reconstruction",
)
PORTED = ("pointnet2_part_seg_msg", "pretrain_pointnet2_part_seg_msg",
          "pointnet2_part_seg_ssg", "pointnet_part_seg", "dgcnn",
          "reconstruction")


def get_module(name: str):
    """Resolve a model module by its reference-compatible name."""
    if "dgcnn" in name:
        name = "dgcnn"
    if name not in MODEL_NAMES:
        raise ValueError(f"unknown model {name!r}; one of {MODEL_NAMES}")
    if name not in PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP.md §1 item 4); "
            f"ported: {PORTED}")
    return importlib.import_module(f"prifit_torch.models.{name}")


__all__ = ["MODEL_NAMES", "PORTED", "common", "dgcnn", "get_module",
           "pointnet2_part_seg_msg", "pointnet2_part_seg_ssg",
           "pointnet_part_seg", "pretrain_pointnet2_part_seg_msg",
           "reconstruction", "SegOutput", "nll_loss",
           "pairwise_contrastive_loss"]
