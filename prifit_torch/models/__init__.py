"""Models of the port and their registry.

``get_module`` keeps the JAX package's registry rule
(``prifit_tpu/models/__init__.py``): a name is one of ``MODEL_NAMES``, and
any name containing ``"dgcnn"`` means ``dgcnn``; an unknown name raises
``ValueError``.  Every name is ported: the six part-seg models the JAX
trainers build (``pointnet2_part_seg_msg`` with its ``extra_layers`` and
``reconstruct`` variants, ``pretrain_pointnet2_part_seg_msg``,
``pointnet2_part_seg_ssg``, ``pointnet_part_seg``, ``dgcnn``,
``reconstruction``), the ModelNet40 classifiers (``pointnet_cls``,
``pointnet2_cls_ssg``, ``pointnet2_cls_msg``) and the S3DIS
semantic-segmentation models (``pointnet_sem_seg``,
``pointnet2_sem_seg``).  The last five take no category one-hot and
return ``(log-probs, aux)`` tuples, as their JAX models do.
"""

import importlib

from prifit_torch.models import (
    common,
    dgcnn,
    pointnet2_cls_msg,
    pointnet2_cls_ssg,
    pointnet2_part_seg_msg,
    pointnet2_part_seg_ssg,
    pointnet2_sem_seg,
    pointnet_cls,
    pointnet_part_seg,
    pointnet_sem_seg,
    pretrain_pointnet2_part_seg_msg,
    reconstruction,
)
from prifit_torch.models.common import (
    SegOutput,
    chamfer_loss_dense,
    nll_loss,
    pairwise_contrastive_loss,
    to_categorical,
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
# the models the part-seg trainers build; the others take no category
# one-hot and return tuples
PART_SEG = ("pointnet2_part_seg_msg", "pretrain_pointnet2_part_seg_msg",
            "pointnet2_part_seg_ssg", "pointnet_part_seg", "dgcnn",
            "reconstruction")


def get_module(name: str):
    """Resolve a model module by its reference-compatible name."""
    if "dgcnn" in name:
        name = "dgcnn"
    if name not in MODEL_NAMES:
        raise ValueError(f"unknown model {name!r}; one of {MODEL_NAMES}")
    return importlib.import_module(f"prifit_torch.models.{name}")


__all__ = ["MODEL_NAMES", "PART_SEG", "common", "dgcnn",
           "get_module", "pointnet2_cls_msg", "pointnet2_cls_ssg",
           "pointnet2_part_seg_msg", "pointnet2_part_seg_ssg",
           "pointnet2_sem_seg", "pointnet_cls", "pointnet_part_seg",
           "pointnet_sem_seg", "pretrain_pointnet2_part_seg_msg",
           "reconstruction", "SegOutput", "chamfer_loss_dense",
           "nll_loss", "pairwise_contrastive_loss", "to_categorical"]
