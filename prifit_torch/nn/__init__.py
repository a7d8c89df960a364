"""Network blocks (port of ``prifit_tpu/nn``).  The JAX package's
``PointMLP`` module has no class here: its 1x1 conv + batch norm + relu
chain is the function :func:`prifit_torch.nn.pointnet2.point_mlp` over
the owning layer's ``convs`` and ``bns``."""

from prifit_torch.nn import norm, pointnet2
from prifit_torch.nn.norm import BatchNorm
from prifit_torch.nn.pointnet2 import (
    SetAbstraction,
    SetAbstractionMsg,
    FeaturePropagation,
)
from prifit_torch.nn.pointnet import (
    STN,
    PointNetEncoder,
    feature_transform_regularizer,
)
from prifit_torch.nn.dgcnn import DGCNNEncoderGn, DGCNNGn
from prifit_torch.nn.atlasnet import PointGenCon, AtlasNet

__all__ = [
    "norm",
    "pointnet2",
    "BatchNorm",
    "SetAbstraction",
    "SetAbstractionMsg",
    "FeaturePropagation",
    "STN",
    "PointNetEncoder",
    "feature_transform_regularizer",
    "DGCNNEncoderGn",
    "DGCNNGn",
    "PointGenCon",
    "AtlasNet",
]
