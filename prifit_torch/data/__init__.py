"""Input pipeline (port of ``prifit_tpu/data``: the ShapeNet-Part, ACD,
ModelNet40 and S3DIS datasets, the loader with device prefetch, the host
augmentations and their on-device counterparts)."""

from prifit_torch.data import augment_torch, provider
from prifit_torch.data.augment import Augment
from prifit_torch.data.loader import DataLoader, prefetch_to_device, \
    shard_for_host
from prifit_torch.data.modelnet import ModelNetDataLoader
from prifit_torch.data.s3dis import S3DIS_CLASSES, S3DISDataset
from prifit_torch.data.shapenet import (
    SEG_CLASSES,
    ACDSelfSupDataset,
    MultiACDSelfSupDataset,
    PartNormalDataset,
    SelfSupPartNormalDataset,
    pc_normalize,
)

__all__ = [
    "SEG_CLASSES",
    "pc_normalize",
    "PartNormalDataset",
    "SelfSupPartNormalDataset",
    "ACDSelfSupDataset",
    "MultiACDSelfSupDataset",
    "DataLoader",
    "shard_for_host",
    "ModelNetDataLoader",
    "S3DISDataset",
    "S3DIS_CLASSES",
    "prefetch_to_device",
    "Augment",
    "augment_torch",
    "provider",
]
