"""Input pipeline (port of ``prifit_tpu/data``: the ShapeNet-Part and ACD
datasets, the loader with device prefetch, the host augmentations and
their on-device counterparts; ModelNet and S3DIS are not ported yet)."""

from prifit_torch.data import augment_torch, provider
from prifit_torch.data.augment import Augment
from prifit_torch.data.loader import DataLoader, prefetch_to_device
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
    "prefetch_to_device",
    "Augment",
    "augment_torch",
    "provider",
]
