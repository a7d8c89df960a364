"""ShapeNet-Part / ACD dataset loaders (host-side numpy).

The port's copy of ``prifit_tpu/data/shapenet.py``: the same files,
splits and per-item draws, so batches equal the JAX package's bit for
bit.

Reference-compatible rebuilds of the four Dataset classes in
``data_utils/ShapeNetDataLoader.py`` with the reference's latent breakages
fixed (SURVEY.md §2.9.4): the in-RAM cache is actually *read* on hits (the
reference stores into a dead ``ppoint_set`` local), the ACD k-shot path
doesn't reference an undefined global, and all sampling randomness comes
from an explicit ``np.random.Generator`` instead of the global ``random``
state.

Semantics preserved:
  - directory layout: ``synsetoffset2category.txt`` + ``train_test_split``
    jsons + per-synset ``.txt`` point files (xyz [+normal] + seg label);
  - per-category k-shot subsampling (``ShapeNetDataLoader.py:78-79``);
  - unit-sphere ``pc_normalize`` (``:17-22``);
  - resample to ``npoints`` WITH replacement per access (``:132-134``);
  - self-sup variant excludes files in the labeled set (``:185``);
  - ACD loader reads ``.npy`` with the last column = ACD component id,
    returns the 4-tuple ``(points, chamfer_points, cls, seg)`` where
    ``chamfer_points`` is the full-resolution normalized cloud (``:407``);
  - ACD 80/20 ``use_val`` split via random subsampling (``:321-323``).
"""

import json
import math
import os
import os.path as osp

import numpy as np

from prifit_torch.native import fast_loadtxt

# category -> global part label ids (ShapeNetDataLoader.py:100-105)
SEG_CLASSES = {
    "Earphone": [16, 17, 18], "Motorbike": [30, 31, 32, 33, 34, 35],
    "Rocket": [41, 42, 43], "Car": [8, 9, 10, 11], "Laptop": [28, 29],
    "Cap": [6, 7], "Skateboard": [44, 45, 46], "Mug": [36, 37],
    "Guitar": [19, 20, 21], "Bag": [4, 5], "Lamp": [24, 25, 26, 27],
    "Table": [47, 48, 49], "Airplane": [0, 1, 2, 3],
    "Pistol": [38, 39, 40], "Chair": [12, 13, 14, 15], "Knife": [22, 23],
}


def pc_normalize(pc: np.ndarray) -> np.ndarray:
    """Center + scale to the unit sphere (``ShapeNetDataLoader.py:17-22``)."""
    centroid = np.mean(pc, axis=0)
    pc = pc - centroid
    m = np.max(np.sqrt(np.sum(pc ** 2, axis=1)))
    return pc / m


def _read_split_ids(root: str, name: str) -> set:
    path = osp.join(root, "train_test_split",
                    f"shuffled_{name}_file_list.json")
    with open(path) as f:
        return {str(d.split("/")[2]) for d in json.load(f)}


class PartNormalDataset:
    """Labeled ShapeNet-Part loader (``ShapeNetDataLoader.py:24-140``)."""

    def __init__(self, root, npoints=2500, split="train", class_choice=None,
                 normal_channel=False, k_shot=-1,
                 rng: np.random.Generator | None = None):
        self.npoints = npoints
        self.root = root
        self.normal_channel = normal_channel
        self.k_shot = k_shot
        self.rng = rng if rng is not None else np.random.default_rng()

        self.cat = {}
        with open(osp.join(root, "synsetoffset2category.txt")) as f:
            for line in f:
                ls = line.strip().split()
                self.cat[ls[0]] = ls[1]
        self.classes_original = dict(zip(self.cat, range(len(self.cat))))
        if class_choice is not None:
            self.cat = {k: v for k, v in self.cat.items()
                        if k in class_choice}

        train_ids = _read_split_ids(root, "train")
        val_ids = _read_split_ids(root, "val")
        test_ids = _read_split_ids(root, "test")

        self.meta = {}
        for item in self.cat:
            dir_point = osp.join(root, self.cat[item])
            fns = sorted(os.listdir(dir_point))
            if split == "trainval":
                fns = [fn for fn in fns
                       if fn[0:-4] in train_ids or fn[0:-4] in val_ids]
            elif split == "train":
                fns = [fn for fn in fns if fn[0:-4] in train_ids]
            elif split == "val":
                fns = [fn for fn in fns if fn[0:-4] in val_ids]
            elif split == "val2":
                # half-size random subset of test (reference :68-70)
                fns = [fn for fn in fns if fn[0:-4] in test_ids]
                count = round((len(fns) / 2874) * 1870)
                fns = list(self.rng.choice(fns, count, replace=False))
            elif split == "test":
                fns = [fn for fn in fns if fn[0:-4] in test_ids]
            else:
                raise ValueError(f"Unknown split: {split}")

            if 0 < self.k_shot < len(fns):
                fns = list(self.rng.choice(fns, self.k_shot, replace=False))

            self.meta[item] = [
                osp.join(dir_point, osp.splitext(osp.basename(fn))[0]
                         + ".txt") for fn in fns]

        self.datapath = [(item, fn) for item in self.cat
                         for fn in self.meta[item]]
        self.classes = {i: self.classes_original[i] for i in self.cat}
        self.seg_classes = SEG_CLASSES
        self.cache = {}
        self.cache_size = 20000

    def _load(self, index):
        if index in self.cache:
            return self.cache[index]
        cat, fn = self.datapath[index]
        cls = np.array([self.classes[cat]], dtype=np.int32)
        data = fast_loadtxt(fn).astype(np.float32)
        point_set = data[:, 0:6] if self.normal_channel else data[:, 0:3]
        seg = data[:, -1].astype(np.int32)
        if len(self.cache) < self.cache_size:
            self.cache[index] = (point_set, cls, seg)
        return point_set, cls, seg

    def get(self, index, rng: np.random.Generator | None = None):
        """Item access with an explicit rng for the resample-with-
        replacement, so DataLoader worker threads stay deterministic
        (loader.py).  ``__getitem__`` uses the dataset's own rng."""
        rng = self.rng if rng is None else rng
        point_set, cls, seg = self._load(index)
        point_set = point_set.copy()
        point_set[:, 0:3] = pc_normalize(point_set[:, 0:3])
        choice = rng.choice(len(seg), self.npoints, replace=True)
        return point_set[choice, :], cls, seg[choice]

    def __getitem__(self, index):
        return self.get(index)

    def __len__(self):
        return len(self.datapath)


class SelfSupPartNormalDataset(PartNormalDataset):
    """PartNormalDataset minus the labeled files — the "dummy" self-sup
    source (``ShapeNetDataLoader.py:149-255``)."""

    def __init__(self, root, npoints=2500, split="train", class_choice=None,
                 normal_channel=False, k_shot=-1, labeled_fns=(),
                 rng: np.random.Generator | None = None):
        self._labeled_files = {osp.basename(x) for x in labeled_fns}
        super().__init__(root, npoints=npoints, split=split,
                         class_choice=class_choice,
                         normal_channel=normal_channel, k_shot=-1, rng=rng)
        # exclusion + k-shot re-applied post-hoc (same resulting set as the
        # reference's in-loop filtering; sorted order matches its
        # sorted(set - set))
        self.meta = {
            item: sorted(fn for fn in fns
                         if osp.basename(fn) not in self._labeled_files)
            for item, fns in self.meta.items()}
        if k_shot > 0:
            self.meta = {item: list(self.rng.choice(fns, k_shot,
                                                    replace=False))
                         if len(fns) > k_shot else fns
                         for item, fns in self.meta.items()}
        self.k_shot = k_shot
        self.datapath = [(item, fn) for item in self.cat
                         for fn in self.meta[item]]
        self.cache = {}


class ACDSelfSupDataset:
    """Unlabeled clouds with precomputed ACD component labels
    (``ShapeNetDataLoader.py:265-410``).

    ``__getitem__`` returns the 4-tuple
    ``(point_set [npoints, 3|6], chamfer_points [full, 3|6], cls [1],
    seg [npoints])`` — ``chamfer_points`` is the full-resolution normalized
    cloud used as the chamfer target.
    """

    def __init__(self, root, npoints=2500, class_choice=None,
                 normal_channel=False, k_shot=-1, exclude_fns=(),
                 splits=None, use_val=False, prefetch=False,
                 rng: np.random.Generator | None = None):
        self.npoints = npoints
        self.root = root
        self.normal_channel = normal_channel
        self.k_shot = k_shot
        self.use_val = use_val
        self.rng = rng if rng is not None else np.random.default_rng()
        exclude = {osp.splitext(osp.basename(f))[0] for f in exclude_fns}

        subfolders = sorted(os.listdir(root))
        self.classes_original = dict(zip(subfolders, range(len(subfolders))))
        self.cat = self.classes_original

        self.meta = {}
        for item in self.cat:
            dir_point = osp.join(root, item)
            fns = [f for f in os.listdir(dir_point) if f.endswith(".npy")]
            if exclude:
                fns = sorted({osp.splitext(osp.basename(f))[0]
                              for f in fns} - exclude)
            else:
                fns = sorted(osp.splitext(osp.basename(f))[0] for f in fns)
            num_samples = len(fns)
            if self.k_shot > 0 and len(fns) > self.k_shot:
                fns = list(self.rng.choice(fns, self.k_shot, replace=False))
            if self.use_val:
                # fixed 80/20 train/val split per category (:321-323)
                n = math.floor(num_samples * 0.8)
                fns = list(self.rng.choice(fns, min(n, len(fns)),
                                           replace=False))
            self.meta[item] = [osp.join(dir_point, t + ".npy") for t in fns]

        self.datapath = [(item, fn) for item in self.cat
                         for fn in self.meta[item]]
        self.classes = {i: self.classes_original[i] for i in self.cat}
        self.cache = {}
        self.cache_size = len(self.datapath)
        self.prefetch = prefetch
        if prefetch:
            # the reference eagerly materializes everything (:344-368);
            # with the cache fixed this is just a warm-up pass
            for i in range(len(self.datapath)):
                self._load(i)

    def _load(self, index):
        if index in self.cache:
            return self.cache[index]
        cat, fn = self.datapath[index]
        cls = np.array([self.classes[cat]], dtype=np.int32)
        data = np.load(fn).astype(np.float32)
        point_set = data[:, 0:6] if self.normal_channel else data[:, 0:3]
        seg = data[:, -1].astype(np.int32)
        if len(self.cache) < self.cache_size:
            self.cache[index] = (point_set, cls, seg)
        return point_set, cls, seg

    def get(self, index, rng: np.random.Generator | None = None):
        """See ``PartNormalDataset.get`` (worker-deterministic rng)."""
        rng = self.rng if rng is None else rng
        point_set, cls, seg = self._load(index)
        point_set = point_set.copy()
        point_set[:, 0:3] = pc_normalize(point_set[:, 0:3])
        choice = rng.choice(len(seg), self.npoints, replace=True)
        chamfer_points = point_set[:, :]
        return point_set[choice, :], chamfer_points, cls, seg[choice]

    def __getitem__(self, index):
        return self.get(index)

    def __len__(self):
        return len(self.datapath)


class MultiACDSelfSupDataset(ACDSelfSupDataset):
    """ACD variant returning the 3-tuple ``(points, cls, seg)`` without
    chamfer points (``ShapeNetDataLoader.py:417-520``; unused by the
    reference entry points, kept for surface parity)."""

    def get(self, index, rng: np.random.Generator | None = None):
        rng = self.rng if rng is None else rng
        point_set, cls, seg = self._load(index)
        point_set = point_set.copy()
        point_set[:, 0:3] = pc_normalize(point_set[:, 0:3])
        choice = rng.choice(len(seg), self.npoints, replace=True)
        return point_set[choice, :], cls, seg[choice]

    def __getitem__(self, index):
        return self.get(index)
