"""S3DIS scene semantic-segmentation loader (block sampling, host-side
numpy).

The port's copy of ``prifit_tpu/data/s3dis.py``: per-room
``Area_<i>_<room>.npy`` files of ``[N, 7]`` rows (xyz, rgb, label),
sampled in 1 m x 1 m blocks of ``num_point`` points, with the train/test
split by held-out area.  Every draw comes from the ``np.random.Generator``
passed in, in the JAX package's order, so items equal its items bit for
bit for the same seed.
"""

import os
import os.path as osp

import numpy as np

# the 13 S3DIS classes (reference data_utils/meta/class_names.txt)
S3DIS_CLASSES = [
    "ceiling", "floor", "wall", "beam", "column", "window", "door",
    "table", "chair", "sofa", "bookcase", "board", "clutter",
]


class S3DISDataset:
    """Block-sampled S3DIS rooms.

    Args:
        root: directory of ``Area_<i>_<room>.npy`` files ([N, 7]:
            xyz rgb label).
        num_point: points per block sample.
        test_area: held-out area index (1..6).
        split: "train" (all areas but test_area) or "test".
        block_size: xy extent of a sampled block in meters.
        with_rgb: include rgb (scaled to [0, 1]) -> 6 channels, else 3.
        rng: the source of every draw.
    """

    def __init__(self, root, num_point=4096, test_area=5, split="train",
                 block_size=1.0, with_rgb=True,
                 rng: np.random.Generator | None = None):
        self.num_point = num_point
        self.block_size = block_size
        self.with_rgb = with_rgb
        self.rng = rng if rng is not None else np.random.default_rng()

        rooms = sorted(f for f in os.listdir(root) if f.endswith(".npy"))
        tag = f"Area_{test_area}"
        if split == "train":
            rooms = [r for r in rooms if tag not in r]
        else:
            rooms = [r for r in rooms if tag in r]
        if not rooms:
            raise ValueError(f"no rooms for split={split} under {root}")

        self.room_points, self.room_labels = [], []
        n_per_room = []
        for r in rooms:
            data = np.load(osp.join(root, r))
            self.room_points.append(data[:, 0:6].astype(np.float32))
            self.room_labels.append(data[:, 6].astype(np.int32))
            n_per_room.append(data.shape[0])
        # rooms drawn in proportion to their point counts, one item per
        # num_point points (the classic epoch definition)
        total = sum(n_per_room)
        self.room_prob = np.asarray(n_per_room, np.float64) / total
        self.length = max(int(total // num_point), 1)

    def __len__(self):
        return self.length

    def __getitem__(self, index):
        ri = int(self.rng.choice(len(self.room_points), p=self.room_prob))
        pts = self.room_points[ri]
        labels = self.room_labels[ri]

        # draw a block center until the block holds more than 1024 points
        # (at most 10 draws; the last block is kept either way)
        for _ in range(10):
            center = pts[int(self.rng.integers(len(pts))), :3]
            half = self.block_size / 2.0
            mask = ((np.abs(pts[:, 0] - center[0]) <= half)
                    & (np.abs(pts[:, 1] - center[1]) <= half))
            if mask.sum() > 1024:
                break
        idx = np.where(mask)[0]
        choice = self.rng.choice(idx, self.num_point,
                                 replace=len(idx) < self.num_point)
        block = pts[choice].copy()
        seg = labels[choice]

        # center the block in xy, keep z absolute; rgb to [0, 1]
        block[:, 0:2] -= center[0:2]
        if self.with_rgb:
            block[:, 3:6] /= 255.0
            return block, seg
        return block[:, 0:3], seg
