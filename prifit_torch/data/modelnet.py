"""ModelNet40 loader (host-side numpy).

The port's copy of ``prifit_tpu/data/modelnet.py``: the
``modelnet40_normal_resampled`` layout of the PointNet++ codebase family,

    ROOT/modelnet40_shape_names.txt       one class name per line
    ROOT/modelnet40_{train,test}.txt      shape ids, e.g. airplane_0001
    ROOT/<class>/<shape_id>.txt           csv rows: x,y,z,nx,ny,nz

An item is ``(points [npoint, 6 or 3] f32, cls [1] int32)``: the first
``npoint`` rows of the file (with ``uniform``, ``npoint`` rows at an even
stride instead), xyz normalized to the unit sphere.  It draws nothing, so
items equal the JAX package's bit for bit.
"""

import os.path as osp

import numpy as np

from prifit_torch.data.shapenet import pc_normalize
from prifit_torch.native import fast_loadtxt


class ModelNetDataLoader:
    def __init__(self, root, npoint=1024, split="train",
                 normal_channel=True, uniform=False):
        self.root = root
        self.npoints = npoint
        self.normal_channel = normal_channel
        self.uniform = uniform

        with open(osp.join(root, "modelnet40_shape_names.txt")) as f:
            self.cat = [line.strip() for line in f if line.strip()]
        self.classes = dict(zip(self.cat, range(len(self.cat))))

        with open(osp.join(root, f"modelnet40_{split}.txt")) as f:
            shape_ids = [line.strip() for line in f if line.strip()]
        # class name = shape id minus its trailing _NNNN
        names = ["_".join(s.split("_")[0:-1]) for s in shape_ids]
        self.datapath = [
            (names[i], osp.join(root, names[i], shape_ids[i] + ".txt"))
            for i in range(len(shape_ids))]
        self.cache = {}

    def __len__(self):
        return len(self.datapath)

    def __getitem__(self, index):
        if index in self.cache:
            point_set, cls = self.cache[index]
        else:
            cat, fn = self.datapath[index]
            cls = np.array([self.classes[cat]], dtype=np.int32)
            point_set = fast_loadtxt(fn).astype(np.float32)
            self.cache[index] = (point_set, cls)
        if self.uniform:
            idx = np.linspace(0, point_set.shape[0] - 1, self.npoints,
                              dtype=np.int64)
            pts = point_set[idx].copy()
        else:
            pts = point_set[: self.npoints].copy()
        pts[:, 0:3] = pc_normalize(pts[:, 0:3])
        if not self.normal_channel:
            pts = pts[:, 0:3]
        return pts, cls
