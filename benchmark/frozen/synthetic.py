"""Frozen copy of the port's synthetic ShapeNet-Part + ACD generator
(``prifit_torch/tools/synthetic_primitive_dataset.py`` at commit 0adee2a,
the ellipsoid family of ``make_lift_benchmark`` and what it calls), the
benchmark's traffic source.  Each shape is a union of ellipsoid surfaces;
the part label of a point is the ellipsoid it was sampled from, and an ACD
shape's component id is its primitive instance.  The same arguments write
the same files as the port's generator.
"""

import json
import os
import os.path as osp

import numpy as np

# category -> global part label ids (prifit_torch/data/shapenet.py)
SEG_CLASSES = {
    "Earphone": [16, 17, 18], "Motorbike": [30, 31, 32, 33, 34, 35],
    "Rocket": [41, 42, 43], "Car": [8, 9, 10, 11], "Laptop": [28, 29],
    "Cap": [6, 7], "Skateboard": [44, 45, 46], "Mug": [36, 37],
    "Guitar": [19, 20, 21], "Bag": [4, 5], "Lamp": [24, 25, 26, 27],
    "Table": [47, 48, 49], "Airplane": [0, 1, 2, 3],
    "Pistol": [38, 39, 40], "Chair": [12, 13, 14, 15], "Knife": [22, 23],
}

SYNSETS = {
    "Airplane": "02691156", "Bag": "02773838", "Cap": "02954340",
    "Car": "02958343", "Chair": "03001627", "Earphone": "03261776",
    "Guitar": "03467517", "Knife": "03624134", "Lamp": "03636649",
    "Laptop": "03642806", "Motorbike": "03790512", "Mug": "03797390",
    "Pistol": "03948459", "Rocket": "04099429", "Skateboard": "04225987",
    "Table": "04379243",
}
# categories by part-vocabulary size (>= 3 parts so subsets vary)
LIFT_ORDER = ["Motorbike", "Airplane", "Car", "Chair", "Lamp", "Guitar",
              "Earphone", "Rocket", "Skateboard", "Table", "Pistol"]


def _rot(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 2] *= -1
    return q


def _sample_shape(rng, template, n_points):
    """Sample one shape from a category template.

    Returns xyz [n, 3], normals [n, 3], part [n] in [0, P).
    """
    P = len(template)
    radii = np.stack([t["r"] * rng.uniform(0.7, 1.3, 3) for t in template])
    centers = np.stack([t["c"] + rng.normal(scale=0.15, size=3)
                        for t in template])
    rots = [t["R"] @ _rot_small(rng) for t in template]

    areas = np.array([np.prod(r) ** (2 / 3) for r in radii])
    counts = np.maximum((n_points * areas / areas.sum()).astype(int), 16)
    counts[-1] += n_points - counts.sum()

    xyz, nrm, part = [], [], []
    for p in range(P):
        u = rng.normal(size=(counts[p], 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        local = u * radii[p]
        # outward normal of an ellipsoid at (x,y,z): (x/a^2, y/b^2, z/c^2)
        n_local = u / radii[p]
        n_local /= np.linalg.norm(n_local, axis=1, keepdims=True)
        xyz.append(local @ rots[p].T + centers[p])
        nrm.append(n_local @ rots[p].T)
        part.append(np.full(counts[p], p))
    return (np.concatenate(xyz), np.concatenate(nrm),
            np.concatenate(part))


def _rot_small(rng, scale=0.2):
    a = rng.normal(scale=scale, size=3)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    from scipy.linalg import expm
    return expm(K)


def _template(rng, parts):
    return [dict(r=rng.uniform(0.4, 1.2, 3),
                 c=rng.normal(scale=1.2, size=3),
                 R=_rot(rng)) for _ in range(parts)]


def _subset_template(rng, pool):
    """Per-shape random part subset from a category pool + strong jitter
    (the hard-mode shape constructor, shared by labeled and ACD trees)."""
    pool_n = len(pool)
    present = rng.random(pool_n) < 0.6
    if present.sum() < 2:
        present[rng.choice(pool_n, 2, replace=False)] = True
    sub_ids = np.flatnonzero(present)
    tpl = [dict(r=pool[j]["r"] * rng.uniform(0.5, 1.6, 3),
                c=pool[j]["c"] + rng.normal(scale=0.4, size=3),
                R=pool[j]["R"] @ _rot_small(rng, 0.5))
           for j in sub_ids]
    return sub_ids, tpl


def make_lift_benchmark(root, n_cats=8, n_per_cat=40, n_acd=2000,
                        n_points=2048, seed=0):
    """Paper-proportioned benchmark of the ellipsoid family: ``n_cats``
    hard-mode categories of ``n_per_cat`` labelled shapes under
    ``root/shapenet`` and ``n_acd`` unlabelled ACD shapes drawn from the
    same category pools under ``root/acd``; deterministic given
    ``seed``."""
    names = LIFT_ORDER[:n_cats]
    rng_pool = np.random.default_rng(seed)
    make_tpl, sample = _template, _sample_shape
    pools = {n: make_tpl(rng_pool, len(SEG_CLASSES[n])) for n in names}

    # ---------------- labeled ShapeNet-Part tree
    sn_root = osp.join(root, "shapenet")
    os.makedirs(osp.join(sn_root, "train_test_split"), exist_ok=True)
    with open(osp.join(sn_root, "synsetoffset2category.txt"), "w") as f:
        for n in names:
            f.write(f"{n}\t{SYNSETS[n]}\n")
    rng_lab = np.random.default_rng(seed + 1)
    splits = {"train": [], "val": [], "test": []}
    for name in names:
        synset = SYNSETS[name]
        offset = SEG_CLASSES[name][0]
        d = osp.join(sn_root, synset)
        os.makedirs(d, exist_ok=True)
        for i in range(n_per_cat):
            token = f"{name.lower()}{i:04d}"
            sub_ids, tpl = _subset_template(rng_lab, pools[name])
            xyz, nrm, part = sample(rng_lab, tpl, n_points)
            seg = sub_ids[part] + offset
            data = np.concatenate(
                [xyz, nrm, seg[:, None]], axis=1).astype(np.float32)
            np.savetxt(osp.join(d, token + ".txt"), data, fmt="%.6f")
            split = ("train" if i < n_per_cat // 2 else
                     "val" if i < 3 * n_per_cat // 4 else "test")
            splits[split].append(f"shape_data/{synset}/{token}")
    for split, items in splits.items():
        with open(osp.join(sn_root, "train_test_split",
                           f"shuffled_{split}_file_list.json"), "w") as f:
            json.dump(items, f)

    # ---------------- unlabeled ACD tree from the same pools
    acd_root = osp.join(root, "acd")
    d = osp.join(acd_root, "shapes")
    os.makedirs(d, exist_ok=True)
    rng_acd = np.random.default_rng(seed + 2)
    for i in range(n_acd):
        name = names[int(rng_acd.integers(len(names)))]
        _, tpl = _subset_template(rng_acd, pools[name])
        xyz, _, part = sample(rng_acd, tpl, n_points)
        data = np.concatenate(
            [xyz, part[:, None]], axis=1).astype(np.float32)
        np.save(osp.join(d, f"acd{i:05d}.npy"), data)
    return sn_root, acd_root
