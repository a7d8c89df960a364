"""Primitive-structured synthetic ShapeNet-Part + ACD datasets.

The port's copy of ``tools/synthetic_primitive_dataset.py``: every
generator, with the same seeds, draws in the same order and the same
``__main__`` flags, so the same arguments write byte-identical files
(``tests/test_torch_lift_tools.py`` holds every file against the
original's).  ``SEG_CLASSES`` comes from :mod:`prifit_torch.data.shapenet`.

    python -m prifit_torch.tools.synthetic_primitive_dataset <dir> --lift

writes the few-shot lift benchmark (8 hard-mode categories of 40 shapes,
2000 unlabelled ACD shapes, N=2048, seed 0) that
:mod:`prifit_torch.tools.run_fewshot_matrix` trains on.

Each shape is a union of ellipsoid surfaces; the part label of a point is
the ellipsoid it was sampled from.  This is exactly the PRIFIT hypothesis
(parts are well approximated by fitted primitives), so few-shot
segmentation on this data is the strongest end-to-end validation there
is without the real ShapeNet-Part/ACD downloads: the convex self-sup loss
should measurably improve mIoU over supervised-only training (the paper's
core claim).

Category construction (deterministic given the seed):
  - each category has a fixed number of parts P and a category "template"
    of P ellipsoid pose priors;
  - each shape perturbs the template (axis lengths, centers, rotation) and
    samples points on each ellipsoid surface proportional to its area.

Writes the reference's on-disk formats (ShapeNetDataLoader.py:29-52,
302-327): synsetoffset2category.txt + split jsons + per-synset .txt files
with xyz + normal + part label, and .npy ACD folders (xyz + component).
"""

import json
import os
import os.path as osp
import tempfile

import numpy as np

from prifit_torch.data.shapenet import SEG_CLASSES

# real category names/synsets so the mIoU harness' SEG_CLASSES category
# masking applies (data/shapenet.py); 3 of each category's valid global
# part ids are used (absent parts score IoU 1 per the reference rule)
CATS = {"Airplane": "02691156", "Chair": "03001627"}
PART_OFFSET = {"Airplane": 0, "Chair": 12}
PARTS_PER_CAT = 3

# hard mode: categories with the LARGEST part vocabularies, per-shape
# random part subsets from a category pool and strong pose jitter — a
# few labeled shapes cannot cover the category's layouts, which is the
# regime where the self-sup fitting loss has something to add
HARD_CATS = {"Motorbike": "03790512", "Lamp": "03636649"}
HARD_PART_OFFSET = {"Motorbike": 30, "Lamp": 24}
HARD_POOL = {"Motorbike": 6, "Lamp": 4}

# lift mode (round 3): the paper's proportions — many categories, per-shape
# part subsets, and 1000s of UNLABELED shapes drawn from the SAME category
# pools (cross-shape part reuse: real ACD components repeat across shapes
# of a class; make_primitive_acd instead draws every shape from a fresh
# random template, so its unlabeled geometry is unrelated to the labeled
# categories).  Real ShapeNet-Part synset ids; global part-id ranges come
# from SEG_CLASSES (prifit_torch/data/shapenet.py).
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


# ------------------------------------------------------ superquadric family
#
# Second accuracy workload (VERDICT r3 item 6): parts that are NOT
# ellipsoids, so the convex-fit hypothesis is only approximate — boxes,
# pinched octahedroids, toroids (a genuine hole/concavity) and bent tubes.
# An ellipsoid fitted to such a part is a lossy summary, which is the
# real-data regime (ShapeNet parts are not quadrics either).

def _sq_cs(theta, eps):
    c, s = np.cos(theta), np.sin(theta)
    return (np.sign(c) * np.abs(c) ** eps,
            np.sign(s) * np.abs(s) ** eps)


def _sq_points(eta, omega, p):
    """Superquadric / supertoroid surface point(s), with optional bend.

    Standard parameterization (Barr 1981): eta in [-pi/2, pi/2]
    (ellipsoid) or [-pi, pi] (toroid), omega in [-pi, pi].
    """
    a1, a2, a3 = p["a"]
    e1, e2 = p["eps"]
    ce, se = _sq_cs(eta, e1)
    co, so = _sq_cs(omega, e2)
    if p.get("hole", 0.0) > 0:
        ring = p["hole"] + ce
        parts = [a1 * ring * co, a2 * ring * so, a3 * se + 0.0 * co]
    else:
        parts = [a1 * ce * co, a2 * ce * so, a3 * se + 0.0 * co]
    xyz = np.stack(np.broadcast_arrays(*parts), -1)
    k = p.get("bend", 0.0)
    if abs(k) > 1e-6:
        # circular bend of the z axis (curvature k): concave inner side
        x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
        r = 1.0 / k - x
        xyz = np.stack([1.0 / k - r * np.cos(z * k),
                        y, r * np.sin(z * k)], -1)
    return xyz


def _sample_superquadric(rng, p, n):
    """~Area-uniform surface samples + numerical normals for one part.

    A parameter grid's cell areas (cross product of FD partials) weight
    the (eta, omega) proposal; normals come from the same partials at the
    sampled parameters, so deformations (bend) are handled for free.
    """
    eta_lo, eta_hi = ((-np.pi, np.pi) if p.get("hole", 0.0) > 0
                      else (-np.pi / 2, np.pi / 2))
    G = 64
    ec = np.linspace(eta_lo, eta_hi, G + 1)
    oc = np.linspace(-np.pi, np.pi, 2 * G + 1)
    V = _sq_points(ec[:, None], oc[None, :], p)           # [G+1, 2G+1, 3]
    de = V[1:, :-1] - V[:-1, :-1]
    do = V[:-1, 1:] - V[:-1, :-1]
    area = np.linalg.norm(np.cross(de, do), axis=-1).ravel()
    cells = rng.choice(area.size, size=n, p=area / area.sum())
    ei, oi = np.unravel_index(cells, (G, 2 * G))
    eta = ec[ei] + rng.uniform(0, 1, n) * (ec[1] - ec[0])
    omega = oc[oi] + rng.uniform(0, 1, n) * (oc[1] - oc[0])
    xyz = _sq_points(eta, omega, p)
    h = 1e-4
    t_e = _sq_points(eta + h, omega, p) - _sq_points(eta - h, omega, p)
    t_o = _sq_points(eta, omega + h, p) - _sq_points(eta, omega - h, p)
    nrm = np.cross(t_e, t_o)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
    return xyz, nrm


def _sq_template(rng, parts):
    """Category pool: mixed box-ish / octahedroid / toroid / bent-tube
    parts (exponents eps < 1 are boxy, > 1 pinched; hole > 0 a toroid)."""
    out = []
    for _ in range(parts):
        kind = rng.choice(["box", "pinch", "toroid", "tube"])
        p = dict(a=rng.uniform(0.35, 1.1, 3),
                 c=rng.normal(scale=1.2, size=3),
                 R=_rot(rng), eps=rng.uniform(0.3, 1.0, 2),
                 hole=0.0, bend=0.0)
        if kind == "pinch":
            p["eps"] = rng.uniform(1.2, 2.2, 2)
        elif kind == "toroid":
            p["eps"] = rng.uniform(0.5, 1.5, 2)
            p["hole"] = rng.uniform(1.3, 2.5)
            p["a"] = rng.uniform(0.25, 0.6, 3)
        elif kind == "tube":
            p["a"] = np.array([rng.uniform(0.15, 0.35),
                               rng.uniform(0.15, 0.35),
                               rng.uniform(0.8, 1.6)])
            p["bend"] = rng.uniform(0.4, 1.0)
        out.append(p)
    return out


def _sq_jitter(rng, q):
    """Per-shape pose/size jitter of one pooled superquadric part."""
    p = dict(q)
    p["a"] = q["a"] * rng.uniform(0.6, 1.5, 3)
    p["c"] = q["c"] + rng.normal(scale=0.4, size=3)
    p["R"] = q["R"] @ _rot_small(rng, 0.5)
    p["eps"] = np.clip(q["eps"] * rng.uniform(0.8, 1.25, 2), 0.25, 2.5)
    return p


def _sample_shape_sq(rng, template, n_points):
    """Superquadric analog of ``_sample_shape`` (same return contract)."""
    P = len(template)
    scale = np.stack([p["a"] for p in template])
    areas = np.prod(scale, axis=1) ** (2 / 3) \
        * np.array([1.0 + 2.0 * p.get("hole", 0.0) for p in template])
    counts = np.maximum((n_points * areas / areas.sum()).astype(int), 16)
    counts[-1] += n_points - counts.sum()
    xyz, nrm, part = [], [], []
    for p in range(P):
        local, n_local = _sample_superquadric(rng, template[p], counts[p])
        xyz.append(local @ template[p]["R"].T + template[p]["c"])
        nrm.append(n_local @ template[p]["R"].T)
        part.append(np.full(counts[p], p))
    return (np.concatenate(xyz), np.concatenate(nrm),
            np.concatenate(part))


def make_primitive_shapenet(root, n_per_cat=40, n_points=2048, seed=0,
                            hard=False):
    """ShapeNet-Part-format tree of primitive-union shapes.

    ``hard=True`` uses the larger part-vocabulary categories with
    per-shape random subsets of a category part pool (each part present
    with p=0.6, at least 2) and strong pose jitter — few-shot supervision
    cannot cover the layout variety, unlike the easy variant where one
    template per category makes a single labeled shape nearly sufficient.
    """
    rng = np.random.default_rng(seed)
    cats = HARD_CATS if hard else CATS
    offsets = HARD_PART_OFFSET if hard else PART_OFFSET
    os.makedirs(osp.join(root, "train_test_split"), exist_ok=True)
    with open(osp.join(root, "synsetoffset2category.txt"), "w") as f:
        for name, synset in cats.items():
            f.write(f"{name}\t{synset}\n")

    splits = {"train": [], "val": [], "test": []}
    for name, synset in cats.items():
        pool_n = HARD_POOL[name] if hard else PARTS_PER_CAT
        pool = _template(rng, pool_n)
        d = osp.join(root, synset)
        os.makedirs(d, exist_ok=True)
        for i in range(n_per_cat):
            token = f"{name.lower()}{i:04d}"
            if hard:
                present = rng.random(pool_n) < 0.6
                if present.sum() < 2:
                    present[rng.choice(pool_n, 2, replace=False)] = True
                sub_ids = np.flatnonzero(present)
                tpl = [dict(r=pool[j]["r"] * rng.uniform(0.5, 1.6, 3),
                            c=pool[j]["c"] + rng.normal(scale=0.4, size=3),
                            R=pool[j]["R"] @ _rot_small(rng, 0.5))
                       for j in sub_ids]
                xyz, nrm, part = _sample_shape(rng, tpl, n_points)
                seg = sub_ids[part] + offsets[name]
            else:
                xyz, nrm, part = _sample_shape(rng, pool, n_points)
                seg = part + offsets[name]
            data = np.concatenate(
                [xyz, nrm, seg[:, None]], axis=1).astype(np.float32)
            np.savetxt(osp.join(d, token + ".txt"), data, fmt="%.6f")
            split = ("train" if i < n_per_cat // 2 else
                     "val" if i < 3 * n_per_cat // 4 else "test")
            splits[split].append(f"shape_data/{synset}/{token}")

    for split, items in splits.items():
        with open(osp.join(root, "train_test_split",
                           f"shuffled_{split}_file_list.json"), "w") as f:
            json.dump(items, f)
    return root


def make_primitive_acd(root, n_shapes=80, n_points=2048, seed=1,
                       subfolder="shapes"):
    """ACD-format .npy folder of primitive-union shapes (components =
    ellipsoid ids) for the self-sup branch."""
    rng = np.random.default_rng(seed)
    d = osp.join(root, subfolder)
    os.makedirs(d, exist_ok=True)
    for i in range(n_shapes):
        tpl = _template(rng, int(rng.integers(2, 5)))
        xyz, _, part = _sample_shape(rng, tpl, n_points)
        data = np.concatenate(
            [xyz, part[:, None]], axis=1).astype(np.float32)
        np.save(osp.join(d, f"acd{i:04d}.npy"), data)
    return root


def _subset_template(rng, pool, family="ellipsoid"):
    """Per-shape random part subset from a category pool + strong jitter
    (the hard-mode shape constructor, shared by labeled and ACD trees)."""
    pool_n = len(pool)
    present = rng.random(pool_n) < 0.6
    if present.sum() < 2:
        present[rng.choice(pool_n, 2, replace=False)] = True
    sub_ids = np.flatnonzero(present)
    if family == "superquadric":
        tpl = [_sq_jitter(rng, pool[j]) for j in sub_ids]
    else:
        tpl = [dict(r=pool[j]["r"] * rng.uniform(0.5, 1.6, 3),
                    c=pool[j]["c"] + rng.normal(scale=0.4, size=3),
                    R=pool[j]["R"] @ _rot_small(rng, 0.5))
               for j in sub_ids]
    return sub_ids, tpl


def make_lift_benchmark(root, n_cats=8, n_per_cat=40, n_acd=2000,
                        n_points=2048, seed=0, family="ellipsoid"):
    """Paper-proportioned benchmark: n_cats hard-mode categories + a large
    ACD tree drawn from the SAME category pools.

    The lift regime (VERDICT r2 item 1): many unlabeled shapes sharing the
    labeled categories' primitive layouts, few labels.  Writes
    ``root/shapenet`` (labeled, hard-style subsets) and ``root/acd``
    (unlabeled .npy, component id = primitive instance).  Everything is
    deterministic given ``seed``; labeled and unlabeled shapes are drawn
    from independent rng streams (disjoint by construction).

    ``family="superquadric"`` draws every part from the non-ellipsoid
    pool (boxes/octahedroids/toroids/bent tubes) — the second accuracy
    workload, where fitted ellipsoids are only lossy part summaries.
    """
    names = LIFT_ORDER[:n_cats]
    rng_pool = np.random.default_rng(seed)
    make_tpl = _sq_template if family == "superquadric" else _template
    sample = _sample_shape_sq if family == "superquadric" \
        else _sample_shape
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
            sub_ids, tpl = _subset_template(rng_lab, pools[name], family)
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
        _, tpl = _subset_template(rng_acd, pools[name], family)
        xyz, _, part = sample(rng_acd, tpl, n_points)
        data = np.concatenate(
            [xyz, part[:, None]], axis=1).astype(np.float32)
        np.save(osp.join(d, f"acd{i:05d}.npy"), data)
    return sn_root, acd_root


def make_modelnet_benchmark(root, n_cats=10, n_train=24, n_test=8,
                            n_points=1024, seed=0, family="ellipsoid"):
    """Realistic-input benchmark for the ``--modelnet_val`` SVM probe.

    Writes the ``modelnet40_normal_resampled`` layout
    (``data/modelnet.py``): ``n_cats`` structurally distinct categories
    (each a fixed primitive-layout pool; per-shape random subsets +
    jitter like the lift benchmark), x,y,z,nx,ny,nz rows per shape.
    The reference's probe recipe (``pretrain_partseg_shapenet.py:
    406-425``) runs against real ModelNet40; this gives the probe a
    non-fixture workload in environments without the dataset.
    """
    rng_pool = np.random.default_rng(seed)
    make_tpl = _sq_template if family == "superquadric" else _template
    sample = _sample_shape_sq if family == "superquadric" \
        else _sample_shape
    names = [f"cat{c:02d}" for c in range(n_cats)]
    pools = {n: make_tpl(rng_pool, 4 + (i % 3))
             for i, n in enumerate(names)}
    os.makedirs(root, exist_ok=True)
    with open(osp.join(root, "modelnet40_shape_names.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    rng = np.random.default_rng(seed + 1)

    def _mild(pool):
        # ModelNet-style categories are structurally stable: full part
        # set, mild jitter (the lift benchmark's hard-mode subsetting
        # models ShapeNet-Part's within-category variation instead)
        if family == "superquadric":
            return [_sq_jitter(rng, q) for q in pool]
        return [dict(r=q["r"] * rng.uniform(0.85, 1.18, 3),
                     c=q["c"] + rng.normal(scale=0.1, size=3),
                     R=q["R"] @ _rot_small(rng, 0.15)) for q in pool]

    ids = {"train": [], "test": []}
    for name in names:
        d = osp.join(root, name)
        os.makedirs(d, exist_ok=True)
        for i in range(n_train + n_test):
            token = f"{name}_{i:04d}"
            tpl = _mild(pools[name])
            xyz, nrm, _ = sample(rng, tpl, n_points)
            data = np.concatenate([xyz, nrm], axis=1).astype(np.float32)
            np.savetxt(osp.join(d, token + ".txt"), data, fmt="%.6f",
                       delimiter=",")
            ids["train" if i < n_train else "test"].append(token)
    for split, items in ids.items():
        with open(osp.join(root, f"modelnet40_{split}.txt"), "w") as f:
            f.write("\n".join(items) + "\n")
    return root


def make_s3dis_rooms(root, n_rooms=4, n_points=20000, seed=0):
    """Realistic-input S3DIS-style rooms for the sem-seg pipeline.

    Geometry per room (``data/s3dis.py`` layout, [N, 7] npy rows of
    xyz rgb label): floor/ceiling/4 walls as planes, a table (top +
    legs), chairs, a wall board, and clutter boxes — classes are
    geometrically separable the way real indoor scans are (height,
    extent, position).  Rooms alternate between Area_1 (train) and
    Area_5 (the default held-out test area)."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    W, D, H = 4.0, 4.0, 3.0

    def plane(n, extent, fixed_axis, value):
        p = rng.uniform(0, 1, (n, 3)) * np.asarray(extent)
        p[:, fixed_axis] = value
        return p

    def box(n, center, size):
        # surface samples of an axis-aligned box: project onto a random
        # face per point
        p = rng.uniform(-0.5, 0.5, (n, 3))
        ax = rng.integers(0, 3, n)
        p[np.arange(n), ax] = np.sign(p[np.arange(n), ax] + 1e-9) * 0.5
        return np.asarray(center) + p * np.asarray(size)

    for i in range(n_rooms):
        area = 1 if i % 2 == 0 else 5
        # (sampler, label, area weight)
        parts = [
            (lambda n: plane(n, (W, D, 0), 2, 0.0), 1, W * D),   # floor
            (lambda n: plane(n, (W, D, 0), 2, H), 0, W * D),     # ceiling
            (lambda n: plane(n, (0, D, H), 0, 0.0), 2, D * H),   # walls
            (lambda n: plane(n, (0, D, H), 0, W), 2, D * H),
            (lambda n: plane(n, (W, 0, H), 1, 0.0), 2, W * H),
            (lambda n: plane(n, (W, 0, H), 1, D), 2, W * H),
        ]
        tc = rng.uniform(1.2, 2.8, 2)
        parts.append((lambda n, c=tuple(tc): box(
            n, (c[0], c[1], 0.74), (1.2, 0.7, 0.06)), 7, 1.7))
        for dx, dy in [(-0.5, -0.3), (0.5, -0.3), (-0.5, 0.3),
                       (0.5, 0.3)]:
            parts.append((lambda n, c=(tc[0] + dx, tc[1] + dy): box(
                n, (c[0], c[1], 0.35), (0.07, 0.07, 0.7)), 7, 0.2))
        for _ in range(2):
            cc = rng.uniform(0.6, 3.4, 2)
            parts.append((lambda n, c=tuple(cc): box(
                n, (c[0], c[1], 0.45), (0.45, 0.45, 0.9)), 8, 1.6))
        by = rng.uniform(1.0, 3.0)
        parts.append((lambda n, y=by: box(
            n, (W - 0.02, y, 1.5), (0.04, 1.2, 0.9)), 11, 1.1))
        for _ in range(3):
            cc = rng.uniform(0.3, 3.7, 2)
            sz = rng.uniform(0.1, 0.5, 3)
            z0 = rng.uniform(0.1, 0.4)
            parts.append((lambda n, c=tuple(cc), s=tuple(sz), z=z0: box(
                n, (c[0], c[1], z), s), 12, 0.6))

        weights = np.array([w for _, _, w in parts])
        alloc = np.maximum(
            (weights / weights.sum() * n_points).astype(int), 48)
        rows = []
        for (sampler, label, _), n in zip(parts, alloc):
            p = sampler(int(n))
            rgb = np.clip(rng.normal(0.45 + 0.03 * label, 0.08,
                                     (int(n), 3)), 0, 1)
            lab = np.full((int(n), 1), label, np.float32)
            rows.append(np.concatenate(
                [p.astype(np.float32), rgb.astype(np.float32), lab], 1))
        data = np.concatenate(rows, 0)
        rng.shuffle(data, axis=0)
        np.save(osp.join(root, f"Area_{area}_room{i:02d}.npy"), data)
    return root


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default=osp.join(
        tempfile.gettempdir(), "prim_data"))
    ap.add_argument("--hard", action="store_true")
    ap.add_argument("--lift", action="store_true",
                    help="paper-proportioned benchmark (make_lift_benchmark)")
    ap.add_argument("--family", default="ellipsoid",
                    choices=["ellipsoid", "superquadric"])
    ap.add_argument("--n_cats", type=int, default=8)
    ap.add_argument("--n_per_cat", type=int, default=40)
    ap.add_argument("--n_acd", type=int, default=2000)
    ap.add_argument("--n_points", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()
    if a.lift:
        make_lift_benchmark(a.out, n_cats=a.n_cats, n_per_cat=a.n_per_cat,
                            n_acd=a.n_acd, n_points=a.n_points, seed=a.seed,
                            family=a.family)
        print("lift benchmark written to", a.out)
    else:
        make_primitive_shapenet(osp.join(a.out, "shapenet"), hard=a.hard)
        make_primitive_acd(osp.join(a.out, "acd"))
        print("written to", a.out, "(hard)" if a.hard else "")
