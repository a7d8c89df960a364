"""The first batches of the trainer's two streams, worked out from the
tree's files: the datasets and loader of the frozen copy
(:mod:`benchmark.reference.port.data`), and frozen copies of
``augment_sup``, ``np_onehot`` and the stream transforms of
``prifit_torch/cli/train_partseg.py`` at commit 0adee2a (with
``--normal``, ``--category`` and ``--fused_augment`` off)."""

import itertools

import numpy as np

from benchmark.reference.port.data import provider
from benchmark.reference.port.data.loader import DataLoader
from benchmark.reference.port.data.shapenet import ACDSelfSupDataset, \
    PartNormalDataset


def augment_sup(points, rng):
    pts = points.copy()
    pts[:, :, 0:3] = provider.random_scale_point_cloud(pts[:, :, 0:3],
                                                       rng=rng)
    pts[:, :, 0:3] = provider.shift_point_cloud(pts[:, :, 0:3], rng=rng)
    return pts


def sup_transform(batch, rng, num_classes):
    points, cls, target = batch
    pts = augment_sup(points, rng)
    return (np.ascontiguousarray(pts, np.float32),
            np.zeros((cls.shape[0], num_classes), np.float32),
            target.astype(np.int64))


def selfsup_transform(ss, rng, npoint, num_classes):
    ss_points, chamfer_pts, ss_cls, _ = ss
    chamfer_pts = augment_sup(chamfer_pts, rng)
    choice = rng.choice(chamfer_pts.shape[1], npoint, replace=False)
    enc_pts = chamfer_pts[:, choice, :]
    cls_zero = np.zeros((enc_pts.shape[0], num_classes), np.float32)
    return (enc_pts.astype(np.float32), cls_zero,
            chamfer_pts[:, :, :3].astype(np.float32))


def contrastive_transform(ss, rng, num_classes):
    ss_points, ss_seg = ss[0], ss[-1]
    ss_points = augment_sup(ss_points, rng)
    cls_zero = np.zeros((ss_points.shape[0], num_classes), np.float32)
    return (ss_points[:, :, :3].astype(np.float32), cls_zero,
            ss_seg.astype(np.int64))


def first_batches(p: dict, seed: int, tree: dict, n_sup: int, n_ss: int):
    """``(sup batches, self-sup batches)``: the first ``n_sup`` and
    ``n_ss`` batches each stream hands its step, as numpy arrays."""
    train_ds = PartNormalDataset(
        tree["shapenet"], npoints=p["npoint"], split=p["split"],
        normal_channel=False, k_shot=p["k_shot"],
        rng=np.random.default_rng(seed))
    sup = DataLoader(train_ds, batch_size=p["batch_size"], shuffle=True,
                     seed=seed)
    rng_sup = np.random.default_rng(seed + 17)
    sups = [sup_transform(b, rng_sup, p["num_classes"])
            for b in itertools.islice(iter(sup), n_sup)]
    labeled = list(itertools.chain(*train_ds.meta.values()))
    ss_ds = ACDSelfSupDataset(
        tree["acd"], npoints=p["npoint"], normal_channel=False,
        k_shot=p["n_cls_selfsup"], exclude_fns=labeled,
        rng=np.random.default_rng(seed + 1))
    contrastive = p["ss_loss"] == "contrastive"
    ss = DataLoader(ss_ds, batch_size=p["batch_size"], shuffle=True,
                    seed=seed + 1,
                    chamfer_npoints=p["chamfer_npoints"])
    rng_ss = np.random.default_rng(seed + 31)
    sss = [contrastive_transform(b, rng_ss, p["num_classes"]) if contrastive
           else selfsup_transform(b, rng_ss, p["npoint"], p["num_classes"])
           for b in itertools.islice(iter(ss), n_ss)]
    return sups, sss
