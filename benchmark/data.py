"""The cells' data tree, generated once per checkout.

The tree is the traffic file's ``tree`` parameters run through the
frozen generator (:mod:`benchmark.frozen.synthetic`), written under
``benchmark/_cache/tree-<hash>``, where the hash covers the generator's
source and the parameters; a run that finds it reads it.  It is the same
for every seed: the seed draws the k-shot subset, the loaders' order and
augmentation, the weights and every draw of the steps."""

import hashlib
import json
import os
import os.path as osp
import shutil

from benchmark.frozen import synthetic

CACHE = osp.join(osp.dirname(osp.abspath(__file__)), "_cache")


def tree_key(params: dict) -> str:
    h = hashlib.sha256()
    with open(synthetic.__file__, "rb") as f:
        h.update(f.read())
    h.update(json.dumps(params, sort_keys=True).encode())
    return h.hexdigest()[:16]


def ensure_tree(params: dict) -> dict:
    """``{"shapenet": <labelled root>, "acd": <unlabelled root>}`` of the
    tree ``params`` describe, generated on first use."""
    if params.get("generator") != "make_lift_benchmark" or \
            params.get("family") != "ellipsoid":
        raise ValueError(f"unknown tree generator {params}")
    key = tree_key(params)
    root = osp.join(CACHE, f"tree-{key}")
    if not osp.isdir(root):
        tmp = osp.join(CACHE, f"partial-{key}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        synthetic.make_lift_benchmark(
            tmp, n_cats=params["n_cats"], n_per_cat=params["n_per_cat"],
            n_acd=params["n_acd"], n_points=params["n_points"],
            seed=params["seed"])
        os.rename(tmp, root)
    return {"shapenet": osp.join(root, "shapenet"),
            "acd": osp.join(root, "acd")}
