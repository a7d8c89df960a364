"""Does the self-sup objective teach PART structure?

The port's copy of ``tools/probe_embedding.py``.  For an encoder (random
init from ``--seed``, or a checkpoint via ``--ckpt``) it embeds held-out
synthetic shapes, clusters each shape with the pipeline's own mean shift
(:func:`prifit_torch.clustering.cluster_batch` at the recipe's settings:
10 iterations, 25 slots; on the card the bandwidth, mean-shift and NMS
kernels) and reports NMI(mean-shift labels, true part labels)
(:func:`prifit_torch.eval.nmi.normalized_mutual_info`, the port's copy of
scikit-learn's) and the clusters a shape.  If a pretrained encoder's NMI
does not beat a random one's while both sit at the same loss floor, the
objective is satisfied by ANY spatially-coherent clustering of these
primitive-union shapes, and the lift mechanism has nothing to push on at
this data difficulty.

``--space embedding`` clusters the self-sup embedding head
(``extra_conv_emb``), ``--space feat`` the 128-d pre-head feature (the
calibration: ``feat`` of a supervised model is part-discriminative).

The model is ``pointnet2_part_seg_msg`` with 50 parts at the default
encoder dtype, lecun-normal weights from ``--seed`` as the trainer makes
them, in eval mode.  ``--ckpt`` is a checkpoint file of the port's
trainers (``<run>/checkpoints/best_model``) or a reference ``.pth``; it is
merged into that model (:func:`prifit_torch.train.checkpoint.
load_params`), and the names the file lacks keep their init and are
printed.  The port's model always holds ``extra_conv_emb``, so a port
checkpoint of a supervised run carries that run's untrained init of it,
where a JAX checkpoint has no such head and the JAX probe keeps the
probe's own init.  A shape's points and part labels come from one
``__getitem__`` call (each call resamples the points); the dataset draws
from ``--seed``, where the JAX probe's draws are unseeded.

Usage (on the card; ``--device cpu`` runs the plain PyTorch path):
  python -m prifit_torch.tools.probe_embedding --data <lift8> --n 16
  python -m prifit_torch.tools.probe_embedding --data <lift8> --n 16 \\
      --ckpt <lift8>/pretrain/s786_e15/<run>/checkpoints/best_model
"""

import argparse
import os.path as osp

import numpy as np
import torch

from prifit_torch.clustering.mean_shift import cluster_batch
from prifit_torch.data.shapenet import PartNormalDataset
from prifit_torch.entry import init_weights
from prifit_torch.eval.nmi import normalized_mutual_info
from prifit_torch.models.pointnet2_part_seg_msg import get_model
from prifit_torch.tools.run_fewshot_matrix import tool_device
from prifit_torch.train.checkpoint import load_params

# the recipe's mean shift (reference README.md:60-63)
ITERATIONS, MAX_NUM_CLUSTERS = 10, 25


def build_model(seed: int, device) -> torch.nn.Module:
    """``pointnet2_part_seg_msg`` with 50 parts, lecun-normal weights from
    ``seed`` (:func:`prifit_torch.entry.init_weights`, as the trainer
    makes them), in eval mode on ``device``."""
    model = get_model(num_parts=50, device="cpu")
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def probe(model, dataset, idxs, *, space="embedding", quantile=0.05,
          batch=4, device=None):
    """Per-shape NMI between the mean-shift clusters of ``model``'s
    ``space`` (``"embedding"`` or ``"feat"``) and the true parts, and the
    clusters a shape, over the shapes ``idxs`` of ``dataset`` in batches
    of ``batch``; returns ``(nmi [n] float64, clusters [n] int64)``."""
    device = torch.device(device) if device is not None else \
        next(model.parameters()).device
    nmis, counts = [], []
    for s in range(0, len(idxs), batch):
        chunk = idxs[s:s + batch]
        # one __getitem__ per index: each call resamples points, so
        # pts/segs must come from the SAME call to stay aligned
        items = [dataset[i] for i in chunk]
        pts = torch.as_tensor(np.stack([it[0] for it in items]),
                              dtype=torch.float32, device=device)
        segs = np.stack([it[2] for it in items])
        cls = torch.zeros((len(chunk), 16), dtype=torch.float32,
                          device=device)
        with torch.no_grad():
            out = model(pts, cls, embed=True)
            emb = out.embedding if space == "embedding" else out.feat
            res = cluster_batch(emb, quantile=quantile,
                                iterations=ITERATIONS,
                                max_num_clusters=MAX_NUM_CLUSTERS)
        labels = res.labels.cpu().numpy()
        counts.extend(res.num_clusters.cpu().tolist())
        for b in range(len(chunk)):
            nmis.append(normalized_mutual_info(segs[b], labels[b]))
    return np.asarray(nmis, np.float64), np.asarray(counts, np.int64)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", required=True,
                    help="root containing shapenet/ (make_lift_benchmark "
                         "output)")
    ap.add_argument("--ckpt", default="",
                    help="checkpoint file to probe (default: random init)")
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--npoint", type=int, default=2048)
    ap.add_argument("--split", default="test")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--quantile", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=786)
    ap.add_argument("--space", default="embedding",
                    choices=["embedding", "feat"],
                    help="cluster the selfsup embedding head or the "
                         "128-d pre-head feat (calibration: feat of a "
                         "supervised model is part-discriminative)")
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu for the plain PyTorch path")
    return ap.parse_args(argv)


def main(argv=None):
    """Probe as the flags say; prints and returns ``(nmi, clusters)``
    per shape."""
    args = parse_args(argv)
    device = tool_device(args.device)
    ds = PartNormalDataset(osp.join(args.data, "shapenet"),
                           npoints=args.npoint, split=args.split,
                           normal_channel=False,
                           rng=np.random.default_rng(args.seed))
    idxs = np.linspace(0, len(ds) - 1, args.n).astype(int)
    model = build_model(args.seed, device)
    if args.ckpt:
        kept = load_params(model, *osp.split(args.ckpt.rstrip("/")),
                           log=lambda msg: None)
        print(f"merged {args.ckpt}; kept at init (absent from it): "
              f"{kept or 'none'}")
    nmis, counts = probe(model, ds, idxs, space=args.space,
                         quantile=args.quantile, batch=args.batch,
                         device=device)

    tag = args.ckpt or "random-init"
    print(f"probe[{tag}] space={args.space} split={args.split} "
          f"n={len(nmis)} q={args.quantile}")
    print(f"  NMI(mean-shift clusters, true parts): "
          f"mean={np.mean(nmis):.4f} sd={np.std(nmis):.4f} "
          f"min={np.min(nmis):.4f} max={np.max(nmis):.4f}")
    print(f"  clusters/shape: mean={np.mean(counts):.1f} "
          f"range=[{np.min(counts)}, {np.max(counts)}]")
    return nmis, counts


if __name__ == "__main__":
    main()
