"""Synthetic fit-pipeline demo (port of ``prifit_tpu/cli/fitting.py``).

End-to-end cluster -> fit -> sample -> chamfer -> backward on synthetic
ellipsoid scenes with known parameters, printing the recovered against
the true axis lengths, the convex loss, its chamfer and the norm of its
gradient in the embeddings.

  python -m prifit_torch.cli.fitting --batch_size 2

It runs on the CUDA card (the bandwidth, mean-shift, mean-shift backward
and NMS kernels); ``main(parse_args([...]), device="cpu")`` runs the plain
versions on the CPU.
"""

import numpy as np
import torch

from prifit_torch.cli.args_parser import parse_args
from prifit_torch.geometry import (
    convex_loss,
    create_synthetic_dataset,
    fit_ellipsoids_batch,
)
from prifit_torch.utils.device import resolve_device


def main(args, device=None) -> dict:
    """Run the demo and print its lines; returns the numbers printed:
    ``r`` and ``center`` (the fits to the true one-hot weights, ``[B, 3,
    3]``), ``true_r`` and ``true_center``, and ``total``, ``chamfer`` and
    ``grad_norm`` of the convex loss of ``weights[..., :8] + 0.05``."""
    dev = resolve_device(device)
    scene = create_synthetic_dataset(args.batch_size, seed=args.seed)
    points = torch.from_numpy(scene.points).to(dev)
    weights = torch.from_numpy(scene.weights).to(dev)

    # 1) fitting with ground-truth one-hot weights: parameter recovery
    with torch.no_grad():
        params = fit_ellipsoids_batch(points, weights)
    r = params.r[:, :3].cpu().numpy()
    for b in range(args.batch_size):
        for i in range(3):
            got = np.sort(r[b, i])
            want = np.sort(scene.params[b, i])
            print(f"shape {b} ellipsoid {i}: fitted {got.round(2)} "
                  f"true {want.round(2)}")

    # 2) full pipeline from embeddings: loss value + gradient norm
    emb = (weights[:, :, :8] + 0.05).requires_grad_(True)
    out = convex_loss(points, points, emb, quantile=args.quantile,
                      iterations=args.msc_iterations,
                      max_num_clusters=min(args.max_num_clusters, 8),
                      n_per_prim=args.n_per_prim)
    out.total.backward()
    total, chamfer = out.total.item(), out.chamfer.item()
    gnorm = float(torch.linalg.norm(emb.grad.reshape(-1)))
    print(f"convex loss {total:.5f} chamfer {chamfer:.5f} "
          f"|grad| {gnorm:.5f}")
    assert np.isfinite(total) and gnorm > 0
    print("fit pipeline OK")
    return dict(r=r, center=params.center[:, :3].cpu().numpy(),
                true_r=scene.params, true_center=scene.centers,
                total=total, chamfer=chamfer, grad_norm=gnorm)


if __name__ == "__main__":
    main(parse_args())
