"""A/B: fused (nearest-k within the radius) against reference-exact
(first-k by index) ball query, on the port.

The port's copy of ``tools/ab_ball_query.py``.  It trains the flagship
MSG model (``pointnet2_part_seg_msg``, the default encoder dtype)
supervised on geometry-determined labels (the octant of each point: a
learnable structure, unlike random labels) with both neighbour-selection
semantics (``get_model(fused_ball_query=...)``), two seeds each, and
reports the loss curves and the final train and held-out accuracy.  The
clouds are the JAX script's bit for bit (the same numpy draws); the
weights start from :func:`prifit_torch.entry.init_weights` seeded by
the run's seed, and the steps' draws (FPS start, dropout, the ``mxsr``
rounding keys) come from a ``torch.Generator`` seeded by it, where the
JAX script draws a key a step.

``run`` takes the batch, the cloud size, the step count and a starting
state_dict as keyword arguments, so that a test can run it small from
the JAX model's weights.

Usage (on the card; ``--device cpu`` runs the plain PyTorch path):
  python -m prifit_torch.tools.ab_ball_query
"""

import argparse

import numpy as np
import torch

from prifit_torch.entry import init_weights
from prifit_torch.models import get_module
from prifit_torch.tools.run_fewshot_matrix import tool_device
from prifit_torch.train.state import create_train_state
from prifit_torch.train.steps import make_supervised_step
from prifit_torch.utils.device import resolve_device

B, N, STEPS, PARTS = 16, 1024, 60, 8


def octant_labels(pts):
    return ((np.asarray(pts[..., 0]) > 0).astype(np.int32)
            + 2 * (np.asarray(pts[..., 1]) > 0).astype(np.int32)
            + 4 * (np.asarray(pts[..., 2]) > 0).astype(np.int32))


def clouds(seed, b=B, n=N):
    """``(pts, eval_pts)`` ``[b, n, 3]`` f32: the JAX script's draws."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(b, n, 3)).astype(np.float32)
    eval_pts = rng.normal(size=(b, n, 3)).astype(np.float32)
    return pts, eval_pts


def run(fused: bool, seed: int, *, device=None, b=B, n=N, steps=STEPS,
        state_dict=None):
    """``(losses, train_acc, eval_acc)`` of ``steps`` supervised steps
    (lr 0.01, batch-norm momentum 0.1) on ``b`` clouds of ``n`` points,
    then an eval forward on ``b`` held-out clouds; ``state_dict`` starts
    the model from given weights instead of :func:`init_weights`.  On
    CUDA unless ``device`` names another."""
    device = resolve_device(device)
    mod = get_module("pointnet2_part_seg_msg")
    model = mod.get_model(num_parts=PARTS, fused_ball_query=fused,
                          device="cpu")
    if state_dict is None:
        init_weights(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(state_dict, strict=True)
    pts_np, eval_np = clouds(seed, b, n)
    pts = torch.as_tensor(pts_np, device=device)
    eval_pts = torch.as_tensor(eval_np, device=device)
    cls = torch.zeros((b, 16), dtype=torch.float32, device=device)
    target = torch.as_tensor(octant_labels(pts_np), dtype=torch.int64,
                             device=device)
    eval_target = octant_labels(eval_np)

    state = create_train_state(model.to(device).train())
    step = make_supervised_step(mod.get_loss)
    generator = torch.Generator(device=device).manual_seed(seed)
    losses = []
    for _ in range(steps):
        state, m = step(state, pts, cls, target, 0.01, 0.1, generator)
        losses.append(float(m["loss"]))
    train_acc = float(m["acc"])

    model.eval()
    with torch.no_grad():
        out = model(eval_pts, cls)
    pred = out.seg_logits.argmax(-1).cpu().numpy()
    eval_acc = float((pred == eval_target).mean())
    return losses, train_acc, eval_acc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the runs train (cuda, or cpu for the plain "
                         "PyTorch path)")
    device = tool_device(ap.parse_args(argv).device)
    print("device:", torch.cuda.get_device_name(device)
          if device.type == "cuda" else device.type)
    results = {}
    for fused in (True, False):
        accs, evals, curves = [], [], []
        for seed in (0, 1):
            losses, tr, ev = run(fused, seed, device=device)
            accs.append(tr)
            evals.append(ev)
            curves.append(losses)
            print(f"fused={fused} seed={seed}: "
                  f"loss {losses[0]:.3f}->{losses[-1]:.3f} "
                  f"train_acc {tr:.4f} eval_acc {ev:.4f}", flush=True)
        results[fused] = dict(
            train_acc=float(np.mean(accs)), eval_acc=float(np.mean(evals)),
            final_loss=float(np.mean([c[-1] for c in curves])),
            curve=np.mean(curves, axis=0)[::10].round(4).tolist())
    print()
    for fused, r in results.items():
        print(f"fused={fused}: train_acc {r['train_acc']:.4f} "
              f"eval_acc {r['eval_acc']:.4f} "
              f"final_loss {r['final_loss']:.4f} curve {r['curve']}")
    d = results[True]["eval_acc"] - results[False]["eval_acc"]
    print(f"\neval_acc delta (fused - exact): {d:+.4f}")
    return results


if __name__ == "__main__":
    main()
