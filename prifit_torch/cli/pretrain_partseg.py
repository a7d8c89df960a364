"""Self-supervised pretrainer.

Port of ``prifit_tpu/cli/pretrain_partseg.py`` (reference
``pretrain_partseg_shapenet.py:62-469``): convex-loss training on
unlabelled ACD shapes with the pretrain augmentations (scale and shift,
optional anisotropic scale and y-rotations), a self-sup validation loss
on the held-out 20% split each epoch, a checkpoint every 5 epochs and
``best_model`` by validation loss.  ``--ss_loss contrastive`` trains the
ACD pairwise contrastive loss instead.  The flags are the JAX package's
(:mod:`prifit_torch.cli.args_parser`).

Execution: one process, the steps of :mod:`prifit_torch.train.steps`
eagerly on one CUDA device (``main(args, device="cpu")`` runs them on
the CPU), batches augmented on the host with the JAX pretrainer's draws
and copied to the device two batches ahead of the steps
(:func:`prifit_torch.data.loader.prefetch_to_device`).  One
``torch.Generator`` on the device drives the steps' draws and the
contrastive validation loss's; it is seeded from ``--seed`` and the epoch
at the start of each epoch.  The validation forward runs in eval mode,
so the convex loss takes its deterministic fallbacks and ``beta`` does
not decay.

The pretrainer's ``best_model`` warm-starts the part-seg trainer:
``python -m prifit_torch.cli.train_partseg --pretrained_model
<run>/checkpoints/best_model ...``.

``--modelnet_val``: where a ModelNet40 tree lies beside the ACD one
(``<dirname of --ss_path>/modelnet40_normal_resampled``), each epoch ends
with the linear-SVM probe of :mod:`prifit_torch.eval.svm_probe` on the
frozen model's pooled ``feat`` (``--svm_c``, ``--cross_val_svm``), its
test accuracy in ``metrics.jsonl`` as ``modelnet_svm_acc`` and the
tensorboard scalar ``modelnet_val``; where none does, the probe is
skipped with a log line, as the JAX pretrainer skips it.

Not ported: multi-process sharding (ROADMAP.md §1 item 5).

Usage:
  python -m prifit_torch.cli.pretrain_partseg \\
      --model pretrain_pointnet2_part_seg_msg --l2_norm --batch_size 24 \\
      --npoint 2048 --quantile 0.05 --msc_iterations 10 \\
      --max_num_clusters 25 --epoch 100 --ss_path <acd>
"""

import argparse
import json
import os
import os.path as osp
import time

import numpy as np
import torch

from prifit_torch.cli import dp
from prifit_torch.cli.args_parser import parse_args
from prifit_torch.cli.train_partseg import (
    build_model,
    check_supported,
    experiment_name,
    setup_logger,
)
from prifit_torch.data import (
    ACDSelfSupDataset,
    DataLoader,
    ModelNetDataLoader,
    prefetch_to_device,
    provider,
)
from prifit_torch.eval.svm_probe import make_feature_forward, svm_probe
from prifit_torch.models import get_module
from prifit_torch.nn.norm import set_process_group
from prifit_torch.parallel import make_data_mesh, \
    maybe_initialize_distributed, replicate
from prifit_torch.train.checkpoint import save_checkpoint
from prifit_torch.train.schedules import bn_momentum_schedule, lr_schedule
from prifit_torch.train.state import create_train_state
from prifit_torch.train.steps import make_contrastive_step, make_selfsup_step
from prifit_torch.utils.device import resolve_device
from prifit_torch.utils.tblog import ScalarWriter


def augment_pretrain(points, args, rng):
    """The pretrain augmentations of a batch (reference ``pretrain:318-
    337``): scale, then shift, of the xyz columns, then with
    ``--random_anisotropic_scale`` an anisotropic scale in [0.8, 1.25),
    with ``--rotation_z`` a rotation about y and with ``--rotation_z_45``
    one by a multiple of pi/4, all drawn from ``rng``."""
    pts = points.copy()
    pts[:, :, 0:3] = provider.random_scale_point_cloud(pts[:, :, 0:3],
                                                       rng=rng)
    pts[:, :, 0:3] = provider.shift_point_cloud(pts[:, :, 0:3], rng=rng)
    if args.random_anisotropic_scale:
        pts[:, :, 0:3] = provider.random_anisotropic_scale_point_cloud(
            pts[:, :, 0:3], scale_low=0.8, scale_high=1.25, rng=rng)
    if args.rotation_z:
        pts = provider.rotate_point_cloud_y(pts, rng=rng)
    if args.rotation_z_45:
        pts = provider.rotate_point_cloud_y_pi4(pts, rng=rng)
    return pts


def acd_split(args):
    """``(train, val)``: the 80/20 self-sup split of the ACD shapes
    (``pretrain:168-180``), the train files drawn with rng ``seed + 1``
    and the val set the rest, resampled with rng ``seed + 2``."""
    ss_train = ACDSelfSupDataset(
        args.ss_path, npoints=args.npoint, normal_channel=args.normal,
        k_shot=args.n_cls_selfsup, use_val=True,
        rng=np.random.default_rng(args.seed + 1))
    ss_val = ACDSelfSupDataset(
        args.ss_path, npoints=args.npoint, normal_channel=args.normal,
        k_shot=args.n_cls_selfsup, use_val=False,
        exclude_fns=[fn for _, fn in ss_train.datapath],
        rng=np.random.default_rng(args.seed + 2))
    return ss_train, ss_val


def modelnet_loaders(args, log):
    """``--modelnet_val``: the probe's ModelNet40 ``(train, test)``
    loaders (``--npoint`` points, ``--normal``, all shapes at
    ``--batch_size``) of the tree beside the ACD one, or None, with a log
    line, where there is none (``pretrain:97-119`` of the JAX
    pretrainer)."""
    if not args.modelnet_val:
        return None
    mn_root = osp.join(osp.dirname(args.ss_path),
                       "modelnet40_normal_resampled")
    if not osp.isdir(mn_root):
        log(f"--modelnet_val: no dataset at {mn_root}; skipping probe")
        return None
    return tuple(
        DataLoader(ModelNetDataLoader(mn_root, npoint=args.npoint,
                                      split=split,
                                      normal_channel=args.normal),
                   args.batch_size, drop_last=False)
        for split in ("train", "test"))


def modelnet_probe(model, loaders, args, device, log) -> dict:
    """The linear-SVM probe of ``model``'s frozen ``feat`` on the
    ModelNet40 ``loaders``, logged with its feature-extraction rate and
    its SVM time."""
    probe = svm_probe(make_feature_forward(model),
                      *loaders, svm_c=args.svm_c,
                      cross_val=args.cross_val_svm, device=device)
    log(f"ModelNet40 SVM probe: acc {probe['accuracy']:.4f} "
        f"(C={probe['C']}); {probe['clouds']} clouds embedded at "
        f"{probe['clouds'] / probe['extract_s']:.1f} clouds/s "
        f"({probe['load_s']:.2f} s of {probe['extract_s']:.2f} s loading), "
        f"SVM {probe['svm_ms']:.1f} ms")
    return probe


def convex_flags(args) -> dict:
    """The convex loss's arguments of ``args`` (the self-sup step's and
    the validation forward's)."""
    return dict(
        include_convex_loss=True, if_cuboid=args.if_cuboid,
        include_intersect_loss=args.include_intersect_loss,
        include_entropy_loss=args.include_entropy_loss,
        include_pruning=args.include_pruning, quantile=args.quantile,
        msc_iterations=args.msc_iterations,
        max_num_clusters=args.max_num_clusters,
        num_bandwidth_candidates=args.num_bandwidth_candidates,
        n_per_prim=args.n_per_prim, alpha=args.alpha)


def batch_transform(args, rng, augment=True):
    """The host work that turns a loader batch ``(points, chamfer_points,
    cls, seg)`` into a step's inputs, drawing from ``rng``: for the convex
    loss ``(points, cls_zero, chamfer_points)``, the encoder's
    ``--npoint`` points chosen from the chamfer cloud; for the
    contrastive loss ``(points, cls_zero, component labels)`` from the
    npoint cloud, whose labels ride along.  With ``augment`` (the train
    stream) the clouds are augmented first; validation takes them as
    they are."""

    def transform(item):
        pts, chamfer_pts, _, seg = item
        cls_zero = np.zeros((pts.shape[0], args.num_classes), np.float32)
        if args.ss_loss == "contrastive":
            if augment:
                pts = augment_pretrain(pts, args, rng)
            enc = pts[:, :, :3]
            if args.normal:
                # ACD shapes have no normals: zeros
                enc = np.concatenate([enc, np.zeros_like(enc)], -1)
            return enc.astype(np.float32), cls_zero, seg.astype(np.int64)
        if augment:
            # the JAX pretrainer augments the npoint cloud too and uses
            # only the chamfer cloud; its draws are kept, so the batches
            # are JAX's
            augment_pretrain(pts, args, rng)
            chamfer_pts = augment_pretrain(chamfer_pts, args, rng)
        choice = rng.choice(chamfer_pts.shape[1], args.npoint,
                            replace=False)
        return (chamfer_pts[:, choice, :].astype(np.float32), cls_zero,
                chamfer_pts[:, :, :3].astype(np.float32))

    return transform


def build_step(args, mod):
    """The self-sup step of ``args``: the convex loss, or the contrastive
    loss under ``--ss_loss contrastive``; both take ``(state, points,
    cls_onehot, chamfer points or component labels, lr, bn_momentum,
    lmbda, generator)``, data-parallel over the model's group."""
    if args.ss_loss == "contrastive":
        return make_contrastive_step(mod.get_selfsup_loss,
                                     margin=args.margin)
    return make_selfsup_step(**convex_flags(args))


@torch.no_grad()
def validation_loss(model, mod, loader, args, rng, generator, device,
                    on_batch=None) -> float:
    """The mean self-sup loss of ``model`` in eval mode over ``loader``
    (``pretrain:377-402``): the convex ``total_loss`` of ``--npoint``
    points chosen from each chamfer cloud with ``rng``, or the
    contrastive loss of the npoint cloud and its component labels, its
    negatives drawn from ``generator``; ``inf`` for no batch.  The
    batches are read in turn with the forwards, as in the JAX pretrainer:
    prefetched in a thread, they were no faster (``PERF.md`` §6).
    ``on_batch(vi)``, when given, is called after each batch."""
    model.eval()
    flags = convex_flags(args)
    transform = batch_transform(args, rng, augment=False)
    losses = []
    for vi, batch in enumerate(loader):
        points, cls_zero, third = (torch.as_tensor(a, device=device)
                                   for a in transform(batch))
        if args.ss_loss == "contrastive":
            loss = mod.get_selfsup_loss(model(points, cls_zero).feat, third,
                                        generator, args.margin)
        else:
            loss = model(points, cls_zero, chamfer_points=third,
                         **flags).total_loss
        losses.append(loss.item())
        if on_batch is not None:
            on_batch(vi)
    return float(np.mean(losses)) if losses else float("inf")


def main(args, device=None, on_iteration=None, on_val_batch=None,
         on_probe=None):
    """Pretrain as ``args`` say; returns the best validation loss.

    ``device``: CUDA unless a caller names another (raises without a
    GPU).  ``on_iteration(epoch, i)`` and ``on_val_batch(epoch, vi)``,
    when given, are called after each train step and each validation
    batch (timing hooks), and ``on_probe(epoch, probe)`` after each
    ModelNet40 probe with :func:`~prifit_torch.eval.svm_probe.svm_probe`'s
    result."""
    device = resolve_device(device)
    check_supported(args)
    maybe_initialize_distributed()
    mesh = make_data_mesh(args.batch_size)
    if not mesh.member:
        return None
    main_rank = dp.is_main()
    exp_dir = osp.join(args.experiment_root,
                       "pretrain_" + experiment_name(args))
    ckpt_dir = osp.join(exp_dir, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    log = dp.quiet(setup_logger("pretrain", osp.join(exp_dir,
                                                     "pretrain.log"))
                   if main_rank else None)
    log(f"PARAMETERS: {vars(args)}")
    probe_loaders = modelnet_loaders(args, log)

    rng = np.random.default_rng(args.seed)
    ss_train, ss_val = acd_split(args)
    log(f"self-sup train {len(ss_train)} / val {len(ss_val)}")
    train_loader = DataLoader(
        ss_train, shuffle=True, seed=args.seed,
        chamfer_npoints=args.chamfer_npoints, num_workers=args.num_workers,
        **dp.loader_shard(mesh, args.batch_size))
    val_loader = DataLoader(ss_val, args.batch_size, shuffle=False,
                            chamfer_npoints=args.chamfer_npoints)

    mod = get_module(args.model)
    # neither objective reads the pretrain model's AtlasNet (the convex
    # loss skips it, the contrastive loss reads ``feat``), and the JAX
    # pretrainer, initialized under the convex loss, has none: so no
    # AtlasNet is built, whatever --reconstruct says
    model = build_model(argparse.Namespace(**dict(vars(args),
                                                  reconstruct=False)),
                        mod, device)
    replicate(mesh, model)
    set_process_group(model, mesh.group("data"))
    state = create_train_state(model, optimizer=args.optimizer,
                               decay_rate=args.decay_rate)
    ss_step = build_step(args, mod)
    lmbda = args.lmbda if args.ss_loss == "contrastive" else 1.0
    generator, reseed, sr_key = dp.rank_generator(device, mesh)
    transform = batch_transform(args, rng)

    best_val = float("inf")
    metrics_path = osp.join(exp_dir, "metrics.jsonl")
    # tensorboard scalars (reference pretrain:126,363-368,402)
    tb = ScalarWriter(exp_dir) if main_rank else None
    for epoch in range(args.epoch):
        t0 = time.time()
        reseed(args.seed * 1000003 + epoch)
        lr = lr_schedule(epoch, args.learning_rate, args.lr_decay,
                         args.step_size, args.lr_clip)
        momentum = bn_momentum_schedule(epoch, args.step_size)
        log(f"Epoch {epoch + 1}/{args.epoch}: lr {lr:.6f}")

        losses = []
        # global batches an epoch: every rank runs the same count
        stream = prefetch_to_device(train_loader, transform=transform,
                                    device=device)
        for i in range(len(ss_train) // args.batch_size):
            state, m = ss_step(state, *next(stream), lr, momentum, lmbda,
                               generator, sr_key())
            losses.append(m["ss_loss"])
            if on_iteration is not None:
                on_iteration(epoch, i)
        stream.close()
        # one read of the epoch's losses to the host
        losses = torch.stack(losses).tolist()
        train_loss = float(np.mean(losses))
        val_loss = validation_loss(
            model, mod, val_loader, args, rng, generator, device,
            on_batch=None if on_val_batch is None
            else lambda vi: on_val_batch(epoch, vi))
        log(f"Epoch {epoch + 1} done in {time.time() - t0:.1f}s: "
            f"train loss {train_loss:.5f} val loss {val_loss:.5f}")
        probe = modelnet_probe(model, probe_loaders, args, device, log) \
            if probe_loaders is not None else None
        if probe is not None and on_probe is not None:
            on_probe(epoch, probe)
        if not main_rank:
            best_val = min(best_val, val_loss)
            continue
        for i, loss in enumerate(losses):
            tb.scalar("selfsup_loss_iter", loss,
                      epoch * len(losses) + i + 1)
        tb.scalar("selfsup_loss_epoch", train_loss, epoch)
        tb.scalar("train_lr", lr, epoch)
        tb.scalar("train_bn_momentum", momentum, epoch)
        tb.scalar("selfsup_loss_val", val_loss, epoch)

        extra = {"train_loss": train_loss, "val_loss": val_loss}
        if (epoch + 1) % 5 == 0:  # every 5 epochs (pretrain:428)
            save_checkpoint(ckpt_dir, f"model_{epoch + 1:03d}", epoch=epoch,
                            state=state, extra=extra)
        if val_loss < best_val:  # best by val loss (pretrain:442-454)
            best_val = val_loss
            save_checkpoint(ckpt_dir, "best_model", epoch=epoch, state=state,
                            extra=extra)
            log(f"New best val loss {val_loss:.5f}; saved best_model")
        epoch_metrics = {"epoch": epoch, "train_loss": train_loss,
                         "val_loss": val_loss, "lr": lr}
        if probe is not None:
            epoch_metrics["modelnet_svm_acc"] = probe["accuracy"]
            tb.scalar("modelnet_val", probe["accuracy"], epoch)
        with open(metrics_path, "a") as f:
            f.write(json.dumps(epoch_metrics) + "\n")
        tb.flush()
    if tb is not None:
        tb.close()
    return best_val


if __name__ == "__main__":
    main(parse_args())
