"""Joint semi-supervised part-segmentation trainer.

Port of ``prifit_tpu/cli/train_partseg.py`` (reference
``train_partseg_shapenet.py:102-496``): alternating supervised NLL steps
on few-shot labeled ShapeNet-Part and self-supervised steps (the convex
loss, or the ACD contrastive loss) on unlabeled ACD data, with the
reference's LR / BN-momentum / lambda schedules, per-epoch checkpoints,
auto-resume and the final mIoU evaluation.  The flags are the JAX
package's, with its defaults (:mod:`prifit_torch.cli.args_parser`).

Execution: the steps of :mod:`prifit_torch.train.steps` run eagerly on
one CUDA device (``main(args, device="cpu")`` runs them on the CPU).
Batches are read and augmented on the host (numpy, the JAX package's
draws, so the batches are the JAX trainer's bit for bit) in background
threads, and copied to the device on a side stream two batches ahead of
the steps (:func:`prifit_torch.data.loader.prefetch_to_device`); with
``--fused_augment`` the steps augment on the device instead.  One
``torch.Generator`` on the device drives every step's draws (the FPS
start, dropout, the ``mxsr`` rounding keys, the self-sup losses' draws,
the fused augmentation); it is seeded from ``--seed`` and the epoch at
the start of each epoch, so a resumed run draws what an uninterrupted
one would.

Not ported yet, and refused with ``NotImplementedError``: ``--sp_points``
above 1 (ROADMAP.md §1 item 5), any ``--model`` but
``pointnet2_part_seg_msg``, and its ``--extra_layers`` and
``--reconstruct`` variants (§1 item 4).

Usage (canonical recipe, README.md:60-63):
  python -m prifit_torch.cli.train_partseg --seed 786 --alpha 0.01 \\
      --split val --k_shot 10 --batch_size 24 --step_size 1 --selfsup \\
      --epoch 20 --learning_rate 0.01 --lmbda 1 --quantile 0.05 \\
      --msc_iterations 10 --max_num_clusters 25 \\
      --data_root <shapenet> --ss_path <acd>
"""

import itertools
import json
import logging
import os
import os.path as osp
import time

import numpy as np
import torch

from prifit_torch import native
from prifit_torch.cli.args_parser import parse_args
from prifit_torch.data import (
    ACDSelfSupDataset,
    DataLoader,
    PartNormalDataset,
    SelfSupPartNormalDataset,
    prefetch_to_device,
    provider,
)
from prifit_torch.entry import init_weights
from prifit_torch.eval.miou import evaluation, make_eval_forward
from prifit_torch.models import get_module
from prifit_torch.train.checkpoint import (
    restore_checkpoint,
    restore_params_only,
    save_checkpoint,
)
from prifit_torch.train.schedules import (
    bn_momentum_schedule,
    lambda_schedule,
    lr_schedule,
)
from prifit_torch.train.state import create_train_state
from prifit_torch.train.steps import (
    make_contrastive_step,
    make_selfsup_step,
    make_supervised_step,
)
from prifit_torch.utils.device import resolve_device
from prifit_torch.utils.tblog import ScalarWriter


def setup_logger(name: str, logfile: str):
    """File+stream logger that does not depend on the root logger's
    configuration (``logging.basicConfig`` is a no-op once the root
    logger has handlers)."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    for h in logger.handlers:
        h.close()
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(message)s")
    for h in (logging.StreamHandler(), logging.FileHandler(logfile)):
        h.setFormatter(fmt)
        logger.addHandler(h)
    return logger.info


def experiment_name(args) -> str:
    """Hyperparameter-encoding run directory (reference ``train:119-157``
    builds the de-facto run registry the same way)."""
    parts = [args.model, f"k{args.k_shot}", f"seed{args.seed}",
             f"bs{args.batch_size}", f"lr{args.learning_rate}"]
    if args.selfsup:
        parts += [f"ss-{args.ss_dataset}", f"lmbda{args.lmbda}",
                  f"q{args.quantile}", f"msc{args.msc_iterations}",
                  f"K{args.max_num_clusters}", f"alpha{args.alpha}"]
        if args.include_intersect_loss:
            parts.append("intersect")
        if args.include_entropy_loss:
            parts.append(f"ent{args.beta}")
        if args.if_cuboid:
            parts.append("cuboid")
    return "_".join(str(p) for p in parts)


def check_supported(args) -> None:
    """Raise ``NotImplementedError`` for the flags the port cannot run
    yet, naming the ROADMAP.md item that ports them."""
    if args.sp_points > 1:
        raise NotImplementedError(
            f"--sp_points {args.sp_points}: point-axis parallelism is not "
            f"ported yet (ROADMAP.md §1 item 5)")
    get_module(args.model)
    if args.extra_layers or args.reconstruct:
        raise NotImplementedError(
            "--extra_layers / --reconstruct: these variants of "
            "pointnet2_part_seg_msg are not ported yet (ROADMAP.md §1 "
            "item 4)")


def build_model(args, mod, device):
    """The model of ``args`` (reference ``train_partseg_shapenet.py:
    219-232``) on ``device``, with lecun-normal weights from ``--seed``
    (:func:`prifit_torch.entry.init_weights`) and fresh batch-norm
    statistics.  ``--l2_norm`` is accepted and unused, as in the JAX
    model."""
    model = mod.get_model(num_parts=args.num_parts,
                          normal_channel=args.normal,
                          compute_dtype=args.encoder_dtype,
                          stage_dtypes=args.stage_dtypes, device="cpu")
    init_weights(model, torch.Generator().manual_seed(args.seed))
    return model.to(device)


def augment_sup(points, rng):
    """The host augmentation of a batch (reference ``train:372-373``):
    isotropic scale, then shift, of the xyz columns, from ``rng``."""
    pts = points.copy()
    pts[:, :, 0:3] = provider.random_scale_point_cloud(pts[:, :, 0:3],
                                                       rng=rng)
    pts[:, :, 0:3] = provider.shift_point_cloud(pts[:, :, 0:3], rng=rng)
    return pts


def np_onehot(cls, num_classes: int) -> np.ndarray:
    return np.eye(num_classes, dtype=np.float32)[np.asarray(cls).ravel()]


def train_init_class(state, model, mod, loader, args, log,
                     num_epochs: int = 500, device=None):
    """Logistic-regression re-init of the final classifier layer.

    Reference ``train_init_class`` (``train:56-99``): ``num_epochs``
    epochs of SGD(lr=0.1, momentum=0.5) on ``conv2`` only, with the model
    in eval mode (batch-norm statistics frozen, no dropout).  The layers
    before ``conv2`` are frozen, so their features are computed without
    gradients.
    """
    device = resolve_device(device)
    conv2 = model.conv2
    opt = torch.optim.SGD(conv2.parameters(), lr=0.1, momentum=0.5)
    model.eval()
    rng = np.random.default_rng(args.seed)
    for epoch in range(num_epochs):
        losses = []
        for points, cls, target in loader:
            pts = torch.as_tensor(augment_sup(points, rng), device=device)
            onehot = torch.as_tensor(np_onehot(cls, args.num_classes),
                                     device=device)
            with torch.no_grad():
                feat = model(pts, onehot).feat
            logp = torch.log_softmax(model._head(feat, conv2), dim=-1)
            loss = mod.get_loss(logp, torch.as_tensor(
                target.astype(np.int64), device=device))
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.item())
        if epoch % 100 == 0 or epoch == num_epochs - 1:
            log(f"Init Classifier epoch {epoch + 1}/{num_epochs} "
                f"loss {np.mean(losses):.4f}")
    return state


def build_loaders(args, log):
    """``(train_loader, selfsup_loader)``: the labeled ShapeNet-Part loader
    and, under ``--selfsup``, the self-sup one (ACD, or the "dummy"
    ShapeNet-Part source), seeded as in the JAX trainer; the self-sup
    loader is None without ``--selfsup``."""
    train_ds = PartNormalDataset(
        args.data_root, npoints=args.npoint, split=args.train_split,
        normal_channel=args.normal, k_shot=args.k_shot,
        rng=np.random.default_rng(args.seed))
    train_loader = DataLoader(train_ds, args.batch_size, shuffle=True,
                              seed=args.seed, num_workers=args.num_workers)
    log(f"The number of training data is: {len(train_ds)}")
    if not args.selfsup:
        return train_loader, None

    if args.retain_overlaps:
        labeled_fns = []
    else:
        labeled_fns = list(itertools.chain(*train_ds.meta.values()))
    if args.ss_dataset == "dummy":
        log('Using "dummy" self-supervision dataset')
        ss_ds = SelfSupPartNormalDataset(
            args.data_root, npoints=args.npoint, split="trainval",
            normal_channel=args.normal, k_shot=args.n_cls_selfsup,
            labeled_fns=labeled_fns,
            rng=np.random.default_rng(args.seed + 1))
        chamfer_n = None
    else:
        log('Using "ACD" self-supervision dataset')
        ss_ds = ACDSelfSupDataset(
            args.ss_path, npoints=args.npoint,
            normal_channel=args.normal, k_shot=args.n_cls_selfsup,
            exclude_fns=labeled_fns,
            rng=np.random.default_rng(args.seed + 1))
        chamfer_n = args.chamfer_npoints
    log(f"\t{len(ss_ds)} self-sup samples")
    selfsup_loader = DataLoader(
        ss_ds, args.batch_size, shuffle=True, seed=args.seed + 1,
        chamfer_npoints=chamfer_n, num_workers=args.num_workers)
    return train_loader, selfsup_loader


def cycle(loader):
    """The loader's batches, epoch after epoch."""
    while True:
        yield from loader


def batch_transforms(args):
    """``(sup_transform, ss_transform)``: the host work that turns a
    loader batch into a step's numpy inputs, each with its own rng (as in
    the JAX trainer), so augmentation is deterministic within a stream
    whatever the other stream's pace.  ``sup_transform`` gives ``(points,
    cls_onehot, target)``; ``ss_transform`` (None without ``--selfsup``)
    gives the self-sup step's ``(points, cls_zero, chamfer_points)``, or
    the contrastive step's ``(points, cls_zero, component labels)``."""
    rng_sup = np.random.default_rng(args.seed + 17)
    rng_ss = np.random.default_rng(args.seed + 31)

    def sup_transform(batch):
        points, cls, target = batch
        pts = points if args.fused_augment else augment_sup(points, rng_sup)
        cls_onehot = np_onehot(cls, args.num_classes) if args.category \
            else np.zeros((cls.shape[0], args.num_classes), np.float32)
        return (np.ascontiguousarray(pts, np.float32), cls_onehot,
                target.astype(np.int64))

    def contrastive_transform(ss):
        ss_points = ss[0]
        ss_seg = ss[-1]
        ss_points = augment_sup(ss_points, rng_ss)
        enc_pts = ss_points[:, :, :3]
        if args.normal:
            # self-sup data has no normals: zero-pad (train:430)
            enc_pts = np.concatenate([enc_pts, np.zeros_like(enc_pts)], -1)
        cls_zero = np.zeros((ss_points.shape[0], args.num_classes),
                            np.float32)
        return (enc_pts.astype(np.float32), cls_zero,
                ss_seg.astype(np.int64))

    def selfsup_transform(ss):
        if len(ss) == 4:
            ss_points, chamfer_pts, ss_cls, _ = ss
        else:
            # "dummy" self-sup dataset has no full-res cloud; its
            # resampled points double as the chamfer target
            ss_points, ss_cls, _ = ss
            chamfer_pts = ss_points
        if args.fused_augment:
            # augmentation + resample happen inside the step; feed a
            # correctly-shaped placeholder for the encoder input
            enc_pts = chamfer_pts[:, :args.npoint, :]
        else:
            chamfer_pts = augment_sup(chamfer_pts, rng_ss)
            # reference re-samples the encoder input from the full-res
            # cloud (train:441; the dataloader's own ss_points are never
            # fed to the model)
            choice = rng_ss.choice(chamfer_pts.shape[1], args.npoint,
                                   replace=False)
            enc_pts = chamfer_pts[:, choice, :]
        if args.normal:
            enc_pts = np.concatenate(
                [enc_pts[:, :, :3], np.zeros_like(enc_pts[:, :, :3])], -1)
        cls_zero = np.zeros((enc_pts.shape[0], args.num_classes),
                            np.float32)
        return (enc_pts.astype(np.float32), cls_zero,
                chamfer_pts[:, :, :3].astype(np.float32))

    if not args.selfsup:
        return sup_transform, None
    if args.ss_loss == "contrastive":
        return sup_transform, contrastive_transform
    return sup_transform, selfsup_transform


def build_steps(args, mod):
    """``(sup_step, ss_step)``: the supervised step and, under
    ``--selfsup``, the self-sup step (the convex loss, or ``--ss_loss
    contrastive``; None without ``--selfsup``).  Both self-sup steps take
    ``(state, points, cls_onehot, chamfer_points or component labels,
    lr, bn_momentum, lmbda, generator)``."""
    sup_step = make_supervised_step(mod.get_loss,
                                    fused_augment=args.fused_augment)
    if not args.selfsup:
        return sup_step, None
    if args.ss_loss == "contrastive":
        return sup_step, make_contrastive_step(mod.get_selfsup_loss,
                                               margin=args.margin)
    # NOTE the reference gates the convex loss on --include_convex_loss
    # even under --selfsup (train:444) and its README recipe omits the
    # flag, which trains with a ZERO self-sup loss as shipped; --selfsup
    # here implies the convex loss (the paper's intent), as in the JAX
    # trainer
    return sup_step, make_selfsup_step(
        fused_augment=args.fused_augment,
        if_cuboid=args.if_cuboid,
        include_intersect_loss=args.include_intersect_loss,
        include_entropy_loss=args.include_entropy_loss,
        include_pruning=args.include_pruning,
        quantile=args.quantile, msc_iterations=args.msc_iterations,
        max_num_clusters=args.max_num_clusters,
        num_bandwidth_candidates=args.num_bandwidth_candidates,
        n_per_prim=args.n_per_prim, alpha=args.alpha)


def main(args, device=None, on_iteration=None):
    """Train as ``args`` say; returns the final evaluation's metrics.

    ``device``: CUDA unless a caller names another (raises without a
    GPU).  ``on_iteration(epoch, i)``, when given, is called after each
    iteration's steps (a timing hook)."""
    device = resolve_device(device)
    check_supported(args)
    exp_dir = osp.join(args.experiment_root, experiment_name(args))
    ckpt_dir = osp.join(exp_dir, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    log = setup_logger("train", osp.join(exp_dir, "train.log"))
    log(f"PARAMETERS: {vars(args)}")
    log(f"device {device}; point files parsed by the "
        f"{native.parser_name()} parser")
    metrics_path = osp.join(exp_dir, "metrics.jsonl")
    # tensorboard scalars next to the jsonl (reference train:170,477-480)
    tb = ScalarWriter(exp_dir)

    train_loader, selfsup_loader = build_loaders(args, log)

    # ---------------------------------------------------------- model
    mod = get_module(args.model)
    model = build_model(args, mod, device)
    state = create_train_state(model, optimizer=args.optimizer,
                               decay_rate=args.decay_rate)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"Model {args.model}: {n_params / 1e6:.2f}M params")

    # resume and warm-start are mutually exclusive like the reference
    # (train:263-280): a warm-started run begins at epoch 0; auto-resume
    # picks up an interrupted run from its last checkpoint
    start_epoch = 0
    if args.pretrained_model is not None:
        d, n = osp.split(args.pretrained_model)
        state = restore_params_only(d, n, state, log=log)
        log(f"Warm-started from {args.pretrained_model}")
        if args.init_cls:
            state = train_init_class(state, model, mod, train_loader,
                                     args, log, device=device)
    else:
        try:
            state, start_epoch = restore_checkpoint(ckpt_dir, "last_model",
                                                    state)
            log(f"Resumed from epoch {start_epoch}")
            start_epoch += 1
        except FileNotFoundError:
            log("No existing model, starting training from scratch...")

    sup_step, ss_step = build_steps(args, mod)
    generator = torch.Generator(device=device)
    best_metrics = {"best_class_avg_miou": 0.0, "best_acc": 0.0,
                    "best_epoch": 0, "best_instance_avg_miou": 0.0,
                    "best_chamfer_loss": float("inf")}
    eval_cache = {}

    # --------------------------------------------- prefetched streams
    # Host-side augmentation and the copy to the device run in background
    # threads, two batches ahead of the steps (prefetch_to_device).
    sup_transform, ss_transform = batch_transforms(args)

    def stream(loader, transform):
        return prefetch_to_device(cycle(loader), transform=transform,
                                  device=device)

    sup_stream = stream(train_loader, sup_transform)
    ss_stream = stream(selfsup_loader, ss_transform) \
        if ss_step is not None else None

    # ---------------------------------------------------------- epochs
    for epoch in range(start_epoch, args.epoch):
        t0 = time.time()
        generator.manual_seed(args.seed * 1000003 + epoch)
        lr = lr_schedule(epoch, args.learning_rate, args.lr_decay,
                         args.step_size, args.lr_clip)
        momentum = bn_momentum_schedule(epoch, args.step_size)
        lmbda = lambda_schedule(epoch, args.lmbda, args.anneal_lambda,
                                args.anneal_rate, args.anneal_step)
        log(f"Epoch {epoch + 1}/{args.epoch}: lr {lr:.6f} "
            f"bn-momentum {momentum:.4f} lambda {lmbda:.4f}")

        num_iters = args.epoch_iters or (
            len(selfsup_loader) if args.selfsup else len(train_loader))
        mean_correct, sup_losses, ss_losses = [], [], []

        for i in range(num_iters):
            # ---------------- supervised step (batch pre-augmented and
            # on the device from the sup_stream prefetcher)
            points, cls_onehot, target = next(sup_stream)
            state, m = sup_step(state, points, cls_onehot, target, lr,
                                momentum, generator)
            mean_correct.append(m["acc"])
            sup_losses.append(m["loss"])

            # ---------------- self-supervised step, in the port's
            # argument order (points, cls_onehot, then the chamfer points
            # or the component labels)
            if ss_step is not None:
                enc_pts, cls_zero, third = next(ss_stream)
                state, m = ss_step(state, enc_pts, cls_zero, third, lr,
                                   momentum, lmbda, generator)
                ss_losses.append(m["ss_loss"])
            if on_iteration is not None:
                on_iteration(epoch, i)

        # one read of the epoch's metrics to the host
        train_acc = torch.stack(mean_correct).mean().item()
        sup_loss = torch.stack(sup_losses).mean().item()
        msg = (f"Epoch {epoch + 1} done in {time.time() - t0:.1f}s: "
               f"train acc {train_acc:.5f} sup loss {sup_loss:.5f}")
        ss_loss = None
        if ss_losses:
            ss_loss = torch.stack(ss_losses).mean().item()
            msg += f" ss loss {ss_loss:.5f}"
        log(msg)

        save_checkpoint(ckpt_dir, f"model_{epoch + 1:03d}", epoch=epoch,
                        state=state, extra={"train_acc": train_acc})
        save_checkpoint(ckpt_dir, "last_model", epoch=epoch, state=state,
                        extra={"train_acc": train_acc})
        with open(metrics_path, "a") as f:
            f.write(json.dumps({
                "epoch": epoch, "train_acc": train_acc, "lr": lr,
                "bn_momentum": momentum, "lambda": lmbda}) + "\n")
        # scalar names mirror the reference (train:477-480)
        tb.scalar("train_acc", train_acc, epoch)
        tb.scalar("train_lr", lr, epoch)
        tb.scalar("train_bn_momentum", momentum, epoch)
        tb.scalar("selfsup_lambda", lmbda, epoch)
        tb.scalar("train_loss", sup_loss, epoch)
        if ss_loss is not None:
            tb.scalar("selfsup_loss", ss_loss, epoch)
        tb.flush()

        if args.eval_every and (epoch + 1) % args.eval_every == 0:
            prev_best = best_metrics["best_class_avg_miou"]
            run_evaluation(args, epoch, model, state, log,
                           metrics=best_metrics, cache=eval_cache,
                           device=device)
            if best_metrics["best_class_avg_miou"] > prev_best:
                # checkpoint the actual best-mIoU model
                save_checkpoint(ckpt_dir, "best_model", epoch=epoch,
                                state=state, extra={
                                    "class_avg_miou":
                                        best_metrics["best_class_avg_miou"]})

    # retire the prefetch producer threads (the cycling streams never
    # exhaust on their own)
    sup_stream.close()
    if ss_stream is not None:
        ss_stream.close()

    # final evaluation (reference train:487)
    metrics = run_evaluation(args, args.epoch - 1, model, state, log,
                             metrics=best_metrics, cache=eval_cache,
                             device=device)
    if not osp.exists(osp.join(ckpt_dir, "best_model")):
        save_checkpoint(ckpt_dir, "best_model", epoch=args.epoch - 1,
                        state=state, extra={
                            "class_avg_miou": metrics["class_avg_iou"]})
    with open(metrics_path, "a") as f:
        f.write(json.dumps({"final_eval": metrics}) + "\n")
    tb.close()
    return metrics


def run_evaluation(args, epoch, model, state, log, metrics=None,
                   cache=None, device=None):
    """Evaluate ``model`` on ``--eval_split``; the dataset and loader are
    built once and kept in ``cache``.  Short tail batches are padded to
    ``--batch_size`` (``evaluation``'s ``pad_to``), as in the JAX
    trainer."""
    device = resolve_device(device)
    cache = cache if cache is not None else {}
    if "loader" not in cache:
        eval_ds = PartNormalDataset(
            args.data_root, npoints=args.npoint, split=args.eval_split,
            normal_channel=args.normal,
            rng=np.random.default_rng(args.seed))
        cache["loader"] = DataLoader(eval_ds, args.batch_size,
                                     shuffle=False, drop_last=False,
                                     num_workers=args.num_workers)
        log(f"The number of test data is: {len(eval_ds)}")
    return evaluation(
        make_eval_forward(model), cache["loader"], num_parts=args.num_parts,
        epoch=epoch, log=log, metrics=metrics, device=device,
        pad_to=args.batch_size)


if __name__ == "__main__":
    main(parse_args())
