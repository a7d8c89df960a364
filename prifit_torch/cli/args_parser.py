"""Flag system — one flat parser shared by the port's entry points.

The port's copy of ``prifit_tpu/cli/args_parser.py``: the same flags,
defaults and choices (reference ``args_parser.py:3-85`` plus the JAX
package's additions at the bottom: ``--data_root``, ``--n_per_prim``,
``--chamfer_npoints`` and the rest).  ``--gpu`` and ``--cudnn_off`` are
accepted and unused; the device is the entry point's ``device`` argument
(CUDA unless a caller names another).
"""

import argparse


def parse_args(argv=None):
    parser = argparse.ArgumentParser("Train PointNet++ PartSeg Model")
    add = parser.add_argument
    add("--model", type=str, default="pointnet2_part_seg_msg")
    add("--batch_size", type=int, default=16)
    add("--epoch", default=251, type=int)
    add("--learning_rate", default=0.001, type=float)
    add("--gpu", type=str, default=None, help="unused (parity)")
    add("--cudnn_off", action="store_true", default=False,
        help="unused (parity)")
    add("--seed", type=int, default=0)
    add("--optimizer", type=str, default="Adam")
    add("--decay_rate", type=float, default=1e-4)
    add("--npoint", type=int, default=2048)
    add("--category", action="store_true", default=False)
    add("--l2_norm", action="store_true", default=False)
    add("--step_size", type=int, default=20)
    add("--rotation_z", action="store_true", default=False)
    add("--rotation_z_45", action="store_true", default=False)
    add("--random_anisotropic_scale", action="store_true", default=False)
    add("--modelnet_val", action="store_true", default=False)
    add("--lr_clip", type=float, default=1e-5)
    add("--lr_decay", type=float, default=0.5)
    add("--dgcnn_k", type=int, default=20)
    add("--num_classes", type=int, default=16)
    add("--num_parts", type=int, default=50)
    # self-supervised loss settings
    add("--selfsup", action="store_true", default=False)
    add("--margin", type=float, default=0.5)
    add("--lmbda", type=float, default=10.0)
    add("--n_cls_selfsup", type=int, default=-1)
    add("--ss_dataset", type=str, default="acd")
    add("--ss_path", type=str, default="data/ShapeNetACD")
    add("--retain_overlaps", action="store_true", default=False)
    add("--anneal_lambda", action="store_true", default=False)
    add("--anneal_step", type=int, default=5)
    add("--anneal_rate", type=float, default=0.5)
    # few-shot settings
    add("--k_shot", type=int, default=-1)
    add("--pretrained_model", type=str, default=None)
    add("--init_cls", action="store_true", default=False)
    add("--train_split", type=str, default="trainval")
    add("--eval_split", type=str, default="test")
    add("--quantile", type=float, default=0.01)
    add("--msc_iterations", type=int, default=20)
    add("--max_num_clusters", type=int, default=25)
    add("--include_convex_loss", action="store_true", default=False)
    add("--include_intersect_loss", action="store_true", default=False)
    add("--include_entropy_loss", action="store_true", default=False)
    add("--include_pruning", action="store_true", default=False)
    add("--alpha", type=float, default=1)
    add("--beta", type=float, default=0.01)
    add("--if_cuboid", action="store_true", default=False)
    add("--reconstruct", action="store_true", default=False)
    add("--extra_layers", action="store_true", default=False)
    add("--num_charts", type=int, default=25)
    add("--num_points", type=int, default=128)
    add("--embed", action="store_true", default=False)
    add("--ckpt", type=str, default=None)
    add("--num_point", type=int, default=1024)
    add("--log_dir", type=str, default="pointnet2_part_seg_msg")
    add("--normal", action="store_true", default=False)
    add("--sqrt", action="store_true", default=False)
    add("--num_votes", type=int, default=3)
    add("--cross_val_svm", action="store_true", default=False)
    add("--svm_c", type=float, default=220.0)
    add("--val_svm", action="store_true", default=False)
    add("--svm_jitter", action="store_true", default=False)
    add("--do_sa3", action="store_true", default=False)
    add("--random_feats", action="store_true", default=False)
    # split flag used by the canonical recipe (README.md:60); the reference
    # forwards it as PartNormalDataset's split via train_split
    add("--split", type=str, default=None,
        help="alias: overrides --train_split when set")
    # --- additions of the JAX package ---
    add("--data_root", type=str,
        default="data/shapenetcore_partanno_segmentation_benchmark_v0_normal")
    add("--n_per_prim", type=int, default=256,
        help="surface samples per primitive slot (replaces the "
             "reference's 10000-total ragged allocation)")
    add("--chamfer_npoints", type=int, default=5000,
        help="fixed collation size for full-resolution chamfer clouds")
    add("--num_bandwidth_candidates", type=int, default=2,
        help="parallel quantile-doubling candidates (reference retry loop)")
    add("--experiment_root", type=str, default="log")
    add("--ss_loss", type=str, default="convex",
        choices=["convex", "contrastive"],
        help="self-sup objective: PRIFIT convex fitting loss (default) or "
             "the original ACD pairwise contrastive loss (the reference "
             "constructs the latter at train:235 but bypasses it)")
    add("--fused_augment", action="store_true", default=False,
        help="apply scale+shift augmentation on the device inside the "
             "train step (zero host augmentation)")
    add("--eval_every", type=int, default=0,
        help="run evaluation every K epochs (0 = only at the end)")
    add("--num_workers", type=int, default=4,
        help="loader worker threads (the reference hard-codes "
             "DataLoader(num_workers=4), train_partseg_shapenet.py:178); "
             "0 = synchronous.  Batches are bit-identical either way")
    add("--epoch_iters", type=int, default=0,
        help="override iterations per epoch (0 = reference semantics: "
             "len(selfsup loader) under --selfsup, else len(train "
             "loader)).  Lets a supervised-only arm run the exact epoch "
             "structure of a joint run for matched-budget comparisons")
    add("--sp_points", type=int, default=1,
        help="shard the self-sup point axis over this many devices "
             "(ring mean-shift + psum fitting).  1 = batch-only; the "
             "port raises for more until point parallelism is ported")
    add("--stage_dtypes", type=str, default="",
        help="per-encoder-stage dtype overrides for the bf16 bisection, "
             "e.g. 'sa1:bf16,fp2:q' (bf16 = stage MLP in bf16; q = f32 "
             "compute with output quantized to bf16, exact gradients)")
    add("--encoder_dtype", type=str, default="auto",
        choices=["auto", "f32", "bf16", "sa_bf16", "mx", "mxsr"],
        help="encoder MLP compute dtype. auto == mxsr (bf16 storage "
             "fwd+bwd with STOCHASTICALLY-rounded cotangents, "
             "nn/mixed.py: unbiased casts give f32-grade few-shot "
             "accuracy on two data families at f32-matching step time — "
             "STATUS.md rounds 3-4; heads, BN stats and the convex-loss "
             "geometry always f32). f32 restores the pre-round-5 "
             "default; bf16 destabilizes few-shot training via biased "
             "COTANGENT rounding (round-3 bisection) and is kept with "
             "sa_bf16 as a measured A/B; mx = bf16 activations with "
             "exact f32 cotangents (mxsr's ancestor, slower)")
    args = parser.parse_args(argv)
    if args.split is not None:
        args.train_split = args.split
    return args
