"""Standalone evaluation entry point (port of
``prifit_tpu/cli/testing.py``, reference ``testing.py:252-254``).

  python -m prifit_torch.cli.testing --pretrained_model <ckpt> \\
      --model pointnet2_part_seg_msg --data_root <shapenet>

``--model`` takes every model the trainer builds, through the trainer's
own ``build_model``.  ``--pretrained_model`` is a checkpoint the port's
trainer wrote (``checkpoints/best_model``, ...) or a reference torch
``.pth``.  Runs on CUDA unless ``main(args, device="cpu")`` is called;
under ``torchrun`` each batch is sharded over the data mesh of the most
ranks that divide ``--batch_size`` and the logits gathered, as the JAX
CLI shards it (:mod:`prifit_torch.cli.dp`).
"""

import os.path as osp

import numpy as np

from prifit_torch.cli import dp
from prifit_torch.cli.args_parser import parse_args
from prifit_torch.cli.train_partseg import build_model, check_supported
from prifit_torch.data import DataLoader, PartNormalDataset
from prifit_torch.eval.miou import evaluation, make_eval_forward
from prifit_torch.models import get_module
from prifit_torch.parallel import make_data_mesh, \
    maybe_initialize_distributed
from prifit_torch.train.checkpoint import restore_params_only
from prifit_torch.train.state import create_train_state
from prifit_torch.utils.device import resolve_device


def main(args, device=None, log=print):
    """Evaluate the model of ``args`` on ``--eval_split``; returns
    ``evaluation``'s metrics."""
    device = resolve_device(device)
    check_supported(args)
    maybe_initialize_distributed()
    mesh = make_data_mesh(args.batch_size)
    if not mesh.member:
        return None
    log = dp.quiet(log)
    model = build_model(args, get_module(args.model), device)
    state = create_train_state(model)
    if args.pretrained_model is not None:
        d, n = osp.split(args.pretrained_model)
        state = restore_params_only(d, n, state, log=log)
        log(f"Loaded pretrained model from {args.pretrained_model}")

    eval_ds = PartNormalDataset(
        args.data_root, npoints=args.npoint, split=args.eval_split,
        normal_channel=args.normal, rng=np.random.default_rng(args.seed))
    log(f"The number of test data is: {len(eval_ds)}")
    eval_loader = DataLoader(eval_ds, args.batch_size, shuffle=False,
                             drop_last=False, num_workers=args.num_workers)
    # tail batches are padded to batch_size, as in the JAX package
    return evaluation(dp.sharded_forward(make_eval_forward(model), mesh),
                      eval_loader,
                      num_parts=args.num_parts, device=device,
                      pad_to=args.batch_size, log=log)


if __name__ == "__main__":
    main(parse_args())
