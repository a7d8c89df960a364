"""The port's part-seg trainer and eval CLI with the other models the
JAX trainer builds, end to end on the CPU at a small size (npoint 48,
batch 2, one epoch of 2 iterations, ``tests/fixtures.py`` trees).

Each ``--model`` trains with ``--selfsup``: ``dgcnn`` with the convex
loss (its kNN graph of ``--dgcnn_k`` neighbours), ``pointnet2_part_seg_ssg``
at the default encoder dtype (``mxsr``) with the zero-loss self-sup step
(the model has no convex loss), ``pointnet_part_seg`` and
``reconstruction`` with ``--ss_loss contrastive``.  Each run must give
finite losses, the JAX trainer's ``metrics.jsonl`` keys and checkpoint
names, and ``cli/testing.py`` on its ``best_model`` must give the final
eval's metrics.  ``--init_cls`` re-initializes the layer named ``conv2``
through the whole eval forward (in ``pointnet_part_seg`` an encoder
layer) and refuses ``dgcnn``, which has none, as the JAX trainer fails
there.
"""

import os.path as osp

import numpy as np
import pytest
import torch

from prifit_torch.cli import testing
from prifit_torch.cli import train_partseg as T
from prifit_torch.data import DataLoader, PartNormalDataset
from test_torch_trainer import _args, _ckpt, _run, roots  # noqa: F401

torch.set_num_threads(1)

RUNS = {
    "dgcnn": ("--selfsup", "--dgcnn_k", "8"),
    "pointnet2_part_seg_ssg": ("--selfsup",),
    "pointnet_part_seg": ("--selfsup", "--ss_loss", "contrastive"),
    "reconstruction": ("--selfsup", "--ss_loss", "contrastive"),
}
# a state_dict key only the model has
KEYS = {"dgcnn": "dgcnn.encoder.edge_convs.2.conv.weight",
        "pointnet2_part_seg_ssg": "sa1.mlp_convs.0.weight",
        "pointnet_part_seg": "fstn.fc3.weight",
        "reconstruction": "atlasnet.decoder.convs.0.weight"}


@pytest.mark.parametrize("model", list(RUNS))
def test_model_trains_and_evaluates(roots, tmp_path, model):  # noqa: F811
    args = _args(roots, tmp_path, "--model", model, "--epoch_iters", "2",
                 *RUNS[model])
    metrics, exp, _, log = _run(args)
    assert f"Model {model}:" in log and "ss loss" in log
    ckpt = _ckpt(exp, "last_model")
    assert ckpt["step"] == 4 and KEYS[model] in ckpt["model_state_dict"]
    # only the MSG models carry the self-sup entropy weight
    assert "beta" not in ckpt["model_state_dict"]
    targs = _args(roots, tmp_path, "--model", model, *RUNS[model][1:],
                  "--pretrained_model",
                  osp.join(exp, "checkpoints", "best_model"))
    res = testing.main(targs, device="cpu", log=lambda *_: None)
    assert res["instance_avg_iou"] == pytest.approx(
        metrics["instance_avg_iou"], abs=1e-6)


def test_ssg_selfsup_loss_is_zero(roots, tmp_path):  # noqa: F811
    """The SSG self-sup step takes a zero loss, as the JAX trainer's."""
    _, _, _, log = _run(_args(roots, tmp_path, "--model",
                              "pointnet2_part_seg_ssg", "--selfsup",
                              "--encoder_dtype", "f32"))
    assert "ss loss 0.00000" in log


def _init_cls(roots, model):  # noqa: F811
    args = _args(roots, "unused", "--model", model, "--dgcnn_k", "8")
    mod = T.get_module(model)
    net = T.build_model(args, mod, "cpu")
    state = T.create_train_state(net)
    ds = PartNormalDataset(args.data_root, npoints=48, split="train",
                           rng=np.random.default_rng(0))
    before = {k: v.clone() for k, v in net.state_dict().items()}
    T.train_init_class(state, net, mod, DataLoader(ds, 2), args,
                       lambda *_: None, num_epochs=1, device="cpu")
    return net, before


def test_init_cls_trains_pointnet_conv2(roots):  # noqa: F811
    """In ``pointnet_part_seg``, ``conv2`` is the encoder's second layer:
    it alone moves, with its gradient through the layers after it; every
    parameter takes gradients again afterwards."""
    net, before = _init_cls(roots, "pointnet_part_seg")
    for k, v in net.state_dict().items():
        assert torch.equal(v, before[k]) != k.startswith("conv2."), k
    assert all(p.requires_grad for p in net.parameters())


def test_init_cls_refuses_dgcnn(roots):  # noqa: F811
    with pytest.raises(ValueError, match="conv2"):
        _init_cls(roots, "dgcnn")
