"""The port's part-seg trainer (``python -m prifit_torch.cli.train_partseg``)
end to end on the CPU, at a small size (npoint 48, batch 2, one
iteration an epoch).

Each run must give finite losses, the JAX trainer's ``metrics.jsonl``
keys and its checkpoint names: a supervised plus convex self-sup epoch at
the default encoder dtype and its resume (``epoch``, ``step`` and the
self-sup ``beta`` restored), a contrastive epoch, a ``--fused_augment``
epoch, an ``--init_cls`` warm start from a saved checkpoint (with the
classifier re-init cut to one epoch) and epochs of the ``--extra_layers``
and ``--reconstruct`` variants.  ``--sp_points 2`` in one process exits
with the JAX trainer's check, and the registry's classification and
semantic-segmentation models raise a ``TypeError`` (the trainer builds
part-seg models); the trainer's other part-seg models are run by
``test_torch_trainer_models.py``.
"""

import functools
import json
import os
import os.path as osp
import re

import numpy as np
import pytest
import torch

from prifit_torch.cli import train_partseg as T
from prifit_torch.cli.args_parser import parse_args
from prifit_torch.data import DataLoader, PartNormalDataset
from prifit_torch.train.checkpoint import save_checkpoint
from tests.fixtures import make_acd_fixture, make_shapenet_fixture

torch.set_num_threads(1)

# the keys of the JAX trainer's metrics.jsonl lines
# (prifit_tpu/cli/train_partseg.py:493-495, 535)
EPOCH_KEYS = {"epoch", "train_acc", "lr", "bn_momentum", "lambda"}
METRIC_KEYS = {"accuracy", "class_avg_accuracy", "class_avg_iou",
               "instance_avg_iou", "chamfer_loss", "best_class_avg_miou",
               "best_acc", "best_epoch", "best_instance_avg_miou",
               "best_chamfer_loss"}


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer")
    sn = make_shapenet_fixture(str(tmp / "sn"), n_per_cat=4, n_points=64)
    acd = make_acd_fixture(str(tmp / "acd"), n_shapes=4, n_points=96)
    return sn, acd


def _args(roots, tmp, *extra):
    sn, acd = roots
    return parse_args([
        "--epoch", "1", "--epoch_iters", "1", "--batch_size", "2",
        "--npoint", "48", "--k_shot", "2", "--data_root", sn,
        "--ss_path", acd, "--chamfer_npoints", "96", "--quantile", "0.2",
        "--msc_iterations", "2", "--max_num_clusters", "4",
        "--n_per_prim", "16", "--num_workers", "2",
        "--learning_rate", "0.005", "--experiment_root", str(tmp), *extra])


def _run(args):
    metrics = T.main(args, device="cpu")
    exp = osp.join(args.experiment_root, T.experiment_name(args))
    with open(osp.join(exp, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    with open(osp.join(exp, "train.log")) as f:
        log = f.read()
    assert set(metrics) == METRIC_KEYS
    assert 0.0 <= metrics["instance_avg_iou"] <= 1.0
    epochs = [line for line in lines if "final_eval" not in line]
    assert all(set(line) == EPOCH_KEYS for line in epochs)
    assert all(np.isfinite(line["train_acc"]) for line in epochs)
    assert lines[-1] == {"final_eval": metrics}
    losses = [float(x) for x in re.findall(r"loss ([-+0-9.enai]+)", log)]
    assert losses and all(np.isfinite(losses)), log
    return metrics, exp, lines, log


def _ckpt(exp, name):
    return torch.load(osp.join(exp, "checkpoints", name),
                      weights_only=False)


def test_convex_epoch_and_resume(roots, tmp_path):
    """A supervised + convex self-sup epoch at the default dtype, then a
    second epoch that resumes from its ``last_model``."""
    args = _args(roots, tmp_path, "--selfsup")
    assert args.encoder_dtype == "auto"
    _, exp, lines, log = _run(args)
    assert "ss loss" in log
    assert sorted(os.listdir(osp.join(exp, "checkpoints"))) == \
        ["best_model", "last_model", "model_001"]
    first = _ckpt(exp, "last_model")
    assert first["epoch"] == 0 and first["step"] == 2
    # beta starts at 1.0 (--beta only names the run) and decays once a
    # self-sup step
    assert first["model_state_dict"]["beta"].item() == pytest.approx(0.99)

    args.epoch = 2
    _, exp2, lines, log = _run(args)
    assert exp2 == exp and "Resumed from epoch 0" in log
    assert [line["epoch"] for line in lines if "epoch" in line] == [0, 1]
    second = _ckpt(exp, "last_model")
    assert second["epoch"] == 1 and second["step"] == 4
    assert second["model_state_dict"]["beta"].item() == \
        pytest.approx(0.99 * 0.99)
    assert "model_002" in os.listdir(osp.join(exp, "checkpoints"))


def test_contrastive_epoch(roots, tmp_path):
    _, exp, _, log = _run(_args(roots, tmp_path, "--selfsup", "--ss_loss",
                                "contrastive", "--encoder_dtype", "f32"))
    assert "ss loss" in log
    # the contrastive step never runs the convex loss: beta stays 1
    assert _ckpt(exp, "last_model")["model_state_dict"]["beta"].item() == 1.0


def test_fused_augment_epoch(roots, tmp_path):
    _, exp, _, log = _run(_args(roots, tmp_path, "--selfsup",
                                "--fused_augment", "--encoder_dtype", "f32"))
    assert "ss loss" in log
    assert _ckpt(exp, "last_model")["step"] == 2


@pytest.mark.parametrize("variant", ["--extra_layers", "--reconstruct"])
def test_variant_epoch(roots, tmp_path, variant):
    """A supervised + convex self-sup epoch of a ``pointnet2_part_seg_msg``
    variant at the default dtype; its checkpoint holds the variant's
    layers (the embedding tower, or AtlasNet)."""
    _, exp, _, log = _run(_args(roots, tmp_path, "--selfsup", variant))
    assert "ss loss" in log
    sd = _ckpt(exp, "last_model")["model_state_dict"]
    key = "fp1_embed_conv1.weight" if variant == "--extra_layers" \
        else "atlasnet.decoder.convs.0.weight"
    assert key in sd
    assert sd["beta"].item() == pytest.approx(0.99)


def test_init_cls_from_checkpoint(roots, tmp_path, monkeypatch):
    """``--pretrained_model`` with ``--init_cls``: a warm start from a
    saved checkpoint, then the classifier re-init (cut to one epoch
    here), then training from epoch 0."""
    args = _args(roots, tmp_path / "a", "--encoder_dtype", "f32")
    state = T.create_train_state(
        T.build_model(args, T.get_module(args.model), "cpu"))
    ckpt = save_checkpoint(str(tmp_path / "a"), "best_model", epoch=4,
                           state=state)
    monkeypatch.setattr(T, "train_init_class", functools.partial(
        T.train_init_class, num_epochs=1))
    warm = _args(roots, tmp_path / "b", "--encoder_dtype", "f32",
                 "--pretrained_model", ckpt, "--init_cls")
    _, _, lines, log = _run(warm)
    assert "Warm-started from" in log and "Init Classifier epoch 1/1" in log
    assert lines[0]["epoch"] == 0


def test_train_init_class_touches_only_conv2(roots):
    args = _args(roots, "unused", "--encoder_dtype", "f32")
    mod = T.get_module(args.model)
    model = T.build_model(args, mod, "cpu")
    state = T.create_train_state(model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ds = PartNormalDataset(args.data_root, npoints=48, split="train",
                           rng=np.random.default_rng(0))
    T.train_init_class(state, model, mod, DataLoader(ds, 2), args,
                       lambda *_: None, num_epochs=1, device="cpu")
    for k, v in model.state_dict().items():
        if k.startswith("conv2."):
            assert not torch.equal(v, before[k]), k
        else:
            assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("extra,error,match", [
    (("--sp_points", "2"), SystemExit, "must divide the device count"),
    (("--model", "pointnet_cls"), TypeError, "part-seg models"),
    (("--model", "pointnet2_cls_msg"), TypeError, "part-seg models"),
    (("--model", "pointnet2_sem_seg"), TypeError, "part-seg models"),
])
def test_unported_flags_raise(roots, tmp_path, extra, error, match):
    """``--sp_points 2`` in one process fails the JAX trainer's check
    (the point axis needs as many ranks), before anything is written;
    the classification and sem-seg models are ported, but the trainer
    builds part-seg models only and refuses them with a ``TypeError``,
    as the JAX trainer's ``build_model`` fails on their constructors."""
    with pytest.raises(error, match=match):
        T.main(_args(roots, tmp_path, "--selfsup", *extra), device="cpu")
    assert not os.listdir(tmp_path)


def test_unknown_model_and_no_gpu_raise(roots, tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="unknown model"):
        T.main(_args(roots, tmp_path, "--model", "nope"), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.main(_args(roots, tmp_path))
