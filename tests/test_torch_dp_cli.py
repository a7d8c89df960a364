"""The port's CLIs under data parallelism on the CPU: 2 gloo ranks (the
harness of ``test_torch_parallel.py``) run, on fixture trees,

- ``train_partseg`` warm-started with ``--init_cls`` on a labeled set of 9
  shapes at ``--batch_size 2``: the round-robin shards hold 5 and 4
  shapes, so a loop over each rank's own loader would run 5 batches on
  one rank and 4 on the other, and pair its gradient all-reduces wrongly;
- ``pretrain_partseg`` for one epoch with the ModelNet40 probe;
- ``testing`` on the trainer's ``best_model``, against the one-process
  evaluation of the same checkpoint.

All of it runs in one spawn; the tests read its results.  This module
imports no JAX.
"""

import functools
import json
import os
import os.path as osp

import numpy as np
import pytest
import torch
import torch.distributed as dist

from prifit_torch.cli.args_parser import parse_args
from test_torch_parallel import spawn_run

torch.set_num_threads(1)

SS = ["--quantile", "0.2", "--msc_iterations", "2", "--max_num_clusters",
      "4", "--n_per_prim", "16"]
INIT_EPOCHS = 2


def _train_argv(root, ckpt):
    return ["--epoch", "1", "--epoch_iters", "1", "--batch_size", "2",
            "--npoint", "48", "--data_root", root["sn"],
            "--encoder_dtype", "f32", "--num_workers", "0",
            "--pretrained_model", ckpt, "--init_cls",
            "--experiment_root", osp.join(root["tmp"], "train")]


def _pretrain_argv(root):
    return ["--model", "pretrain_pointnet2_part_seg_msg", "--epoch", "1",
            "--batch_size", "2", "--npoint", "48", "--chamfer_npoints", "96",
            "--ss_path", root["acd"], "--encoder_dtype", "f32",
            "--modelnet_val", "--num_workers", "0",
            "--experiment_root", osp.join(root["tmp"], "pretrain"), *SS]


def _testing_argv(root, ckpt):
    return ["--batch_size", "2", "--npoint", "48", "--data_root", root["sn"],
            "--encoder_dtype", "f32", "--pretrained_model", ckpt]


def _task_clis(rank, world, root):
    """The three CLIs on this rank, in turn."""
    from prifit_torch.cli import pretrain_partseg as P
    from prifit_torch.cli import testing
    from prifit_torch.cli import train_partseg as T

    out = {}
    # the re-init's gradient all-reduces and batches, on this rank
    reduces, batches = [0], [0]
    average = T.average_gradients

    def counted_average(*a, **k):
        reduces[0] += 1
        return average(*a, **k)

    def counted_init(state, model, mod, loader, *a, **k):
        def counted_batches(it):
            for b in it:
                batches[0] += 1
                yield b

        class Counted:
            dataset = loader.dataset

            def __iter__(self):
                return counted_batches(loader)

        state = init_class(state, model, mod, Counted(), *a, **k)
        out["conv2"] = {n: p.detach().numpy().copy()
                        for n, p in model.conv2.named_parameters()}
        return state

    init_class = functools.partial(T.train_init_class,
                                   num_epochs=INIT_EPOCHS)
    T.average_gradients = counted_average
    T.train_init_class = counted_init
    args = parse_args(_train_argv(root, root["ckpt"]))
    out["train"] = T.main(args, device="cpu")
    out["exp"] = osp.join(args.experiment_root, T.experiment_name(args))
    out["reduces"], out["batches"] = reduces[0], batches[0]
    # rank 0 writes best_model after the final evaluation
    dist.barrier()

    probes = []
    out["pretrain"] = P.main(parse_args(_pretrain_argv(root)), device="cpu",
                             on_probe=lambda e, p: probes.append(
                                 p["accuracy"]))
    out["probes"] = probes

    best = osp.join(out["exp"], "checkpoints", "best_model")
    out["testing"] = testing.main(parse_args(_testing_argv(root, best)),
                                  device="cpu", log=lambda *_: None)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2-rank spawn, and the one-process evaluation of the trainer's
    ``best_model``."""
    from prifit_torch.cli import testing
    from prifit_torch.cli import train_partseg as T
    from prifit_torch.train.checkpoint import save_checkpoint
    from prifit_torch.train.state import create_train_state
    from tests.fixtures import make_acd_fixture, make_modelnet_fixture, \
        make_shapenet_fixture

    tmp = tmp_path_factory.mktemp("dp_cli")
    root = dict(tmp=str(tmp),
                sn=make_shapenet_fixture(str(tmp / "sn"), n_per_cat=4,
                                         n_points=64),
                acd=make_acd_fixture(str(tmp / "data" / "acd"), n_shapes=6,
                                     n_points=96))
    make_modelnet_fixture(str(tmp / "data" / "modelnet40_normal_resampled"),
                          n_classes=3, n_per_class=3, n_points=64)
    args = parse_args(_train_argv(root, "unused"))
    state = create_train_state(T.build_model(args, T.get_module(args.model),
                                             "cpu"))
    root["ckpt"] = save_checkpoint(str(tmp / "warm"), "best_model", epoch=0,
                                   state=state)
    ranks = spawn_run(2, _task_clis, root)
    best = osp.join(ranks[0]["exp"], "checkpoints", "best_model")
    one = testing.main(parse_args(_testing_argv(root, best)), device="cpu",
                       log=lambda *_: None)
    return dict(ranks=ranks, one=one, root=root)


def test_init_cls_runs_the_global_batch_count_on_uneven_shards(runs):
    """Each rank runs ``9 // 2 = 4`` batches an epoch of the re-init (its
    shard of 5 or 4 shapes, one a batch, cycled), so both make the same
    gradient all-reduces, and end with the same ``conv2``, then the same
    training step and evaluation; rank 0 alone wrote the run's files."""
    r0, r1 = runs["ranks"]
    for r in (r0, r1):
        assert r["batches"] == r["reduces"] == INIT_EPOCHS * (9 // 2)
    for n, v in r0["conv2"].items():
        np.testing.assert_array_equal(v, r1["conv2"][n], err_msg=n)
    assert r0["train"] == r1["train"]
    with open(osp.join(r0["exp"], "train.log")) as f:
        log = f.read()
    assert "The number of training data is: 9" in log
    assert f"Init Classifier epoch {INIT_EPOCHS}/{INIT_EPOCHS}" in log
    assert "Data-parallel mesh over 2 device(s)" in log
    assert log.count("PARAMETERS") == 1
    assert sorted(os.listdir(osp.join(r0["exp"], "checkpoints"))) == [
        "best_model", "last_model", "model_001"]


def test_pretrain_on_two_ranks(runs):
    """One pretrain epoch (4 training shapes of the 80/20 split, 2
    global batches): both ranks end with the same finite best val loss
    and the same probe accuracy; rank 0 alone wrote ``metrics.jsonl``,
    with one line."""
    r0, r1 = runs["ranks"]
    assert r0["pretrain"] == r1["pretrain"]
    assert np.isfinite(r0["pretrain"])
    assert len(r0["probes"]) == 1 and r0["probes"] == r1["probes"]
    exp = osp.join(runs["root"]["tmp"], "pretrain")
    (run,) = os.listdir(exp)
    with open(osp.join(exp, run, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert len(lines) == 1
    assert lines[0]["modelnet_svm_acc"] == r0["probes"][0]
    with open(osp.join(exp, run, "pretrain.log")) as f:
        assert f.read().count("PARAMETERS") == 1


def test_testing_on_two_ranks_equals_one_process(runs):
    """``testing`` on 2 ranks (each padded batch of 2 sharded, the logits
    gathered) gives both ranks the one-process metrics exactly."""
    r0, r1 = runs["ranks"]
    assert r0["testing"] == r1["testing"] == runs["one"]
    assert np.isfinite(r0["testing"]["instance_avg_iou"])
