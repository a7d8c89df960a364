"""The port's mIoU evaluation against the JAX package's on the CPU.

The masked argmax, the per-shape IoUs and ``evaluation``'s metric dict
must equal the JAX package's exactly on the same logits (the forwards
here return logits computed in numpy from the points, so both sides see
the same values), including the padding of a short tail batch.  The
slice as a whole: ``run_evaluation`` of the port's trainer with JAX
weights carried through ``convert.py`` must be within 1e-6 of the JAX
trainer's ``run_evaluation`` with the same weights and data (f32
encoder), and the eval CLI on a port checkpoint must give the same
metrics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prifit_torch.cli import testing as t_testing
from prifit_torch.cli import train_partseg as T
from prifit_torch.cli.args_parser import parse_args as t_parse_args
from prifit_torch.convert import state_dict_from_jax
from prifit_torch.data import DataLoader as TLoader
from prifit_torch.data import PartNormalDataset as TPart
from prifit_torch.eval import eval_utils as TU
from prifit_torch.eval import miou as TM
from prifit_torch.train.checkpoint import save_checkpoint
from prifit_torch.train.state import create_train_state as t_create_state
from prifit_tpu.cli import train_partseg as J
from prifit_tpu.cli.args_parser import parse_args as j_parse_args
from prifit_tpu.data import DataLoader as JLoader
from prifit_tpu.data import PartNormalDataset as JPart
from prifit_tpu.eval import eval_utils as JU
from prifit_tpu.eval import miou as JM
from prifit_tpu.models import get_module as j_get_module
from prifit_tpu.train.state import create_train_state as j_create_state
from prifit_tpu.train.state import selfsup_init_kwargs
from tests.fixtures import make_shapenet_fixture

torch.set_num_threads(1)

PARTS = 50


@pytest.fixture(scope="module")
def shapenet_root(tmp_path_factory):
    return make_shapenet_fixture(
        str(tmp_path_factory.mktemp("shapenet")), n_per_cat=8, n_points=64)


def _logits(rng, B, N, ties=False):
    if ties:
        # small integers: many exact ties, which go to the lowest part id
        return rng.integers(0, 3, size=(B, N, PARTS)).astype(np.float32)
    return rng.normal(size=(B, N, PARTS)).astype(np.float32)


@pytest.mark.parametrize("ties", [False, True])
def test_category_masked_argmax_equal_jax(ties):
    rng = np.random.default_rng(0)
    logits = _logits(rng, 6, 40, ties)
    first = rng.integers(0, PARTS, size=6)
    got = TM.category_masked_argmax(torch.from_numpy(logits),
                                    torch.from_numpy(first))
    want = JM.category_masked_argmax(jnp.asarray(logits),
                                     jnp.asarray(first.astype(np.int32)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    cat_of_part, mask = TM._category_tables()
    assert mask[cat_of_part[first][:, None], got.numpy()].all()


def _labels(rng, B, N):
    """Per-shape part labels of one random category each."""
    cats = rng.integers(0, len(TM.CATEGORY_NAMES), size=B)
    parts = [TM.SEG_CLASSES[TM.CATEGORY_NAMES[c]] for c in cats]
    return np.stack([rng.choice(p, size=N) for p in parts]).astype(np.int64)


def test_batch_shape_ious_equal_jax():
    rng = np.random.default_rng(1)
    target = _labels(rng, 8, 30)
    # predictions: the labels with some points moved to another part of
    # the category, and one shape with a part absent from both
    pred = target.copy()
    flip = rng.random(target.shape) < 0.3
    pred[flip] = np.roll(target, 1, axis=1)[flip]
    for a, b in zip(TM.batch_shape_ious(pred, target),
                    JM.batch_shape_ious(pred, target)):
        np.testing.assert_array_equal(a, b)
    for b in range(8):
        cat = TM.CATEGORY_NAMES[TM._category_tables()[0][target[b, 0]]]
        assert TM.mean_iou_one_sample(pred[b], target[b], cat) == \
            JM.mean_iou_one_sample(pred[b], target[b], cat)
        assert TU.mean_IOU_one_sample(pred[b], target[b], PARTS) == \
            JU.mean_IOU_one_sample(pred[b], target[b], PARTS)


def _table_forward(seed=3):
    """Logits as a fixed numpy function of the points, so the port and
    the JAX package evaluate the same values."""
    w = np.random.default_rng(seed).normal(size=(3, PARTS))

    def logits(points):
        return (np.asarray(points, np.float64)[..., :3] @ w).astype(
            np.float32)

    def t_forward(points, cls):
        return torch.from_numpy(logits(points.numpy()))

    def j_forward(points, cls):
        return jnp.asarray(logits(np.asarray(points)))

    return t_forward, j_forward


@pytest.mark.parametrize("batch_size,pad,tracking", [
    (4, True, False), (4, True, True), (5, False, False), (1, False, True)])
def test_evaluation_equal_jax(shapenet_root, batch_size, pad, tracking):
    """The fixture's test split has 6 shapes: batch size 4 leaves a tail
    of 2 (padded to 4 when ``pad``), 5 a tail of 1."""
    def loader(Part, Loader):
        ds = Part(shapenet_root, npoints=48, split="test",
                  rng=np.random.default_rng(2))
        return Loader(ds, batch_size, drop_last=False)

    t_forward, j_forward = _table_forward()
    best = dict(best_class_avg_miou=0.0, best_acc=0.0, best_epoch=0,
                best_instance_avg_miou=0.0, best_chamfer_loss=float("inf"))
    t_best, j_best = (dict(best), dict(best)) if tracking else (None, None)
    kw = dict(num_parts=PARTS, epoch=2, pad_to=batch_size if pad else None,
              log=lambda *_: None)
    got = TM.evaluation(t_forward, loader(TPart, TLoader), metrics=t_best,
                        device="cpu", **kw)
    want = JM.evaluation(j_forward, loader(JPart, JLoader), metrics=j_best,
                         **kw)
    assert got == want
    assert 0.0 < got["instance_avg_iou"] < 1.0
    if tracking:
        assert got["best_epoch"] == 3


def test_evaluation_needs_a_device(monkeypatch):
    """Like the port's other entry points, ``evaluation`` runs on CUDA
    unless the caller names a device, and raises without a GPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t_forward, _ = _table_forward()
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.evaluation(t_forward, [], log=lambda *_: None)


def test_make_eval_forward_runs_in_eval_mode():
    import prifit_torch.entry as entry
    model, points, cls = entry.flagship(1, 48, device="cpu")
    model.train()
    logits = TM.make_eval_forward(model)(points, cls)
    assert not model.training and not logits.requires_grad
    assert logits.shape == (1, 48, PARTS)
    torch.testing.assert_close(logits.exp().sum(-1),
                               torch.ones((1, 48)))


def _args(parse, root, tmp):
    return parse([
        "--batch_size", "4", "--npoint", "48", "--data_root", root,
        "--encoder_dtype", "f32", "--num_workers", "0",
        "--experiment_root", str(tmp)])


def test_run_evaluation_with_jax_weights(shapenet_root, tmp_path):
    """The slice's eval path end to end: the JAX trainer's model and
    ``run_evaluation`` against the port's with the same weights (carried
    by ``state_dict_from_jax``) on the fixture's test split, whose 6
    shapes at batch 4 leave a padded tail."""
    ja = _args(j_parse_args, shapenet_root, tmp_path)
    ta = _args(t_parse_args, shapenet_root, tmp_path)
    mod = j_get_module(ja.model)
    model = J.build_model(ja, mod)
    pts = jnp.zeros((2, 64, 3), jnp.float32)
    state = j_create_state(model, (pts, jnp.zeros((2, 16))),
                           selfsup_init_kwargs(pts), seed=5)
    # random batch-norm statistics, so the running ones are carried too
    rng = np.random.default_rng(7)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.normal(size=a.shape) * 0.1 if str(p[-1].key)
                      .endswith("mean") else rng.uniform(0.5, 1.5, a.shape)
                      ).astype(np.float32), state.batch_stats)
    state = state.replace(batch_stats=stats)
    log = lambda *_: None  # noqa: E731
    want = J.run_evaluation(ja, 0, model, state, log, metrics=None)

    t_model = T.build_model(ta, T.get_module(ta.model), "cpu")
    t_model.load_state_dict(state_dict_from_jax(state.variables()),
                            strict=True)
    t_state = t_create_state(t_model)
    got = T.run_evaluation(ta, 0, t_model, t_state, log, device="cpu")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)

    # the eval CLI on a checkpoint of those weights gives the same metrics
    save_checkpoint(str(tmp_path), "ckpt", epoch=0, state=t_state)
    ta.pretrained_model = str(tmp_path / "ckpt")
    cli = t_testing.main(ta, device="cpu", log=log)
    assert cli == got


def test_eval_cli_needs_a_device(monkeypatch, shapenet_root, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_testing.main(_args(t_parse_args, shapenet_root, tmp_path))
