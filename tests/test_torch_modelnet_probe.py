"""The port's ModelNet40 loader, its linear SVM and the pretrainer's
``--modelnet_val`` probe against the JAX package on the CPU.

- ``ModelNetDataLoader`` items equal JAX's bit for bit on
  ``tests/fixtures.py::make_modelnet_fixture``, with and without
  normals, prefix and ``uniform`` stride.
- ``LinearSVC`` against ``sklearn.svm.LinearSVC`` (the JAX probe's
  solver; here only the oracle), two and five classes, C = 1 and 220, on
  unscaled 256-d blobs: each classifier's objective at most sklearn's
  times 1 + 1e-4 (both evaluated by the port's ``objective``; sklearn
  stops at tol 1e-4, the port at a gradient norm of 1e-8 of the weights'),
  equal predictions on train and test points, and with two classes one
  classifier, as sklearn's.  The tie rule (the first class; 0 goes to the
  first of two), and no scikit-learn import.
- ``extract_global_features`` of ``make_feature_forward`` on
  ``pretrain_pointnet2_part_seg_msg`` (JAX variables converted, f32)
  within 1e-5 of the largest entry of JAX's.
- ``svm_probe`` on the fixture through a fixed feature map: accuracy,
  train accuracy and C equal to JAX's, with and without ``cross_val``.
- ``pretrain_partseg.main --modelnet_val --cross_val_svm`` for one epoch
  writes ``modelnet_svm_acc`` (``test_torch_pretrain.py`` runs the plain
  ``--modelnet_val``).
"""

import json
import os.path as osp
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.svm import LinearSVC as SkLinearSVC

from prifit_torch.cli import pretrain_partseg as P
from prifit_torch.cli.args_parser import parse_args
from prifit_torch.convert import state_dict_from_jax
from prifit_torch.data import DataLoader, ModelNetDataLoader
from prifit_torch.eval.svm_probe import (
    CV_GRID,
    LinearSVC,
    _augment,
    extract_global_features,
    make_feature_forward,
    objective,
    svm_probe,
)
from prifit_torch.models import pretrain_pointnet2_part_seg_msg as tmod
from prifit_tpu.data import DataLoader as JDataLoader
from prifit_tpu.data import ModelNetDataLoader as JModelNetDataLoader
from prifit_tpu.eval.svm_probe import \
    extract_global_features as j_extract_global_features
from prifit_tpu.eval.svm_probe import \
    make_feature_forward as j_make_feature_forward
from prifit_tpu.eval.svm_probe import svm_probe as j_svm_probe
from prifit_tpu.models import get_module as jget_module
from test_torch_pretrain import SS, acd_small  # noqa: F401 (fixture)
from test_torch_train import jax_variables
from tests.fixtures import make_modelnet_fixture

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
NPOINT = 512


@pytest.fixture(scope="module")
def mn_root(tmp_path_factory):
    """4 classes of 9 shapes (6 train, 3 test) of 600 points."""
    return make_modelnet_fixture(str(tmp_path_factory.mktemp("mn")),
                                 n_classes=4, n_per_class=9, n_points=600)


@pytest.mark.parametrize("normal", [True, False])
@pytest.mark.parametrize("uniform", [False, True])
def test_modelnet_items_match_jax(mn_root, normal, uniform):
    for split in ("train", "test"):
        kw = dict(npoint=NPOINT, split=split, normal_channel=normal,
                  uniform=uniform)
        got, ref = ModelNetDataLoader(mn_root, **kw), \
            JModelNetDataLoader(mn_root, **kw)
        assert len(got) == len(ref) == (24 if split == "train" else 12)
        for i in range(len(got)):
            (gp, gc), (rp, rc) = got[i], ref[i]
            assert gp.shape == (NPOINT, 6 if normal else 3)
            np.testing.assert_array_equal(gp, rp)
            np.testing.assert_array_equal(gc, rc)
            assert gc.dtype == np.int32


def _blobs(k, n_per, seed, d=256):
    """``k`` classes of unscaled 256-d blobs (|x| about 50): centers 3 apart
    per coordinate, spread 1, so the classes are separable with margin;
    a train and a test draw."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * 3.0
    y = np.repeat(np.arange(k), n_per)
    draw = lambda: np.abs(centers[y] + rng.normal(size=(len(y), d))).astype(
        np.float32)
    return draw(), y, draw(), y


@pytest.mark.parametrize("k", [2, 5])
@pytest.mark.parametrize("c", [1.0, 220.0])
def test_linear_svc_against_sklearn(k, c):
    x, y, xt, yt = _blobs(k, 12, k * 7 + int(c))
    t = lambda a: torch.from_numpy(a)
    svm = LinearSVC(C=c).fit(t(x), t(y))
    sk = SkLinearSVC(C=c).fit(x, y)
    m = 1 if k == 2 else k
    assert svm.coef_.shape == sk.coef_.shape == (m, 256)
    assert svm.coef_.dtype == torch.float64
    assert svm.rel_grad_ <= 1e-8
    W_sk = torch.cat([torch.from_numpy(sk.coef_).t(),
                      torch.from_numpy(sk.intercept_)[None]]).double()
    f_sk = objective(W_sk, _augment(t(x)), svm.targets(t(y)), c)
    f = svm.objective(t(x), t(y))
    assert bool((f <= f_sk * (1 + 1e-4)).all()), (f, f_sk)
    for a in (x, xt):
        np.testing.assert_array_equal(svm.predict(t(a)).numpy(),
                                      sk.predict(a))
    assert svm.score(t(xt), t(yt)) == sk.score(xt, yt)


def test_linear_svc_two_classes_and_ties():
    """Two classes make one classifier whose positive side is the second
    class; a decision value of exactly 0 goes to the first.  With more
    classes a tie of decision values goes to the first of them."""
    x = torch.tensor([[1.0, 0.0], [-1.0, 0.0], [2.0, 0.0], [-2.0, 0.0]])
    y = torch.tensor([7, 3, 7, 3])
    svm = LinearSVC(C=1.0).fit(x, y)
    assert svm.classes_.tolist() == [3, 7]
    assert svm.decision_function(x).shape == (4,)
    assert svm.predict(x).tolist() == [7, 3, 7, 3]
    svm.intercept_ = torch.zeros(1, dtype=torch.float64)
    assert svm.predict(torch.tensor([[0.0, 5.0]])).tolist() == [3]
    svm = LinearSVC(C=1.0).fit(torch.eye(3), torch.tensor([0, 1, 2]))
    svm.coef_ = torch.ones((3, 3), dtype=torch.float64)
    svm.intercept_ = torch.tensor([0.0, 1.0, 1.0], dtype=torch.float64)
    assert svm.predict(torch.zeros((1, 3))).tolist() == [1]


def test_probe_needs_no_sklearn():
    code = ("import sys; sys.modules['sklearn'] = None\n"
            "import torch\n"
            "from prifit_torch.eval.svm_probe import LinearSVC\n"
            "x = torch.tensor([[0.0], [1.0], [4.0], [5.0]])\n"
            "y = torch.tensor([0, 0, 1, 1])\n"
            "assert LinearSVC(220.0).fit(x, y).score(x, y) == 1.0\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


@pytest.fixture(scope="module")
def pretrain_pair():
    """The JAX ``pretrain_pointnet2_part_seg_msg`` (f32, ``l2_norm``) with
    its init variables (batch-norm statistics randomized), and the port's
    model with them converted."""
    jmod = jget_module("pretrain_pointnet2_part_seg_msg").get_model(
        num_parts=50, l2_norm=True, compute_dtype="f32")
    rng = np.random.default_rng(6)
    v = jax_variables(jmod, rng, rng.normal(size=(2, NPOINT, 3)).astype(
        np.float32), np.zeros((2, 16), np.float32))
    model = tmod.get_model(50, l2_norm=True, compute_dtype="f32",
                           device="cpu")
    model.load_state_dict(state_dict_from_jax(v), strict=True)
    return jmod, v, model


def test_feature_extraction_matches_jax(mn_root, pretrain_pair):
    jmod, v, model = pretrain_pair
    kw = dict(npoint=NPOINT, split="test", normal_channel=False)
    got, labels, load_s = extract_global_features(
        make_feature_forward(model),
        DataLoader(ModelNetDataLoader(mn_root, **kw), 4, drop_last=False))
    want, jlabels = j_extract_global_features(
        j_make_feature_forward(jmod, v),
        JDataLoader(JModelNetDataLoader(mn_root, **kw), 4, drop_last=False))
    assert got.shape == want.shape == (12, 256) and load_s >= 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(labels.numpy(), jlabels)


@pytest.mark.parametrize("cross_val", [False, True])
def test_svm_probe_matches_jax(mn_root, cross_val):
    """Both probes on the fixture's xyz through the same feature map,
    ``[p, p^2]``: the test accuracy moves with C (0.83 at C=1, 1.0 from
    C=10), so the grid's choice (the first C of the best accuracy) shows.
    On these features sklearn converges at every C of the grid; where it
    stops at its ``max_iter`` (at C=220 on some unscaled features) its
    accuracy is that of another point than the optimum, and the
    objective test above holds the port's."""
    def loaders(loader_cls, dl_cls):
        return [dl_cls(loader_cls(mn_root, npoint=NPOINT, split=split,
                                  normal_channel=False), 5, drop_last=False)
                for split in ("train", "test")]

    got = svm_probe(lambda p: torch.cat([p, p * p], -1),
                    *loaders(ModelNetDataLoader, DataLoader),
                    cross_val=cross_val)
    want = j_svm_probe(lambda p: jnp.concatenate([p, p * p], -1),
                       *loaders(JModelNetDataLoader, JDataLoader),
                       cross_val=cross_val)
    assert {k: got[k] for k in want} == want
    assert want["C"] == (10.0 if cross_val else 220.0)
    assert got["clouds"] == 36
    assert len(got["newton_steps"]) == (5 if cross_val else 1)


def test_pretrain_main_probes_with_cross_val(acd_small, tmp_path):  # noqa: F811
    mn = osp.join(osp.dirname(acd_small), "modelnet40_normal_resampled")
    make_modelnet_fixture(mn, n_classes=3, n_per_class=3, n_points=64)
    args = parse_args([
        "--model", "pretrain_pointnet2_part_seg_msg", "--epoch", "1",
        "--batch_size", "2", "--npoint", "48", "--chamfer_npoints", "96",
        "--ss_path", acd_small, "--encoder_dtype", "f32", "--modelnet_val",
        "--cross_val_svm", "--experiment_root", str(tmp_path), *SS])
    probes = []
    try:
        P.main(args, device="cpu", on_probe=lambda e, p: probes.append(p))
    finally:
        shutil.rmtree(mn)
    exp = osp.join(str(tmp_path), "pretrain_" + P.experiment_name(args))
    with open(osp.join(exp, "metrics.jsonl")) as f:
        line = json.loads(f.readline())
    assert len(probes) == 1 and probes[0]["C"] in CV_GRID
    assert line["modelnet_svm_acc"] == probes[0]["accuracy"]
    assert probes[0]["clouds"] == 9 and probes[0]["svm_ms"] > 0
