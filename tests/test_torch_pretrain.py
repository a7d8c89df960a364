"""The port's self-supervised pretrainer (``python -m
prifit_torch.cli.pretrain_partseg``) and its model
``pretrain_pointnet2_part_seg_msg`` against the JAX package on the CPU.

Held exactly: the pretrain augmentations under each flag and the ACD
train/val file lists, from the same numpy seeds.  Held within 1e-4
relative: the pretrain model's eval-mode convex ``total_loss`` (with
equal cluster counts) and one self-sup step's loss, with ``l2_norm`` on
and off, from converted JAX variables, and the CLI's validation loss
against the JAX pretrainer's ``val_forward``.  Then ``main`` end to end
at npoint 48 (convex and contrastive), the warm start of the part-seg
trainer from its ``best_model``, ``--modelnet_val`` and the missing GPU.
"""

import functools
import json
import os
import os.path as osp
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prifit_torch.cli import pretrain_partseg as P
from prifit_torch.cli import train_partseg as T
from prifit_torch.cli.args_parser import parse_args
from prifit_torch.convert import state_dict_from_jax
from prifit_torch.data import DataLoader
from prifit_torch.models import pretrain_pointnet2_part_seg_msg as tmod
from prifit_torch.train.state import create_train_state
from prifit_tpu.cli import pretrain_partseg as JP
from prifit_tpu.data import ACDSelfSupDataset as JACD
from prifit_tpu.data import DataLoader as JDataLoader
from prifit_tpu.models import get_module
from test_torch_grad import align_eigh_signs, jax_eigh
from test_torch_train import jax_variables, with_xyz_gain
from tests.fixtures import make_modelnet_fixture

torch.set_num_threads(1)

NPOINT, CHAMFER = 128, 256
# test_torch_train.py's self-sup settings: one mean-shift step
SS = ["--quantile", "0.05", "--msc_iterations", "1", "--max_num_clusters",
      "6", "--n_per_prim", "32"]
AUG_FLAGS = {"none": [], "anisotropic": ["--random_anisotropic_scale"],
             "rotation_z": ["--rotation_z"],
             "rotation_z_45": ["--rotation_z_45"],
             "all": ["--random_anisotropic_scale", "--rotation_z",
                     "--rotation_z_45"]}


def _blob_acd(root, n_shapes):
    """``n_shapes`` ACD shapes of 600 points, each 3 gaussian blobs of 200
    (the components) 4 apart, as ``test_torch_train.py::blob_cloud``.
    With ``make_acd_fixture``'s overlapping blobs two modes of a cluster
    often agree to f32 rounding after a mean-shift step, and which one
    NMS makes the center is a rounding tie that moves the loss by up to
    1.5% (JAX's own with ``l2_norm`` on and off too)."""
    rng = np.random.default_rng(0)
    os.makedirs(root / "shapes")
    for i in range(n_shapes):
        comp = np.arange(600) % 3
        pts = np.eye(3)[comp] * 4.0 + rng.normal(size=(600, 3)) * 0.3
        np.save(root / "shapes" / f"acd{i:04d}.npy", np.concatenate(
            [pts, comp[:, None]], 1).astype(np.float32))
    return str(root)


@pytest.fixture(scope="module")
def acd(tmp_path_factory):
    return _blob_acd(tmp_path_factory.mktemp("pretrain") / "acd", 10)


@pytest.fixture(scope="module")
def acd_small(tmp_path_factory):
    """6 shapes: 2 iterations an epoch at batch 2, and 1 val batch (a CPU
    step takes seconds: sa1 groups 512 centroids whatever the cloud)."""
    return _blob_acd(tmp_path_factory.mktemp("pretrain") / "acd", 6)


def _args(acd, *extra):
    return parse_args(["--model", "pretrain_pointnet2_part_seg_msg",
                       "--batch_size", "2", "--npoint", str(NPOINT),
                       "--chamfer_npoints", str(CHAMFER), "--ss_path", acd,
                       "--encoder_dtype", "f32", "--seed", "5", *SS, *extra])


@pytest.mark.parametrize("flags", list(AUG_FLAGS))
def test_augment_pretrain_matches_jax(flags):
    args = parse_args(AUG_FLAGS[flags])
    pts = np.random.default_rng(0).normal(size=(3, 40, 6)).astype(
        np.float32)
    got = P.augment_pretrain(pts, args, np.random.default_rng(9))
    ref = JP.augment_pretrain(pts, args, np.random.default_rng(9))
    np.testing.assert_array_equal(got, ref)
    assert not np.array_equal(got, pts)


def _jax_split(args):
    """The JAX pretrainer's datasets (``prifit_tpu/cli/pretrain_partseg.py:
    73-82``)."""
    j_train = JACD(args.ss_path, npoints=args.npoint,
                   normal_channel=args.normal, k_shot=args.n_cls_selfsup,
                   use_val=True, rng=np.random.default_rng(args.seed + 1))
    j_val = JACD(args.ss_path, npoints=args.npoint,
                 normal_channel=args.normal, k_shot=args.n_cls_selfsup,
                 use_val=False,
                 exclude_fns=[fn for _, fn in j_train.datapath],
                 rng=np.random.default_rng(args.seed + 2))
    return j_train, j_val


def test_acd_split_matches_jax(acd):
    """The 80/20 split of the JAX pretrainer
    (``prifit_tpu/cli/pretrain_partseg.py:73-82``): the same train and
    val files, disjoint, 8 and 2 of the 10 shapes."""
    args = _args(acd)
    train, val = P.acd_split(args)
    j_train, j_val = _jax_split(args)
    assert train.datapath == j_train.datapath
    assert val.datapath == j_val.datapath
    assert (len(train), len(val)) == (8, 2)
    assert not {fn for _, fn in train.datapath} & {fn for _, fn in
                                                  val.datapath}


def _jax_model(l2_norm):
    return get_module("pretrain_pointnet2_part_seg_msg").get_model(
        num_parts=50, l2_norm=l2_norm, compute_dtype="f32", dropout_rate=0.0)


@functools.lru_cache(maxsize=None)
def _variables(acd):
    """JAX variables of the pretrain model (the same tree with
    ``l2_norm`` on or off), statistics randomized, ``beta`` 1, and fp1's
    xyz weights scaled (``test_torch_train.py::with_xyz_gain``) so that
    the blobs give several clusters."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 256, 3)).astype(np.float32)
    v = jax_variables(_jax_model(False), rng, x,
                      np.zeros((2, 16), np.float32))
    return dict(params=with_xyz_gain(v["params"]),
                batch_stats=v["batch_stats"],
                selfsup_state={"beta": np.float32(1.0)})


@functools.lru_cache(maxsize=None)
def _jax_val_forward(l2_norm):
    """The JAX pretrainer's convex ``val_forward``
    (``prifit_tpu/cli/pretrain_partseg.py:148-153``), with its flags."""
    model = _jax_model(l2_norm)
    flags = P.convex_flags(parse_args(SS))
    return jax.jit(lambda v, p, c, cls: model.apply(
        v, p, cls, chamfer_points=c, train=False, **flags))


def _val_batch(acd):
    args = _args(acd)
    _, val = P.acd_split(args)
    loader = DataLoader(val, 2, chamfer_npoints=CHAMFER)
    pts, chamfer, _, _ = next(iter(loader))
    choice = np.random.default_rng(3).choice(CHAMFER, NPOINT, replace=False)
    return np.ascontiguousarray(chamfer[:, choice]), np.ascontiguousarray(
        chamfer[:, :, :3])


def _port_model(acd, l2_norm):
    model = tmod.get_model(num_parts=50, l2_norm=l2_norm,
                           compute_dtype="f32", dropout_rate=0.0,
                           device="cpu")
    model.load_state_dict(state_dict_from_jax(_variables(acd)), strict=True)
    return model


@pytest.mark.parametrize("l2_norm", [False, True], ids=["plain", "l2"])
def test_pretrain_model_eval_matches_jax(acd, monkeypatch, l2_norm):
    """The eval-mode forward with the convex loss on an ACD val batch:
    ``total_loss`` within 1e-4 relative and equal cluster counts, with the
    eigenvector signs aligned (``test_torch_grad.py::align_eigh_signs``),
    and ``beta`` untouched."""
    align_eigh_signs(monkeypatch, jax_eigh)
    enc, chamfer = _val_batch(acd)
    out = _jax_val_forward(l2_norm)(_variables(acd), jnp.asarray(enc),
                                    jnp.asarray(chamfer),
                                    jnp.zeros((2, 16)))
    model = _port_model(acd, l2_norm).eval()
    flags = P.convex_flags(parse_args(SS))
    with torch.no_grad():
        got = model(torch.from_numpy(enc), torch.zeros((2, 16)),
                    chamfer_points=torch.from_numpy(chamfer), **flags)
    np.testing.assert_array_equal(
        got.convex.clusters.num_clusters.numpy(),
        np.asarray(out.convex.clusters.num_clusters))
    np.testing.assert_allclose(got.total_loss.item(), float(out.total_loss),
                               rtol=1e-4)
    assert model.beta.item() == 1.0


@pytest.mark.parametrize("l2_norm", [False, True], ids=["plain", "l2"])
def test_pretrain_selfsup_step_matches_jax(acd, monkeypatch, l2_norm):
    """One B=2 f32 self-sup step from the JAX state: ss_loss within 1e-4
    relative of the JAX train forward's, and ``beta`` 0.99 on both sides
    (FPS pinned to start 0, default convex terms, which draw nothing, and
    the eigenvector signs aligned)."""
    monkeypatch.setenv("PRIFIT_DET_FPS", "1")
    enc, chamfer = _val_batch(acd)
    v = _variables(acd)
    flags = P.convex_flags(parse_args(SS))
    out, upd = jax.jit(lambda v, p, c: _jax_model(l2_norm).apply(
        v, p, jnp.zeros((2, 16)), chamfer_points=c, train=True,
        rngs={"sampling": jax.random.PRNGKey(1),
              "dropout": jax.random.PRNGKey(2),
              "selfsup": jax.random.PRNGKey(3)},
        mutable=["batch_stats", "selfsup_state"], **flags))(
        v, jnp.asarray(enc), jnp.asarray(chamfer))
    monkeypatch.undo()
    align_eigh_signs(monkeypatch, jax_eigh)
    state = create_train_state(_port_model(acd, l2_norm))
    args = _args(acd)
    _, m = P.build_step(args, tmod)(
        state, torch.from_numpy(enc), torch.zeros((2, 16)),
        torch.from_numpy(chamfer), 1e-3, 0.1, 1.0)
    np.testing.assert_allclose(m["ss_loss"].item(), float(out.total_loss),
                               rtol=1e-4)
    assert float(upd["selfsup_state"]["beta"]) == pytest.approx(0.99)
    assert state.model.beta.item() == pytest.approx(0.99)


def test_pretrain_reconstruct_matches_jax(acd, monkeypatch):
    """The pretrain model's ``reconstruct`` (the JAX model's ``elif``):
    with the convex loss off, the forward decodes mean(``feat``) with
    AtlasNet and its ``total_loss`` is the dense chamfer, within 1e-5
    relative of JAX's, the reconstruction within 1e-5; with the convex
    loss on, AtlasNet does not run.  JAX's AtlasNet variables come from an
    init with the convex loss off, the rest from ``_variables``.

    In eval mode: in train mode JAX's ``feat`` on these blob clouds is
    2.3e-3 off a float64 run of the port, the port's f32 one 9e-5.  JAX's
    f32 encoder takes some batch-norm variances as ``w^T C w / n - (m
    w)^2`` over the input's covariance (``prifit_tpu/nn/pointnet2.py::
    _moment_stats``), a sum that cancels more than the port's ``E[a^2] -
    E[a]^2`` where the inputs sit 4 from the origin; its eval forward is
    4e-7 off."""
    enc, _ = _val_batch(acd)
    jm = get_module("pretrain_pointnet2_part_seg_msg").get_model(
        num_parts=50, reconstruct=True, compute_dtype="f32",
        dropout_rate=0.0)
    cls = jnp.zeros((2, 16))
    init = jax.jit(lambda r: jm.init(r, jnp.asarray(enc), cls, train=True))(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)})
    v = _variables(acd)
    v = dict(v, params=dict(v["params"], atlasnet=init["params"]["atlasnet"]),
             batch_stats=dict(v["batch_stats"], atlasnet=_randomize(
                 init["batch_stats"]["atlasnet"])))
    out = jax.jit(lambda v, p: jm.apply(v, p, cls, train=False))(
        v, jnp.asarray(enc))
    model = tmod.get_model(num_parts=50, reconstruct=True,
                           compute_dtype="f32", dropout_rate=0.0,
                           device="cpu")
    model.load_state_dict(state_dict_from_jax(v), strict=True)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(enc), torch.zeros((2, 16)))
    assert got.recon_points.shape == (2, 25 * 121, 3)
    np.testing.assert_allclose(got.recon_points.numpy(),
                               np.asarray(out.recon_points), atol=1e-5)
    np.testing.assert_allclose(got.total_loss.item(), float(out.total_loss),
                               rtol=1e-5)
    align_eigh_signs(monkeypatch, jax_eigh)
    with torch.no_grad():
        got = model(torch.from_numpy(enc), torch.zeros((2, 16)),
                    chamfer_points=torch.from_numpy(enc),
                    **P.convex_flags(parse_args(SS)))
    assert got.recon_points is None and got.convex is not None


def _randomize(stats):
    """Batch-norm statistics drawn from a fixed seed, in ``stats``'s
    tree."""
    rng = np.random.default_rng(13)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.normal(size=a.shape) * 0.1
                         if str(path[-1].key).endswith("mean")
                         else rng.uniform(0.5, 1.5, size=a.shape)
                         ).astype(np.float32), stats)


def test_validation_loss_matches_jax(acd, monkeypatch):
    """``validation_loss`` of a converted state over the val split equals
    the JAX pretrainer's loop (``pretrain_partseg.py:253-273``: a
    ``--npoint`` choice from each chamfer cloud by the run's rng, then
    ``val_forward``) within 1e-4, and leaves ``beta`` alone."""
    align_eigh_signs(monkeypatch, jax_eigh)
    args = _args(acd, "--l2_norm")
    _, val = P.acd_split(args)
    model = _port_model(acd, True)
    got = P.validation_loss(model, tmod, DataLoader(
        val, 2, chamfer_npoints=CHAMFER), args, np.random.default_rng(11),
        None, torch.device("cpu"))
    rng = np.random.default_rng(11)
    _, j_val = _jax_split(args)
    losses = []
    for pts, chamfer_pts, cls, seg in JDataLoader(
            j_val, 2, shuffle=False, chamfer_npoints=CHAMFER):
        choice = rng.choice(chamfer_pts.shape[1], NPOINT, replace=False)
        out = _jax_val_forward(True)(
            _variables(acd), jnp.asarray(chamfer_pts[:, choice, :]),
            jnp.asarray(chamfer_pts[:, :, :3]), jnp.zeros((2, 16)))
        losses.append(float(out.total_loss))
    assert len(losses) == 1
    np.testing.assert_allclose(got, np.mean(losses), rtol=1e-4)
    assert model.beta.item() == 1.0


def _run(args):
    best = P.main(args, device="cpu")
    exp = osp.join(args.experiment_root,
                   "pretrain_" + T.experiment_name(args))
    with open(osp.join(exp, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    with open(osp.join(exp, "pretrain.log")) as f:
        log = f.read()
    return best, exp, lines, log


def _ckpt(exp, name):
    return torch.load(osp.join(exp, "checkpoints", name), weights_only=False)


@pytest.mark.parametrize("loss", ["convex", "contrastive"])
def test_main_runs_five_epochs(acd_small, tmp_path, loss):
    """``main`` at npoint 48 for 5 epochs of 2 iterations: ``model_005``,
    ``best_model`` from the epoch of the lowest val loss, one
    ``metrics.jsonl`` line an epoch with the JAX pretrainer's keys, and
    ``beta`` decayed once a convex step (not by the val forward)."""
    args = parse_args([
        "--model", "pretrain_pointnet2_part_seg_msg", "--l2_norm",
        "--epoch", "5", "--batch_size", "2", "--npoint", "48",
        "--chamfer_npoints", "96", "--ss_path", acd_small, "--ss_loss", loss,
        "--num_workers", "2", "--learning_rate", "0.005",
        "--random_anisotropic_scale", "--rotation_z",
        "--experiment_root", str(tmp_path), *SS])
    best, exp, lines, log = _run(args)
    assert [line["epoch"] for line in lines] == list(range(5))
    assert all(set(line) == {"epoch", "train_loss", "val_loss", "lr"}
               for line in lines)
    vals = [line["val_loss"] for line in lines]
    assert all(np.isfinite(vals)) and best == min(vals)
    names = sorted(os.listdir(osp.join(exp, "checkpoints")))
    assert names == ["best_model", "model_005"]
    first_best = int(np.argmin(vals))
    ck = _ckpt(exp, "best_model")
    assert ck["epoch"] == first_best
    assert ck["extra"]["val_loss"] == pytest.approx(min(vals))
    last = _ckpt(exp, "model_005")
    assert last["epoch"] == 4 and last["step"] == 10
    beta = last["model_state_dict"]["beta"].item()
    assert beta == pytest.approx(0.99 ** 10 if loss == "convex" else 1.0)
    assert "self-sup train 4 / val 2" in log


def test_finetune_warm_starts_from_pretrain(acd_small, tmp_path):
    """``train_partseg --pretrained_model <pretrain>/best_model``: every
    entry the pretrain checkpoint has (the backbone, ``conv1``/``bn1``,
    ``extra_conv_emb``, ``beta`` and the pretrain model's own seg head
    ``conv2``, as in the JAX package, whose pretrain model has the head
    too) is restored exactly; under ``--extra_layers`` the entries the
    file lacks (the fp1 chain and the embedding tower) keep their fresh
    init and the file's fp1 MLP is ignored."""
    pre = parse_args(["--model", "pretrain_pointnet2_part_seg_msg",
                      "--epoch", "1", "--batch_size", "2", "--npoint", "48",
                      "--chamfer_npoints", "96", "--ss_path", acd_small,
                      "--experiment_root", str(tmp_path), *SS])
    _, exp, _, _ = _run(pre)
    ckpt = osp.join(exp, "checkpoints", "best_model")
    saved = _ckpt(exp, "best_model")["model_state_dict"]
    for extra in ([], ["--extra_layers"]):
        args = parse_args(["--pretrained_model", ckpt, *extra])
        mod = T.get_module(args.model)
        fresh = T.build_model(args, mod, "cpu").state_dict()
        state = create_train_state(T.build_model(args, mod, "cpu"))
        d, n = osp.split(ckpt)
        T.restore_params_only(d, n, state, log=lambda *_: None)
        got = state.model.state_dict()
        for k, t in got.items():
            ref = saved[k] if k in saved else fresh[k]
            assert torch.equal(t, ref), k
        assert got["beta"].item() == pytest.approx(0.99 ** 2)
        if extra:
            assert "fp1_conv1.weight" not in saved
            assert "fp1.mlp_convs.0.weight" not in got


def test_modelnet_val_skips_or_raises(acd_small, tmp_path):
    """``--modelnet_val``: skipped with a log line where no ModelNet40
    tree lies beside the ACD one, as the JAX pretrainer skips it; with a
    tree (a fixture one), the epoch ends with the probe, which the log
    reports and ``metrics.jsonl`` holds as ``modelnet_svm_acc`` (it
    raised before the probe was ported)."""
    logs = []
    assert P.modelnet_loaders(_args(acd_small, "--modelnet_val"),
                              logs.append) is None
    assert "skipping probe" in logs[0]
    mn = osp.join(osp.dirname(acd_small), "modelnet40_normal_resampled")
    make_modelnet_fixture(mn, n_classes=3, n_per_class=3, n_points=64)
    try:
        _, _, lines, log = _run(parse_args([
            "--model", "pretrain_pointnet2_part_seg_msg", "--epoch", "1",
            "--batch_size", "2", "--npoint", "48", "--chamfer_npoints",
            "96", "--ss_path", acd_small, "--encoder_dtype", "f32",
            "--modelnet_val", "--experiment_root", str(tmp_path), *SS]))
    finally:
        shutil.rmtree(mn)
    assert set(lines[0]) == {"epoch", "train_loss", "val_loss", "lr",
                             "modelnet_svm_acc"}
    assert 0.0 <= lines[0]["modelnet_svm_acc"] <= 1.0
    assert "ModelNet40 SVM probe: acc" in log and "9 clouds" in log


def test_main_raises_without_a_gpu(acd, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        P.main(_args(acd, "--experiment_root", str(tmp_path)))
    assert not os.listdir(tmp_path)
