"""The port's input pipeline against the JAX package's on the CPU.

Datasets, loader batches, the host augmentations and the trainer's
``augment_sup`` are numpy in both packages and must be equal bit for bit
from the same seeds.  The on-device augmentations
(``prifit_torch.data.augment_torch``) take the JAX package's draws and
must be within 1e-6 of ``prifit_tpu.data.augment_jax``.  The fused train
steps must equal the plain steps on inputs augmented with the same
generator draws.
"""

import itertools
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prifit_torch import native as t_native
from prifit_torch.cli.train_partseg import augment_sup as t_augment_sup
from prifit_torch.data import augment_torch as TA
from prifit_torch.data import provider as TP
from prifit_torch.data.augment import Augment as TAugment
from prifit_torch.data.loader import DataLoader as TLoader
from prifit_torch.data.loader import prefetch_to_device
from prifit_torch.data.shapenet import (
    ACDSelfSupDataset as TACD,
    MultiACDSelfSupDataset as TMultiACD,
    PartNormalDataset as TPart,
    SelfSupPartNormalDataset as TSelfSupPart,
)
from prifit_tpu.cli.train_partseg import augment_sup as j_augment_sup
from prifit_tpu.data import augment_jax as JA
from prifit_tpu.data import provider as JP
from prifit_tpu.data.augment import Augment as JAugment
from prifit_tpu.data.loader import DataLoader as JLoader
from prifit_tpu.data.shapenet import (
    ACDSelfSupDataset as JACD,
    MultiACDSelfSupDataset as JMultiACD,
    PartNormalDataset as JPart,
    SelfSupPartNormalDataset as JSelfSupPart,
)
from prifit_tpu.native import fast_loadtxt as j_fast_loadtxt
from tests.fixtures import make_acd_fixture, make_shapenet_fixture

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def shapenet_root(tmp_path_factory):
    return make_shapenet_fixture(
        str(tmp_path_factory.mktemp("shapenet")), n_per_cat=8, n_points=64)


@pytest.fixture(scope="module")
def acd_root(tmp_path_factory):
    return make_acd_fixture(str(tmp_path_factory.mktemp("acd")),
                            n_shapes=10, n_points=120)


def _batches(loader, epochs=2):
    return [b for _ in range(epochs) for b in loader]


def assert_same_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("num_workers", [0, 2])
@pytest.mark.parametrize("k_shot,shuffle,normal", [
    (-1, False, False), (2, True, False), (3, True, True)])
def test_part_normal_batches_equal_jax(shapenet_root, num_workers, k_shot,
                                       shuffle, normal):
    def batches(Part, Loader):
        ds = Part(shapenet_root, npoints=32, split="trainval",
                  normal_channel=normal, k_shot=k_shot,
                  rng=np.random.default_rng(4))
        return _batches(Loader(ds, 2, shuffle=shuffle, seed=7,
                               drop_last=False, num_workers=num_workers))

    assert_same_batches(batches(TPart, TLoader), batches(JPart, JLoader))


@pytest.mark.parametrize("split", ["train", "val", "test", "val2"])
def test_part_normal_splits_equal_jax(shapenet_root, split):
    t = TPart(shapenet_root, npoints=16, split=split,
              rng=np.random.default_rng(1))
    j = JPart(shapenet_root, npoints=16, split=split,
              rng=np.random.default_rng(1))
    assert t.datapath == j.datapath
    for i in range(len(t)):
        for a, b in zip(t[i], j[i]):
            np.testing.assert_array_equal(a, b)


def test_selfsup_part_normal_equal_jax(shapenet_root):
    labeled = TPart(shapenet_root, npoints=16, split="train", k_shot=2,
                    rng=np.random.default_rng(0))
    fns = list(itertools.chain(*labeled.meta.values()))
    kw = dict(npoints=24, split="trainval", k_shot=3, labeled_fns=fns)
    t = TSelfSupPart(shapenet_root, rng=np.random.default_rng(2), **kw)
    j = JSelfSupPart(shapenet_root, rng=np.random.default_rng(2), **kw)
    assert t.datapath == j.datapath
    assert not set(fn for _, fn in t.datapath) & set(fns)
    assert_same_batches(_batches(TLoader(t, 2, shuffle=True, seed=3)),
                        _batches(JLoader(j, 2, shuffle=True, seed=3)))


@pytest.mark.parametrize("num_workers", [0, 2])
@pytest.mark.parametrize("chamfer_npoints,use_val,k_shot", [
    (120, False, -1), (80, True, -1), (200, False, 6)])
def test_acd_batches_equal_jax(acd_root, num_workers, chamfer_npoints,
                               use_val, k_shot):
    def batches(ACD, Loader):
        ds = ACD(acd_root, npoints=48, use_val=use_val, k_shot=k_shot,
                 exclude_fns=["acd0003.npy"], rng=np.random.default_rng(5))
        return _batches(Loader(ds, 3, shuffle=True, seed=9,
                               chamfer_npoints=chamfer_npoints,
                               num_workers=num_workers))

    got, want = batches(TACD, TLoader), batches(JACD, JLoader)
    assert_same_batches(got, want)
    assert got[0][1].shape == (3, chamfer_npoints, 3)


def test_multi_acd_equal_jax(acd_root):
    t = TMultiACD(acd_root, npoints=40, rng=np.random.default_rng(6))
    j = JMultiACD(acd_root, npoints=40, rng=np.random.default_rng(6))
    assert_same_batches(_batches(TLoader(t, 4, seed=1)),
                        _batches(JLoader(j, 4, seed=1)))


def test_native_parser_equal_jax_and_numpy(shapenet_root, monkeypatch):
    fn = TPart(shapenet_root, npoints=8,
               rng=np.random.default_rng(0)).datapath[0][1]
    assert t_native.parser_name() == "native"
    got = t_native.fast_loadtxt(fn)
    np.testing.assert_array_equal(got, j_fast_loadtxt(fn))
    np.testing.assert_array_equal(
        got, np.loadtxt(fn).astype(np.float32))
    monkeypatch.setattr(t_native, "_get_lib", lambda: None)
    assert t_native.parser_name() == "numpy"
    np.testing.assert_array_equal(t_native.fast_loadtxt(fn), got)


# (name, keyword arguments, channels): the rotations that are not "y" or
# "with_normal" ones take xyz only
PROVIDER_FNS = [
    ("rotate_point_cloud", {}, 3),
    ("rotate_point_cloud_z", {}, 3),
    ("rotate_point_cloud_y", {}, 6),
    ("rotate_point_cloud_y_pi4", {}, 6),
    ("rotate_point_cloud_with_normal", {}, 6),
    ("rotate_perturbation_point_cloud", {"angle_clip": 0.3}, 3),
    ("rotate_perturbation_point_cloud_with_normal", {}, 6),
    ("jitter_point_cloud", {}, 6),
    ("shift_point_cloud", {"shift_range": 0.2}, 3),
    ("random_scale_point_cloud", {}, 6),
    ("random_anisotropic_scale_point_cloud", {}, 6),
    ("random_point_dropout", {}, 6),
    ("shuffle_points", {}, 6),
]


@pytest.mark.parametrize("name,kw,channels", PROVIDER_FNS,
                         ids=[n for n, _, _ in PROVIDER_FNS])
def test_provider_equal_jax(name, kw, channels):
    batch = np.random.default_rng(3).normal(
        size=(4, 50, channels)).astype(np.float32)
    got = getattr(TP, name)(batch, rng=np.random.default_rng(8), **kw)
    want = getattr(JP, name)(batch, rng=np.random.default_rng(8), **kw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_provider_deterministic_fns_equal_jax():
    batch = np.random.default_rng(3).normal(size=(3, 20, 6)).astype(
        np.float32)
    for name, args in (("normalize_data", ()),
                       ("rotate_point_cloud_y_by_angle", (0.7,)),
                       ("rotate_point_cloud_by_angle", (0.7,)),
                       ("rotate_point_cloud_by_angle_with_normal", (0.7,))):
        x = batch[..., :3] if name == "rotate_point_cloud_by_angle" \
            else batch
        np.testing.assert_array_equal(getattr(TP, name)(x, *args),
                                      getattr(JP, name)(x, *args))
    labels = np.arange(3)
    for a, b in zip(TP.shuffle_data(batch, labels, np.random.default_rng(2)),
                    JP.shuffle_data(batch, labels, np.random.default_rng(2))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("normal", [False, True])
def test_augment_sup_and_augment_equal_jax(normal):
    pts = np.random.default_rng(1).normal(
        size=(3, 40, 6 if normal else 3)).astype(np.float32)
    rt, rj = np.random.default_rng(17), np.random.default_rng(17)
    for _ in range(3):   # the rng's stream, not only its first draw
        np.testing.assert_array_equal(t_augment_sup(pts, rt),
                                      j_augment_sup(pts, rj))
    t = TAugment(p=0.6, dropout=True, anisotropic=True,
                 rng=np.random.default_rng(9))
    j = JAugment(p=0.6, dropout=True, anisotropic=True,
                 rng=np.random.default_rng(9))
    x = pts[..., :3]
    for _ in range(4):
        np.testing.assert_array_equal(t(x), j(x))


def _jax_batch(seed=0, shape=(4, 64, 3)):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return x, jnp.asarray(x), torch.from_numpy(x)


def _close(got, want, tol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=tol)


def test_fused_augment_with_jax_draws():
    """Each on-device augmentation, given the draws ``augment_jax`` makes
    from its key, equals ``augment_jax`` within 1e-6."""
    x, xj, xt = _jax_batch()
    B, N, C = x.shape
    key = jax.random.PRNGKey(3)
    u = jax.random.uniform
    scales = u(key, (B, 1, 1), minval=0.8, maxval=1.25)
    _close(TA.random_scale_point_cloud(xt, scales=torch.tensor(
        np.asarray(scales))), JA.random_scale_point_cloud(key, xj))
    shifts = u(key, (B, 1, 3), minval=-0.1, maxval=0.1)
    _close(TA.shift_point_cloud(xt, shifts=torch.tensor(
        np.asarray(shifts))), JA.shift_point_cloud(key, xj))
    noise = jax.random.normal(key, xj.shape)
    _close(TA.jitter_point_cloud(xt, noise=torch.tensor(
        np.asarray(noise))), JA.jitter_point_cloud(key, xj))
    angles = torch.tensor(np.asarray(u(key, (B,)) * 2 * jnp.pi))
    _close(TA.rotate_point_cloud(xt, angles=angles),
           JA.rotate_point_cloud(key, xj))
    _close(TA.rotate_point_cloud_z(xt, angles=angles),
           JA.rotate_point_cloud_z(key, xj))
    an = u(key, (B, 1, C), minval=0.8, maxval=1.25)
    _close(TA.random_anisotropic_scale_point_cloud(
        xt, scales=torch.tensor(np.asarray(an))),
        JA.random_anisotropic_scale_point_cloud(key, xj))
    k1, k2 = jax.random.split(key)
    ratios = torch.tensor(np.asarray(u(k1, (B, 1)) * 0.875))
    uniforms = torch.tensor(np.asarray(u(k2, (B, N))))
    _close(TA.random_point_dropout(xt, ratios=ratios, uniforms=uniforms),
           JA.random_point_dropout(key, xj))


@pytest.mark.parametrize("channels", [3, 6])
def test_standard_train_augment_with_jax_draws(channels):
    x, xj, xt = _jax_batch(1, (3, 50, channels))
    key = jax.random.PRNGKey(11)
    k1, k2 = jax.random.split(key)
    scales = jax.random.uniform(k1, (3, 1, 1), minval=0.8, maxval=1.25)
    shifts = jax.random.uniform(k2, (3, 1, 3), minval=-0.1, maxval=0.1)
    got = TA.standard_train_augment(
        xt, scales=torch.tensor(np.asarray(scales)),
        shifts=torch.tensor(np.asarray(shifts)))
    _close(got, JA.standard_train_augment(key, xj))
    if channels == 6:
        np.testing.assert_array_equal(got[..., 3:].numpy(), x[..., 3:])


def test_augment_draws_from_generator():
    """Without draws each function takes them from the generator: the
    same seed gives the same output, within the ranges of the JAX
    package's draws."""
    x, _, xt = _jax_batch(2)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return TA.standard_train_augment(xt, generator=g)

    torch.testing.assert_close(run(5), run(5), rtol=0, atol=0)
    assert not torch.equal(run(5), run(6))
    g = torch.Generator().manual_seed(0)
    ratio = TA.random_scale_point_cloud(xt, generator=g) / xt
    assert 0.8 <= ratio.min() and ratio.max() <= 1.25 + 1e-6
    d = TA.shift_point_cloud(xt, generator=g) - xt
    assert d.abs().max() <= 0.1 + 1e-6
    d = TA.jitter_point_cloud(xt, generator=g) - xt
    assert d.abs().max() <= 0.05 + 1e-6
    assert TA.random_point_dropout(xt, generator=g).shape == xt.shape
    with pytest.raises(ValueError, match="generator"):
        TA.standard_train_augment(xt)


def test_augment_and_resample():
    """The fused self-sup input: the augmented full-resolution cloud, and
    the xyz of ``npoint`` distinct points of it (zero normals at 6
    channels), as ``prifit_tpu/train/steps.py:93-100`` builds them."""
    x, _, xt = _jax_batch(4, (2, 90, 3))
    g = torch.Generator().manual_seed(1)
    chamfer, points = TA.augment_and_resample(xt, 40, 6, generator=g)
    g = torch.Generator().manual_seed(1)
    want = TA.standard_train_augment(xt, generator=g)
    choice = torch.randperm(90, generator=g)[:40]
    torch.testing.assert_close(chamfer, want, rtol=0, atol=0)
    torch.testing.assert_close(points[..., :3], want[:, choice],
                               rtol=0, atol=0)
    assert len(set(choice.tolist())) == 40
    assert not points[..., 3:].any()


def test_prefetch_to_device_cpu():
    """On the CPU the stream hands over tensors of the transformed
    batches in order, surfaces producer errors, latches at its end and
    retires its thread on close."""
    batches = [(np.full((2, 3), i, np.float32), np.arange(i, i + 2))
               for i in range(4)]
    seen = []

    def transform(b):
        seen.append(int(b[0][0, 0]))
        return b[0] * 10, b[1]

    out = list(prefetch_to_device(iter(batches), transform=transform,
                                  device="cpu"))
    assert seen == [0, 1, 2, 3]
    for i, (a, b) in enumerate(out):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        assert torch.equal(a, torch.full((2, 3), 10.0 * i))
        assert torch.equal(b, torch.arange(i, i + 2))

    def bad():
        yield 1
        raise RuntimeError("boom")

    it = prefetch_to_device(bad(), device="cpu")
    assert int(next(it)) == 1
    with pytest.raises(RuntimeError, match="boom"):
        next(it)
    with pytest.raises(StopIteration):
        next(it)

    before = threading.active_count()
    stream = prefetch_to_device(itertools.count(), device="cpu")
    assert int(next(stream)) == 0
    stream.close()
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_prefetch_to_device_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        prefetch_to_device(iter([1]))


def _twin_states():
    """Two identical f32 flagship train states at B=1, N=48 on the CPU."""
    import prifit_torch.entry as entry
    return [entry.train_flagship(1, 48, device="cpu", compute_dtype="f32")
            for _ in range(2)]


def _assert_same_update(sa, sb, ma, mb):
    for k in ma:
        torch.testing.assert_close(ma[k], mb[k], rtol=0, atol=0)
    for (n, a), b in zip(sa.model.state_dict().items(),
                         sb.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)


def test_fused_supervised_step_equals_augmented_step():
    """``fused_augment=True`` augments on the device from the step's
    generator, before the forward's draws: the same as the plain step on
    points augmented with the same generator."""
    from prifit_torch.models.pointnet2_part_seg_msg import get_loss
    from prifit_torch.train.steps import make_supervised_step
    (sa, pts, cls, target), (sb, _, _, _) = _twin_states()
    ga = torch.Generator().manual_seed(3)
    gb = torch.Generator().manual_seed(3)
    _, ma = make_supervised_step(get_loss, fused_augment=True)(
        sa, pts, cls, target, 1e-3, 0.1, ga)
    aug = TA.standard_train_augment(pts, generator=gb)
    assert not torch.equal(aug, pts)
    _, mb = make_supervised_step(get_loss)(sb, aug, cls, target, 1e-3, 0.1,
                                           gb)
    _assert_same_update(sa, sb, ma, mb)


def test_fused_selfsup_step_equals_augmented_step():
    """The fused self-sup step augments ``chamfer_points`` and resamples
    the encoder input from it (``points`` is a placeholder): the same as
    the plain step on :func:`augment_and_resample`'s outputs from the
    same generator."""
    from prifit_torch.train.steps import make_selfsup_step
    (sa, pts, cls, _), (sb, _, _, _) = _twin_states()
    chamfer = torch.from_numpy(np.random.default_rng(2).normal(
        size=(1, 120, 3)).astype(np.float32))
    kw = dict(quantile=0.2, msc_iterations=2, max_num_clusters=4,
              n_per_prim=16)
    ga = torch.Generator().manual_seed(4)
    gb = torch.Generator().manual_seed(4)
    _, ma = make_selfsup_step(fused_augment=True, **kw)(
        sa, chamfer[:, :48], cls, chamfer, 1e-3, 0.1, 1.0, ga)
    c2, p2 = TA.augment_and_resample(chamfer, 48, 3, generator=gb)
    _, mb = make_selfsup_step(**kw)(sb, p2, cls, c2, 1e-3, 0.1, 1.0, gb)
    _assert_same_update(sa, sb, ma, mb)
    assert torch.isfinite(ma["ss_loss"])
