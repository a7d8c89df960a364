"""The port's S3DIS loader and scene semantic-segmentation models
(``pointnet_sem_seg``, ``pointnet2_sem_seg``) against the JAX package on
the CPU.

- ``S3DISDataset`` items equal JAX's bit for bit, item after item from
  one seed, on ``tests/fixtures.py::make_s3dis_fixture`` rooms (sparse:
  every block draw retries 10 times; denser: retries vary), for the
  train and test splits, with and without rgb.
- Each model from converted JAX variables (batch-norm statistics
  randomized, ``pointnet_sem_seg``'s transformers' last dense drawn
  small), on S3DIS blocks, FPS from index 0 (``PRIFIT_DET_FPS=1``),
  dropout 0, f32: eval log-probs within 1e-5 of their largest entry;
  train-mode log-probs within 5e-4 of theirs and running statistics
  within 5e-5 of theirs, the loss (unweighted and class-weighted) within
  1e-5 relative and every gradient within 5e-2 of its norm (the limits
  of ``test_torch_cls_models.py`` but the log-probs').  Against the same
  model in float64, JAX's jitted train-mode log-probs of
  ``pointnet2_sem_seg`` are up to 2.5e-4 of the largest entry off (its
  op-by-op ones 1.1e-4, the port's 1e-5), and every f32 run of
  ``pointnet_sem_seg`` (JAX's and the port's) 1.2e-4: its transformers'
  batch norms normalize 8 rows after the max.  ``pointnet2_sem_seg`` at
  B=4, N=2048 (its sa4 groups 16
  centroids of 64 points with K=32 at r=0.8, where many balls hold fewer
  than 32 points and pad); ``pointnet_sem_seg`` at B=8, N=512 (its
  transformers' batch norms after the max have B rows, chaotic at B=2).
- The input width: JAX's models size their first layer from the input,
  the port's from ``channel`` (``with_rgb`` by default).  JAX's own odd
  case, ``with_rgb=False`` fed 6 channels, loads into a port model built
  with ``channel=convert.input_channels(v)``; the default model refuses
  the weights and the input.
"""

import re

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prifit_torch.convert import input_channels, params_from_jax, \
    state_dict_from_jax
from prifit_torch.data import S3DIS_CLASSES, S3DISDataset
from prifit_torch.models import get_module
from prifit_tpu.data import S3DIS_CLASSES as J_CLASSES
from prifit_tpu.data import S3DISDataset as JS3DISDataset
from prifit_tpu.models import get_module as jget_module
from test_torch_cls_models import _close, _perturb_transforms
from test_torch_partseg_ssg import NoDropout, randomize_stats
from tests.fixtures import make_s3dis_fixture

torch.set_num_threads(1)

CLASSES = 13
TRAIN_TOL, STATS_TOL, LOSS_RTOL, GRAD_RTOL = 5e-4, 5e-5, 1e-5, 5e-2
BN_MOMENTUM = 0.1
RNGS = {"sampling": jax.random.PRNGKey(4), "dropout": jax.random.PRNGKey(5)}
SHAPES = {"pointnet2_sem_seg": (4, 2048), "pointnet_sem_seg": (8, 512)}


@pytest.fixture(scope="module")
def rooms(tmp_path_factory):
    """Sparse rooms (5000 points in 3 m cubes: no 1 m block holds 1024, so
    every draw retries 10 times) and denser ones (12000)."""
    base = tmp_path_factory.mktemp("s3dis")
    return {"sparse": make_s3dis_fixture(str(base / "sparse")),
            "dense": make_s3dis_fixture(str(base / "dense"),
                                        n_points=12000, seed=1)}


@pytest.mark.parametrize("density", ["sparse", "dense"])
@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("with_rgb", [True, False])
def test_s3dis_items_match_jax(rooms, density, split, with_rgb):
    kw = dict(num_point=256, split=split, with_rgb=with_rgb)
    got = S3DISDataset(rooms[density], rng=np.random.default_rng(3), **kw)
    ref = JS3DISDataset(rooms[density], rng=np.random.default_rng(3), **kw)
    assert len(got) == len(ref) >= 1
    np.testing.assert_array_equal(got.room_prob, ref.room_prob)
    for _ in range(6):
        (gb, gs), (rb, rs) = got[0], ref[0]
        assert gb.shape == (256, 6 if with_rgb else 3) and gb.dtype == \
            np.float32
        np.testing.assert_array_equal(gb, rb)
        np.testing.assert_array_equal(gs, rs)
    assert S3DIS_CLASSES == J_CLASSES


def _blocks(root, b, n, seed):
    ds = S3DISDataset(root, num_point=n, rng=np.random.default_rng(seed))
    xs, ys = zip(*(ds[0] for _ in range(b)))
    return np.stack(xs), np.stack(ys).astype(np.int64)


def _kwargs(name, **kw):
    key = "num_classes" if name == "pointnet2_sem_seg" else "num_class"
    return {key: CLASSES, **kw}


def _port(name, variables, **kw):
    model = get_module(name).get_model(**_kwargs(name, **kw), device="cpu")
    if hasattr(model, "dropout_rate"):
        model.dropout_rate = 0.0
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def _init(jmod, x, seed):
    v = jax.jit(lambda r: jmod.init(r, jnp.asarray(x), train=False))(
        {"params": jax.random.PRNGKey(seed),
         "sampling": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)})
    return jax.tree_util.tree_map(np.array, v["params"]), v["batch_stats"]


@pytest.fixture(scope="module", params=list(SHAPES))
def run(request, rooms):
    """A sem-seg model's JAX variables and blocks, its eval log-probs, and
    its jitted train-mode log-probs, statistics, and loss and gradients
    unweighted and class-weighted."""
    name = request.param
    b, n = SHAPES[name]
    x, target = _blocks(rooms["dense"], b, n, 7)
    rng = np.random.default_rng(8)
    weight = rng.uniform(0.5, 2.0, CLASSES).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PRIFIT_DET_FPS", "1")
        mp.setattr(fnn, "Dropout", NoDropout)
        mod = jget_module(name)
        jmod = mod.get_model(**_kwargs(name))
        params, stats = _init(jmod, x, 0)
        if name == "pointnet_sem_seg":
            _perturb_transforms(params, rng)
        v = {"params": params, "batch_stats": randomize_stats(stats, rng)}
        eval_logp = jmod.apply(v, jnp.asarray(x), train=False)[0]

        def loss(p, w):
            (logp, aux), upd = jmod.apply(
                {"params": p, "batch_stats": v["batch_stats"]},
                jnp.asarray(x), train=True, bn_momentum=BN_MOMENTUM,
                rngs=RNGS, mutable=["batch_stats"])
            return mod.get_loss(logp, jnp.asarray(target), aux, weight=w), (
                logp, upd["batch_stats"])

        runs = {}
        fn = jax.jit(jax.value_and_grad(loss, has_aux=True))
        for tag, w in (("unweighted", None), ("weighted", jnp.asarray(weight))):
            (lv, (logp, new_stats)), grads = fn(v["params"], w)
            runs[tag] = dict(loss=float(lv), grads=params_from_jax(grads))
    return dict(name=name, x=x, target=target, weight=weight, v=v,
                eval_logp=eval_logp, logp=logp, stats=new_stats, runs=runs)


def test_eval_forward_matches_jax(run):
    d = run
    model = _port(d["name"], d["v"]).eval()
    with torch.no_grad():
        logp, _ = model(torch.from_numpy(d["x"]))
    assert logp.shape == d["x"].shape[:2] + (CLASSES,)
    _close(logp, d["eval_logp"])


def _zero_grad_bias(model, name):
    """A bias whose gradient is analytically 0: a dense bias a batch norm
    follows (all but the head's last), and a batch-norm bias before a
    max over the points or neighbours, whose shift a later batch norm
    removes (an SA layer's last; the encoder's and each transformer's
    ``bn3``)."""
    last = "conv2.bias" if model == "pointnet2_sem_seg" else "conv4.bias"
    if name != last and re.search(r"(conv\d|mlp_convs\.\d+|fc[12])\.bias$",
                                  name):
        return True
    return re.fullmatch(r"sa\d\.mlp_bns\.2\.bias|feat\.(f?stn\.)?bn3\.bias",
                        name) is not None


@pytest.mark.parametrize("weighted", [False, True])
def test_train_forward_loss_and_gradients_match_jax(run, weighted):
    d = run
    ref = d["runs"]["weighted" if weighted else "unweighted"]
    model = _port(d["name"], d["v"]).train()
    logp, aux = model(torch.from_numpy(d["x"]), bn_momentum=BN_MOMENTUM)
    _close(logp, d["logp"], TRAIN_TOL)
    want = state_dict_from_jax({"params": d["v"]["params"],
                                "batch_stats": d["stats"]})
    for name, t in model.named_buffers():
        _close(t, want[name], STATS_TOL)
    w = torch.from_numpy(d["weight"]) if weighted else None
    loss = get_module(d["name"]).get_loss(
        logp, torch.from_numpy(d["target"]), aux, weight=w)
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=LOSS_RTOL)
    checked = 0
    for name, p in model.named_parameters():
        if _zero_grad_bias(d["name"], name):
            continue
        r = ref["grads"][name]
        err = float((p.grad - r).norm() / r.norm())
        assert err <= GRAD_RTOL, f"{name}: relative gradient error {err}"
        checked += 1
    assert checked > 10


@pytest.mark.parametrize("name", list(SHAPES))
def test_input_width_follows_the_jax_weights(rooms, name):
    """JAX's ``with_rgb=False`` model initialized on 6 channels (its own
    test does so): the port builds it with ``channel=6`` from
    ``input_channels``, and that model's eval forward matches JAX's; the
    default ``with_rgb=False`` model (3 channels) refuses both the
    weights and the 6-channel input, naming the width."""
    x, _ = _blocks(rooms["dense"], 2, 1024, 9)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PRIFIT_DET_FPS", "1")
        jmod = jget_module(name).get_model(**_kwargs(name, with_rgb=False))
        params, stats = _init(jmod, x, 3)
        v = {"params": params, "batch_stats": stats}
        want = jmod.apply(v, jnp.asarray(x), train=False)[0]
    assert input_channels(v) == 6
    model = _port(name, v, with_rgb=False, channel=input_channels(v))
    with torch.no_grad():
        _close(model.eval()(torch.from_numpy(x))[0], want)
    narrow = get_module(name).get_model(**_kwargs(name, with_rgb=False),
                                        device="cpu")
    with pytest.raises(RuntimeError, match="size mismatch"):
        narrow.load_state_dict(state_dict_from_jax(v), strict=True)
    with pytest.raises(ValueError, match="channel=6"):
        narrow(torch.from_numpy(x))
