"""The port's supervised and self-supervised train steps against the JAX
package on the CPU, with the f32 encoder.

The JAX ``pointnet2_part_seg_msg`` (``compute_dtype="f32"``, dropout 0,
FPS pinned to start 0 through ``PRIFIT_DET_FPS=1``) is initialized, its
batch-norm statistics randomized, and converted into the port with
``state_dict_from_jax``; gradient trees go through ``params_from_jax``.
The JAX side runs the ``compute`` of ``train/steps.py`` under one jit and
the JAX ``TrainState.apply_gradients``; the port runs its own steps.

Gradients are held two ways, relative to each parameter's gradient norm:
within ``F64_RTOL`` of the same port step run in float64 (the model in
double precision), and within ``JAX_RTOL`` of the JAX package's.  The
second limit is JAX's, not the port's: against the float64 step, the
port's f32 gradients are off by at most 2e-3 (supervised) and 4e-4
(self-sup), the JAX package's by up to 8e-3 and 1.8e-2.  Every batch
norm's backward subtracts the mean of its cotangent, a sum of many terms
that nearly cancel, and JAX's CPU reduction rounds that sum more
coarsely; each layer below inherits the error.  A real gradient defect is
O(1) and fails both.

Each pre-BN dense bias has an analytically zero gradient (the batch norm
subtracts it out), and so has sa3's last batch-norm bias (see
``_zero_grad_bias``).  Their numerical gradients are rounding noise on
both sides, which Adam turns into updates of about +-lr.  Those biases
are not compared directly, only through the losses and the running means
they enter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prifit_torch.clustering import mean_shift as T
from prifit_torch.convert import params_from_jax, state_dict_from_jax
from prifit_torch.models.pointnet2_part_seg_msg import get_loss, get_model
from prifit_torch.train.state import create_train_state
from prifit_torch.train.steps import make_selfsup_step, make_supervised_step
from prifit_tpu.clustering import mean_shift as J
from prifit_tpu.models import get_module
from prifit_tpu.train.state import TrainState as JTrainState
from prifit_tpu.train.state import make_optimizer as j_make_optimizer
from test_torch_grad import align_eigh_signs, jax_eigh

torch.set_num_threads(1)

B, N, PARTS = 2, 512, 50
LR, BN_MOMENTUM, LMBDA = 1e-3, 0.1, 1.0
# one mean-shift step: after two, each cluster's modes agree to f32
# rounding and the center choice is a rounding tie
SS_KW = dict(quantile=0.05, msc_iterations=1, max_num_clusters=6,
             n_per_prim=32, num_bandwidth_candidates=2)
# fp1's weights on its xyz inputs scaled up for the self-sup step, so that
# the embedding follows position and a cloud of 3 blobs gives 3 clusters:
# with 1 cluster the membership is 1 everywhere and the loss does not
# depend on the embedding at all
XYZ_GAIN = 30.0
F64_RTOL = 5e-3   # see the module docstring
JAX_RTOL = 5e-2


def _zero_grad_bias(name: str) -> bool:
    """A bias whose gradient is analytically zero: a dense bias that a
    batch norm follows, and sa3's last batch-norm bias, whose shift
    reaches fp3 as the same constant on every row that fp3's first batch
    norm normalizes."""
    return name.endswith(".bias") and (
        ".conv_blocks." in name or ".mlp_convs." in name
        or name in ("conv1.bias", "sa3.mlp_bns.2.bias"))


def jax_variables(model, rng, x, cls):
    """Variables of the JAX ``model``, initialized on ``x``'s first 256
    points, with batch-norm statistics drawn from ``rng``."""
    xs = jnp.asarray(x[:, :256])
    v = jax.jit(lambda r: model.init(
        r, xs, jnp.asarray(cls), chamfer_points=xs, train=True,
        include_convex_loss=True, quantile=0.5, msc_iterations=1,
        max_num_clusters=2, n_per_prim=4))(
        {"params": jax.random.PRNGKey(0),
         "sampling": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2),
         "selfsup": jax.random.PRNGKey(3)})

    def randomize(path, a):
        name = str(path[-1].key)
        if name.endswith("mean"):
            return rng.normal(size=a.shape).astype(np.float32) * 0.1
        return rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32)

    return {"params": jax.tree_util.tree_map(np.asarray, v["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(
                randomize, v["batch_stats"])}


def blob_cloud(rng):
    """``[B, N, 3]``: each cloud 3 gaussian blobs of equal size."""
    lab = np.arange(N) % 3
    return np.stack([np.eye(3)[rng.permutation(lab)] * 4.0
                     + rng.normal(size=(N, 3)) * 0.3
                     for _ in range(B)]).astype(np.float32)


def with_xyz_gain(params):
    """A copy of JAX ``params`` with fp1's weights on its xyz inputs
    scaled by ``XYZ_GAIN``."""
    params = jax.tree_util.tree_map(np.array, params)
    params["fp1"]["PointMLP_0"]["w0"][16:22] *= XYZ_GAIN
    return params


@pytest.fixture(scope="module")
def setup():
    """Data, JAX variables and the two jitted JAX ``compute`` functions,
    traced with the FPS start pinned."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PRIFIT_DET_FPS", "1")
        rng = np.random.default_rng(21)
        x = rng.normal(size=(B, N, 3)).astype(np.float32)
        cls = np.zeros((B, 16), np.float32)
        cls[:, 2] = 1.0
        target = rng.integers(0, PARTS, size=(B, N))
        model = get_module("pointnet2_part_seg_msg").get_model(
            num_parts=PARTS, compute_dtype="f32", dropout_rate=0.0)
        variables = jax_variables(model, rng, x, cls)
        xj, cj, tj = jnp.asarray(x), jnp.asarray(cls), jnp.asarray(target)
        rngs = {"sampling": jax.random.PRNGKey(4),
                "dropout": jax.random.PRNGKey(5),
                "selfsup": jax.random.PRNGKey(6)}

        def sup(params, stats):
            out, upd = model.apply(
                {"params": params, "batch_stats": stats}, xj, cj,
                train=True, bn_momentum=BN_MOMENTUM, rngs=rngs,
                mutable=["batch_stats"])
            loss = get_module("pointnet2_part_seg_msg").get_loss(
                out.seg_logits, tj, out.trans_feat)
            acc = jnp.mean((jnp.argmax(out.seg_logits, -1) == tj)
                           .astype(jnp.float32))
            return loss, (upd["batch_stats"], acc)

        blobs = blob_cloud(rng)
        ss_params = with_xyz_gain(variables["params"])
        bj = jnp.asarray(blobs)

        def selfsup(params, stats):
            out, upd = model.apply(
                {"params": params, "batch_stats": stats,
                 "selfsup_state": {"beta": jnp.ones((), jnp.float32)}},
                bj, cj, chamfer_points=bj, train=True,
                bn_momentum=BN_MOMENTUM, rngs=rngs,
                mutable=["batch_stats", "selfsup_state"],
                include_convex_loss=True, **SS_KW)
            return jnp.mean(out.total_loss) * LMBDA, (
                upd, out.chamfer_loss, out.embedding,
                out.convex.clusters.bandwidth,
                out.convex.clusters.num_clusters)

        sup_fn = jax.jit(jax.value_and_grad(sup, has_aux=True))
        ss_fn = jax.jit(jax.value_and_grad(selfsup, has_aux=True))
        ss_vars = {"params": ss_params,
                   "batch_stats": variables["batch_stats"]}
        ss_out = ss_fn(ss_params, variables["batch_stats"])
        yield dict(x=x, cls=cls, target=target, variables=variables,
                   sup_fn=sup_fn, blobs=blobs, ss_vars=ss_vars,
                   ss_out=ss_out)


def _port_state(variables):
    model = get_model(num_parts=PARTS, compute_dtype="f32", dropout_rate=0.0,
                      device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return create_train_state(model)


def _f64_grads(variables, step, tensors, scalars):
    """The gradients of ``step(state, *tensors, *scalars)`` run on the
    port's model in float64 from ``variables``, with the float tensors in
    float64."""
    state = _port_state(variables)
    state.model.double()
    step(state, *(t.double() if t.is_floating_point() else t
                  for t in tensors), *scalars)
    return {n: g.float() for n, g in _grads(state.model).items()}


def _tensors(d):
    return [torch.from_numpy(d[k]) for k in ("x", "cls", "target")]


def _grads(model):
    return {n: p.grad.clone() for n, p in model.named_parameters()}


def _assert_grads_match(grads, ref, rtol):
    """Each parameter's gradient in ``grads`` within ``rtol`` of the norm
    of its reference gradient in ``ref`` (both name -> tensor), the biases
    of ``_zero_grad_bias`` aside, and exactly 0 where the loss does not
    reach the parameter; returns the largest relative error."""
    worst = 0.0
    for name, g in grads.items():
        if _zero_grad_bias(name):
            continue
        r = ref[name]
        if not bool(r.any()):
            assert not bool(g.any()), name
            continue
        err = float((g - r).norm() / r.norm())
        worst = max(worst, err)
        assert err <= rtol, f"{name}: relative gradient error {err}"
    return worst


def _assert_stats_match(buffers, variables, jax_stats, atol):
    """The running statistics in ``buffers`` (name -> tensor) against
    JAX's ``batch_stats``."""
    sd = state_dict_from_jax({"params": variables["params"],
                              "batch_stats": jax_stats})
    for name, buf in buffers.items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), sd[name].numpy(),
                                       atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def sup_runs(setup):
    """Three Adam steps (coupled weight decay 1e-4) on each side from the
    same weights: the JAX ``compute`` and ``TrainState.apply_gradients``,
    and the port's supervised step; with each side's losses, and its
    step-1 gradients, running statistics and accuracy."""
    tx = j_make_optimizer("Adam", 1e-4)
    params = setup["variables"]["params"]
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         batch_stats=setup["variables"]["batch_stats"],
                         selfsup_state={}, opt_state=tx.init(params), tx=tx)
    apply = jax.jit(lambda st, g: st.apply_gradients(g, LR))
    jax_run = {"losses": []}
    for i in range(3):
        (loss, (stats, acc)), grads = setup["sup_fn"](jstate.params,
                                                      jstate.batch_stats)
        jstate = apply(jstate, grads).replace(batch_stats=stats)
        jax_run["losses"].append(float(loss))
        if i == 0:
            jax_run.update(grads=params_from_jax(grads), stats=stats,
                           acc=float(acc))

    state = _port_state(setup["variables"])
    step = make_supervised_step(get_loss)
    run = {"losses": []}
    for i in range(3):
        state, metrics = step(state, *_tensors(setup), LR, BN_MOMENTUM)
        run["losses"].append(metrics["loss"].item())
        if i == 0:
            run.update(acc=metrics["acc"].item(), grads=_grads(state.model),
                       buffers={n: b.clone() for n, b in
                                state.model.named_buffers()})
    run["steps"] = state.step
    return run, jax_run


def test_supervised_step_gradients_match_jax(setup, sup_runs):
    """Step 1 from the same weights: loss within 1e-5 relative and the
    accuracy exactly (the same f32 forward in another sum order); every
    parameter's gradient within ``F64_RTOL`` of the float64 step's and
    ``JAX_RTOL`` of JAX's; the running statistics within 1e-5."""
    run, jax_run = sup_runs
    np.testing.assert_allclose(run["losses"][0], jax_run["losses"][0],
                               rtol=1e-5)
    assert run["acc"] == pytest.approx(jax_run["acc"], abs=1e-7)
    _assert_grads_match(run["grads"], jax_run["grads"], JAX_RTOL)
    _assert_grads_match(run["grads"], _f64_grads(
        setup["variables"], make_supervised_step(get_loss), _tensors(setup),
        (LR, BN_MOMENTUM)), F64_RTOL)
    _assert_stats_match(run["buffers"], setup["variables"], jax_run["stats"],
                        1e-5)


def test_supervised_adam_trajectory_matches_jax(sup_runs):
    """Three Adam steps: the step-1 loss from identical weights within
    1e-5 relative; later steps amplify f32 reduction-order noise, and
    JAX's f32 gradients are off by up to 8e-3 (module docstring), which
    Adam's per-element normalization passes on to the updates; so the
    trajectory is held within 1e-2 relative, which still catches any real
    gradient defect (those are O(1)).

    The running statistics after 3 steps are not compared (step 1's are,
    above).  Gradient entries at noise level -- the pre-BN biases, and
    fp3's weights on sa3's global features, which are constant over a
    shape's points -- get full +-lr Adam updates of either sign on either
    side; the batch norms cancel those in train mode, but the running
    means keep them (measured: 0.5 apart in fp3's first batch norm)."""
    run, jax_run = sup_runs
    assert run["steps"] == 3
    np.testing.assert_allclose(run["losses"][0], jax_run["losses"][0],
                               rtol=1e-5)
    np.testing.assert_allclose(run["losses"], jax_run["losses"], rtol=1e-2)
    assert run["losses"][2] < run["losses"][0]


def test_selfsup_step_matches_jax(setup, monkeypatch):
    """One self-sup step at 1 mean-shift step, 6 slots, on a cloud of 3
    blobs: 4 clusters per shape, and both sides choose the same center ids
    (asserted first: the gradient flows through the chosen modes'
    trajectories); then, with the eigenvector signs aligned, ss_loss and
    chamfer within 1e-4 relative (f32 clustering, fit and chamfer in
    another sum order), every parameter's gradient within ``F64_RTOL`` of
    the float64 step's and ``JAX_RTOL`` of JAX's, and beta decayed
    once."""
    (jl, (upd, jcham, emb, bw, nc)), grads = setup["ss_out"]
    state = _port_state(setup["ss_vars"])
    x, cls = torch.from_numpy(setup["blobs"]), torch.from_numpy(setup["cls"])
    align_eigh_signs(monkeypatch, jax_eigh)
    step = make_selfsup_step(**SS_KW)
    state, metrics = step(state, x, cls, x, LR, BN_MOMENTUM, LMBDA)

    iters, K = SS_KW["msc_iterations"], SS_KW["max_num_clusters"]
    emb = np.asarray(emb)
    Xn = emb / np.linalg.norm(emb, axis=-1, keepdims=True)
    jids = [np.asarray(J.nms_fixed_slots(
        J.mean_shift_iterations(jnp.asarray(e), b, iters), b, K)[0])
        for e, b in zip(Xn, bw)]
    with torch.no_grad():
        bt = torch.from_numpy(np.array(bw))
        modes = T.mean_shift_iterations(torch.from_numpy(Xn), bt, iters)
        tids = T.nms_fixed_slots(modes, bt, K)[0]
    np.testing.assert_array_equal(tids.numpy(), np.stack(jids))
    assert np.asarray(nc).tolist() == [4, 4]

    np.testing.assert_allclose(metrics["ss_loss"].item(), float(jl),
                               rtol=1e-4)
    np.testing.assert_allclose(metrics["chamfer_loss"].item(), float(jcham),
                               rtol=1e-4)
    _assert_grads_match(_grads(state.model), params_from_jax(grads),
                        JAX_RTOL)
    _assert_grads_match(_grads(state.model), _f64_grads(
        setup["ss_vars"], step, (x, cls, x), (LR, BN_MOMENTUM, LMBDA)),
        F64_RTOL)
    assert state.model.beta.item() == pytest.approx(0.99)
    assert float(upd["selfsup_state"]["beta"]) == pytest.approx(0.99)


def test_beta_decays_only_in_the_selfsup_step(setup):
    """The entropy weight ``beta``: an eval forward with the convex loss
    leaves it at 1.0, as a JAX ``apply`` that may not mutate
    ``selfsup_state`` does; one self-sup step decays it to exactly the
    ``selfsup_state`` beta that the JAX step's ``compute`` returns (and
    the step stores, ``prifit_tpu/train/steps.py``); a later eval forward
    keeps it."""
    (_, (upd, *_)), _ = setup["ss_out"]
    state = _port_state(setup["ss_vars"])
    x, cls = torch.from_numpy(setup["blobs"]), torch.from_numpy(setup["cls"])

    def eval_forward():
        with torch.no_grad():
            state.model.eval()(x, cls, chamfer_points=x,
                               include_convex_loss=True, **SS_KW)
        return state.model.beta.numpy().copy()

    assert eval_forward() == np.float32(1.0)
    state, _ = make_selfsup_step(**SS_KW)(state, x, cls, x, LR,
                                          BN_MOMENTUM, LMBDA)
    jbeta = np.asarray(upd["selfsup_state"]["beta"], np.float32)
    assert jbeta == np.float32(0.99)
    np.testing.assert_array_equal(state.model.beta.numpy(), jbeta)
    np.testing.assert_array_equal(eval_forward(), jbeta)
