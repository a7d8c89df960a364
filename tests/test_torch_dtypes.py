"""The encoder dtypes the trainer accepts besides ``f32`` and ``mxsr``,
each a B=2 train step of ``pointnet2_part_seg_msg`` against the JAX
model's on the CPU: ``--encoder_dtype`` ``bf16`` and ``mx`` here,
``sa_bf16`` in ``test_torch_dtypes_sa_bf16.py`` and the
``--stage_dtypes`` modes in ``test_torch_dtypes_stages.py`` (the files
share :func:`mode_runs`; split so that each stays near 90 s).

Both sides start from one JAX state (initialized once in f32; the
dtypes change no parameter), with dropout 0, FPS pinned to start 0 and
fp1's xyz weights scaled by ``XYZ_GAIN`` (so a 3-blob cloud gives 3
clusters in the self-sup step).  The JAX side runs the supervised loss
and its gradients, and for ``bf16`` and ``mx`` also the self-sup forward
on the blobs, under one jit, called on the data and on the data scaled by
1 +- 2^-20 and 1 +- 2^-19.

bf16 storage makes the model's gradient chaotic at B=2: a value that sums
to another f32 value rounds to another bf16 value now and then, which
flips a K-max tie or a relu boundary, and every batch norm's backward
amplifies that.  So each quantity is held within twice JAX's own spread
under those input changes (``_spread``), plus a floor: each gradient
relative to its norm, +5e-2 (the f32 step's limit); the supervised loss
within 1e-4 relative or twice the spread, whichever is larger; each
running statistic +1e-5; the self-sup loss and chamfer +1e-4 relative.
Each test's docstring states the bound that held.

The launch counts are checked on the CPU through the plain versions: the
K-max backward pair runs 6 times a step under ``mx`` (rounding off), never
otherwise, and the stochastic-rounding cast never runs in these modes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import prifit_torch.nn.mixed as M
from prifit_torch.convert import params_from_jax, state_dict_from_jax
from prifit_torch.kernels import max_bwd as KM
from prifit_torch.kernels import stochastic_round as KS
from prifit_torch.models.pointnet2_part_seg_msg import get_loss, get_model
from prifit_torch.train.state import create_train_state
from prifit_torch.train.steps import make_selfsup_step, make_supervised_step
from prifit_tpu.models import get_module
from test_torch_grad import align_eigh_signs, jax_eigh
from test_torch_train import XYZ_GAIN, _zero_grad_bias

torch.set_num_threads(1)

B, N, PARTS = 2, 512, 50
SS_KW = dict(quantile=0.05, msc_iterations=1, max_num_clusters=6,
             n_per_prim=32, num_bandwidth_candidates=2)
# the input scales of JAX's own spread
SCALES = (1 + 2.0 ** -20, 1 - 2.0 ** -20, 1 + 2.0 ** -19, 1 - 2.0 ** -19)
COUNTED = {"cnt_gsm": (KM, "cnt_gsm_plain"), "dz": (KM, "dz_plain"),
           "sr_plain": (KS, "sr_bf16_plain"), "sr": (M, "sr_bf16")}


def _data():
    rng = np.random.default_rng(21)
    x = rng.normal(size=(B, N, 3)).astype(np.float32)
    cls = np.zeros((B, 16), np.float32)
    cls[:, 2] = 1.0
    target = rng.integers(0, PARTS, size=(B, N))
    lab = np.arange(N) % 3
    blobs = np.stack([np.eye(3)[rng.permutation(lab)] * 4.0
                      + rng.normal(size=(N, 3)) * 0.3
                      for _ in range(B)]).astype(np.float32)
    return rng, x, cls, target, blobs


def jax_state():
    """Data and one JAX variable set for every mode: the f32 model's
    init, batch-norm statistics drawn from the seed, fp1's xyz weights
    scaled by ``XYZ_GAIN``."""
    rng, x, cls, target, blobs = _data()
    model = get_module("pointnet2_part_seg_msg").get_model(
        num_parts=PARTS, compute_dtype="f32", dropout_rate=0.0)
    xs = jnp.asarray(x[:, :256])
    v = jax.jit(lambda r: model.init(
        r, xs, jnp.asarray(cls), chamfer_points=xs, train=False,
        include_convex_loss=True, quantile=0.5, msc_iterations=1,
        max_num_clusters=2, n_per_prim=4))(
        {"params": jax.random.PRNGKey(0),
         "sampling": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2),
         "selfsup": jax.random.PRNGKey(3)})

    def randomize(path, a):
        if str(path[-1].key).endswith("mean"):
            return rng.normal(size=a.shape).astype(np.float32) * 0.1
        return rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32)

    params = jax.tree_util.tree_map(np.array, v["params"])
    params["fp1"]["PointMLP_0"]["w0"][16:22] *= XYZ_GAIN
    variables = {"params": params,
                 "batch_stats": jax.tree_util.tree_map_with_path(
                     randomize, v["batch_stats"])}
    return dict(x=x, cls=cls, target=target, blobs=blobs,
                variables=variables)


def _count_plain_calls(mp):
    """Count the calls of the K-max pair's and the rounding cast's CPU
    versions (each a launch on the card)."""
    counts = dict.fromkeys(COUNTED, 0)
    for name, (mod, attr) in COUNTED.items():
        real = getattr(mod, attr)

        def counted(*a, _real=real, _name=name, **k):
            counts[_name] += 1
            return _real(*a, **k)

        mp.setattr(mod, attr, counted)
    return counts


def mode_runs(st, model_kw, selfsup):
    """One mode (``model_kw``: ``compute_dtype`` and/or ``stage_dtypes``):
    JAX's runs on the data and on it scaled by ``SCALES`` (supervised loss,
    gradients and batch statistics; with ``selfsup`` the self-sup loss and
    chamfer on the blobs), and the port's supervised step (and self-sup
    step) from the same weights with the plain versions' calls counted."""
    x, cls, target, blobs = st["x"], st["cls"], st["target"], st["blobs"]
    variables = st["variables"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PRIFIT_DET_FPS", "1")
        mod = get_module("pointnet2_part_seg_msg")
        model = mod.get_model(num_parts=PARTS, dropout_rate=0.0, **model_kw)
        rngs = {"sampling": jax.random.PRNGKey(4),
                "dropout": jax.random.PRNGKey(5),
                "selfsup": jax.random.PRNGKey(6)}
        cj = jnp.asarray(cls)

        def both(params, stats, xx, bb):
            out, upd = model.apply(
                {"params": params, "batch_stats": stats}, xx, cj,
                train=True, bn_momentum=0.1, rngs=rngs,
                mutable=["batch_stats"])
            loss = mod.get_loss(out.seg_logits, jnp.asarray(target))
            if not selfsup:
                return loss, (upd["batch_stats"], 0.0, 0.0)
            ss, _ = model.apply(
                {"params": params, "batch_stats": stats,
                 "selfsup_state": {"beta": jnp.ones((), jnp.float32)}},
                bb, cj, chamfer_points=bb, train=True, bn_momentum=0.1,
                rngs=rngs, mutable=["batch_stats", "selfsup_state"],
                include_convex_loss=True, **SS_KW)
            return loss, (upd["batch_stats"], jnp.mean(ss.total_loss),
                          ss.chamfer_loss)

        fn = jax.jit(jax.value_and_grad(both, has_aux=True))
        jax_runs = []
        for s in (1.0,) + SCALES:
            (loss, (stats, ss, cham)), grads = fn(
                variables["params"], variables["batch_stats"],
                jnp.asarray(x * np.float32(s)),
                jnp.asarray(blobs * np.float32(s)))
            jax_runs.append(dict(
                loss=float(loss), ss=float(ss), cham=float(cham),
                grads=params_from_jax(grads),
                stats=state_dict_from_jax({"params": variables["params"],
                                           "batch_stats": stats})))

        def port_state():
            m = get_model(num_parts=PARTS, dropout_rate=0.0, device="cpu",
                          **model_kw)
            m.load_state_dict(state_dict_from_jax(variables), strict=True)
            return create_train_state(m)

        counts = _count_plain_calls(mp)
        state = port_state()
        _, sm = make_supervised_step(get_loss)(
            state, torch.from_numpy(x), torch.from_numpy(cls),
            torch.from_numpy(target), 1e-3, 0.1)
        port = dict(loss=sm["loss"].item(),
                    grads={n: p.grad.clone()
                           for n, p in state.model.named_parameters()},
                    stats=dict(state.model.named_buffers()),
                    counts=dict(counts))
        if selfsup:
            align_eigh_signs(mp, jax_eigh)
            ss_state = port_state()
            bt = torch.from_numpy(blobs)
            _, ssm = make_selfsup_step(**SS_KW)(
                ss_state, bt, torch.from_numpy(cls), bt, 1e-3, 0.1, 1.0)
            port.update(ss=ssm["ss_loss"].item(),
                        cham=ssm["chamfer_loss"].item())
            port["ss_counts"] = {k: v - port["counts"][k]
                                 for k, v in counts.items()}
    return port, jax_runs


def _spread(jax_runs, get):
    """The largest change of ``get(run)`` (a float or tensor) between
    JAX's run on the data and its runs on the data scaled by
    ``SCALES``."""
    ref = get(jax_runs[0])
    return max(float(np.abs(np.asarray(get(r)) - np.asarray(ref)).max())
               for r in jax_runs[1:])


def check_supervised(port, jax_runs, kmax_launches):
    """The supervised step under the rules of the module docstring; the
    plain calls: the K-max pair ``kmax_launches`` times each, no rounding
    cast.  Returns ``(loss error, the loss bound that held, the largest
    gradient error over twice its spread plus 5e-2)``."""
    ref = jax_runs[0]
    err = abs(port["loss"] - ref["loss"])
    floor, spread = 1e-4 * abs(ref["loss"]), 2 * _spread(
        jax_runs, lambda r: r["loss"])
    assert err <= max(floor, spread), (err, floor, spread)
    held = "1e-4 relative" if err <= floor else "twice the spread"
    worst, checked = 0.0, 0
    for name, r in ref["grads"].items():
        g = port["grads"][name]
        if _zero_grad_bias(name):
            continue
        if not bool(r.any()):
            assert not bool(g.any()), name
            continue
        e = float((g - r).norm() / r.norm())
        own = max(float((j["grads"][name] - r).norm() / r.norm())
                  for j in jax_runs[1:])
        assert e <= 2 * own + 5e-2, (name, e, own)
        worst = max(worst, e / (2 * own + 5e-2))
        checked += 1
    assert checked > 60
    for name, buf in port["stats"].items():
        if name.endswith(("running_mean", "running_var")):
            spread = _spread(jax_runs, lambda j: j["stats"][name].numpy())
            np.testing.assert_allclose(buf.numpy(), ref["stats"][name],
                                       rtol=0, atol=2 * spread + 1e-5,
                                       err_msg=name)
    c = port["counts"]
    assert c["cnt_gsm"] == c["dz"] == kmax_launches, c
    assert c["sr"] == c["sr_plain"] == 0, c
    return err, held, worst


def check_selfsup(port, jax_runs, kmax_launches):
    """The self-sup step on the blobs: ss_loss and chamfer within twice
    JAX's own spread plus 1e-4 relative; the same plain calls as the
    supervised step."""
    ref = jax_runs[0]
    for k in ("ss", "cham"):
        assert abs(port[k] - ref[k]) <= 2 * _spread(
            jax_runs, lambda r: r[k]) + 1e-4 * abs(ref[k]), k
    c = port["ss_counts"]
    assert c["cnt_gsm"] == c["dz"] == kmax_launches, c
    assert c["sr"] == c["sr_plain"] == 0, c


MODES = {"bf16": (dict(compute_dtype="bf16"), True),
         "mx": (dict(compute_dtype="mx"), True)}


@pytest.fixture(scope="module")
def runs():
    st = jax_state()
    return {name: mode_runs(st, kw, ss) for name, (kw, ss) in MODES.items()}


@pytest.mark.parametrize("mode", MODES)
def test_supervised_step_matches_jax(runs, mode):
    """One supervised step per ``--encoder_dtype``.  The loss bound that
    held: 1e-4 relative in both (measured 8.1e-5 for ``bf16``, 9.8e-6 for
    ``mx``); every gradient within 0.61 of its bound (errors 0.3-0.5 of
    the norm, JAX's own spread alike).  The K-max backward pair runs 6
    times under ``mx``, none under ``bf16``."""
    port, jax_runs = runs[mode]
    check_supervised(port, jax_runs, 6 if mode == "mx" else 0)


@pytest.mark.parametrize("mode", [m for m, (_, ss) in MODES.items() if ss])
def test_selfsup_step_matches_jax(runs, mode):
    """One self-sup step (1 mean-shift step, 6 slots) on 3 blobs, for
    ``bf16`` and ``mx``: the losses 1.0% and 1.6% off JAX's, whose own
    spread is 1.2% and 2.8%."""
    port, jax_runs = runs[mode]
    check_selfsup(port, jax_runs, 6 if mode == "mx" else 0)
