"""The port's flagship eval forward with primitive fit against the JAX
package on the CPU.

JAX variables (random init, randomized batch-norm statistics) go through
``prifit_torch.convert`` into the port's model with ``strict=True``; the
same seeded cloud then goes through both eval forwards with the convex
self-sup loss (bench settings except the sample count).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prifit_torch.convert import state_dict_from_jax
from prifit_torch.models.pointnet2_part_seg_msg import get_model
from prifit_torch.nn.norm import BatchNorm
from prifit_tpu.models import get_module
from prifit_tpu.nn.norm import BatchNorm as JBatchNorm

torch.set_num_threads(1)

B, N, PARTS = 2, 1024, 50
KW = dict(include_convex_loss=True, quantile=0.05, msc_iterations=10,
          max_num_clusters=25, n_per_prim=64, num_bandwidth_candidates=2)


def make_data():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(B, N, 3)).astype(np.float32)
    cls = np.zeros((B, 16), np.float32)
    cls[:, 2] = 1.0
    return x, cls


def make_variables(data):
    """JAX init at a small cloud (parameter shapes do not depend on it),
    with batch-norm running statistics randomized so the mapping of
    mean/var is exercised."""
    x, cls = data
    model = get_module("pointnet2_part_seg_msg").get_model(
        num_parts=PARTS, compute_dtype="f32")
    xs = jnp.asarray(x[:, :256])
    v = jax.jit(lambda r: model.init(
        r, xs, jnp.asarray(cls), chamfer_points=xs, train=True,
        include_convex_loss=True, quantile=0.5, msc_iterations=1,
        max_num_clusters=2, n_per_prim=4))(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2), "selfsup": jax.random.PRNGKey(3)})
    rng = np.random.default_rng(5)

    def randomize(path, a):
        name = str(path[-1].key)
        if name.endswith("mean"):
            return rng.normal(size=a.shape).astype(np.float32) * 0.1
        return rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32)

    stats = jax.tree_util.tree_map_with_path(randomize, v["batch_stats"])
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def data():
    return make_data()


@pytest.fixture(scope="module")
def variables(data):
    return make_variables(data)


def _jax_forward(variables, data, compute_dtype, fused):
    x, cls = data
    model = get_module("pointnet2_part_seg_msg").get_model(
        num_parts=PARTS, compute_dtype=compute_dtype,
        fused_ball_query=fused)
    out, _ = jax.jit(lambda v, p, c: model.apply(
        v, p, c, chamfer_points=p, train=False,
        mutable=["selfsup_state"], **KW))(
        variables, jnp.asarray(x), jnp.asarray(cls))
    return jax.tree_util.tree_map(np.asarray, out)


def _torch_forward(variables, data, compute_dtype, fused):
    x, cls = data
    model = get_model(num_parts=PARTS, compute_dtype=compute_dtype,
                      fused_ball_query=fused, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    model.eval()
    with torch.no_grad():
        xt = torch.from_numpy(x)
        return model(xt, torch.from_numpy(cls), chamfer_points=xt, **KW)


@pytest.mark.parametrize("train", [False, True])
def test_batchnorm_matches_jax(train):
    """Output within 1e-5 (f32 means summed in another order) and, in
    training, the same running mean and unbiased running variance after
    one update at momentum 0.3."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(2, 6, 5, 8)) * 2.0 + 1.0).astype(np.float32)
    stats = {"mean": rng.normal(size=8).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, size=8).astype(np.float32)}
    params = {"scale": rng.uniform(0.5, 1.5, size=8).astype(np.float32),
              "bias": rng.normal(size=8).astype(np.float32)}
    ref, upd = JBatchNorm().apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        not train, 0.3, mutable=["batch_stats"])
    bn = BatchNorm(8)
    bn.load_state_dict({"weight": torch.tensor(params["scale"]),
                        "bias": torch.tensor(params["bias"]),
                        "running_mean": torch.tensor(stats["mean"]),
                        "running_var": torch.tensor(stats["var"])})
    bn.train(train)
    out = bn(torch.from_numpy(x), 0.3)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5)
    new = upd["batch_stats"]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(new["mean"]), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(new["var"]), rtol=1e-5)


def test_state_dict_loads_strict(variables):
    """Every converted entry lands on a port parameter or buffer of the
    same shape, and no port entry is left out."""
    model = get_model(num_parts=PARTS, device="cpu")
    sd = state_dict_from_jax(variables)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    # the grouped first layer's split: features first, then xyz
    w = model.sa2.conv_blocks[0][0].weight[:, :, 0, 0].detach().numpy()
    g = variables["params"]["sa2"]["GroupedFirstLayer_0"]
    np.testing.assert_array_equal(w[:, :320], g["w_feat"].T)
    np.testing.assert_array_equal(w[:, 320:], g["w_xyz"].T)


@pytest.mark.parametrize("fused", [True, False])
def test_eval_forward_f32_matches_jax(variables, data, fused):
    """f32 encoder: seg logits, feat and hidden within 1e-4 (f32 matmuls
    summed in another order through ~15 layers), cluster counts equal,
    total loss within 1e-4 relative."""
    ref = _jax_forward(variables, data, "f32", fused)
    out = _torch_forward(variables, data, "f32", fused)
    np.testing.assert_allclose(out.seg_logits.numpy(), ref.seg_logits,
                               atol=1e-4)
    np.testing.assert_allclose(out.feat.numpy(), ref.feat, atol=1e-4)
    for h, hr in zip(out.hidden, ref.hidden):
        np.testing.assert_allclose(h.numpy(), hr, atol=1e-4)
    np.testing.assert_array_equal(
        out.convex.clusters.num_clusters.numpy(),
        ref.convex.clusters.num_clusters)
    np.testing.assert_allclose(out.total_loss.item(), float(ref.total_loss),
                               rtol=1e-4)


def test_eval_forward_default_bf16_matches_jax(variables, data):
    """Default dtype (``auto`` runs the encoder chains in bf16 in eval):
    bf16 rounds at other places in the two frameworks, so logits and feat
    are held within 0.1 (bf16 keeps ~3 significant digits through ~15
    layers); the f32 head and losses stay finite."""
    ref = _jax_forward(variables, data, "auto", True)
    out = _torch_forward(variables, data, "auto", True)
    np.testing.assert_allclose(out.seg_logits.numpy(), ref.seg_logits,
                               atol=0.1)
    np.testing.assert_allclose(out.feat.numpy(), ref.feat, atol=0.1)
    assert np.isfinite(out.total_loss.item())
    assert out.hidden[0].dtype == torch.float32
