"""The port's fresh weights (``prifit_torch.entry.init_weights``) against
the JAX package's ``init`` on the CPU.

The draws cannot be equal (the PRNGs differ); each parameter's
distribution must be.  For ``pointnet2_part_seg_msg`` (with the self-sup
``extra_conv_emb``), ``pointnet2_part_seg_ssg``, ``pointnet2_sem_seg``
and ``pointnet2_cls_msg``, JAX's fresh variables are mapped into the
port's names by ``prifit_torch.convert.state_dict_from_jax`` and loaded
into a port model, beside a port model of the same configuration
initialized by ``init_weights``:

- every entry that is not a kernel (biases, batch-norm scales and
  biases, running statistics, ``beta``) equals JAX's exactly;
- every kernel block, a grouped first layer's xyz columns and feature
  columns apart (``gfl_weights``), has the std and mean of JAX's block of
  the same name within four standard errors of their difference (from
  the block's size and the truncated normal's kurtosis), and its fan-in
  is the one JAX's std implies;
- no entry on either side exceeds flax's truncation bound ``2 /
  (sqrt(fan_in) * 0.87962566)``.

``lecun_normal_`` itself is held against flax's ``lecun_normal()`` on
large draws by a two-sample Kolmogorov-Smirnov distance, and against the
inverse normal CDF of the generator's uniform draws.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from prifit_torch.convert import state_dict_from_jax
from prifit_torch.entry import TRUNC_STD, grouped_first_layers, \
    init_weights, lecun_normal_
from prifit_torch.models import get_module
from prifit_torch.nn.atlasnet import ChartDense
from prifit_torch.nn.pointnet2 import gfl_weights
from prifit_tpu.models import get_module as jget_module
from prifit_tpu.train.state import selfsup_init_kwargs

torch.set_num_threads(1)

B, N = 1, 64
# model name -> (port kwargs, JAX kwargs, input width, part-seg)
MODELS = {
    "pointnet2_part_seg_msg": (dict(num_parts=8), dict(num_parts=8), 3, True),
    "pointnet2_part_seg_ssg": (dict(num_classes=8), dict(num_classes=8), 3,
                               True),
    "pointnet2_sem_seg": (dict(num_classes=13), dict(num_classes=13), 6,
                          False),
    "pointnet2_cls_msg": (dict(num_class=10), dict(num_class=10), 6, False),
}
# four standard errors of a difference of two independent estimates
Z = 4.0


def _trunc_moments(a=2.0):
    """(variance, kurtosis) of a unit normal truncated at +-a."""
    phi = math.exp(-a * a / 2) / math.sqrt(2 * math.pi)
    mass = math.erf(a / math.sqrt(2))
    m2 = 1 - 2 * a * phi / mass
    m4 = (3 * (mass - 2 * a * phi) - 2 * a ** 3 * phi) / mass
    return m2, m4 / m2 ** 2


M2, KURT = _trunc_moments()


def test_trunc_std_is_flax_constant():
    """``TRUNC_STD`` is the std of a unit normal truncated at +-2."""
    assert math.sqrt(M2) == pytest.approx(TRUNC_STD, rel=1e-12)


def _kernels(model):
    """``{name: (block [rows, cols], fan_in)}`` of every kernel of the
    port ``model``: a grouped first layer's xyz and feature columns as two
    blocks."""
    grouped = grouped_first_layers(model)
    out = {}
    for name, mod in model.named_modules():
        if mod in grouped:
            d_in, xyz_first = grouped[mod]
            w_feat, w_xyz = gfl_weights(mod, d_in, xyz_first)
            out[f"{name}.weight[xyz]"] = (w_xyz, 3)
            if d_in:
                out[f"{name}.weight[feat]"] = (w_feat, d_in)
        elif isinstance(mod, (torch.nn.Conv1d, torch.nn.Conv2d)):
            out[f"{name}.weight"] = (mod.weight.reshape(
                mod.weight.shape[0], -1), mod.weight[0].numel())
        elif isinstance(mod, (torch.nn.Linear, ChartDense)):
            out[f"{name}.weight"] = (mod.weight, mod.in_features)
    return {k: (w.detach().double(), f) for k, (w, f) in out.items()}


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request):
    """``(port model from init_weights, port model holding JAX's fresh
    variables)`` of one configuration."""
    name = request.param
    kw, jkw, width, part_seg = MODELS[name]
    x = jnp.asarray(np.random.default_rng(0).normal(
        size=(B, N, width)).astype(np.float32))
    jmod = jget_module(name).get_model(**jkw)
    if part_seg:
        args = (x, jnp.zeros((B, 16), jnp.float32))
        call = selfsup_init_kwargs(x) if name.endswith("msg") else dict(
            train=False)
    else:
        args, call = (x,), dict(train=False)
    v = jax.jit(lambda r: jmod.init(r, *args, **call))(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2), "selfsup": jax.random.PRNGKey(3)})
    v = jax.tree_util.tree_map(np.asarray, v)
    mod = get_module(name)
    ported = mod.get_model(**kw, device="cpu")
    ported.load_state_dict(state_dict_from_jax(v), strict=True)
    fresh = mod.get_model(**kw, device="cpu")
    init_weights(fresh, torch.Generator().manual_seed(0))
    return fresh, ported


def test_every_other_entry_equals_jax(pair):
    """Biases, batch-norm parameters and statistics and ``beta``: the
    values JAX's ``init`` gives, exactly."""
    fresh, ported = pair
    kernels = {k.split("[")[0] for k in _kernels(fresh)}
    want = ported.state_dict()
    got = fresh.state_dict()
    assert set(got) == set(want)
    others = [k for k in got if k not in kernels]
    assert others
    for k in others:
        assert torch.equal(got[k], want[k]), k


def test_kernel_blocks_have_jax_std(pair):
    """Each kernel block's std and mean against JAX's block of the same
    name, within ``Z`` standard errors of the difference: the sample std
    of n draws of a truncated normal of std s has standard error
    ``s sqrt((kurtosis - 1) / (4 n))``, its mean ``s / sqrt(n)``.  The
    fan-in is the one JAX's block was drawn at."""
    fresh, ported = pair
    got, want = _kernels(fresh), _kernels(ported)
    assert set(got) == set(want)
    grouped = [k for k in got if k.endswith("[xyz]")]
    assert grouped
    for k, (w, fan_in) in got.items():
        j, jfan = want[k]
        assert w.shape == j.shape and fan_in == jfan, k
        n, s = w.numel(), 1 / math.sqrt(fan_in)
        se_std = s * math.sqrt((KURT - 1) / (4 * n))
        assert abs(w.std(unbiased=False) - j.std(unbiased=False)) <= \
            Z * math.sqrt(2) * se_std, (k, w.std(), j.std(), s)
        assert abs(w.mean() - j.mean()) <= Z * math.sqrt(2) * s / \
            math.sqrt(n), k
        # the fan-in JAX drew at: its std within Z standard errors of s
        assert abs(j.std(unbiased=False) - s) <= Z * se_std, (k, j.std(), s)


def test_kernels_within_flax_truncation(pair):
    """No entry beyond ``2 / (sqrt(fan_in) * TRUNC_STD)`` on either side
    (an untruncated normal passes 2 std in 4.6% of its draws)."""
    for model in pair:
        for k, (w, fan_in) in _kernels(model).items():
            bound = 2 / (math.sqrt(fan_in) * TRUNC_STD)
            assert w.abs().max() <= bound * (1 + 1e-6), (k, w.abs().max(),
                                                        bound)


def test_grouped_first_layers_draw_xyz_at_fan_in_three(pair):
    """A grouped first layer's xyz columns have std 1/sqrt(3) whatever
    its feature width, on both sides."""
    for model in pair:
        for k, (w, fan_in) in _kernels(model).items():
            if k.endswith("[xyz]"):
                n = w.numel()
                s = 1 / math.sqrt(3)
                se = s * math.sqrt((KURT - 1) / (4 * n))
                assert fan_in == 3
                assert abs(w.std(unbiased=False) - s) <= Z * se, k


@pytest.mark.parametrize("fan_in", [3, 320])
def test_lecun_normal_matches_flax(fan_in):
    """``lecun_normal_`` against flax's ``lecun_normal()`` on 2^17 draws
    each: the two-sample Kolmogorov-Smirnov distance below its 1e-4
    critical value ``2.15 sqrt(2 / n)``, and both within the bound."""
    shape = (fan_in, (1 << 17) // fan_in)
    j = np.asarray(fnn.initializers.lecun_normal()(
        jax.random.PRNGKey(fan_in), shape), np.float64).ravel()
    w = torch.empty(shape[::-1])
    lecun_normal_(w, fan_in, torch.Generator().manual_seed(fan_in))
    w = w.double().numpy().ravel()
    n = min(w.size, j.size)
    grid = np.sort(np.concatenate([w, j]))
    cdf_w = np.searchsorted(np.sort(w), grid, side="right") / w.size
    cdf_j = np.searchsorted(np.sort(j), grid, side="right") / j.size
    assert np.abs(cdf_w - cdf_j).max() < 2.15 * math.sqrt(2 / n)
    bound = 2 / (math.sqrt(fan_in) * TRUNC_STD)
    assert np.abs(w).max() <= bound * (1 + 1e-6)
    assert np.abs(j).max() <= bound * (1 + 1e-6)
    assert np.abs(w).max() > 0.99 * bound


def test_lecun_normal_is_one_uniform_draw_through_the_inverse_cdf():
    """Each entry is the inverse normal CDF of one ``uniform_`` draw of
    the generator, so a seed gives the same weights whatever the torch
    version (``torch.nn.init.trunc_normal_`` changed its sampler)."""
    from scipy.special import erfinv

    w = torch.empty(64, 5)
    lecun_normal_(w, 5, torch.Generator().manual_seed(3))
    u = torch.empty(64, 5).uniform_(
        generator=torch.Generator().manual_seed(3)).double().numpy()
    lo = 1.0 + math.erf(-2.0 / math.sqrt(2.0))
    want = np.clip(math.sqrt(2.0) * erfinv((lo - 1.0) + u * (2.0 - 2 * lo)),
                   -2.0, 2.0) / (math.sqrt(5) * TRUNC_STD)
    np.testing.assert_allclose(w.numpy(), want, rtol=1e-5, atol=1e-6)
