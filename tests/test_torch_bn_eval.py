"""The eval epilogue of a PointNet++ dense layer
(``prifit_torch.kernels.bn_eval``) and where the encoder takes it.

Its plain version must equal the op chain that the encoder runs outside
eval (``dense``'s bias add, ``BatchNorm``'s eval forward, the cast,
``torch.relu``, ``torch.amax``) exactly, in bf16 and f32 storage, from an
f32 grouped input, with and without the dense bias and the K-max, at the
encoder's widths and row counts that are not a multiple of a block.  An
MSG eval forward with no gradient recorded calls it once a layer (24
times, 6 of them with the K-max) and gives the same values as the op
chain; training mode, eval with gradients, ``FQ`` and charted batch
norms keep the op chain.  Plain PyTorch on the CPU: no JAX."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from prifit_torch import entry
from prifit_torch.kernels.bn_eval import bn_relu_eval, bn_relu_eval_plain
from prifit_torch.models.pointnet2_part_seg_msg import get_model
from prifit_torch.nn import pointnet2 as p2
from prifit_torch.nn.norm import BatchNorm
from prifit_torch.utils import profiling

torch.set_num_threads(1)

WIDTHS = (32, 64, 96, 128, 196, 256, 1024)
# (storage, input): the product of a dense layer with its bias or without
# one, or a grouped first layer's f32 pre-activation
CASES = [(torch.bfloat16, "dense_bias"), (torch.bfloat16, "dense"),
         (torch.bfloat16, "grouped"), (None, "dense_bias"), (None, "dense"),
         (None, "grouped")]
# [groups, K, F]: 3 x 37 rows, not a multiple of any block's rows
GROUPS, K = 3, 37


def _bn(F, gen, charts=None):
    bn = BatchNorm(F, charts=charts)
    shape = bn.weight.shape
    with torch.no_grad():
        bn.running_mean.copy_(torch.randn(shape, generator=gen) * 0.3)
        bn.running_var.copy_(torch.rand(shape, generator=gen) * 2 + 0.05)
        bn.weight.copy_(torch.randn(shape, generator=gen))
        bn.bias.copy_(torch.randn(shape, generator=gen) * 0.5)
    return bn.eval()


def _op_chain(x, w, b, bn, storage, source, kmax):
    """The layer as the encoder computes it outside the eval kernel."""
    if source == "grouped":
        h = p2.cast(x, storage)
    else:
        h = p2.dense(x, w, b if source == "dense_bias" else None, storage)
    h = torch.relu(bn(h))
    return torch.amax(h, dim=-2) if kmax else h


@pytest.mark.parametrize("kmax", [False, True])
@pytest.mark.parametrize("F", WIDTHS)
@pytest.mark.parametrize("storage,source", CASES)
def test_plain_equals_the_op_chain(storage, source, F, kmax):
    gen = torch.Generator().manual_seed(F)
    bn = _bn(F, gen)
    d_in = 24
    x = torch.randn((GROUPS, K, d_in if source != "grouped" else F),
                    generator=gen)
    w = torch.randn((F, d_in), generator=gen) * 0.3
    b = torch.randn((F,), generator=gen)
    with torch.no_grad():
        want = _op_chain(x, w, b, bn, storage, source, kmax)
        z = x if source == "grouped" else p2.dense(x, w, None, storage)
        got = bn_relu_eval_plain(
            z, bn.running_mean, torch.rsqrt(bn.running_var + bn.eps),
            bn.weight, bn.bias, b if source == "dense_bias" else None,
            storage, kmax)
    assert got.dtype == want.dtype == (storage or torch.float32)
    assert got.shape == want.shape
    assert torch.equal(got, want)
    assert bool((want == 0).any()) and bool((want > 0).any())


def _counted(fn):
    """``fn()``, and the eval epilogue calls the encoder made in it, all
    and with the K-max (its counters count launches, and on the CPU
    nothing launches)."""
    calls, real = [], p2.bn_relu_eval

    def record(*args):
        calls.append(bool(args[8]))
        return real(*args)

    p2.bn_relu_eval = record
    try:
        out = fn()
    finally:
        p2.bn_relu_eval = real
    return out, len(calls), sum(calls)


@pytest.fixture(scope="module")
def flagship():
    return entry.flagship(2, 256, device="cpu")


def test_eval_forward_takes_the_kernel_once_a_layer(flagship):
    model, points, cls = flagship
    with torch.no_grad():
        out, calls, max_calls = _counted(lambda: model(points, cls))
    # sa1 3 x 3, sa2 2 x 3, sa3 3, fp3-fp1 2 each; the K-max ends each of
    # the five SA scales and sa3
    assert (calls, max_calls) == (24, 6)
    chain, calls, _ = _counted(lambda: model(points, cls))
    assert calls == 0
    assert torch.equal(out.seg_logits, chain.seg_logits.detach())


@pytest.mark.parametrize("compute_dtype", ["f32", "bf16"])
def test_eval_forward_equals_the_op_chain(compute_dtype):
    model = get_model(num_parts=50, compute_dtype=compute_dtype,
                      device="cpu")
    entry.init_weights(model, torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    for bn in model.modules():
        if isinstance(bn, BatchNorm):
            with torch.no_grad():
                bn.running_mean.normal_(0.0, 0.2, generator=gen)
                bn.running_var.uniform_(0.5, 2.0, generator=gen)
    model.eval()
    points = torch.randn((2, 256, 3), generator=gen)
    cls = torch.zeros((2, 16))
    with torch.no_grad():
        got, calls, _ = _counted(lambda: model(points, cls))
    assert calls == 24
    want = model(points, cls)
    assert torch.equal(got.seg_logits, want.seg_logits.detach())


def test_training_mode_keeps_the_op_chain():
    state, points, cls, _ = entry.train_flagship(2, 256, device="cpu",
                                                 compute_dtype="f32")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        _, calls, _ = _counted(lambda: state.model(points, cls,
                                                   generator=gen))
    assert calls == 0


def test_fq_and_charts_keep_the_op_chain():
    gen = torch.Generator().manual_seed(3)
    convs = [torch.nn.Conv1d(8, 16, 1), torch.nn.Conv1d(16, 32, 1)]
    x = torch.randn((2, 5, 7, 8), generator=gen)
    bns = [_bn(16, gen), _bn(32, gen)]
    with torch.no_grad():
        for dtype, want_calls in ((p2.FQ, 0), (torch.bfloat16, 2)):
            out, calls, max_calls = _counted(lambda: p2.point_mlp(
                convs, bns, x, dtype, 0.1, kmax=True))
            assert (calls, max_calls) == (want_calls, want_calls // 2)
            assert out.shape == (2, 5, 32)
        charted = [_bn(16, gen, charts=2), _bn(32, gen, charts=2)]
        out, calls, _ = _counted(lambda: p2.point_mlp(
            convs, charted, x[0, :2], None, 0.1))
        assert calls == 0 and out.shape == (2, 7, 32)


def test_wrapper_computes_inv_with_rsqrt_and_counts():
    # the counters count launches: the plain version on the CPU is none
    gen = torch.Generator().manual_seed(4)
    bn = _bn(64, gen)
    z = torch.randn((4, 9, 64), generator=gen).bfloat16()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        assert profiling.recording()    # clears the last session's
        got = bn_relu_eval(z, bn.running_mean, bn.running_var, bn.eps,
                           bn.weight, bn.bias, kmax=True)
        want = torch.amax(torch.relu(bn(z)), dim=-2)
    c = profiling.counters()
    assert (c.get("bn_eval.calls", 0), c.get("bn_eval.max_calls", 0)) \
        == (0, 0)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
