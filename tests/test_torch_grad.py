"""Gradients of the port's differentiable pieces against the JAX package on
the CPU: the mean-shift step's closed-form backward (the plain version of
the backward kernel), the guarded eigh, the gather's scatter-add
transpose, the optimizers and schedules, and the structured convex loss.
Also: training under the ``mx``/``mxsr``/``auto`` dtypes runs, and the
fused augment still raises."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from prifit_torch.clustering import mean_shift as T
from prifit_torch.geometry.convex_loss import convex_loss
from prifit_torch.geometry.fitting import eigh3_guarded
from prifit_torch.kernels import mean_shift as KM
from prifit_torch.models.pointnet2_part_seg_msg import get_loss, get_model
from prifit_torch.ops.sampling import gather_neighbors
from prifit_torch.train import schedules as S
from prifit_torch.train.state import TrainState, make_optimizer
from prifit_torch.train.steps import _apply_gradients, make_selfsup_step, \
    make_supervised_step
from prifit_tpu.clustering import mean_shift as J
from prifit_tpu.geometry import fitting as JF
from prifit_tpu.geometry.convex_loss import convex_loss as j_convex_loss
from prifit_tpu.ops.pallas.mean_shift import _ref_step, mean_shift_step_pallas
from prifit_tpu.ops.sampling import scatter_accumulate
from prifit_tpu.train import schedules as JS
from prifit_tpu.train.state import make_optimizer as j_make_optimizer

torch.set_num_threads(1)


def align_eigh_signs(monkeypatch, reference):
    """Patch ``torch.linalg.eigh`` so that each eigenvector column takes
    the sign that ``reference(A)`` (a function returning ``(w, v)`` as
    numpy arrays or tensors) gives for the same matrix.  An eigenvector's
    sign is whatever the solver picks, in the JAX package too, and the
    fit samples a primitive along its axes, so a flipped column mirrors
    the sample lattice and moves the chamfer by ~1e-3.  Aligning the
    convention lets two implementations be compared on everything
    else."""
    orig = torch.linalg.eigh

    def eigh(A):
        w, v = orig(A)
        ref = torch.as_tensor(np.array(reference(A)[1]), device=v.device)
        dots = torch.sum(v * ref, dim=-2)
        return w, v * torch.where(dots < 0, -1.0, 1.0)[..., None, :]

    monkeypatch.setattr(torch.linalg, "eigh", eigh)


def jax_eigh(A):
    return jnp.linalg.eigh(jnp.asarray(A.detach().cpu().numpy()))


def _unit_rows(rng, shape):
    X = rng.normal(size=shape).astype(np.float32)
    return X / np.linalg.norm(X, axis=-1, keepdims=True)


@pytest.mark.parametrize("N", [256, 512])
@pytest.mark.parametrize("bw2", [0.3, 0.07])
def test_mean_shift_backward_matches_jax(N, bw2):
    """dq and dX for one cotangent, from the port's plain backward and
    from autograd through ``MeanShiftStep`` on the CPU, against
    ``jax.vjp`` of ``_ref_step`` within 2e-5 of the largest gradient entry
    (f32, the exponent rounded differently and sums in another order),
    and against the interpret-mode Pallas backward within
    ``1.5 * 2^-8 / bw2`` of it: its products take bf16 operands, which
    move each exponent by up to ``2^-8 / b^2`` and each kernel value by
    that fraction (2e-2 at ``bw2 = 0.3``).  At ``bw2 = 0.07`` about half
    the exponents clamp at -13, so the gradient cutoff is exercised."""
    rng = np.random.default_rng(N)
    q, X = _unit_rows(rng, (N, 128)), _unit_rows(rng, (N, 128))
    g = rng.normal(size=(N, 128)).astype(np.float32)
    qj, Xj, gj = jnp.asarray(q), jnp.asarray(X), jnp.asarray(g)
    bj = jnp.float32(bw2)
    clamped = float(jnp.mean((qj @ Xj.T - 1.0) / bj < -13.0))
    assert (clamped > 0.2) == (bw2 < 0.1)
    _, vjp = jax.vjp(lambda a, b: _ref_step(a, b, bj), qj, Xj)
    ref = [np.asarray(t) for t in vjp(gj)]
    _, vjp = jax.vjp(lambda a, b: mean_shift_step_pallas(a, b, bj, True),
                     qj, Xj)
    pal = [np.asarray(t) for t in vjp(gj)]

    qt = torch.from_numpy(q)[None].requires_grad_()
    Xt = torch.from_numpy(X)[None].requires_grad_()
    bt = torch.tensor([bw2], dtype=torch.float32)
    m, s = KM.mean_shift_step(qt, Xt, bt)
    plain = KM.mean_shift_step_bwd_plain(qt.detach(), Xt.detach(), bt,
                                         m.detach(), s, torch.from_numpy(g)[None])
    auto = torch.autograd.grad(m, (qt, Xt), torch.from_numpy(g)[None])
    scale = max(np.abs(r).max() for r in ref)
    for p, a, r, pl in zip(plain, auto, ref, pal):
        np.testing.assert_array_equal(a[0].numpy(), p[0].numpy())
        np.testing.assert_allclose(p[0].numpy(), r, atol=2e-5 * scale)
        np.testing.assert_allclose(p[0].numpy(), pl,
                                   atol=1.5 * 2 ** -8 / bw2 * scale)


def _sym(rng, n):
    A = rng.normal(size=(n, 3, 3)).astype(np.float32)
    return (A + A.transpose(0, 2, 1)) / 2.0


def test_eigh3_guarded_random_matches_jax_grad():
    """Random symmetric matrices: the gradient of a loss that does not
    depend on the eigenvectors' signs, end to end through both
    decompositions, within 1e-4 relative (f32 eigensolvers)."""
    rng = np.random.default_rng(0)
    A = _sym(rng, 16)
    ws = rng.normal(size=(16, 3)).astype(np.float32)
    wv = rng.normal(size=(16, 3, 3)).astype(np.float32)

    def jloss(a):
        s, V = jax.vmap(JF.eigh3_guarded)(a)
        return jnp.sum(s * ws) + jnp.sum(V * V * wv)

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(A)))
    At = torch.from_numpy(A).requires_grad_()
    s, V = eigh3_guarded(At)
    (torch.sum(s * torch.from_numpy(ws))
     + torch.sum(V * V * torch.from_numpy(wv))).backward()
    np.testing.assert_allclose(At.grad.numpy(), ref,
                               atol=1e-4 * np.abs(ref).max())


def test_eigh3_guarded_degenerate_finite_and_matches_jax_vjp():
    """A zero matrix (three equal eigenvalues, an empty slot's
    covariance) and matrices with a repeated eigenvalue: the gradient is
    finite, where ``torch.linalg.eigh``'s own backward gives NaN, and it
    equals the JAX package's guarded pullback ``_eigh3_bwd`` at the same
    decomposition within 1e-6 relative."""
    rng = np.random.default_rng(1)
    Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    rep = (Q @ np.diag([2.0, 2.0, 0.5]) @ Q.T).astype(np.float32)
    A = np.stack([np.zeros((3, 3), np.float32), rep,
                  np.diag([1.0, 3.0, 3.0]).astype(np.float32)])
    gs = rng.normal(size=(3, 3)).astype(np.float32)
    gV = rng.normal(size=(3, 3, 3)).astype(np.float32)

    At = torch.from_numpy(A).requires_grad_()
    s, V = eigh3_guarded(At)
    torch.autograd.backward((s, V), (torch.from_numpy(gs),
                                     torch.from_numpy(gV)))
    assert torch.isfinite(At.grad).all()
    ref = jax.vmap(lambda s_, V_, a, b: JF._eigh3_bwd((s_, V_), (a, b))[0])(
        jnp.asarray(s.detach().numpy()), jnp.asarray(V.detach().numpy()),
        jnp.asarray(gs), jnp.asarray(gV))
    ref = np.asarray(ref)
    np.testing.assert_allclose(At.grad.numpy(), ref,
                               atol=1e-6 * np.abs(ref).max())

    Au = torch.from_numpy(A).requires_grad_()
    w, v = torch.linalg.eigh(Au)
    torch.autograd.backward((w, v), (torch.from_numpy(gs),
                                     torch.from_numpy(gV)))
    assert not torch.isfinite(Au.grad).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_backward_matches_scatter_accumulate(dtype):
    """The gradient through ``gather_neighbors`` (f32 accumulation, cast
    to the table's dtype) against ``scatter_accumulate(exact_grad=True)``
    with many repeated indices: within 1e-6 relative in f32 (sums in
    another order) and 1 bf16 rounding step in bf16."""
    rng = np.random.default_rng(2)
    B, Nn, C = 2, 16, 8
    idx = rng.integers(0, Nn, size=(B, 12, 5))
    g = rng.normal(size=(B, 12, 5, C)).astype(np.float32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    ref = scatter_accumulate(Nn, jnp.asarray(idx), jnp.asarray(g).astype(jd),
                             True)
    ref = np.asarray(ref.astype(jnp.float32))
    pts = torch.zeros((B, Nn, C), dtype=td, requires_grad=True)
    out = gather_neighbors(pts, torch.from_numpy(idx))
    (grad,) = torch.autograd.grad(out, pts, torch.from_numpy(g).to(td))
    assert grad.dtype == td
    rtol = 1e-6 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(grad.float().numpy(), ref, rtol=rtol,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["Adam", "SGD"])
def test_optimizer_matches_optax(name):
    """Three updates at changing learning rates from the same parameters
    and gradients, against the JAX package's optax chain and
    ``-lr * update``, within 1e-6 (f32 update arithmetic in another
    order).  The third parameter gets no gradient in the port (the loss
    does not reach it) and a zero one in JAX: Adam's coupled weight decay
    moves it the same on both sides."""
    rng = np.random.default_rng(3)
    shapes = [(4, 3), (5,), (2, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    lrs = [1e-3, 5e-4, 2e-3]
    tx = j_make_optimizer(name, 1e-4)
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    for gs, lr in zip(grads, lrs):
        gs = [jnp.asarray(g) for g in gs[:2]] + [jnp.zeros(shapes[2])]
        upd, opt_state = tx.update(gs, opt_state, jp)
        jp = optax.apply_updates(jp, jax.tree_util.tree_map(
            lambda u: -lr * u, upd))

    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    state = TrainState(model=None, optimizer=make_optimizer(tp, name))
    for gs, lr in zip(grads, lrs):
        for p, g in zip(tp[:2], gs):
            p.grad = torch.from_numpy(g)
        tp[2].grad = None
        _apply_gradients(state, lr)
    assert state.step == 3
    for p, r in zip(tp, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(r),
                                   atol=1e-6)
    moved = not np.array_equal(tp[2].detach().numpy(), params[2])
    assert moved == (name == "Adam")


def test_schedules_match():
    for epoch in range(101):
        assert S.lr_schedule(epoch, 0.001) == JS.lr_schedule(epoch, 0.001)
        assert S.lr_schedule(epoch, 0.01, 0.7, 7, 1e-4) == \
            JS.lr_schedule(epoch, 0.01, 0.7, 7, 1e-4)
        assert S.bn_momentum_schedule(epoch) == JS.bn_momentum_schedule(epoch)
        assert S.bn_momentum_schedule(epoch, 5, 0.02) == \
            JS.bn_momentum_schedule(epoch, 5, 0.02)
        for anneal in (False, True):
            assert S.lambda_schedule(epoch, 0.8, anneal) == \
                JS.lambda_schedule(epoch, 0.8, anneal)


@pytest.mark.parametrize("compute_dtype", ["mxsr", "auto", "mx"])
def test_training_in_mixed_dtypes_runs(compute_dtype):
    """A supervised step in each mixed dtype trains through the region:
    finite loss and gradients, a nonzero gradient for every parameter
    but the biases whose gradient is analytically 0 (a batch norm
    follows them) and the self-sup embedding head, which the supervised
    loss does not reach, and running statistics moved in every batch
    norm.  ``mxsr`` and
    ``auto`` draw their rounding key from the generator."""
    from test_torch_train import _zero_grad_bias   # it imports this file
    model = get_model(num_parts=50, compute_dtype=compute_dtype,
                      device="cpu")
    state = TrainState(model=model,
                       optimizer=make_optimizer(model.parameters()))
    before = {n: b.clone() for n, b in model.named_buffers()
              if n.endswith(("running_mean", "running_var"))}
    rng = np.random.default_rng(4)
    pts = torch.from_numpy(rng.normal(size=(1, 512, 3)).astype(np.float32))
    cls = torch.zeros((1, 16))
    step = make_supervised_step(get_loss)
    _, metrics = step(state, pts, cls,
                      torch.zeros((1, 512), dtype=torch.long), 1e-3, 0.1,
                      torch.Generator().manual_seed(0))
    assert torch.isfinite(metrics["loss"])
    for name, p in model.named_parameters():
        assert torch.isfinite(p.grad).all(), name
        if not (_zero_grad_bias(name) or name.startswith("extra_conv_emb")):
            assert bool(p.grad.any()), name
    for name, b in before.items():
        assert not torch.equal(model.get_buffer(name), b), name


def test_fused_augment_raises():
    with pytest.raises(NotImplementedError, match="augment"):
        make_supervised_step(get_loss, fused_augment=True)
    with pytest.raises(NotImplementedError, match="augment"):
        make_selfsup_step(fused_augment=True)


def _structured(seed, B, N, D=128, k=3, noise=0.2):
    """``k`` clusters per shape around orthogonal directions (magnitude
    4), shuffled over the points."""
    rng = np.random.default_rng(seed)
    eye = np.eye(D, dtype=np.float32) * 4.0
    X = np.empty((B, N, D), np.float32)
    for b in range(B):
        lab = rng.permutation(np.arange(N) % k)
        X[b] = eye[rng.permutation(D)[:k]][lab] + rng.normal(
            size=(N, D)) * noise
    return X


# one mean-shift step: after two, each cluster's modes agree to f32
# rounding, and which of them becomes its center is a rounding tie
STRUCT_KW = dict(quantile=0.05, iterations=1, max_num_clusters=6,
                 n_per_prim=32, num_bandwidth_candidates=2)


def _center_ids(cluster_fn, nms_fn, Xn, bw, iters, K):
    return [np.asarray(nms_fn(cluster_fn(x, b, iters), b, K)[0])
            for x, b in zip(Xn, bw)]


def test_convex_loss_grad_structured_matches_jax(monkeypatch):
    """The convex loss on embeddings with 3 clusters per shape: both
    sides choose the same center ids (after 1 mean-shift step the modes
    are still apart by far more than rounding, so the choice is the
    lowest index of each cluster, not a rounding tie); then, with the
    eigenvector signs aligned, the loss within 1e-5 relative and dLoss/dX
    within 1e-3 of its largest entry (f32 clustering, eigh and chamfer
    through another sum order)."""
    B, N = 2, 256
    X = _structured(5, B, N)
    rng = np.random.default_rng(6)
    pts = rng.normal(size=(B, N, 3)).astype(np.float32)
    kw = STRUCT_KW
    jkw = dict(quantile=kw["quantile"], iterations=kw["iterations"],
               max_num_clusters=kw["max_num_clusters"],
               n_per_prim=kw["n_per_prim"],
               num_bandwidth_candidates=kw["num_bandwidth_candidates"])

    def jloss(x):
        out = j_convex_loss(jnp.asarray(pts), jnp.asarray(pts), x, **jkw)
        return out.total, out

    (jl, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(X))
    align_eigh_signs(monkeypatch, jax_eigh)
    Xt = torch.from_numpy(X).requires_grad_()
    out = convex_loss(torch.from_numpy(pts), torch.from_numpy(pts), Xt,
                      **jkw)
    out.total.backward()

    assert out.clusters.num_clusters.tolist() == [3, 3]
    np.testing.assert_array_equal(out.clusters.num_clusters.numpy(),
                                  np.asarray(jout.clusters.num_clusters))
    Xn = X / np.linalg.norm(X, axis=-1, keepdims=True)
    bw = out.clusters.bandwidth.numpy()
    jids = _center_ids(J.mean_shift_iterations, J.nms_fixed_slots,
                       jnp.asarray(Xn), jnp.asarray(bw), kw["iterations"],
                       kw["max_num_clusters"])
    with torch.no_grad():
        modes = T.mean_shift_iterations(torch.from_numpy(Xn),
                                        out.clusters.bandwidth,
                                        kw["iterations"])
        tids = T.nms_fixed_slots(modes, out.clusters.bandwidth,
                                 kw["max_num_clusters"])[0]
    np.testing.assert_array_equal(tids.numpy(), np.stack(jids))
    np.testing.assert_allclose(out.total.item(), float(jl), rtol=1e-5)
    ref = np.asarray(jg)
    np.testing.assert_allclose(Xt.grad.numpy(), ref,
                               atol=1e-3 * np.abs(ref).max())


def test_backward_wrapper_never_falls_back():
    """A tensor that is neither on the CPU nor on a CUDA device is refused
    by the backward wrapper before any launch."""
    X = torch.empty(2, 256, 128, device="meta")
    s = torch.empty(2, 256, device="meta")
    bw = torch.empty(2, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        KM.mean_shift_step_bwd(X, X, bw, X, s, X)


def test_train_flagship_needs_a_device_unless_cpu_asked(monkeypatch):
    import prifit_torch.entry as entry
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.train_flagship(1, 512)
    state, points, cls, target = entry.train_flagship(1, 512, device="cpu")
    assert state.model.training and state.step == 0
    assert isinstance(state.optimizer, torch.optim.Adam)
    assert state.optimizer.defaults["weight_decay"] == 1e-4
    assert points.shape == (1, 512, 3) and cls.shape == (1, 16)
    assert target.shape == (1, 512) and int(target.max()) < 50
    # the default encoder dtype ("auto" = mxsr) in every stage; the f32
    # encoder on request
    stages = ("sa1", "sa2", "sa3", "fp3", "fp2", "fp1")
    assert all(getattr(state.model, s).dtype == "mxsr" for s in stages)
    state, *_ = entry.train_flagship(1, 512, device="cpu",
                                     compute_dtype="f32")
    assert all(getattr(state.model, s).dtype is None for s in stages)
