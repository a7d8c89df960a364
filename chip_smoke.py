"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
It builds every hand-written kernel from ``prifit_torch/kernels/csrc``,
holds each against its plain PyTorch version at the shapes the main paths
give it (and times both, with a one-call PyTorch yardstick where one
exists), and drives the port's two main paths through
``prifit_torch.entry``, each with the launch counts set to 0 just before
it and read just after:

  - the flagship eval forward with primitive fit at B=24, N=2048;
  - the two train steps at B=24, N=2048 with the f32 encoder: a warm-up
    and three timed supervised steps, then the same for the self-sup step.

It checks that every kernel was launched by the paths that run it.  Then
it compares, card against CPU: a B=2 eval forward; ``cluster_batch`` at
the main path's shapes on structured embeddings (several clusters per
shape; the per-shape retry on some); one B=2 supervised step (loss and
every gradient); one B=2 self-sup step (losses); and the gradient of the
convex loss in the embeddings on structured embeddings.  It prints:

  - the card's name and power limit (nvidia-smi);
  - the paths' times, peak memory and launch counts;
  - one JSON line ``{"kernels": [...]}`` with, per kernel, its launches on
    the main paths, its error against the plain version, and the times of
    the calls one forward or one self-sup step makes (kernel, plain
    version, library call) beside the least time the card could take for
    that work;
  - as the last line, ``{"ok": true, "device": {...}}``.

Any failed phase raises, so the script exits non-zero without that line.
Without a CUDA device it exits non-zero before doing anything.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# H100 SXM peaks (NVIDIA data sheet, 700 W): f32 outside the tensor cores
# and HBM3 bandwidth; the bounds below are computed against these.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

B, N = 24, 2048


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps=10, warmup=2):
    """Mean milliseconds of ``fn()`` over ``reps`` calls, by CUDA events
    after ``warmup`` calls (inputs stay in L2 where they fit)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes, nops):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = nops / PEAK_F32_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def unit_rows(gen, shape, n_dirs=12, noise=0.35):
    """Embedding-like unit rows: a few directions per shape plus noise."""
    Bq, Nq, D = shape
    dirs = torch.randn((Bq, n_dirs, D), generator=gen)
    pick = torch.randint(0, n_dirs, (Bq, Nq), generator=gen)
    X = torch.gather(dirs, 1, pick[..., None].expand(-1, -1, D))
    X = X + noise * torch.randn(shape, generator=gen)
    return (X / X.norm(dim=-1, keepdim=True)).cuda()


def check_fps():
    from prifit_torch.kernels import fps
    gen = torch.Generator().manual_seed(1)
    xyz1 = torch.randn((B, N, 3), generator=gen).cuda()
    xyz2 = torch.randn((B, 512, 3), generator=gen).cuda()
    start = torch.zeros(B, dtype=torch.int64, device="cuda")
    calls = [(xyz1, 512), (xyz2, 128)]
    err = 0
    for x, npoint in calls:
        got = fps.farthest_point_sample(x, npoint, start)
        ref = fps.fps_plain(x, npoint, start)
        if not torch.equal(got, ref):
            raise AssertionError(f"fps differs from its plain version at "
                                 f"{tuple(x.shape)} -> {npoint}: "
                                 f"{int((got != ref).sum())} indices")
    ms = cuda_ms(lambda: [fps.farthest_point_sample(x, k, start)
                          for x, k in calls])
    plain_ms = cuda_ms(lambda: [fps.fps_plain(x, k, start)
                                for x, k in calls], reps=2, warmup=1)
    # per step and point: 3 sub, 3 mul, 2 add, 1 min
    ops = sum(9 * x.shape[0] * x.shape[1] * k for x, k in calls)
    byt = sum(nbytes(x, start) + x.shape[0] * k * 4 for x, k in calls)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=None, bound=bound_ms(byt, ops))


def check_gather():
    from prifit_torch.kernels import gather
    gen = torch.Generator().manual_seed(2)
    xyz = torch.randn((B, N, 3), generator=gen).cuda()
    pre2 = torch.randn((B, 512, 128), generator=gen).cuda()
    f2 = torch.randn((B, 128, 256), generator=gen).cuda().bfloat16()
    f1 = torch.randn((B, 512, 128), generator=gen).cuda().bfloat16()

    def idx(n, *shape):
        return torch.randint(0, n, (B,) + shape, generator=gen).cuda()

    # the ten gathers of one forward (sa1: xyz and points per scale; sa2:
    # the projected features per scale; fp2 and fp1: 3-NN features)
    calls = [(xyz, idx(N, 512, k)) for k in (32, 32, 64, 64, 128, 128)]
    calls += [(pre2, idx(512, 128, 64)), (pre2, idx(512, 128, 128)),
              (f2, idx(128, 512, 3)), (f1, idx(512, N, 3))]
    for t, i in calls:
        got = gather.gather_rows(t, i)
        ref = gather.gather_plain(t, i)
        if not torch.equal(got.view(torch.uint8), ref.view(torch.uint8)):
            raise AssertionError(f"gather differs at {tuple(t.shape)} / "
                                 f"{tuple(i.shape)}")
    lib_idx = [(t, i.reshape(B, -1, 1).expand(-1, -1, t.shape[-1]))
               for t, i in calls]
    # per call: table read once, int32 indices read once, output written
    # once
    call_bytes = [nbytes(t) + i.numel() * 4 + i.numel() * t.shape[-1]
                  * t.element_size() for t, i in calls]
    for (t, i), (_, li), byt in zip(calls, lib_idx, call_bytes):
        log(f"  gather {tuple(t.shape)} {t.dtype} by {tuple(i.shape)}: "
            f"{byt / 1e6:.2f} MB, bound_ms {bound_ms(byt, 0)[0]:.4f}, "
            f"kernel_ms {cuda_ms(lambda: gather.gather_rows(t, i)):.4f}, "
            f"library_ms {cuda_ms(lambda: torch.gather(t, 1, li)):.4f}")
    ms = cuda_ms(lambda: [gather.gather_rows(t, i) for t, i in calls])
    plain_ms = cuda_ms(lambda: [gather.gather_plain(t, i)
                                for t, i in calls])
    library_ms = cuda_ms(lambda: [torch.gather(t, 1, i) for t, i in lib_idx])
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound=bound_ms(sum(call_bytes), 0))


def check_bandwidth(X):
    from prifit_torch.kernels import bandwidth
    ks = [int(0.05 * N)]
    got = bandwidth.kth_nn_distance(X, ks)
    ref = bandwidth.kth_nn_plain(X, ks)
    err = (got - ref).abs().max().item()
    # f32 dots summed in another order than cuBLAS, against the bisection
    # grid of 4 / 2^24
    if not err <= 1e-5:
        raise AssertionError(f"bandwidth max abs err {err} > 1e-5")
    ms = cuda_ms(lambda: bandwidth.kth_nn_distance(X, ks))
    plain_ms = cuda_ms(lambda: bandwidth.kth_nn_plain(X, ks), reps=3)
    # yardstick: exact k-th value of cdist^2 (a sort, not the bisection)
    library_ms = cuda_ms(lambda: torch.kthvalue(
        torch.cdist(X, X) ** 2, ks[0], dim=-1), reps=3)
    ops = 2 * B * N * N * 128 + 24 * len(ks) * B * N * N
    byt = nbytes(X) + B * len(ks) * N * 4
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound=bound_ms(byt, ops)), ref


def check_mean_shift(X, bw):
    from prifit_torch.kernels import mean_shift
    bw2 = (bw ** 2).contiguous()
    m, s = mean_shift.mean_shift_step(X, X, bw2)
    mr, sr = mean_shift.mean_shift_step_plain(X, X, bw2)
    err = (m - mr).abs().max().item()
    serr = ((s - sr).abs() / sr).max().item()
    # f32 sums over 2048 columns in another order; the exponent rounded
    # differently ((sim - 1) / b^2 vs -(2 - 2 sim) / b^2 / 2)
    if not (err <= 1e-4 and serr <= 1e-4):
        raise AssertionError(f"mean_shift max abs err {err}, s rel err "
                             f"{serr}")
    steps = 10
    ms = cuda_ms(lambda: [mean_shift.mean_shift_step(X, X, bw2)
                          for _ in range(steps)], reps=3)
    plain_ms = cuda_ms(lambda: [mean_shift.mean_shift_step_plain(X, X, bw2)
                                for _ in range(steps)], reps=3)
    # yardstick: attention with the same kernel up to the -13 clip
    q4 = (X / bw2[:, None, None])[:, None]
    x4 = X[:, None]
    library_ms = cuda_ms(lambda: [
        torch.nn.functional.scaled_dot_product_attention(q4, x4, x4,
                                                         scale=1.0)
        for _ in range(steps)], reps=3)
    ops = steps * 4 * B * N * N * 128
    byt = steps * (2 * nbytes(X) + nbytes(bw2) + nbytes(m) + nbytes(s))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound=bound_ms(byt, ops))


def check_mean_shift_bwd(X, bw):
    """The backward kernel against its plain version for a dense random
    cotangent, at the path's bandwidth and at one 50 times smaller (most
    exponents clamp at -13 there: the gradient cutoff), within 1e-4 of the
    largest gradient entry: f32 sums over 2048 rows in another order, and
    the exponent rounded differently.  Times the 10 launches of one
    self-sup step; the yardstick is the backward of f32 attention on the
    same inputs."""
    from prifit_torch.kernels import mean_shift
    bw2 = (bw ** 2).contiguous()
    g = torch.randn((B, N, 128), generator=torch.Generator().manual_seed(6)
                    ).cuda()
    err = None
    for shrink in (1.0, 0.02):
        b2 = (bw2 * shrink).contiguous()
        m, s = mean_shift.mean_shift_step_fwd(X, X, b2)
        got = mean_shift.mean_shift_step_bwd(X, X, b2, m, s, g)
        ref = mean_shift.mean_shift_step_bwd_plain(X, X, b2, m, s, g)
        top = max(r.abs().max().item() for r in ref)
        e = max((a - r).abs().max().item() for a, r in zip(got, ref))
        if not e <= 1e-4 * top:
            raise AssertionError(f"mean_shift_bwd max abs err {e} at "
                                 f"bw2 x {shrink} (largest entry {top})")
        err = e if err is None else err
    m, s = mean_shift.mean_shift_step_fwd(X, X, bw2)
    steps = 10
    ms = cuda_ms(lambda: [mean_shift.mean_shift_step_bwd(X, X, bw2, m, s, g)
                          for _ in range(steps)], reps=3)
    plain_ms = cuda_ms(lambda: [
        mean_shift.mean_shift_step_bwd_plain(X, X, bw2, m, s, g)
        for _ in range(steps)], reps=2, warmup=1)
    q4 = (X / bw2[:, None, None])[:, None].requires_grad_()
    k4 = X[:, None].clone().requires_grad_()
    v4 = X[:, None].clone().requires_grad_()
    out = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4,
                                                           scale=1.0)
    library_ms = cuda_ms(lambda: [
        torch.autograd.grad(out, (q4, k4, v4), g[:, None], retain_graph=True)
        for _ in range(steps)], reps=3)
    # 10 n^2 D flops a shape and launch: the two forward products and the
    # three backward ones
    ops = steps * 10 * B * N * N * 128
    byt = steps * (4 * nbytes(X) + nbytes(bw2) + nbytes(s) + 2 * nbytes(X))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound=bound_ms(byt, ops))


def check_nms():
    from prifit_torch.kernels import nms
    gen = torch.Generator().manual_seed(4)
    anchors = torch.randn((B, 20, 128), generator=gen)
    anchors = anchors / anchors.norm(dim=-1, keepdim=True)
    pick = torch.randint(0, 20, (B, N), generator=gen)
    modes = torch.gather(anchors, 1, pick[..., None].expand(-1, -1, 128))
    modes = modes.cuda().contiguous()
    bw = torch.full((B,), 0.35, device="cuda")
    got = nms.nms_passes(modes, bw)
    ref = nms.nms_passes_plain(modes, bw)
    for name, g, r in zip(("counts", "is_center", "used"), got, ref):
        if not torch.equal(g, r):
            raise AssertionError(f"nms {name} differs from its plain "
                                 f"version")
    ms = cuda_ms(lambda: nms.nms_passes(modes, bw))
    plain_ms = cuda_ms(lambda: nms.nms_passes_plain(modes, bw), reps=3)
    # what this data needs: every distance for the nearest-mode counts,
    # the distance rows of the occupied modes for the representatives,
    # and every mode's distances to the centers for the used flags
    counts, is_center, _ = ref
    pairs = (B * N + int((counts > 0).sum()) + int(is_center.sum())) * N
    ops = 2 * pairs * 128
    byt = nbytes(modes, bw) + 3 * B * N * 4
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                library_ms=None, bound=bound_ms(byt, ops))


def main_path(entry, kernels):
    """The flagship eval forward with fit at B=24, N=2048: one warm-up
    forward, then three with the launch counts reset just before."""
    model, points, cls = entry.flagship(B, N)
    out = entry.eval_forward(model, points, cls, **entry.BENCH_KWARGS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = entry.eval_forward(model, points, cls, **entry.BENCH_KWARGS)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = kernels.launch_counts()
    if out.seg_logits.shape != (B, N, 50):
        raise AssertionError(f"seg logits shape {out.seg_logits.shape}")
    for name, t in (("seg_logits", out.seg_logits), ("feat", out.feat),
                    ("total_loss", out.total_loss),
                    ("samples", out.convex.samples)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name} is not finite")
    nc = out.convex.clusters.num_clusters
    if not bool(((nc >= 1) & (nc <= 25)).all()):
        raise AssertionError(f"num_clusters out of range: {nc.tolist()}")
    # the mean-shift backward runs only in training (train_path)
    missing = [k for k, v in counts.items()
               if v == 0 and k != "mean_shift_bwd"]
    if missing:
        raise AssertionError(f"kernels never launched on the eval path: "
                             f"{missing}")
    if counts["mean_shift_bwd"]:
        raise AssertionError("the eval forward launched the backward")
    return counts, times, out


def _check_step(state, before, metrics, what):
    """A train step left finite metrics and gradients, and moved every
    parameter that has a gradient or a value for Adam's decay to act on."""
    for k, v in metrics.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{what}: {k} is not finite")
    for name, p in state.model.named_parameters():
        if not bool(torch.isfinite(p.grad).all()):
            raise AssertionError(f"{what}: gradient of {name} not finite")
        should = bool(p.grad.any()) or bool(before[name].any())
        if should and torch.equal(p.detach(), before[name]):
            raise AssertionError(f"{what}: {name} did not move")


def train_path(entry, kernels):
    """The two train steps at B=24, N=2048 with the f32 encoder
    (``entry.train_flagship``, ``bench.py``'s settings): for each, one
    warm-up step, then three timed ones with the launch counts reset just
    before.  Returns per step kind its times, launch counts, peak memory
    and last metrics."""
    from prifit_torch.models.pointnet2_part_seg_msg import get_loss
    from prifit_torch.train.steps import make_selfsup_step, \
        make_supervised_step
    state, points, cls, target = entry.train_flagship(B, N)
    ts = entry.TRAIN_SETTINGS
    gen = torch.Generator(device="cuda").manual_seed(0)
    sup = make_supervised_step(get_loss)
    ss = make_selfsup_step(**entry.BENCH_KWARGS)
    runs = {
        "supervised": lambda: sup(state, points, cls, target, ts["lr"],
                                  ts["bn_momentum"], gen),
        "selfsup": lambda: ss(state, points, cls, points, ts["lr"],
                              ts["bn_momentum"], ts["lmbda"], gen),
    }
    out = {}
    for name, run in runs.items():
        run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        times = []
        for _ in range(3):
            before = {n: p.detach().clone()
                      for n, p in state.model.named_parameters()}
            t0 = time.perf_counter()
            _, metrics = run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            _check_step(state, before, metrics, name)
        out[name] = dict(times=times, counts=kernels.launch_counts(),
                         peak=torch.cuda.max_memory_allocated(),
                         metrics={k: v.item() for k, v in metrics.items()})
    sc, ssc = out["supervised"]["counts"], out["selfsup"]["counts"]
    for k in ("fps", "gather"):
        if not (sc[k] > 0 and ssc[k] > 0):
            raise AssertionError(f"{k} not launched in both steps: {sc} "
                                 f"{ssc}")
    missing = [k for k, v in ssc.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched by the self-sup "
                             f"step: {missing}")
    fwd, bwd = ssc["mean_shift"], ssc["mean_shift_bwd"]
    if not (bwd == fwd and fwd >= 30 and fwd % 10 == 0):
        raise AssertionError(f"mean_shift_bwd launched {bwd} times for "
                             f"{fwd} forward steps in 3 self-sup steps")
    out["g_rows"] = g_row_share(entry, state, points, cls, gen)
    return out


def g_row_share(entry, state, points, cls, gen):
    """One more self-sup forward and backward (not counted), with a hook
    on every mean-shift step's backward node: per launch, the largest
    number of rows of the cotangent g in one shape that are not zero.
    Centers are gathered from the modes, so at most 25 of 2048 should be.
    Returns (largest count, mean share of nonzero rows)."""
    model = state.model.train()
    out = model(points, cls, chamfer_points=points, generator=gen,
                include_convex_loss=True, **entry.BENCH_KWARGS)
    rows = []

    def hook(grad_outputs):
        nz = grad_outputs[0].abs().amax(-1) > 0                 # [B, N]
        rows.append((int(nz.sum(-1).max()), nz.float().mean().item()))

    seen, stack = set(), [out.total_loss.grad_fn]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if type(node).__name__ == "MeanShiftStepBackward":
            node.register_prehook(hook)
        stack.extend(fn for fn, _ in node.next_functions)
    out.total_loss.backward()
    state.optimizer.zero_grad(set_to_none=True)
    if len(rows) < 10:
        raise AssertionError(f"hooked {len(rows)} mean-shift backwards")
    return max(r[0] for r in rows), sum(r[1] for r in rows) / len(rows)


class eigh_signs_from_card:
    """While active, ``torch.linalg.eigh`` on a CPU tensor returns each
    eigenvector with the sign the card's solver gives for the same
    matrix.  An eigenvector's sign is whatever the solver picks; the fit
    samples a primitive along its axes, so a flipped column mirrors the
    sample lattice and moves the chamfer by ~1e-3.  Aligning it lets the
    card and the CPU be compared on everything else."""

    def __enter__(self):
        self.orig = orig = torch.linalg.eigh

        def eigh(A):
            w, v = orig(A)
            if A.device.type != "cpu":
                return w, v
            ref = orig(A.cuda())[1].cpu()
            dots = torch.sum(v * ref, dim=-2)
            return w, v * torch.where(dots < 0, -1.0, 1.0)[..., None, :]

        torch.linalg.eigh = eigh
        return self

    def __exit__(self, *exc):
        torch.linalg.eigh = self.orig


# biases whose gradient is analytically zero, so rounding noise on both
# sides: the dense biases a batch norm follows, and sa3's last batch-norm
# bias, whose shift fp3's first batch norm removes
def _zero_grad_bias(name):
    return name.endswith(".bias") and (
        ".conv_blocks." in name or ".mlp_convs." in name
        or name in ("conv1.bias", "sa3.mlp_bns.2.bias"))


def _worst_grad_err(grads, ref, what):
    """The largest ``|g - g_ref| / |g_ref|`` over the parameters, the
    zero-gradient biases aside; a parameter with a zero reference
    gradient must have a zero gradient."""
    worst = 0.0
    for name, r in ref.items():
        if _zero_grad_bias(name):
            continue
        if not bool(r.any()):
            if bool(grads[name].any()):
                raise AssertionError(f"{what}: {name} has a gradient where "
                                     f"the reference has none")
            continue
        worst = max(worst, float((grads[name] - r).norm() / r.norm()))
    return worst


def train_card_vs_cpu(entry):
    """One B=2 supervised step and one B=2 self-sup step on the card and
    on the CPU from the same seeded weights, dropout off and FPS from
    index 0, plus the supervised step on the CPU in float64.

    Supervised: loss within 1e-5 relative; every gradient within 5e-2 of
    the CPU gradient's norm, and each side's within 5e-2 of the float64
    step's, the zero-gradient biases aside.  The limit is f32 rounding,
    not the kernels: every batch norm's backward subtracts the mean of its
    cotangent, a sum of many terms that nearly cancel, and each layer
    below inherits the error of that sum; on the CPU the JAX package's own
    f32 gradients are up to 1.8e-2 off a float64 run
    (tests/test_torch_train.py).  A real defect is O(1).

    Self-sup: ss_loss and chamfer within 1e-4 relative, with the
    eigenvector signs aligned.  Its encoder gradients are not compared:
    with random weights each shape has 1 cluster, its membership is 1
    everywhere, and the loss does not depend on the embedding, so they are
    rounding noise (``convex_grad_card_vs_cpu`` compares the convex
    loss's gradient where it is not)."""
    from prifit_torch.models.pointnet2_part_seg_msg import get_loss
    from prifit_torch.train.steps import make_selfsup_step, \
        make_supervised_step
    ts = entry.TRAIN_SETTINGS
    kw = dict(entry.BENCH_KWARGS)
    res = {}
    for dev in ("cuda", "cpu", "cpu64"):
        state, points, cls, target = entry.train_flagship(
            2, N, device="cuda" if dev == "cuda" else "cpu")
        state.model.dropout_rate = 0.0
        if dev == "cpu64":
            state.model.double()
            points, cls = points.double(), cls.double()
        _, sm = make_supervised_step(get_loss)(
            state, points, cls, target, ts["lr"], ts["bn_momentum"])
        grads = {n: p.grad.float().cpu()
                 for n, p in state.model.named_parameters()}
        if dev == "cpu64":
            res[dev] = (sm["loss"].item(), grads)
            continue
        with eigh_signs_from_card():
            _, ssm = make_selfsup_step(**kw)(
                state, points, cls, points, ts["lr"], ts["bn_momentum"],
                ts["lmbda"])
        res[dev] = (sm["loss"].item(), grads, ssm["ss_loss"].item(),
                    ssm["chamfer_loss"].item())
    (lg, gg, sg, cg), (lc, gc, sc, cc) = res["cuda"], res["cpu"]
    g64 = res["cpu64"][1]
    if not abs(lg - lc) <= 1e-5 * abs(lc):
        raise AssertionError(f"supervised loss card {lg} cpu {lc}")
    errs = {"card_vs_cpu": _worst_grad_err(gg, gc, "card vs cpu"),
            "card_vs_f64": _worst_grad_err(gg, g64, "card vs f64"),
            "cpu_vs_f64": _worst_grad_err(gc, g64, "cpu vs f64")}
    for what, e in errs.items():
        if not e <= 5e-2:
            raise AssertionError(f"supervised gradients {what}: largest "
                                 f"error {e} of the norm")
    for what, a, b in (("ss_loss", sg, sc), ("chamfer", cg, cc)):
        if not abs(a - b) <= 1e-4 * abs(b):
            raise AssertionError(f"self-sup {what} card {a} cpu {b}")
    return dict(loss=(lg, lc, res["cpu64"][0]), grad_err=errs,
                ss_loss=(sg, sc), chamfer=(cg, cc))


def convex_grad_card_vs_cpu():
    """dLoss/dX of the convex loss on two of ``structured_embeddings``
    (2 and 4 clusters) at N=2048, card against CPU.  One mean-shift step:
    after more, each cluster's modes agree to f32 rounding and which of
    them becomes the center is a rounding tie, so the gradient would flow
    through different rows.  The center ids are asserted equal first;
    then, with the eigenvector signs aligned, the loss within 1e-5
    relative and the gradient within 1e-3 of its largest entry (f32
    clustering, fit and chamfer in other sum orders)."""
    from prifit_torch.clustering.mean_shift import mean_shift_iterations, \
        nms_fixed_slots
    from prifit_torch.geometry.convex_loss import convex_loss
    X, expected = structured_embeddings(5)
    X, expected = X[:2], expected[:2]
    pts = torch.from_numpy(np.random.default_rng(7).normal(
        size=(2, N, 3)).astype(np.float32))
    kw = dict(quantile=0.05, iterations=1, max_num_clusters=25,
              n_per_prim=256, num_bandwidth_candidates=2)
    res = {}
    for dev in ("cuda", "cpu"):
        Xd = X.to(dev).requires_grad_()
        with eigh_signs_from_card():
            out = convex_loss(pts.to(dev), pts.to(dev), Xd, **kw)
        out.total.backward()
        with torch.no_grad():
            Xn = Xd / Xd.norm(dim=2, keepdim=True)
            bw = out.clusters.bandwidth
            modes = mean_shift_iterations(Xn, bw, kw["iterations"])
            ids = nms_fixed_slots(modes, bw, kw["max_num_clusters"])[0]
        res[dev] = (out.total.item(), Xd.grad.cpu(), ids.cpu(),
                    out.clusters.num_clusters.cpu().tolist())
    (lg, gg, ig, ng), (lc, gc, ic, nc) = res["cuda"], res["cpu"]
    if not (ng == nc == expected):
        raise AssertionError(f"clusters card {ng} cpu {nc} expected "
                             f"{expected}")
    if not torch.equal(ig, ic):
        raise AssertionError("center ids differ card vs cpu")
    if not abs(lg - lc) <= 1e-5 * abs(lc):
        raise AssertionError(f"convex loss card {lg} cpu {lc}")
    err = (gg - gc).abs().max().item()
    if not err <= 1e-3 * gc.abs().max().item():
        raise AssertionError(f"dLoss/dX card vs cpu max abs err {err}")
    return lg, lc, err, gc.abs().max().item(), nc


def card_vs_cpu(entry):
    """The same B=2 forward on the card and on the CPU (plain versions):
    logits within 0.05 (bf16 encoder chains rounded by different matmul
    kernels), equal cluster counts, and total loss within 1e-2 relative
    (the chamfer of primitives fitted to those bf16-rounded embeddings)."""
    outs = []
    for dev in ("cuda", "cpu"):
        model, points, cls = entry.flagship(2, N, device=dev)
        outs.append(entry.eval_forward(model, points, cls,
                                       **entry.BENCH_KWARGS))
    g, c = outs
    err = (g.seg_logits.cpu() - c.seg_logits).abs().max().item()
    if not err <= 0.05:
        raise AssertionError(f"card vs cpu logits max abs err {err}")
    if not torch.equal(g.convex.clusters.num_clusters.cpu(),
                       c.convex.clusters.num_clusters):
        raise AssertionError("card vs cpu num_clusters differ")
    lg, lc = g.total_loss.item(), c.total_loss.item()
    if not abs(lg - lc) <= 1e-2 * abs(lc):
        raise AssertionError(f"card vs cpu total_loss {lg} vs {lc}")
    return err, c.convex.clusters.num_clusters.tolist(), lg, lc


def structured_embeddings(seed):
    """``[B, N, 128]`` embeddings in clusters around orthogonal directions
    (magnitude 4, shuffled over the points), with the expected cluster
    count per shape.  Five shapes in six have 2 to 12 equal clusters
    with noise 0.15.  Every sixth has 10 tight clusters of 180 points and
    31 of 8 (noise 0.05): 41 modes at the first bandwidth, more than the
    25 slots, so the per-shape retry runs, and at the doubled bandwidth
    they merge into 1 cluster."""
    rng = np.random.default_rng(seed)
    eye = np.eye(128, dtype=np.float32) * 4.0
    X = np.empty((B, N, 128), np.float32)
    expected = []
    for b in range(B):
        if b % 6 == 5:
            sizes, noise = [180] * 10 + [8] * 31, 0.05
            expected.append(1)
        else:
            k = (2, 4, 6, 8, 12)[b % 6]
            sizes, noise = [N // k + (i < N % k) for i in range(k)], 0.15
            expected.append(k)
        lab = rng.permutation(np.repeat(np.arange(len(sizes)), sizes))
        dirs = rng.permutation(128)[:len(sizes)]
        X[b] = eye[dirs[lab]] + rng.normal(size=(N, 128)) * noise
    return torch.from_numpy(X), expected


def same_clustering(g, c, expected):
    """Card result ``g`` against CPU result ``c``: num_clusters and valid
    exactly, and equal to ``expected``; bandwidth within 1e-5 relative;
    the same partition of the points into slots, with the weights within
    1e-4 and the centers within 1e-3 once the slots are matched.  Which
    mode of a converged cluster becomes its center follows the rounding
    of the distance sums, and slots are ordered by center id, so the slot
    order may differ (it does between the JAX package and the port on the
    CPU); the partition may not.  Weights agree to ~1e-6 between the two
    on the CPU; the margin covers 10 mean-shift steps summed in other
    orders.  Returns (weights err, centers err)."""
    for name in ("num_clusters", "valid"):
        if not torch.equal(getattr(g, name), getattr(c, name)):
            raise AssertionError(f"cluster_batch {name} differ card vs cpu")
    if c.num_clusters.tolist() != expected:
        raise AssertionError(f"cluster_batch num_clusters "
                             f"{c.num_clusters.tolist()}, expected "
                             f"{expected}")
    if not torch.allclose(g.bandwidth, c.bandwidth, rtol=1e-5, atol=0):
        raise AssertionError("cluster_batch bandwidth differs card vs cpu")
    w_err = c_err = 0.0
    for b in range(B):
        lg, lc = g.labels[b], c.labels[b]
        slots = torch.unique(lg)
        perm = []
        for k in slots:
            targets = torch.unique(lc[lg == k])
            if len(targets) != 1:
                raise AssertionError(f"shape {b}: a card slot spans CPU "
                                     f"slots {targets.tolist()}")
            perm.append(int(targets[0]))
        perm = torch.tensor(perm)
        if len(set(perm.tolist())) != len(slots) or not torch.equal(
                perm[torch.searchsorted(slots, lg)], lc):
            raise AssertionError(f"shape {b}: partitions differ")
        w_err = max(w_err, (g.weights[b][:, slots] - c.weights[b][:, perm])
                    .abs().max().item())
        c_err = max(c_err, (g.centers[b][slots] - c.centers[b][perm])
                    .abs().max().item())
    if not (w_err <= 1e-4 and c_err <= 1e-3):
        raise AssertionError(f"cluster_batch weights err {w_err}, centers "
                             f"err {c_err}")
    return w_err, c_err


def clusters_card_vs_cpu(entry):
    """``cluster_batch`` at the main path's shapes and settings on
    structured embeddings, on the card (the three clustering kernels,
    multi-cluster NMS and the retry) and on the CPU (plain versions)."""
    from prifit_torch.clustering.mean_shift import cluster_batch
    kw = entry.BENCH_KWARGS
    X, expected = structured_embeddings(5)
    g, c = (cluster_batch(X.to(dev), quantile=kw["quantile"],
                          iterations=kw["msc_iterations"],
                          max_num_clusters=kw["max_num_clusters"],
                          num_candidates=kw["num_bandwidth_candidates"])
            for dev in ("cuda", "cpu"))
    g = type(g)(*(t.cpu() for t in g))
    return same_clustering(g, c, expected), expected


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    import prifit_torch.entry as entry
    from prifit_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    build_s = kernels.build_all()
    log(f"kernels built in {build_s:.1f} s")

    results = {}
    results["fps"] = check_fps()
    results["gather"] = check_gather()
    X = unit_rows(torch.Generator().manual_seed(3), (B, N, 128))
    results["bandwidth"], kth = check_bandwidth(X)
    bw = torch.sqrt(torch.clamp_min(kth[:, 0], 1e-6)).mean(-1)
    results["mean_shift"] = check_mean_shift(X, bw)
    results["mean_shift_bwd"] = check_mean_shift_bwd(X, bw)
    results["nms"] = check_nms()
    for name, r in results.items():
        calls = "one self-sup step" if name == "mean_shift_bwd" else \
            "one forward"
        log(f"{name}: max_abs_err {r['max_abs_err']:.3g} kernel_ms "
            f"{r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms "
            f"{r['library_ms']} bound_ms {r['bound'][0]:.4f} "
            f"({r['bound'][1]}) [calls of {calls}, {smi}]")

    counts, times, out = main_path(entry, kernels)
    t = sorted(times)[1]
    log(f"main path B={B} N={N}: forward {t * 1e3:.1f} ms (median of 3), "
        f"{B / t:.1f} clouds/s [{smi}]; launches in 3 forwards {counts}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"num_clusters "
        f"{out.convex.clusters.num_clusters.tolist()}; total_loss "
        f"{out.total_loss.item():.6f}")

    err, nc, lg, lc = card_vs_cpu(entry)
    log(f"card vs cpu B=2: logits max abs err {err:.3g}, num_clusters "
        f"{nc}, total_loss {lg:.6f} (card) {lc:.6f} (cpu)")
    (w_err, c_err), nc = clusters_card_vs_cpu(entry)
    log(f"card vs cpu cluster_batch B={B} N={N} D=128, structured: "
        f"num_clusters {nc} equal, same partitions, weights err "
        f"{w_err:.3g}, centers err {c_err:.3g}")

    train = train_path(entry, kernels)
    for name in ("supervised", "selfsup"):
        r = train[name]
        t = sorted(r["times"])[1]
        log(f"train path B={B} N={N} f32, {name} step: {t * 1e3:.1f} ms "
            f"(median of 3; {', '.join(f'{x * 1e3:.1f}' for x in r['times'])}"
            f"), {B / t:.1f} clouds/s [{smi}]; peak memory "
            f"{r['peak'] / 2**30:.2f} GiB; launches in 3 steps "
            f"{r['counts']}; last metrics {r['metrics']}")
    top, share = train["g_rows"]
    log(f"mean-shift backward cotangent g on the self-sup path: at most "
        f"{top} of {N} rows nonzero in a shape, {100 * share:.3f}% of rows "
        f"on average over its launches")
    tc = train_card_vs_cpu(entry)
    log(f"card vs cpu train B=2: supervised loss {tc['loss'][0]:.7f} (card)"
        f" {tc['loss'][1]:.7f} (cpu) {tc['loss'][2]:.7f} (cpu f64), largest "
        f"gradient error of the norm "
        f"{ {k: round(v, 6) for k, v in tc['grad_err'].items()} }; "
        f"self-sup ss_loss "
        f"{tc['ss_loss'][0]:.7f} / {tc['ss_loss'][1]:.7f}, chamfer "
        f"{tc['chamfer'][0]:.7f} / {tc['chamfer'][1]:.7f}")
    lg, lc, err, top, nc = convex_grad_card_vs_cpu()
    log(f"card vs cpu convex loss gradient, structured B=2 N={N}: "
        f"num_clusters {nc}, same center ids, loss {lg:.7f} / {lc:.7f}, "
        f"dLoss/dX max abs err {err:.3g} (largest entry {top:.3g})")

    paths = {"eval_forward": counts,
             "supervised_step": train["supervised"]["counts"],
             "selfsup_step": train["selfsup"]["counts"]}
    rows = []
    for name, k in kernels.KERNELS.items():
        r = results[name]
        rows.append(dict(
            name=name, route="cuda", source=k.source_path,
            replaces=k.replaces,
            launches=sum(c[name] for c in paths.values()),
            launches_by_path={p: c[name] for p, c in paths.items()},
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
            bound_by=r["bound"][1], library_ms=r["library_ms"]))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
