"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
It builds every hand-written kernel from ``prifit_torch/kernels/csrc``,
holds each against its plain PyTorch version at the shapes the main paths
give it (and times both, with a one-call PyTorch yardstick where one
exists): FPS (indices and coordinates bit for bit, also at a ragged N, on
an integer lattice and at its point limit, and one launch a call),
gather (with int64 and int32 indices, and each call's
device-only time from the profiler), bandwidth (also on rows that are all
equal, and with 5 ranks), the mean-shift forward
(for q = X and for q one step from X) and backward (for a dense
cotangent, for 1 and 25 live rows a shape, against the plain version
evaluated in float64, and for a zero cotangent) and NMS (on duplicated
anchors, converged modes, distinct rows and a bandwidth below every
self-distance); the K-max backward pair
(``max_bwd_cnt_gsm``, ``max_bwd_dz``) at the six K-max regions' shapes
with stochastic rounding on and off, bit for bit; and the ``sr_bf16``
cast at the sizes one ``mxsr`` step casts, bit for bit.  It holds the
four clustering kernels at other shapes too (B=4 at N=2500 with widths 8,
13 and 128, and N=50 with width 128; bandwidth at N=8192), each against
its plain version with the same limits.  It drives the
port's main paths through ``prifit_torch.entry``, each with the launch
counts set to 0 just before it and read just after:

  - the flagship eval forward with primitive fit at B=24, N=2048;
  - the two train steps at B=24, N=2048 at the default encoder dtype
    (``"auto"`` = ``mxsr``): a warm-up and three timed supervised steps,
    then the same for the self-sup step; each step launches the K-max
    backward pair once per K-max region (6 times);
  - the same two steps with the f32 encoder;
  - the other self-sup objectives the JAX trainer selects, at the default
    dtype, a warm-up and three timed steps each: the self-sup step with
    every option of the convex loss (entropy, intersection, pruning,
    alpha 0.01), the same with cuboids, and the contrastive step on
    ACD-like labels.

  - the part-seg trainer, ``prifit_torch.cli.train_partseg.main``, at
    B=24, N=2048 with the recipe's self-sup settings and the default
    dtype, on synthetic ShapeNet-Part and ACD trees written from a seed
    (3 categories of 96 shapes of 2500 points with normals, 48 ACD shapes
    of 6000 points): one epoch of 48 iterations (a supervised step and a
    self-sup step each, with the host data pipeline) and the final eval
    over the test split (72 clouds); its resume for a second epoch of 4
    iterations (epoch, step and the self-sup ``beta`` restored); one
    8-iteration epoch each with ``--fused_augment`` and with ``--ss_loss
    contrastive``, and 48 iterations with ``--num_workers 0``.  It times each iteration against
    the bare steps' medians above, the host pipeline alone and the
    trainer's steps on its own batches, and the eval's clouds/s, and
    evaluates the trained checkpoint with
    ``prifit_torch.cli.testing`` on the card and on the CPU
    (instance-average mIoU within 1e-2, accuracy within 0.5 points).

It checks that every kernel was launched by the paths that run it, and
no other, and that every cotangent the mean-shift backward gets on the
self-sup paths (the f32 one and both with options) is live in at most 25
rows a shape.  Then it compares, card against CPU: a B=2 eval forward;
``cluster_batch`` at the main path's shapes on structured embeddings
(several clusters per shape; the per-shape retry on some) and at B=4,
N=2500 on 8-wide embeddings like the fitting demo's; one B=2 f32
supervised step (loss and every gradient); one B=2 f32 self-sup step
(losses); one B=2 ``mxsr`` supervised step with the same rounding key on
both sides (the loss, and every gradient against the CPU's own spread
under 2^-20 and 2^-19 changes of the input); the gradient of the
convex loss in the embeddings on structured embeddings, with its default
terms and with every option (for ellipsoids and for cuboids, the
intersection term nonzero); one B=2 f32 self-sup step with every option,
for ellipsoids and for cuboids (losses); and one B=2 f32 contrastive step
(the loss and every gradient), each with the same draws on both sides.
It prints:

  - the card's name and power limit (nvidia-smi);
  - the paths' times, peak memory and launch counts;
  - the trainer's ms per iteration beside the bare steps' sum, its
    launches per iteration and the eval's clouds/s;
  - one JSON line ``{"kernels": [...]}`` with, per kernel, its launches on
    the nine paths (and their sum; ``trainer`` is the whole first trainer
    run with its eval) and per trainer iteration, its error against the plain version,
    and the times of the calls one forward or one step makes (kernel,
    plain version, library call) beside the least time the card could
    take for that work; ``sr_bf16`` has no TPU kernel (``tpu_kernel``
    false); the mean-shift backward's row also has, under ``sparse``, the
    same numbers for cotangents live in 1 and in 25 rows a shape, NMS's
    under ``inputs`` its numbers on each of its four inputs, the
    gather's its device-only time (``device_ms``) and its time with int32
    indices (``int32_ms``), bandwidth's its f32 bound
    (``bound_f32_ms``) and its time on rows that are all equal
    (``equal_rows_ms``), and FPS's each call's time (``per_call_ms``),
    device-only time (``device_ms``), device microseconds a step
    (``us_per_step``) and ``(T, P)`` (``launch_shapes``);
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

# H100 SXM peaks (NVIDIA data sheet, 700 W): f32 outside the tensor cores,
# dense TF32 on the tensor cores, and HBM3 bandwidth; the bounds below are
# computed against these.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
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


def bound_ms(nbytes, nops, tf32_flops=0):
    """The least time for the work: ``nbytes`` at the memory rate against
    ``nops`` f32 operations at the f32 rate plus ``tf32_flops`` tensor-core
    flops at the TF32 rate (a 3xTF32 product counts three times).
    Returns ``(ms, "bytes" or "operations")``."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (nops / PEAK_F32_FLOPS + tf32_flops / PEAK_TF32_FLOPS) * 1e3
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
    """The two FPS calls of one forward (sa1 2048 -> 512, then sa2 on its
    centroids 512 -> 128) with random starts from a seeded CUDA
    generator, and three more inputs at B=4: a ragged N (2500), an integer
    lattice (many equal distances and duplicated points) and N at the
    kernel's limit.  Indices and coordinates bit-equal to the plain
    version; each call is one kernel launch on the device, with no cast
    and no gather around it (``torch.profiler``).  Times the two calls
    beside the plain version, and each alone by CUDA events and on the
    device alone (the profiler), per step."""
    from prifit_torch.kernels import fps
    from prifit_torch.ops.sampling import farthest_points
    gen = torch.Generator().manual_seed(1)
    cgen = torch.Generator(device="cuda").manual_seed(1)
    xyz1 = torch.randn((B, N, 3), generator=gen).cuda()
    start1 = torch.randint(0, N, (B,), generator=cgen, device="cuda")
    start2 = torch.randint(0, 512, (B,), generator=cgen, device="cuda")
    xyz2 = fps.fps_plain(xyz1, 512, start1)[1].contiguous()
    calls = [(xyz1, 512, start1), (xyz2, 128, start2)]
    lattice = torch.randint(-3, 4, (4, N, 3), generator=gen).float()
    extra = [(torch.randn((4, 2500, 3), generator=gen).cuda(), 600),
             (lattice.cuda(), N), (torch.randn(
                 (4, fps.MAX_POINTS, 3), generator=gen).cuda(), 512)]
    for x, npoint, start in calls + [
            (x, k, torch.randint(0, x.shape[1], (4,), generator=cgen,
                                 device="cuda")) for x, k in extra]:
        got = fps.farthest_point_sample(x, npoint, start)
        ref = fps.fps_plain(x, npoint, start)
        for g, r, what in zip(got, ref, ("indices", "coordinates")):
            if not torch.equal(g, r):
                raise AssertionError(
                    f"fps {what} differ from the plain version at "
                    f"{tuple(x.shape)} -> {npoint}: "
                    f"{int((g != r).sum())} entries")
        log(f"fps {tuple(x.shape)} -> {npoint}: (T, P) = "
            f"{fps.launch_shape(x.shape[1])}, indices and coordinates "
            f"bit-equal to the plain version")
    kernels_seen = [name for name, _ in device_kernels(
        lambda: farthest_points(xyz1, 512, start1))]
    if len(kernels_seen) != 1 or "fps_kernel" not in kernels_seen[0]:
        raise AssertionError(f"one SA layer's FPS ran {kernels_seen} on the "
                             f"device, not one fps kernel")
    ms = cuda_ms(lambda: [fps.farthest_point_sample(*c) for c in calls],
                 reps=20)
    per_call = [cuda_ms(lambda c=c: fps.farthest_point_sample(*c), reps=20)
                for c in calls]
    dev = device_ms(lambda: [fps.farthest_point_sample(*c) for c in calls],
                    "fps_kernel")
    plain_ms = cuda_ms(lambda: [fps.fps_plain(*c) for c in calls], reps=2,
                       warmup=1)
    for (x, k, _), t, d in zip(calls, per_call, dev):
        log(f"fps {tuple(x.shape)} -> {k}, (T, P) = "
            f"{fps.launch_shape(x.shape[1])}: {t:.4f} ms a call, device "
            f"{d:.4f} ms, {d * 1e3 / (k - 1):.3f} us a step")
    # per sweep step and point: 3 sub, 3 mul, 2 add, 1 min
    ops = sum(9 * x.shape[0] * x.shape[1] * (k - 1) for x, k, _ in calls)
    byt = sum(nbytes(x, st) + x.shape[0] * k * (8 + 12)
              for x, k, st in calls)
    return dict(max_abs_err=0, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound=bound_ms(byt, ops),
                per_call_ms=per_call, device_ms=dev,
                us_per_step=[d * 1e3 / (k - 1)
                             for d, (_, k, _) in zip(dev, calls)],
                launch_shapes=[fps.launch_shape(x.shape[1])
                               for x, _, _ in calls])


def device_kernels(fn, reps=1):
    """The device kernels that ``reps`` calls of ``fn()`` launch, in
    order, from ``torch.profiler`` after a warm-up call: ``(name,
    microseconds)`` pairs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us()) for e in sorted(
        (e for e in prof.events() if e.device_type == DeviceType.CUDA),
        key=lambda e: e.time_range.start)]


def device_ms(fn, match, reps=5):
    """Device-only milliseconds of each kernel whose name holds ``match``
    that one ``fn()`` launches, from :func:`device_kernels` over ``reps``
    calls: a list, in launch order, of the mean over the calls."""
    us = [t for name, t in device_kernels(fn, reps) if match in name]
    if not us or len(us) % reps:
        raise AssertionError(f"profiler saw {len(us)} '{match}' kernels in "
                             f"{reps} calls")
    per = len(us) // reps
    return [sum(us[i::per]) / reps / 1e3 for i in range(per)]


def check_gather():
    """The ten gathers of one forward (sa1: xyz and points per scale;
    sa2: the projected features per scale; fp2 and fp1: 3-NN features),
    bit-equal to the plain version with the int64 indices the callers
    pass and with int32 ones.  Times the ten calls with each index type,
    and with int64 each call's device-only time from the profiler, beside
    the plain version and ``torch.gather`` on the same inputs."""
    from prifit_torch.kernels import gather
    gen = torch.Generator().manual_seed(2)
    xyz = torch.randn((B, N, 3), generator=gen).cuda()
    pre2 = torch.randn((B, 512, 128), generator=gen).cuda()
    f2 = torch.randn((B, 128, 256), generator=gen).cuda().bfloat16()
    f1 = torch.randn((B, 512, 128), generator=gen).cuda().bfloat16()

    def idx(n, *shape):
        return torch.randint(0, n, (B,) + shape, generator=gen).cuda()

    calls = [(xyz, idx(N, 512, k)) for k in (32, 32, 64, 64, 128, 128)]
    calls += [(pre2, idx(512, 128, 64)), (pre2, idx(512, 128, 128)),
              (f2, idx(128, 512, 3)), (f1, idx(512, N, 3))]
    calls32 = [(t, i.int()) for t, i in calls]
    for t, i in calls + calls32:
        got = gather.gather_rows(t, i)
        ref = gather.gather_plain(t, i)
        if not torch.equal(got.view(torch.uint8), ref.view(torch.uint8)):
            raise AssertionError(f"gather differs at {tuple(t.shape)} / "
                                 f"{tuple(i.shape)} {i.dtype}")
    lib_idx = [(t, i.reshape(B, -1, 1).expand(-1, -1, t.shape[-1]))
               for t, i in calls]
    # per call: table read once, int64 indices read once, output written
    # once
    call_bytes = [nbytes(t, i) + i.numel() * t.shape[-1] * t.element_size()
                  for t, i in calls]
    dev = device_ms(lambda: [gather.gather_rows(t, i) for t, i in calls],
                    "gather_kernel")
    for (t, i), (_, li), byt, d in zip(calls, lib_idx, call_bytes, dev):
        log(f"  gather {tuple(t.shape)} {t.dtype} by {tuple(i.shape)}: "
            f"{byt / 1e6:.2f} MB, bound_ms {bound_ms(byt, 0)[0]:.4f}, "
            f"kernel_ms {cuda_ms(lambda: gather.gather_rows(t, i)):.4f}, "
            f"device-only {d:.4f}, "
            f"library_ms {cuda_ms(lambda: torch.gather(t, 1, li)):.4f}")
    ms = cuda_ms(lambda: [gather.gather_rows(t, i) for t, i in calls])
    ms32 = cuda_ms(lambda: [gather.gather_rows(t, i) for t, i in calls32])
    plain_ms = cuda_ms(lambda: [gather.gather_plain(t, i)
                                for t, i in calls])
    library_ms = cuda_ms(lambda: [torch.gather(t, 1, i) for t, i in lib_idx])
    log(f"  gather, the ten calls: kernel_ms {ms:.4f} (int64), {ms32:.4f} "
        f"(int32); device-only {sum(dev):.4f} (int64); library_ms "
        f"{library_ms:.4f}")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound=bound_ms(sum(call_bytes), 0),
                device_ms=sum(dev), int32_ms=ms32)


def bandwidth_err(X, ks):
    """The largest ``|kernel - plain|`` of bandwidth on ``X`` for the
    ranks ``ks``, and the plain result.  The limit is 1e-5: 3xTF32 dots
    against cuBLAS f32 ones, on the bisection grid of 2^-22."""
    from prifit_torch.kernels import bandwidth
    got = bandwidth.kth_nn_distance(X, ks)
    ref = bandwidth.kth_nn_plain(X, ks)
    err = (got - ref).abs().max().item()
    if not err <= 1e-5:
        raise AssertionError(f"bandwidth max abs err {err} > 1e-5 at "
                             f"{tuple(X.shape)}, ranks {ks}")
    return err, ref


def check_bandwidth(X):
    """The kernel against its plain version at the main path's rank, on
    rows that are all equal (every key in one bin: the select's worst
    case) at that rank, and with 5 ranks (two launches) on 4 shapes of
    each.  Times the main path's call and the all-equal one; the bound
    counts the products as 3 TF32 products at the TF32 rate plus the
    keys' and the select's operations (2 a distance, and 2 a distance and
    rank) at the f32 rate; ``bound_f32_ms`` counts the work of the
    bisection kernel it replaced (f32 products and 24 compares a distance
    and rank)."""
    from prifit_torch.kernels import bandwidth
    ks = [int(0.05 * N)]
    err, ref = bandwidth_err(X, ks)
    same = X[:, :1].expand(-1, N, -1).contiguous()
    five = [1, 13, ks[0], 2 * ks[0], N]
    for x, kk in ((same, ks), (X[:4], five), (same[:4], five)):
        err = max(err, bandwidth_err(x, kk)[0])
    ms = cuda_ms(lambda: bandwidth.kth_nn_distance(X, ks))
    same_ms = cuda_ms(lambda: bandwidth.kth_nn_distance(same, ks))
    plain_ms = cuda_ms(lambda: bandwidth.kth_nn_plain(X, ks), reps=3)
    # yardstick: exact k-th value of cdist^2 (a sort, not the bisection)
    library_ms = cuda_ms(lambda: torch.kthvalue(
        torch.cdist(X, X) ** 2, ks[0], dim=-1), reps=3)
    pairs = B * N * N
    byt = nbytes(X) + B * len(ks) * N * 4
    bound = bound_ms(byt, (2 + 2 * len(ks)) * pairs, 3 * 2 * pairs * 128)
    log(f"  bandwidth B={B} N={N}: kernel_ms {ms:.4f}, all rows equal "
        f"{same_ms:.4f}; library_ms {library_ms:.4f}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound=bound,
                bound_f32_ms=bound_ms(byt, 2 * pairs * 128
                                      + 24 * len(ks) * pairs)[0],
                equal_rows_ms=same_ms), ref


def check_mean_shift(X, bw):
    """The forward kernel against its plain version for q = X (the first
    step) and for q one normalized step away from X (steps 2-10): m within
    1e-4 absolute, s within 1e-4 relative (f32 sums over 2048 columns in
    another order, 3xTF32 products, and the exponent rounded differently:
    (sim - 1) / b^2 against -(2 - 2 sim) / b^2 / 2).  Times the 10 launches
    of one forward; the yardstick is f32 SDPA on the same inputs."""
    from prifit_torch.kernels import mean_shift
    bw2 = (bw ** 2).contiguous()
    m, _ = mean_shift.mean_shift_step(X, X, bw2)
    q1 = (m / torch.linalg.norm(m, dim=-1, keepdim=True)).contiguous()
    err = 0.0
    for q in (X, q1):
        m, s = mean_shift.mean_shift_step(q, X, bw2)
        mr, sr = mean_shift.mean_shift_step_plain(q, X, bw2)
        e = (m - mr).abs().max().item()
        serr = ((s - sr).abs() / sr).max().item()
        if not (e <= 1e-4 and serr <= 1e-4):
            raise AssertionError(f"mean_shift max abs err {e}, s rel err "
                                 f"{serr} (q {'=' if q is X else '!='} X)")
        err = max(err, e)
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
    # two products of 2 n^2 D flops in 3xTF32, and n^2 exponentials
    tf32 = steps * 3 * 4 * B * N * N * 128
    byt = steps * (2 * nbytes(X) + nbytes(bw2) + nbytes(m) + nbytes(s))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms,
                bound=bound_ms(byt, steps * B * N * N, tf32))


def sparse_cotangent(gen, k, shape=(B, N, 128)):
    """A ``shape`` cotangent with ``k`` live (nonzero) rows per shape at
    random ids spread over the rows, as the self-sup path gives the
    mean-shift backward (at most 25 live rows: the centers)."""
    Bq, Nq, D = shape
    g = torch.zeros(shape)
    for b in range(Bq):
        rows = torch.randperm(Nq, generator=gen)[:k]
        g[b, rows] = torch.randn((k, D), generator=gen)
    return g.cuda()


def bwd_plain_err(got, X, b2, m, s, g):
    """The largest ``|got - plain|`` over dq and dX, with the plain version
    evaluated in float64 on the same f32 inputs; its largest entry; the
    same error of the plain version evaluated in f32; and the largest
    ``|got - plain|`` against that f32 evaluation."""
    from prifit_torch.kernels import mean_shift
    ref = mean_shift.mean_shift_step_bwd_plain(
        *(t.double() for t in (X, X, b2, m, s, g)))
    f32 = mean_shift.mean_shift_step_bwd_plain(X, X, b2, m, s, g)

    def diff(a, b):
        return max((u.double() - v.double()).abs().max().item()
                   for u, v in zip(a, b))

    top = max(r.abs().max().item() for r in ref)
    return diff(got, ref), top, diff(f32, ref), diff(got, f32)


def check_mean_shift_bwd(X, bw):
    """The backward kernel against its plain version for a dense random
    cotangent and for cotangents live in 1 and in 25 rows per shape, at the
    path's bandwidth and at one 50 times smaller (most exponents clamp at
    -13 there: the gradient cutoff), within 1e-4 of the largest gradient
    entry: f32 sums over 2048 rows in another order, 3xTF32 products, and
    the exponent rounded differently.  The plain version is evaluated in
    float64 on the same inputs: at the smaller bandwidth, where every
    kernel value and t_ij is up to 1 / b^2 ~ 250 times the gradient it
    sums to, its own f32 evaluation is 0.7-0.9e-4 of the largest entry off
    that (logged here), so it could not tell the kernel's error from its
    own.  An all-zero cotangent must give exact zeros.  Times the 10
    launches of one self-sup step for each cotangent; the yardstick for the
    dense one is the backward of f32 attention on the same inputs."""
    from prifit_torch.kernels import mean_shift
    bw2 = (bw ** 2).contiguous()
    gen = torch.Generator().manual_seed(6)
    g = torch.randn((B, N, 128), generator=gen).cuda()
    sparse = {k: sparse_cotangent(gen, k) for k in (1, 25)}
    err = {}  # at the path's bandwidth, by live rows a shape
    for shrink in (1.0, 0.02):
        b2 = (bw2 * shrink).contiguous()
        m, s = mean_shift.mean_shift_step_fwd(X, X, b2)
        for live, gg in [(N, g)] + list(sparse.items()):
            got = mean_shift.mean_shift_step_bwd(X, X, b2, m, s, gg)
            e, top, own, e32 = bwd_plain_err(got, X, b2, m, s, gg)
            log(f"  mean_shift_bwd bw2 x {shrink}, {live} live rows a shape: "
                f"max abs err {e:.3g} of the largest entry {top:.4g} "
                f"({e / top:.3g}); the plain version in f32 {own:.3g} "
                f"({own / top:.3g}); kernel against that {e32:.3g} "
                f"({e32 / top:.3g})")
            if not e <= 1e-4 * top:
                raise AssertionError(
                    f"mean_shift_bwd max abs err {e} at bw2 x {shrink}, "
                    f"{live} live rows a shape (largest entry {top})")
            err.setdefault(live, e)
        zero = mean_shift.mean_shift_step_bwd(X, X, b2, m, s,
                                              torch.zeros_like(g))
        if any(bool(t.any()) for t in zero):
            raise AssertionError(f"mean_shift_bwd of a zero cotangent is "
                                 f"not zero at bw2 x {shrink}")
    m, s = mean_shift.mean_shift_step_fwd(X, X, bw2)
    steps = 10

    def timed(gg, plain_reps):
        ms = cuda_ms(lambda: [
            mean_shift.mean_shift_step_bwd(X, X, bw2, m, s, gg)
            for _ in range(steps)], reps=3)
        plain_ms = cuda_ms(lambda: [
            mean_shift.mean_shift_step_bwd_plain(X, X, bw2, m, s, gg)
            for _ in range(steps)], reps=plain_reps, warmup=1)
        return ms, plain_ms

    rows = []
    for k, gg in sparse.items():
        k_ms, k_plain = timed(gg, 2)
        # what these live rows need: 10 count n D flops in 3xTF32 and
        # count n exponentials; x and g read, q, m and s read at the live
        # rows, dq and dx written
        live = B * k
        byt = steps * (4 * nbytes(X) + live * (2 * 128 + 1) * 4
                       + nbytes(bw2))
        bnd = bound_ms(byt, steps * live * N, steps * 3 * 10 * live * N * 128)
        rows.append(dict(live_rows=k, max_abs_err=err[k], ms=k_ms,
                         plain_ms=k_plain, bound_ms=bnd[0],
                         bound_by=bnd[1]))
    ms, plain_ms = timed(g, 2)
    q4 = (X / bw2[:, None, None])[:, None].requires_grad_()
    k4 = X[:, None].clone().requires_grad_()
    v4 = X[:, None].clone().requires_grad_()
    out = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4,
                                                           scale=1.0)
    library_ms = cuda_ms(lambda: [
        torch.autograd.grad(out, (q4, k4, v4), g[:, None], retain_graph=True)
        for _ in range(steps)], reps=3)
    # 10 n^2 D flops a shape and launch in 3xTF32 (the two forward products
    # and the three backward ones) and n^2 exponentials
    tf32 = steps * 3 * 10 * B * N * N * 128
    byt = steps * (4 * nbytes(X) + nbytes(bw2) + nbytes(s) + 2 * nbytes(X))
    return dict(max_abs_err=err[N], ms=ms, plain_ms=plain_ms,
                library_ms=library_ms,
                bound=bound_ms(byt, steps * B * N * N, tf32), sparse=rows)


def nms_partition(modes, outs, K=25):
    """The slots ``nms_tail`` makes of the NMS flags ``outs``, and each
    mode's nearest kept center, as ``cluster_batch`` labels the modes:
    ``(labels [B, N], valid [B, K], n_distinct [B])``."""
    from prifit_torch.clustering.mean_shift import nms_tail
    ids, valid, n_distinct = nms_tail(*outs, K)
    centers = torch.gather(modes, 1, ids[..., None].expand(
        -1, -1, modes.shape[-1])) * valid[..., None]
    sim = torch.matmul(centers, modes.transpose(-1, -2))
    sim = torch.where(valid[..., None], sim, torch.full_like(sim, -1e9))
    return torch.argmax(sim, dim=1), valid, n_distinct


def nms_inputs(X, bw, converged=True):
    """The four inputs of the NMS phase at ``X``'s shape (B=24, N=2048,
    D=128 on the main path), with their bandwidths: (a) copies of 20 unit
    anchors per shape; (b) modes like the main path's, 10 mean-shift steps
    from ``X`` at ``bw`` (left out unless ``converged``); (c) N distinct
    random unit rows, every mode occupied and its own center; (d) (a) with
    the bandwidth below every d_ii, so every score is 0 and every
    representative mode 0, and each shape's mode 0 at half length: then it
    is nearer to its copies than to itself and nobody's nearest, so mode 0
    is not occupied."""
    from prifit_torch.clustering.mean_shift import mean_shift_iterations
    Bq, Nq, D = X.shape
    gen = torch.Generator().manual_seed(4)
    anchors = torch.randn((Bq, 20, D), generator=gen)
    anchors = anchors / anchors.norm(dim=-1, keepdim=True)
    pick = torch.randint(0, 20, (Bq, Nq), generator=gen)
    dup = torch.gather(anchors, 1, pick[..., None].expand(-1, -1, D))
    dup = dup.cuda().contiguous()
    distinct = torch.randn((Bq, Nq, D), generator=gen)
    distinct = (distinct / distinct.norm(dim=-1, keepdim=True)).cuda()
    short = dup.clone()
    short[:, 0] *= 0.5
    full = lambda v: torch.full((Bq,), v, device="cuda")  # noqa: E731
    out = {"a_duplicates": (dup, full(0.35))}
    if converged:
        with torch.no_grad():
            conv = mean_shift_iterations(X, bw, 10).contiguous()
        out["b_converged"] = (conv, bw.float().contiguous())
    out["c_distinct"] = (distinct, full(0.35))
    out["d_rep_zero"] = (short, full(-1.0))
    return out


def check_nms(X, bw):
    """The three passes against their plain version on four inputs
    (:func:`nms_inputs`): counts, is_center and used exactly equal on
    (a), (c) and (d); on (b), where the two may differ on true rounding
    ties of the distances (3xTF32 products against cuBLAS f32), the
    partition ``nms_tail`` makes of them, as ``cluster_batch`` uses it
    (the same slots' members, counts of slots and of distinct labels).
    Times both on each input; the bound counts what the input needs:
    every distance for pass 1, the occupied modes' distances among
    themselves for pass 2 and every mode's to the centers for pass 3, as
    3 TF32 products each (the f32 count beside it)."""
    from prifit_torch.kernels import nms
    rows = []
    for name, (modes, b) in nms_inputs(X, bw).items():
        got = nms.nms_passes(modes, b)
        ref = nms.nms_passes_plain(modes, b)
        if name == "b_converged":
            (lg, vg, ng), (lc, vc, nc) = (nms_partition(modes, o)
                                          for o in (got, ref))
            if not (torch.equal(vg.sum(-1), vc.sum(-1))
                    and torch.equal(ng, nc)):
                raise AssertionError("nms: slot counts differ on (b)")
            for s in range(B):
                slot_perm(lg[s].cpu(), lc[s].cpu(), f"nms (b) shape {s}")
        else:
            for what, g, r in zip(("counts", "is_center", "used"), got, ref):
                if not torch.equal(g, r):
                    raise AssertionError(f"nms {what} differs from its "
                                         f"plain version on {name}")
        counts, is_center, _ = ref
        occ = (counts > 0).sum(-1)
        pairs = B * N * N + int((occ * occ).sum()) + N * int(is_center.sum())
        flops = 2 * pairs * 128
        byt = nbytes(modes, b) + 6 * B * N
        bnd = bound_ms(byt, 0, 3 * flops)
        rows.append(dict(
            input=name, ms=cuda_ms(lambda: nms.nms_passes(modes, b)),
            plain_ms=cuda_ms(lambda: nms.nms_passes_plain(modes, b),
                             reps=3),
            bound_ms=bnd[0], bound_by=bnd[1],
            bound_f32_ms=bound_ms(byt, flops)[0],
            occupied=int(occ.sum()), centers=int(is_center.sum())))
        log(f"  nms {name}: {rows[-1]}")
    head = rows[1]  # (b), the main path's kind of input
    return dict(max_abs_err=0.0, ms=head["ms"], plain_ms=head["plain_ms"],
                library_ms=None, bound=(head["bound_ms"], head["bound_by"]),
                inputs=rows)


# (N, D) of the ragged-shape phase, at B=4: the fitting demo's 8-wide
# embeddings, an odd width, the model's width at a point count that is no
# multiple of 64, and a cloud smaller than one tile
RAGGED = [(2500, 8), (2500, 13), (2500, 128), (50, 128)]
RB = 4


def check_ragged_shape(gen, n, d):
    """Bandwidth, the mean-shift forward and backward, and NMS at
    ``[RB, n, d]``, each against its plain version with the main phases'
    limits: bandwidth within 1e-5; the forward for q = X and q one step
    away (m 1e-4 absolute, s 1e-4 relative); the backward for a dense
    cotangent and for 1 live row a shape within 1e-4 of the largest entry
    of the float64 plain version, and exact zeros for a zero cotangent;
    NMS exactly on inputs (a) and (d) of :func:`nms_inputs` (and (c)).
    Returns the errors."""
    from prifit_torch.kernels import mean_shift, nms
    X = unit_rows(gen, (RB, n, d))
    bw_err, kth = bandwidth_err(X, [max(int(0.05 * n), 1)])
    bw = torch.sqrt(torch.clamp_min(kth[:, 0], 1e-6)).mean(-1)
    bw2 = (bw ** 2).contiguous()
    m, _ = mean_shift.mean_shift_step_fwd(X, X, bw2)
    q1 = (m / torch.linalg.norm(m, dim=-1, keepdim=True)).contiguous()
    fwd_err = 0.0
    for q in (X, q1):
        m, s = mean_shift.mean_shift_step_fwd(q, X, bw2)
        mr, sr = mean_shift.mean_shift_step_plain(q, X, bw2)
        e = (m - mr).abs().max().item()
        serr = ((s - sr).abs() / sr).max().item()
        if not (e <= 1e-4 and serr <= 1e-4):
            raise AssertionError(f"mean_shift at {(RB, n, d)}: max abs err "
                                 f"{e}, s rel err {serr}")
        fwd_err = max(fwd_err, e)
    m, s = mean_shift.mean_shift_step_fwd(X, X, bw2)
    bwd_err = 0.0
    for g in (torch.randn((RB, n, d), generator=gen).cuda(),
              sparse_cotangent(gen, 1, (RB, n, d))):
        got = mean_shift.mean_shift_step_bwd(X, X, bw2, m, s, g)
        e, top, _, _ = bwd_plain_err(got, X, bw2, m, s, g)
        if not e <= 1e-4 * top:
            raise AssertionError(f"mean_shift_bwd at {(RB, n, d)}: max abs "
                                 f"err {e} (largest entry {top})")
        bwd_err = max(bwd_err, e / top)
    zero = mean_shift.mean_shift_step_bwd(X, X, bw2, m, s,
                                          torch.zeros_like(X))
    if any(bool(t.any()) for t in zero):
        raise AssertionError(f"mean_shift_bwd of a zero cotangent is not "
                             f"zero at {(RB, n, d)}")
    for name, (modes, b) in nms_inputs(X, bw, converged=False).items():
        for what, g, r in zip(("counts", "is_center", "used"),
                              nms.nms_passes(modes, b),
                              nms.nms_passes_plain(modes, b)):
            if not torch.equal(g, r):
                raise AssertionError(f"nms {what} differs from its plain "
                                     f"version on {name} at {(RB, n, d)}")
    return dict(bandwidth=bw_err, mean_shift=fwd_err,
                mean_shift_bwd_of_top=bwd_err)


def check_ragged():
    """:func:`check_ragged_shape` at each of :data:`RAGGED`, then
    bandwidth alone at the largest N the kernels take, 8192 (D=128)."""
    gen = torch.Generator().manual_seed(11)
    for n, d in RAGGED:
        log(f"  ragged B={RB} N={n} D={d}: max errors "
            f"{check_ragged_shape(gen, n, d)} (nms exact)")
    big = 8192
    X = unit_rows(gen, (RB, big, 128))
    err, _ = bandwidth_err(X, [int(0.05 * big)])
    log(f"  ragged B={RB} N={big} D=128: bandwidth max abs err {err:.3g}")


# (rows, K, F) of the six K-max regions of one train step at B=24, N=2048:
# sa1's three scales (512 centres, K = 32/64/128), sa2's two (128 centres,
# K = 64/128) and sa3's group-all chain (1 centre, K = 128 points)
MAX_BWD_SHAPES = [(B * 512, 32, 64), (B * 512, 64, 128), (B * 512, 128, 128),
                  (B * 128, 64, 256), (B * 128, 128, 256), (B, 128, 1024)]
KEY_255, KEY_0 = (0x1234ABCD, 0x9E3779B9), (0xCAFEBABE, 12345)
# the kernels that only a train step's backward runs; the last three only
# at the mixed-precision dtypes
MIXED_ONLY = ("max_bwd_cnt_gsm", "max_bwd_dz", "sr_bf16")
TRAIN_ONLY = ("mean_shift_bwd",) + MIXED_ONLY


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def max_bwd_inputs(gen, rows, K, F, sr):
    """One K-max region's backward inputs on the card, as the region
    keeps them: z [rows*K, F] bf16 from a Gaussian with ties planted (5%
    of the neighbours copy their row's selected value), the BN affine
    ``a`` (either sign) and ``c`` in bf16, zsel = max_K z where a > 0 and
    min_K z elsewhere, out = relu(a zsel + c) in bf16, and the output
    cotangent g (bf16 under sr, f32 otherwise); plus the f32 statistics
    (scale, mean, inv) and the row count."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    scale, mean = randn(F), 0.1 * randn(F)
    inv = 0.5 + torch.rand((F,), generator=gen, device="cuda")
    a_bf, c_bf = (scale * inv).bfloat16(), (0.5 * randn(F)).bfloat16()
    zk = randn(rows, K, F).bfloat16()
    zsel = torch.where(a_bf > 0, zk.amax(1), zk.amin(1))
    tie = torch.rand((rows, K, F), generator=gen, device="cuda") < 0.05
    zk = torch.where(tie, zsel[:, None, :], zk)
    out_bf = torch.relu((zsel.float() * a_bf.float() + c_bf.float())
                        .bfloat16())
    g = randn(rows, F)
    return dict(z=zk.reshape(rows * K, F), zsel=zsel, out_bf=out_bf,
                g=g.bfloat16() if sr else g, scale=scale, mean=mean, inv=inv,
                n=float(rows * K))


def max_bwd_consts(x, cnt, gsm):
    """``(a, c1, c2)`` of the dz pass from pass 1's outputs (the
    per-feature reductions of ``nn/mixed.py::_max_bwd_core``)."""
    gsm32 = gsm.float()
    xhat_sel = (x["zsel"].float() - x["mean"]) * x["inv"]
    dbias = (gsm32 * cnt).sum(0)
    dscale = (gsm32 * cnt * xhat_sel).sum(0)
    inv, scale, n = x["inv"], x["scale"], x["n"]
    return ((inv * scale).contiguous(), inv * scale * dbias / n,
            inv * inv * scale * dscale / n)


def check_max_bwd():
    """Kernels #7 (``max_bwd_cnt_gsm``) and #8 (``max_bwd_dz``) against
    their plain versions at the six K-max regions' shapes, with
    stochastic rounding on (``mxsr``) and off (``mx``): cnt, gsm and dz
    bit-equal (the kernels round each product and difference as the
    plain version does, and take the same hash bits).  Times the six
    calls of one ``mxsr`` step of each; no single PyTorch call computes
    either function."""
    from prifit_torch.kernels import max_bwd
    gen = torch.Generator(device="cuda").manual_seed(7)
    timed = {}
    for sr in (True, False):
        k255, k0 = (KEY_255, KEY_0) if sr else (None, None)
        for shape in MAX_BWD_SHAPES:
            x = max_bwd_inputs(gen, *shape, sr)
            args = (x["z"], x["zsel"], x["g"], x["out_bf"], k255)
            cnt, gsm = max_bwd.cnt_gsm(*args)
            cnt_p, gsm_p = max_bwd.cnt_gsm_plain(*args)
            if not (torch.equal(cnt, cnt_p)
                    and torch.equal(_bits(gsm), _bits(gsm_p))):
                raise AssertionError(f"max_bwd_cnt_gsm differs from its "
                                     f"plain version at {shape}, sr={sr}")
            if not bool((cnt > 1).any()):
                raise AssertionError(f"no ties at {shape}")
            a, c1, c2 = max_bwd_consts(x, cnt, gsm)
            dargs = (x["z"], x["zsel"], gsm, a, c1, x["mean"], c2, k0)
            dz, dz_p = max_bwd.dz(*dargs), max_bwd.dz_plain(*dargs)
            if not torch.equal(_bits(dz), _bits(dz_p)):
                raise AssertionError(
                    f"max_bwd_dz differs from its plain version at {shape}, "
                    f"sr={sr}: {int((_bits(dz) != _bits(dz_p)).sum())} of "
                    f"{dz.numel()} elements")
            if sr:
                timed[shape] = (args, dargs, cnt, gsm, dz)
            del x, cnt_p, gsm_p, dz_p
    calls = list(timed.values())
    out = {}
    for name, fn, plain, reads, writes in (
            ("max_bwd_cnt_gsm", lambda c: max_bwd.cnt_gsm(*c[0]),
             lambda c: max_bwd.cnt_gsm_plain(*c[0]),
             lambda c: c[0][:4], lambda c: (c[2], c[3])),
            ("max_bwd_dz", lambda c: max_bwd.dz(*c[1]),
             lambda c: max_bwd.dz_plain(*c[1]),
             lambda c: c[1][:7], lambda c: (c[4],))):
        ms = cuda_ms(lambda: [fn(c) for c in calls])
        plain_ms = cuda_ms(lambda: [plain(c) for c in calls], reps=3)
        # each input read once, each output written once; the f32
        # arithmetic (a compare per element for pass 1, six flops per
        # element for pass 2) is far below the byte time
        byt = sum(nbytes(*reads(c), *writes(c)) for c in calls)
        per_elem = 1 if name == "max_bwd_cnt_gsm" else 6
        ops = sum(per_elem * c[0][0].numel() for c in calls)
        out[name] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                         library_ms=None, bound=bound_ms(byt, ops))
    return out


class record_sr_calls:
    """While active, records the number of elements of every stochastic
    rounding cast the mixed-precision region makes (``nn/mixed.py``
    calls ``sr_bf16`` by that module's name)."""

    def __enter__(self):
        import prifit_torch.nn.mixed as mixed
        self.mixed, self.orig, self.numels = mixed, mixed.sr_bf16, []

        def sr_bf16(key, x):
            self.numels.append(x.numel())
            return self.orig(key, x)

        mixed.sr_bf16 = sr_bf16
        return self

    def __exit__(self, *exc):
        self.mixed.sr_bf16 = self.orig


def check_sr_bf16(numels):
    """The ``sr_bf16`` helper kernel against its plain version, bit for
    bit, at the sizes of the casts one ``mxsr`` supervised step makes
    (``numels``) and at an odd size (the one-value-per-thread path);
    times all of one step's casts."""
    from prifit_torch.kernels import stochastic_round as sr
    gen = torch.Generator(device="cuda").manual_seed(8)
    buf = 3 * torch.randn((max(numels),), generator=gen, device="cuda")
    for n in sorted(set(numels)) + [1001]:
        x = buf[:n]
        if not torch.equal(_bits(sr.sr_bf16(KEY_0, x)),
                           _bits(sr.sr_bf16_plain(KEY_0, x))):
            raise AssertionError(f"sr_bf16 differs from its plain version "
                                 f"at {n} elements")
    xs = [buf[:n] for n in numels]
    ms = cuda_ms(lambda: [sr.sr_bf16(KEY_0, x) for x in xs])
    plain_ms = cuda_ms(lambda: [sr.sr_bf16_plain(KEY_0, x) for x in xs],
                       reps=3)
    # 4 bytes read and 2 written per element; the hash is integer work
    # (about 12 operations an element), counted here at the f32 rate
    byt = 6 * sum(numels)
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound=bound_ms(byt, 12 * sum(numels)))


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
    missing = [k for k, v in counts.items()
               if v == 0 and k not in TRAIN_ONLY]
    if missing:
        raise AssertionError(f"kernels never launched on the eval path: "
                             f"{missing}")
    if any(counts[k] for k in TRAIN_ONLY):
        raise AssertionError(f"the eval forward launched a backward kernel: "
                             f"{counts}")
    if counts["fps"] != 2 * 3:
        raise AssertionError(f"fps launched {counts['fps']} times in 3 "
                             f"forwards, not once per SA-MSG layer")
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


def check_encoder_counts(c, mixed, what):
    """The encoder's launches in 3 train steps ``c``: FPS once per SA-MSG
    layer and step; the K-max backward pair once per K-max region and
    step (6 regions) and some rounding casts in a mixed dtype, none of
    either with f32."""
    if c["fps"] != 2 * 3:
        raise AssertionError(f"fps launched {c['fps']} times in 3 {what} "
                             f"steps, not once per SA-MSG layer")
    want = 18 if mixed else 0
    if not (c["max_bwd_cnt_gsm"] == c["max_bwd_dz"] == want):
        raise AssertionError(f"K-max backward launched {c} in 3 {what} "
                             f"steps, not {want} each")
    if bool(c["sr_bf16"]) != mixed:
        raise AssertionError(f"sr_bf16 launched {c['sr_bf16']} times in 3 "
                             f"{what} steps")


def check_selfsup_counts(c, mixed, what):
    """A self-sup step's launches ``c`` in 3 steps: every kernel (but
    the mixed-precision ones with f32), and the mean-shift backward once
    per forward step."""
    missing = [k for k, v in c.items()
               if v == 0 and (mixed or k not in MIXED_ONLY)]
    if missing:
        raise AssertionError(f"kernels never launched by the {what} step: "
                             f"{missing}")
    fwd, bwd = c["mean_shift"], c["mean_shift_bwd"]
    if not (bwd == fwd and fwd >= 30 and fwd % 10 == 0):
        raise AssertionError(f"mean_shift_bwd launched {bwd} times for "
                             f"{fwd} forward steps in 3 {what} steps")


def timed_steps(state, run, kernels, what):
    """One warm-up ``run()`` of a train step, then three timed ones with
    the launch counts reset just before, each checked by
    :func:`_check_step`: their times, launch counts, peak memory and last
    metrics."""
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
        _check_step(state, before, metrics, what)
    return dict(times=times, counts=kernels.launch_counts(),
                peak=torch.cuda.max_memory_allocated(),
                metrics={k: v.item() for k, v in metrics.items()})


def train_path(entry, kernels, compute_dtype):
    """The two train steps at B=24, N=2048 with the encoder dtype
    ``compute_dtype`` (``entry.train_flagship``, ``bench.py``'s settings:
    ``"auto"`` = ``mxsr`` its headline train fields, ``"f32"`` its
    secondary ones): for each, one warm-up step, then three timed ones
    with the launch counts reset just before.  Returns per step kind its
    times, launch counts, peak memory and last metrics; for ``f32`` also
    the mean-shift backward's cotangent rows (:func:`g_row_share`), for
    ``auto`` the sizes of one supervised step's rounding casts."""
    from prifit_torch.models.pointnet2_part_seg_msg import get_loss
    from prifit_torch.train.steps import make_selfsup_step, \
        make_supervised_step
    state, points, cls, target = entry.train_flagship(
        B, N, compute_dtype=compute_dtype)
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
    out = {name: timed_steps(state, run, kernels, name)
           for name, run in runs.items()}
    sc, ssc = out["supervised"]["counts"], out["selfsup"]["counts"]
    mixed = compute_dtype != "f32"
    for k in ("fps", "gather") + (MIXED_ONLY if mixed else ()):
        if not (sc[k] > 0 and ssc[k] > 0):
            raise AssertionError(f"{k} not launched in both steps: {sc} "
                                 f"{ssc}")
    check_selfsup_counts(ssc, mixed, "self-sup")
    for c in (sc, ssc):
        check_encoder_counts(c, mixed, compute_dtype)
    if mixed:
        with record_sr_calls() as rec:
            runs["supervised"]()
        if len(rec.numels) * 3 != sc["sr_bf16"]:
            raise AssertionError(f"{len(rec.numels)} casts recorded, "
                                 f"{sc['sr_bf16']} launched in 3 steps")
        out["sr_numels"] = rec.numels
    else:
        out["g_rows"] = g_row_share(entry, state, points, cls, gen)
    return out


# the paths of the self-sup objectives beyond the bench settings: name ->
# (kind, convex-loss options)
OBJECTIVE_PATHS = {
    "selfsup_step_options_mxsr": ("selfsup", {}),
    "selfsup_step_cuboid_mxsr": ("selfsup", {"if_cuboid": True}),
    "contrastive_step_mxsr": ("contrastive", None),
}
CLUSTERING = ("bandwidth", "mean_shift", "mean_shift_bwd", "nms")


def objective_paths(entry, kernels):
    """The self-sup objectives the JAX trainer selects beyond the bench
    settings, each at B=24, N=2048 at the default dtype (``mxsr``) from
    the seeded flagship (``entry.train_flagship``): the self-sup step
    with every option of the convex loss (``entry.SELFSUP_OPTIONS``:
    entropy, intersection, pruning, alpha 0.01), the same with cuboids,
    and the contrastive step (margin 0.5, lmbda 1) on ACD-like labels
    (``entry.acd_labels``).  Each is :func:`timed_steps` with its launch
    counts checked: the self-sup paths launch what the bench self-sup step
    does, the contrastive one the encoder's kernels and none of the
    clustering's.  The self-sup paths also take :func:`g_row_share`."""
    from prifit_torch.models.pointnet2_part_seg_msg import get_selfsup_loss
    from prifit_torch.train.steps import make_contrastive_step, \
        make_selfsup_step
    ts = entry.TRAIN_SETTINGS
    out = {}
    for name, (kind, extra) in OBJECTIVE_PATHS.items():
        state, points, cls, _ = entry.train_flagship(B, N)
        gen = torch.Generator(device="cuda").manual_seed(0)
        if kind == "selfsup":
            options = dict(entry.SELFSUP_OPTIONS, **extra)
            step = make_selfsup_step(**entry.BENCH_KWARGS, **options)
            args = (points, cls, points)
        else:
            step = make_contrastive_step(get_selfsup_loss, margin=0.5)
            args = (points, cls, entry.acd_labels(points))
        out[name] = r = timed_steps(state, lambda: step(
            state, *args, ts["lr"], ts["bn_momentum"], ts["lmbda"], gen),
            kernels, name)
        c = r["counts"]
        check_encoder_counts(c, True, name)
        if kind == "selfsup":
            check_selfsup_counts(c, True, name)
            r["g_rows"] = g_row_share(entry, state, points, cls, gen,
                                      **options)
        elif any(c[k] for k in CLUSTERING) or not c["gather"]:
            raise AssertionError(f"the contrastive step launched {c}")
        del state, step
    return out


# the trainer phase's synthetic ShapeNet-Part categories: synset and real
# part ids (the JAX package's SEG_CLASSES)
TRAINER_CATEGORIES = {"Airplane": ("02691156", [0, 1, 2, 3]),
                      "Chair": ("03001627", [12, 13, 14, 15]),
                      "Lamp": ("03636649", [24, 25, 26, 27])}
# the recipe's self-sup settings (README.md:60-63, bench.py:71-72)
TRAINER_FLAGS = ["--batch_size", str(B), "--npoint", str(N), "--selfsup",
                 "--ss_dataset", "acd", "--quantile", "0.05",
                 "--msc_iterations", "10", "--max_num_clusters", "25",
                 "--n_per_prim", "256", "--chamfer_npoints", "5000",
                 "--learning_rate", "0.01", "--lmbda", "1", "--alpha", "0.01",
                 "--seed", "786"]
# iterations of the timed trainer run: its walls spread by 2x from one
# iteration to the next, so the median needs several dozen
TRAINER_ITERS = 48
# iterations of the resumed epoch
RESUME_ITERS = 4
# the trainer's other runs: name -> (flags, iterations); the last has no
# loader worker threads (the batches are the same), to see what the
# threads cost an iteration
TRAINER_VARIANTS = {"fused_augment": (["--fused_augment"], 8),
                    "contrastive": (["--ss_loss", "contrastive"], 8),
                    "num_workers_0": (["--num_workers", "0"], TRAINER_ITERS)}
# shapes a category in the synthetic tree: half train, a quarter val, a
# quarter test, so the eval's clouds/s is read over 3 batches of B
TRAINER_SHAPES = 96


def _parts_cloud(rng, parts, n):
    """A cloud of ``n`` points in one gaussian blob per part (centers 1
    apart on average, spread 0.25) and the part of each point."""
    centers = rng.normal(size=(len(parts), 3))
    label = rng.integers(0, len(parts), n)
    pts = centers[label] + 0.25 * rng.normal(size=(n, 3))
    return pts.astype(np.float32), np.asarray(parts)[label]


def write_shapenet_tree(root, n_per_cat=TRAINER_SHAPES, n_points=2500,
                        seed=0):
    """A synthetic ShapeNet-Part tree in the layout of
    ``tests/fixtures.py::make_shapenet_fixture``: ``synsetoffset2category
    .txt``, the three split jsons (first half train, next quarter val, the
    rest test) and a text file a shape of xyz, unit normals and the part
    label, with labels that follow the geometry (one blob a part)."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "train_test_split"))
    splits = {"train": [], "val": [], "test": []}
    with open(os.path.join(root, "synsetoffset2category.txt"), "w") as f:
        for name, (synset, _) in TRAINER_CATEGORIES.items():
            f.write(f"{name}\t{synset}\n")
    for name, (synset, parts) in TRAINER_CATEGORIES.items():
        os.makedirs(os.path.join(root, synset))
        for i in range(n_per_cat):
            token = f"{name.lower()}{i:04d}"
            pts, seg = _parts_cloud(rng, parts, n_points)
            nrm = rng.normal(size=(n_points, 3))
            nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
            data = np.concatenate([pts, nrm, seg[:, None]], axis=1)
            np.savetxt(os.path.join(root, synset, token + ".txt"), data,
                       fmt="%.6f")
            split = "train" if i < n_per_cat // 2 else \
                "val" if i < 3 * n_per_cat // 4 else "test"
            splits[split].append(f"shape_data/{synset}/{token}")
    for split, ids in splits.items():
        with open(os.path.join(root, "train_test_split",
                               f"shuffled_{split}_file_list.json"), "w") as f:
            json.dump(ids, f)
    return root


def write_acd_tree(root, n_shapes=48, n_points=6000, n_components=6,
                   seed=1):
    """A synthetic ACD tree in the layout of ``tests/fixtures.py::
    make_acd_fixture``: ``.npy`` files ``[n_points, 4]`` of xyz and the
    component id, one blob a component."""
    rng = np.random.default_rng(seed)
    d = os.path.join(root, "shapes")
    os.makedirs(d)
    for i in range(n_shapes):
        pts, comp = _parts_cloud(rng, list(range(n_components)), n_points)
        np.save(os.path.join(d, f"acd{i:04d}.npy"), np.concatenate(
            [pts, comp[:, None].astype(np.float32)], axis=1))
    return root


class _WaitTimed:
    """A prefetch stream that adds the host seconds its consumer spends
    in ``__next__`` (waiting for the producer thread) to ``waits``."""

    def __init__(self, stream, waits):
        self.stream, self.waits = stream, waits

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        try:
            return next(self.stream)
        finally:
            self.waits.append(time.perf_counter() - t0)

    def close(self):
        self.stream.close()


def _trainer_run(train_partseg, args, kernels):
    """``train_partseg.main(args)`` on the card with the launch counts
    reset just before; per iteration (through its ``on_iteration`` hook,
    after a synchronize) the wall clock and the counts, and the time the
    iteration waited for its two prefetched batches.  Returns the
    metrics, the iteration walls and waits but the first iteration's
    (which starts the prefetch streams), the counts of the whole run and
    of its last iteration."""
    marks, waits = [], []

    def on_iteration(epoch, i):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), kernels.launch_counts(),
                      sum(waits)))

    prefetch = train_partseg.prefetch_to_device
    train_partseg.prefetch_to_device = \
        lambda *a, **kw: _WaitTimed(prefetch(*a, **kw), waits)
    kernels.reset_launch_counts()
    try:
        metrics = train_partseg.main(args, device="cuda",
                                     on_iteration=on_iteration)
    finally:
        train_partseg.prefetch_to_device = prefetch
    counts = kernels.launch_counts()
    walls = [(b[0] - a[0], b[2] - a[2]) for a, b in zip(marks, marks[1:])]
    last = {k: marks[-1][1][k] - marks[-2][1][k] for k in counts}
    for k, v in metrics.items():
        if not np.isfinite(v) and k != "best_chamfer_loss":
            raise AssertionError(f"trainer metric {k} = {v}")
    if not 0.0 <= metrics["instance_avg_iou"] <= 1.0:
        raise AssertionError(f"trainer metrics {metrics}")
    return metrics, walls, counts, last


def _last_checkpoint(exp):
    return torch.load(os.path.join(exp, "checkpoints", "last_model"),
                      weights_only=False)


def check_restored(state, epoch, ckpt):
    """A checkpoint round trip on the card: the restored model (weights,
    batch-norm statistics, ``beta``), the optimizer's state (Adam's step
    and moments, on the model's device), ``step`` and ``epoch`` equal what
    the file holds."""
    for k, v in state.model.state_dict().items():
        if not torch.equal(v.cpu(), ckpt["model_state_dict"][k]):
            raise AssertionError(f"restored {k} differs")
    saved = ckpt["optimizer_state_dict"]["state"]
    restored = state.optimizer.state_dict()["state"]
    if not saved or saved.keys() != restored.keys():
        raise AssertionError("restored optimizer state differs")
    for i, st in saved.items():
        for k, t in st.items():
            r = restored[i][k]
            if not torch.equal(r.cpu(), t) or (
                    k != "step" and r.device.type != "cuda"):
                raise AssertionError(f"restored optimizer {i}.{k} differs")
    if (state.step, epoch) != (ckpt["step"], ckpt["epoch"]):
        raise AssertionError(f"restored step {state.step} epoch {epoch}")


def trainer_breakdown(train_partseg, args, exp):
    """Where a trainer iteration's time goes beside the bare steps: the
    host pipeline alone (the loaders with their worker threads and the
    two batch transforms, run in turn with no step and no copy to the
    card: a warm-up iteration, then 8 timed) and the trainer's own steps
    (``build_steps``) on the trainer's own batches, from its
    ``last_model`` checkpoint, with no pipeline running beside them (a
    warm-up, then 3 timed each).  The restore is checked by
    :func:`check_restored`.  Returns (host seconds an iteration, the
    supervised and self-sup steps' median seconds)."""
    from prifit_torch.models import get_module
    from prifit_torch.train.checkpoint import restore_checkpoint
    from prifit_torch.train.state import create_train_state

    def noop(*_):
        return None

    loaders = train_partseg.build_loaders(args, noop)
    transforms = train_partseg.batch_transforms(args)
    streams = [train_partseg.cycle(loader) for loader in loaders]

    def host_iteration():
        return [t(next(it)) for t, it in zip(transforms, streams)]

    batches = host_iteration()
    t0 = time.perf_counter()
    for _ in range(8):
        host_iteration()
    host = (time.perf_counter() - t0) / 8

    mod = get_module(args.model)
    state = create_train_state(train_partseg.build_model(
        args, mod, "cuda"))
    _, epoch = restore_checkpoint(os.path.join(exp, "checkpoints"),
                                  "last_model", state)
    check_restored(state, epoch, _last_checkpoint(exp))
    sup_step, ss_step = train_partseg.build_steps(args, mod)
    sup, ss = ([torch.as_tensor(a, device="cuda") for a in b]
               for b in batches)
    gen = torch.Generator(device="cuda").manual_seed(0)
    runs = {"supervised": lambda: sup_step(state, *sup, 1e-3, 0.1, gen),
            "selfsup": lambda: ss_step(state, *ss, 1e-3, 0.1, 1.0, gen)}
    steps = {}
    for name, run in runs.items():
        run()
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        steps[name] = sorted(times)[1]
    return host, steps


def trainer_phase(kernels, bare):
    """The part-seg trainer (``python -m prifit_torch.cli.train_partseg``)
    on the card at B=24, N=2048 with the recipe's self-sup settings and
    the default encoder dtype, on synthetic trees
    (:func:`write_shapenet_tree`: 3 categories of ``TRAINER_SHAPES``
    shapes, 2500 points with normals; :func:`write_acd_tree`: 48 shapes
    of 6000 points), for one epoch of ``TRAINER_ITERS`` iterations and
    the final eval over the test split; then its resume for one more
    epoch of ``RESUME_ITERS`` (``epoch``, ``step`` and ``beta`` must be
    restored), and the runs of ``TRAINER_VARIANTS``
    (``--fused_augment``, ``--ss_loss contrastive``, ``--num_workers
    0``).  Times each iteration (a supervised step plus a self-sup step
    with the host pipeline) against ``bare``, the same call's bare-step
    medians, and :func:`trainer_breakdown`, and the eval's clouds/s
    (``evaluation`` on the checkpoint, the test split's parsed clouds);
    checks the eval of the checkpoint with ``cli/testing.py`` on the card
    against the CPU (instance-avg mIoU within 1e-2, accuracy within 0.5
    points: ties in the masked argmax may flip); and, in
    :func:`trainer_breakdown`, restores ``last_model`` on the card
    (:func:`check_restored`)."""
    import shutil
    import tempfile

    from prifit_torch.cli import testing, train_partseg
    from prifit_torch.cli.args_parser import parse_args
    from prifit_torch.data import DataLoader, PartNormalDataset
    from prifit_torch.eval.miou import evaluation, make_eval_forward
    from prifit_torch.models import get_module
    from prifit_torch.train.checkpoint import restore_params_only
    from prifit_torch.train.state import create_train_state

    os.makedirs(os.path.join(ROOT, "log"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(ROOT,
                                                                   "log"))
    try:
        t0 = time.perf_counter()
        sn = write_shapenet_tree(os.path.join(tmp, "shapenet"))
        acd = write_acd_tree(os.path.join(tmp, "acd"))
        write_s = time.perf_counter() - t0

        def args_for(root, *extra):
            return parse_args(TRAINER_FLAGS + [
                "--data_root", sn, "--ss_path", acd, "--experiment_root",
                os.path.join(tmp, root), "--epoch", "1", *extra])

        out = {"write_s": write_s}
        args = args_for("main", "--epoch_iters", str(TRAINER_ITERS))
        metrics, walls, counts, last = _trainer_run(train_partseg, args,
                                                    kernels)
        missing = [k for k, v in counts.items() if v == 0]
        if missing:
            raise AssertionError(f"kernels never launched by the trainer: "
                                 f"{missing}")
        if last["fps"] != 4 or last["mean_shift_bwd"] != last["mean_shift"] \
                or last["mean_shift"] < args.msc_iterations:
            raise AssertionError(f"a trainer iteration launched {last}")
        exp = os.path.join(args.experiment_root,
                           train_partseg.experiment_name(args))
        names = sorted(os.listdir(os.path.join(exp, "checkpoints")))
        if names != ["best_model", "last_model", "model_001"]:
            raise AssertionError(f"trainer checkpoints {names}")
        first = _last_checkpoint(exp)
        beta1 = first["model_state_dict"]["beta"].item()
        if (first["epoch"], first["step"]) != (0, 2 * TRAINER_ITERS) \
                or abs(beta1 - 0.99 ** TRAINER_ITERS) > 1e-6:
            raise AssertionError(f"checkpoint epoch {first['epoch']} step "
                                 f"{first['step']} beta {beta1}")
        out.update(metrics=metrics, walls=[w for w, _ in walls],
                   waits=[w for _, w in walls], counts=counts, last=last,
                   beta=beta1)
        out["host"], out["own_steps"] = trainer_breakdown(
            train_partseg, args, exp)

        # resume from last_model for one more, shorter epoch
        args.epoch, args.epoch_iters = 2, RESUME_ITERS
        _, rwalls, _, _ = _trainer_run(train_partseg, args, kernels)
        second = _last_checkpoint(exp)
        beta2 = second["model_state_dict"]["beta"].item()
        with open(os.path.join(exp, "train.log")) as f:
            resumed = "Resumed from epoch 0" in f.read()
        if not resumed or (second["epoch"], second["step"]) != (
                1, 2 * (TRAINER_ITERS + RESUME_ITERS)) \
                or abs(beta2 - 0.99 ** (TRAINER_ITERS + RESUME_ITERS)) > 1e-6:
            raise AssertionError(f"resume: logged {resumed}, epoch "
                                 f"{second['epoch']} step {second['step']} "
                                 f"beta {beta2}")
        out["resume"] = dict(walls=[w for w, _ in rwalls], beta=beta2,
                             step=second["step"])

        # the variants
        for name, (extra, iters) in TRAINER_VARIANTS.items():
            vargs = args_for(name, "--epoch_iters", str(iters), *extra)
            _, vwalls, vcounts, vlast = _trainer_run(train_partseg, vargs,
                                                     kernels)
            clustering = [vlast[k] for k in CLUSTERING]
            if (name == "contrastive") == any(clustering) or not vlast["fps"]:
                raise AssertionError(f"{name} iteration launched {vlast}")
            out[name] = dict(walls=[w for w, _ in vwalls],
                             waits=[w for _, w in vwalls], counts=vcounts,
                             last=vlast)

        # the eval's clouds/s: evaluation() of the checkpoint on the test
        # split, once to warm up, then three timed
        ckpt = os.path.join(exp, "checkpoints", "best_model")
        model = train_partseg.build_model(args, get_module(args.model),
                                          "cuda")
        restore_params_only(*os.path.split(ckpt), create_train_state(model),
                            log=lambda *_: None)
        loader = DataLoader(PartNormalDataset(
            sn, npoints=N, split="test", rng=np.random.default_rng(0)),
            B, drop_last=False)
        clouds = len(loader.dataset)
        forward = make_eval_forward(model)
        ev_walls = []
        for _ in range(4):
            t0 = time.perf_counter()
            evaluation(forward, loader, device="cuda", pad_to=B,
                       log=lambda *_: None)
            torch.cuda.synchronize()
            ev_walls.append(time.perf_counter() - t0)
        out["eval"] = dict(clouds=clouds, walls=ev_walls[1:])
        del model, forward

        # the eval CLI on the checkpoint, card against CPU
        targs = args_for("main", "--pretrained_model", ckpt)
        res = {side: testing.main(targs, device=dev, log=lambda *_: None)
               for side, dev in (("card", "cuda"), ("cpu", "cpu"))}
        d_iou = abs(res["card"]["instance_avg_iou"]
                    - res["cpu"]["instance_avg_iou"])
        d_acc = abs(res["card"]["accuracy"] - res["cpu"]["accuracy"])
        if d_iou > 1e-2 or d_acc > 5e-3:
            raise AssertionError(f"eval card vs cpu: {res}")
        out["card_vs_cpu"] = res
        out["bare"] = bare
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def g_row_share(entry, state, points, cls, gen, **options):
    """One more self-sup forward and backward (not counted) with the
    convex-loss ``options``, with a hook on every mean-shift step's
    backward node: per launch, the largest number of rows of the
    cotangent g in one shape that are not zero.  Centers are gathered
    from the modes, so at most 25 of 2048 may be (the backward kernel's
    premise: it walks the live rows only); more raises.  Returns (largest
    count, mean share of nonzero rows)."""
    model = state.model.train()
    out = model(points, cls, chamfer_points=points, generator=gen,
                include_convex_loss=True, **entry.BENCH_KWARGS, **options)
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
    top = max(r[0] for r in rows)
    if top > entry.BENCH_KWARGS["max_num_clusters"]:
        raise AssertionError(f"{top} live cotangent rows in a shape")
    return top, sum(r[1] for r in rows) / len(rows)


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
            2, N, device="cuda" if dev == "cuda" else "cpu",
            compute_dtype="f32")
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


SR_BASE = (12345, 0xCAFEBABE)
# the input scales of the CPU's own spread
SPREAD_SCALES = (1 + 2.0 ** -20, 1 - 2.0 ** -20, 1 + 2.0 ** -19,
                 1 - 2.0 ** -19)


def mxsr_train_card_vs_cpu(entry):
    """One B=2 supervised step at the default dtype (``mxsr``) on the
    card and on the CPU, from the same seeded weights and the same
    stochastic-rounding base key (so both draw the same bits), dropout
    off and FPS from index 0; four more CPU steps on the cloud scaled by
    1 +- 2^-20 and 1 +- 2^-19; and one CPU step with another key.

    bf16 storage makes this gradient chaotic: a z that sums to another
    f32 value (cuBLAS against the CPU, or a moved input) rounds to
    another bf16 value now and then, which moves a K-max tie or a relu
    boundary, and every batch norm's backward amplifies that (it
    subtracts the mean of its cotangent, a sum of terms that nearly
    cancel; in f32 the same amplification leaves card and CPU 1e-2 of
    the norm apart).  So each gradient's limit is the CPU's own spread
    under those input changes (the largest relative change of that
    parameter's gradient over the four): the card must be within twice
    it, plus 5e-2 of the norm (the f32 steps' limit).  The loss, a
    forward value, must be within 1e-3 relative: every activation is
    rounded to bf16, and the card's f32 sums land on the other side of a
    rounding now and then (the bf16 eval forward's total-loss limit is
    1e-2).  Also returns the medians over the parameters of the card's
    error, the CPU's spread and the change another key makes."""
    from prifit_torch.models.pointnet2_part_seg_msg import get_loss
    from prifit_torch.train.steps import make_supervised_step
    ts = entry.TRAIN_SETTINGS
    res = []
    for dev, s, key in [("cuda", 1.0, SR_BASE), ("cpu", 1.0, SR_BASE)] + [
            ("cpu", s, SR_BASE) for s in SPREAD_SCALES] + [
            ("cpu", 1.0, (777, 999))]:
        state, points, cls, target = entry.train_flagship(2, N, device=dev)
        state.model.dropout_rate = 0.0
        _, sm = make_supervised_step(get_loss)(
            state, points * s, cls, target, ts["lr"], ts["bn_momentum"],
            sr_key=key)
        res.append((sm["loss"].item(),
                    {n: p.grad.float().cpu()
                     for n, p in state.model.named_parameters()}))
    (lg, gg), (lc, gc), other_key = res[0], res[1], res[-1]
    res = res[:-1]
    l_spread = max(abs(r[0] - lc) for r in res[2:])
    if not abs(lg - lc) <= 1e-3 * abs(lc):
        raise AssertionError(f"mxsr supervised loss card {lg} cpu {lc}")
    worst = (0.0, 0.0, None)
    errs, spreads, keyed = [], [], []
    for name, r in gc.items():
        if _zero_grad_bias(name) or not bool(r.any()):
            continue
        err = float((gg[name] - r).norm() / r.norm())
        spread = max(float((g[name] - r).norm() / r.norm())
                     for _, g in res[2:])
        errs.append(err)
        spreads.append(spread)
        keyed.append(float((other_key[1][name] - r).norm() / r.norm()))
        if not err <= 2 * spread + 5e-2:
            raise AssertionError(f"mxsr gradient of {name}: card vs cpu "
                                 f"{err} of the norm, cpu spread {spread}")
        if err / (spread + 1e-30) >= worst[0] / (worst[1] + 1e-30):
            worst = (err, spread, name)
    return dict(loss=(lg, lc), loss_spread=l_spread, worst=worst,
                medians=tuple(float(np.median(v))
                              for v in (errs, spreads, keyed)))


def convex_grad_card_vs_cpu(options=None):
    """dLoss/dX of the convex loss on two of ``structured_embeddings``
    (2 and 4 clusters) at N=2048, card against CPU, with its default terms
    or with the convex-loss ``options`` and one entropy subsample and
    jitter, drawn on the CPU, on both sides.  One mean-shift step: after
    more, each cluster's modes agree to f32 rounding and which of them
    becomes the center is a rounding tie, so the gradient would flow
    through different rows.  The center ids are asserted equal first;
    then, with the eigenvector signs aligned, the loss within 1e-5
    relative (1e-4 with options) and the gradient within 1e-3 of its
    largest entry (f32 clustering, fit and chamfer in other sum orders).
    With options the intersection term (several clusters a shape) must be
    nonzero and within 1e-4 relative."""
    from prifit_torch.clustering.mean_shift import mean_shift_iterations, \
        nms_fixed_slots
    from prifit_torch.geometry.convex_loss import convex_loss
    X, expected = structured_embeddings(5)
    X, expected = X[:2], expected[:2]
    pts = torch.from_numpy(np.random.default_rng(7).normal(
        size=(2, N, 3)).astype(np.float32))
    kw = dict(quantile=0.05, iterations=1, max_num_clusters=25,
              n_per_prim=256, num_bandwidth_candidates=2, **(options or {}))
    draws = {}
    if options:
        gen = torch.Generator().manual_seed(9)
        draws = dict(entropy_sub=torch.randperm(N, generator=gen)[:N // 4],
                     jitter=torch.rand(pts.shape, generator=gen) * 0.2)
    res = {}
    for dev in ("cuda", "cpu"):
        Xd = X.to(dev).requires_grad_()
        with eigh_signs_from_card():
            out = convex_loss(pts.to(dev), pts.to(dev), Xd, **kw,
                              **{k: v.to(dev) for k, v in draws.items()})
        out.total.backward()
        with torch.no_grad():
            Xn = Xd / Xd.norm(dim=2, keepdim=True)
            bw = out.clusters.bandwidth
            modes = mean_shift_iterations(Xn, bw, kw["iterations"])
            ids = nms_fixed_slots(modes, bw, kw["max_num_clusters"])[0]
        res[dev] = (out.total.item(), Xd.grad.cpu(), ids.cpu(),
                    out.clusters.num_clusters.cpu().tolist(),
                    out.intersection.item())
    (lg, gg, ig, ng, xg), (lc, gc, ic, nc, xc) = res["cuda"], res["cpu"]
    if not (ng == nc == expected):
        raise AssertionError(f"clusters card {ng} cpu {nc} expected "
                             f"{expected}")
    if not torch.equal(ig, ic):
        raise AssertionError("center ids differ card vs cpu")
    if not abs(lg - lc) <= (1e-4 if options else 1e-5) * abs(lc):
        raise AssertionError(f"convex loss card {lg} cpu {lc}")
    if options and not (xc != 0 and abs(xg - xc) <= 1e-4 * abs(xc)):
        raise AssertionError(f"intersection card {xg} cpu {xc}")
    err = (gg - gc).abs().max().item()
    if not err <= 1e-3 * gc.abs().max().item():
        raise AssertionError(f"dLoss/dX card vs cpu max abs err {err}")
    return lg, lc, err, gc.abs().max().item(), nc, (xg, xc)


def options_train_card_vs_cpu(entry):
    """One B=2 f32 self-sup step with every option
    (``entry.SELFSUP_OPTIONS``), for ellipsoids and for cuboids, on the
    card and on the CPU from the same seeded weights, dropout off and FPS
    from index 0, with one entropy subsample and jitter, drawn on the CPU,
    on both sides and the eigenvector signs aligned: ss_loss and chamfer
    within 1e-4 relative, as the bench self-sup step's check.  With random
    weights each shape has 1 cluster, so the intersection term is 0 here
    (``convex_grad_card_vs_cpu`` holds it where it is not); the entropy
    term is not."""
    from prifit_torch.train.steps import make_selfsup_step
    ts = entry.TRAIN_SETTINGS
    gen = torch.Generator().manual_seed(13)
    sub = torch.randperm(N, generator=gen)[:N // 4]
    jitter = torch.rand((2, N, 3), generator=gen) * 0.2
    out = {}
    for cuboid in (False, True):
        res = {}
        for dev in ("cuda", "cpu"):
            state, points, cls, _ = entry.train_flagship(
                2, N, device=dev, compute_dtype="f32")
            state.model.dropout_rate = 0.0
            step = make_selfsup_step(
                **entry.BENCH_KWARGS, **entry.SELFSUP_OPTIONS,
                if_cuboid=cuboid, entropy_sub=sub.to(dev),
                jitter=jitter.to(dev))
            with eigh_signs_from_card():
                _, m = step(state, points, cls, points, ts["lr"],
                            ts["bn_momentum"], ts["lmbda"])
            res[dev] = (m["ss_loss"].item(), m["chamfer_loss"].item())
        for i, what in enumerate(("ss_loss", "chamfer")):
            a, b = res["cuda"][i], res["cpu"][i]
            if not abs(a - b) <= 1e-4 * abs(b):
                raise AssertionError(f"self-sup {what} with every option "
                                     f"(cuboid {cuboid}) card {a} cpu {b}")
        out["cuboid" if cuboid else "ellipsoid"] = res
    return out


def contrastive_card_vs_cpu(entry):
    """One B=2 f32 contrastive step on the card and on the CPU from the
    same seeded weights, dropout off and FPS from index 0, on the same
    ACD-like labels, with one set of the negatives' uniforms, drawn on the
    CPU, on both sides: the loss within 1e-5 relative and every gradient
    within 5e-2 of the CPU gradient's norm, the limits of the f32
    supervised check (``train_card_vs_cpu``)."""
    from prifit_torch.models.pointnet2_part_seg_msg import get_selfsup_loss
    from prifit_torch.train.steps import make_contrastive_step
    ts = entry.TRAIN_SETTINGS
    u = torch.rand((2, N, N), generator=torch.Generator().manual_seed(14))
    res = {}
    for dev in ("cuda", "cpu"):
        state, points, cls, _ = entry.train_flagship(
            2, N, device=dev, compute_dtype="f32")
        state.model.dropout_rate = 0.0
        labels = entry.acd_labels(points.cpu()).to(dev)
        _, m = make_contrastive_step(get_selfsup_loss, margin=0.5)(
            state, points, cls, labels, ts["lr"], ts["bn_momentum"],
            ts["lmbda"], uniforms=u.to(dev))
        res[dev] = (m["ss_loss"].item(),
                    {n: p.grad.float().cpu()
                     for n, p in state.model.named_parameters()})
    (lg, gg), (lc, gc) = res["cuda"], res["cpu"]
    if not abs(lg - lc) <= 1e-5 * abs(lc):
        raise AssertionError(f"contrastive loss card {lg} cpu {lc}")
    err = _worst_grad_err(gg, gc, "contrastive card vs cpu")
    if not err <= 5e-2:
        raise AssertionError(f"contrastive gradients card vs cpu: largest "
                             f"error {err} of the norm")
    return lg, lc, err


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


def slot_perm(lg, lc, what):
    """Slot labels ``lg`` and ``lc`` of the same points must make the same
    partition: returns ``lg``'s slots and the ``lc`` slot each maps to,
    or raises."""
    slots = torch.unique(lg)
    perm = []
    for k in slots:
        targets = torch.unique(lc[lg == k])
        if len(targets) != 1:
            raise AssertionError(f"{what}: a slot spans slots "
                                 f"{targets.tolist()} of the other side")
        perm.append(int(targets[0]))
    perm = torch.tensor(perm)
    if len(set(perm.tolist())) != len(slots) or not torch.equal(
            perm[torch.searchsorted(slots, lg)], lc):
        raise AssertionError(f"{what}: partitions differ")
    return slots, perm


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
    for b in range(g.labels.shape[0]):
        slots, perm = slot_perm(g.labels[b], c.labels[b], f"shape {b}")
        w_err = max(w_err, (g.weights[b][:, slots] - c.weights[b][:, perm])
                    .abs().max().item())
        c_err = max(c_err, (g.centers[b][slots] - c.centers[b][perm])
                    .abs().max().item())
    if not (w_err <= 1e-4 and c_err <= 1e-3):
        raise AssertionError(f"cluster_batch weights err {w_err}, centers "
                             f"err {c_err}")
    return w_err, c_err


def clusters_card_vs_cpu(entry, X, expected):
    """``cluster_batch`` at the main path's settings on embeddings ``X``
    with the cluster counts ``expected``, on the card (the three
    clustering kernels, multi-cluster NMS and the retry) and on the CPU
    (plain versions): :func:`same_clustering`."""
    from prifit_torch.clustering.mean_shift import cluster_batch
    kw = entry.BENCH_KWARGS
    g, c = (cluster_batch(X.to(dev), quantile=kw["quantile"],
                          iterations=kw["msc_iterations"],
                          max_num_clusters=kw["max_num_clusters"],
                          num_candidates=kw["num_bandwidth_candidates"])
            for dev in ("cuda", "cpu"))
    g = type(g)(*(t.cpu() for t in g))
    return same_clustering(g, c, expected)


def narrow_embeddings(seed, shape=(RB, 2500, 8), sizes=(2, 3, 5, 8)):
    """``shape`` embeddings as the fitting demo makes them, one-hot-like
    rows of width 8: shape b has ``sizes[b]`` equal clusters around
    orthogonal directions (magnitude 4, noise 0.15, shuffled), with the
    expected cluster counts."""
    rng = np.random.default_rng(seed)
    Bq, Nq, D = shape
    X = np.empty(shape, np.float32)
    for b, k in enumerate(sizes):
        lab = rng.permutation(np.arange(Nq) % k)
        X[b] = 4.0 * np.eye(D, dtype=np.float32)[lab] + rng.normal(
            size=(Nq, D)) * 0.15
    return torch.from_numpy(X), list(sizes)


# per-kernel numbers beyond the common ones: the mean-shift backward's on
# sparse cotangents, NMS's on each input, the gather's device-only time and
# its time with int32 indices, bandwidth's f32 bound and its time on rows
# that are all equal, and FPS's time per call (events and device-only), per
# step and launch shapes
EXTRA_KEYS = ("sparse", "inputs", "device_ms", "int32_ms", "bound_f32_ms",
              "equal_rows_ms", "per_call_ms", "us_per_step", "launch_shapes")
# what each kernel phase times
CALLS_OF = {"mean_shift_bwd": "one self-sup step",
            "max_bwd_cnt_gsm": "one mxsr train step",
            "max_bwd_dz": "one mxsr train step",
            "sr_bf16": "one mxsr supervised step"}
# the helper kernel has no TPU counterpart: in the JAX package the cast is
# an XLA fusion
SR_REPLACES = "prifit_tpu/nn/mixed.py:115 (sr_bf16, an XLA fusion)"


def log_kernels(results, smi):
    for name, r in results.items():
        log(f"{name}: max_abs_err {r['max_abs_err']:.3g} kernel_ms "
            f"{r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms "
            f"{r['library_ms']} bound_ms {r['bound'][0]:.4f} "
            f"({r['bound'][1]}) [calls of "
            f"{CALLS_OF.get(name, 'one forward')}, {smi}]")
        for sp in r.get("sparse", ()):
            log(f"  {name}, {sp['live_rows']} live rows a shape: max_abs_err "
                f"{sp['max_abs_err']:.3g} kernel_ms {sp['ms']:.4f} plain_ms "
                f"{sp['plain_ms']:.4f} bound_ms {sp['bound_ms']:.4f} "
                f"({sp['bound_by']}); {r['ms'] / sp['ms']:.1f}x faster than "
                f"dense")


def _ms(walls):
    return f"{sorted(walls)[len(walls) // 2] * 1e3:.1f}"


def _spread(walls):
    """The median, quartiles and range of ``walls`` (seconds) in ms."""
    q = np.percentile(np.asarray(walls) * 1e3, [0, 25, 50, 75, 100])
    return (f"median {q[2]:.1f} of {len(walls)}, quartiles {q[1]:.1f}-"
            f"{q[3]:.1f}, range {q[0]:.1f}-{q[4]:.1f}")


def log_trainer(tr, smi):
    walls, bare = tr["walls"], tr["bare"]
    it = sorted(walls)[len(walls) // 2]
    steps = bare["supervised"] + bare["selfsup"]
    log(f"trainer B={B} N={N} (train_partseg.main, mxsr, "
        f"{TRAINER_ITERS} iterations): {it * 1e3:.1f} ms an iteration "
        f"({_spread(walls)}, the first left out), bare steps "
        f"{bare['supervised'] * 1e3:.1f} + {bare['selfsup'] * 1e3:.1f} = "
        f"{steps * 1e3:.1f} ms (this call's medians), host pipeline gap "
        f"{(it - steps) * 1e3:+.1f} ms ({100 * (it / steps - 1):+.1f}%) "
        f"[{smi}]; waiting for the prefetched batches "
        f"({_spread(tr['waits'])}); launches an iteration {tr['last']}; "
        f"launches in the run "
        f"(with the final eval) {tr['counts']}; final eval "
        f"{tr['metrics']}; trees written in {tr['write_s']:.1f} s")
    own = tr["own_steps"]
    log(f"trainer breakdown: the host pipeline alone (loaders and batch "
        f"transforms, serial, no step) {tr['host'] * 1e3:.1f} ms an "
        f"iteration; the trainer's steps on its own batches with no "
        f"pipeline beside them {own['supervised'] * 1e3:.1f} + "
        f"{own['selfsup'] * 1e3:.1f} = "
        f"{(own['supervised'] + own['selfsup']) * 1e3:.1f} ms [{smi}]")
    r = tr["resume"]
    log(f"trainer resume: epoch, step {r['step']} and beta restored (beta "
        f"{tr['beta']:.6f} after epoch 1, {r['beta']:.6f} after epoch 2); "
        f"{_ms(r['walls'])} ms an iteration")
    for name, (extra, _) in TRAINER_VARIANTS.items():
        v = tr[name]
        log(f"trainer {' '.join(extra)}: {_ms(v['walls'])} ms an iteration "
            f"({_spread(v['walls'])}), waiting "
            f"for batches {_ms(v['waits'])} ms [{smi}]; launches an "
            f"iteration {v['last']}")
    ev = tr["eval"]
    w = sorted(ev["walls"])[1]
    log(f"trainer eval (evaluation() of the checkpoint, {ev['clouds']} test "
        f"clouds at B={B}): {w * 1e3:.1f} ms, {ev['clouds'] / w:.1f} "
        f"clouds/s (median of 3) [{smi}]")
    c = tr["card_vs_cpu"]
    log(f"trainer eval CLI card vs cpu: instance-avg mIoU "
        f"{c['card']['instance_avg_iou']:.6f} / "
        f"{c['cpu']['instance_avg_iou']:.6f}, class-avg mIoU "
        f"{c['card']['class_avg_iou']:.6f} / {c['cpu']['class_avg_iou']:.6f}"
        f", accuracy {c['card']['accuracy']:.6f} / "
        f"{c['cpu']['accuracy']:.6f}")


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
    results["nms"] = check_nms(X, bw)
    del X, kth
    check_ragged()
    results.update(check_max_bwd())
    log_kernels(results, smi)

    counts, times, out = main_path(entry, kernels)
    t = sorted(times)[1]
    log(f"main path B={B} N={N}: forward {t * 1e3:.1f} ms (median of 3), "
        f"{B / t:.1f} clouds/s [{smi}]; launches in 3 forwards {counts}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"num_clusters "
        f"{out.convex.clusters.num_clusters.tolist()}; total_loss "
        f"{out.total_loss.item():.6f}")
    del out

    err, nc, lg, lc = card_vs_cpu(entry)
    log(f"card vs cpu B=2: logits max abs err {err:.3g}, num_clusters "
        f"{nc}, total_loss {lg:.6f} (card) {lc:.6f} (cpu)")
    for what, (X, nc) in (("structured", structured_embeddings(5)),
                          ("narrow", narrow_embeddings(12))):
        w_err, c_err = clusters_card_vs_cpu(entry, X, nc)
        log(f"card vs cpu cluster_batch {tuple(X.shape)}, {what}: "
            f"num_clusters {nc} equal, same partitions, weights err "
            f"{w_err:.3g}, centers err {c_err:.3g}")

    train = {dt: train_path(entry, kernels, dt) for dt in ("auto", "f32")}
    for dt, tr in train.items():
        for name in ("supervised", "selfsup"):
            r = tr[name]
            t = sorted(r["times"])[1]
            log(f"train path B={B} N={N} {dt}, {name} step: "
                f"{t * 1e3:.1f} ms (median of 3; "
                f"{', '.join(f'{x * 1e3:.1f}' for x in r['times'])}), "
                f"{B / t:.1f} clouds/s [{smi}]; peak memory "
                f"{r['peak'] / 2**30:.2f} GiB; launches in 3 steps "
                f"{r['counts']}; last metrics {r['metrics']}")
    numels = train["auto"]["sr_numels"]
    results["sr_bf16"] = check_sr_bf16(numels)
    log(f"sr_bf16 casts of one mxsr supervised step: {len(numels)}, "
        f"{sum(numels) / 1e6:.1f} M elements, the largest "
        f"{max(numels) / 1e6:.1f} M")
    log_kernels({"sr_bf16": results["sr_bf16"]}, smi)
    top, share = train["f32"]["g_rows"]
    log(f"mean-shift backward cotangent g on the self-sup path: at most "
        f"{top} of {N} rows nonzero in a shape, {100 * share:.3f}% of rows "
        f"on average over its launches")
    objectives = objective_paths(entry, kernels)
    for name, r in objectives.items():
        t = sorted(r["times"])[1]
        log(f"train path B={B} N={N} {name}: {t * 1e3:.1f} ms (median of "
            f"3; {', '.join(f'{x * 1e3:.1f}' for x in r['times'])}), "
            f"{B / t:.1f} clouds/s [{smi}]; peak memory "
            f"{r['peak'] / 2**30:.2f} GiB; launches in 3 steps "
            f"{r['counts']}; last metrics {r['metrics']}")
        if "g_rows" in r:
            top, share = r["g_rows"]
            log(f"  mean-shift backward cotangent g on {name}: at most "
                f"{top} of {N} rows nonzero in a shape, {100 * share:.3f}% "
                f"of rows on average over its launches")
    bare = {name: sorted(train["auto"][name]["times"])[1]
            for name in ("supervised", "selfsup")}
    tr = trainer_phase(kernels, bare)
    log_trainer(tr, smi)
    tc = train_card_vs_cpu(entry)
    log(f"card vs cpu train B=2 f32: supervised loss {tc['loss'][0]:.7f} "
        f"(card) {tc['loss'][1]:.7f} (cpu) {tc['loss'][2]:.7f} (cpu f64), "
        f"largest gradient error of the norm "
        f"{ {k: round(v, 6) for k, v in tc['grad_err'].items()} }; "
        f"self-sup ss_loss "
        f"{tc['ss_loss'][0]:.7f} / {tc['ss_loss'][1]:.7f}, chamfer "
        f"{tc['chamfer'][0]:.7f} / {tc['chamfer'][1]:.7f}")
    mc = mxsr_train_card_vs_cpu(entry)
    err, spread, name = mc["worst"]
    log(f"card vs cpu train B=2 mxsr, same base key: supervised loss "
        f"{mc['loss'][0]:.7f} (card) {mc['loss'][1]:.7f} (cpu), cpu spread "
        f"under the input x (1 +- 2^-20, 2^-19) {mc['loss_spread']:.3g}; "
        f"largest gradient error against its cpu spread: {err:.4f} of the "
        f"norm ({name}; cpu spread there {spread:.4f}); medians over the "
        f"parameters: card vs cpu {mc['medians'][0]:.4f}, cpu spread "
        f"{mc['medians'][1]:.4f}, another key {mc['medians'][2]:.4f}")
    for what, options in (
            ("default terms", None),
            ("every option", entry.SELFSUP_OPTIONS),
            ("every option, cuboids", dict(entry.SELFSUP_OPTIONS,
                                           if_cuboid=True))):
        lg, lc, err, top, nc, (xg, xc) = convex_grad_card_vs_cpu(options)
        log(f"card vs cpu convex loss gradient, structured B=2 N={N}, "
            f"{what}: num_clusters {nc}, same center ids, loss {lg:.7f} / "
            f"{lc:.7f}, intersection {xg:.7g} / {xc:.7g}, dLoss/dX max abs "
            f"err {err:.3g} (largest entry {top:.3g})")
    for kind, res in options_train_card_vs_cpu(entry).items():
        log(f"card vs cpu train B=2 f32, self-sup with every option, "
            f"{kind}s: (ss_loss, chamfer) {res['cuda']} (card) "
            f"{res['cpu']} (cpu)")
    lg, lc, err = contrastive_card_vs_cpu(entry)
    log(f"card vs cpu train B=2 f32, contrastive: loss {lg:.7f} (card) "
        f"{lc:.7f} (cpu), largest gradient error {err:.4g} of the norm")

    paths = {"eval_forward": counts}
    for dt, tag in (("auto", "mxsr"), ("f32", "f32")):
        paths[f"supervised_step_{tag}"] = train[dt]["supervised"]["counts"]
        paths[f"selfsup_step_{tag}"] = train[dt]["selfsup"]["counts"]
    paths.update({name: r["counts"] for name, r in objectives.items()})
    paths["trainer"] = tr["counts"]
    rows = []
    for name, k in kernels.KERNELS.items():
        r = results[name]
        rows.append(dict(
            name=name, route="cuda", source=k.source_path,
            replaces=k.replaces or SR_REPLACES, tpu_kernel=bool(k.replaces),
            launches=sum(c[name] for c in paths.values()),
            launches_by_path={p: c[name] for p, c in paths.items()},
            launches_per_trainer_iteration=tr["last"][name],
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
            bound_by=r["bound"][1], library_ms=r["library_ms"],
            **{k: r[k] for k in EXTRA_KEYS if k in r}))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
