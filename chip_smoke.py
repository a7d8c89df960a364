"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --four-cards   (only the four-card NCCL check)

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
with stochastic rounding on and off, bit for bit; the ``sr_bf16``
cast at the sizes one ``mxsr`` step casts, bit for bit; and the eval
epilogue ``bn_relu_eval`` at the 24 calls of the MSG eval forward and on
NaN and -0.0 inputs, bit for bit.  It holds the
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
  - the self-supervised pretrainer,
    ``prifit_torch.cli.pretrain_partseg.main`` with ``--model
    pretrain_pointnet2_part_seg_msg --l2_norm`` at B=24, N=2048 with the
    recipe's self-sup settings and the default dtype, on 240 synthetic
    ACD shapes of 6000 points, for 5 epochs of 8 iterations with 2 val
    batches each (``model_005``, ``best_model``, ``metrics.jsonl``; each
    iteration's and val batch's launches checked exactly); a contrastive
    pretrain epoch (no clustering kernel); ``train_partseg`` warm-started
    from the pretrain's ``best_model`` (the restored weights equal the
    file's before the first step) and ``train_partseg`` runs with
    ``--extra_layers`` and with ``--reconstruct``, 8 iterations each.
  - the trainer's other part-seg models (``models`` phase):
    ``train_partseg.main`` at B=24, N=2048 with the recipe's self-sup
    settings and the default dtype, 8 iterations each, for
    ``--model pointnet2_part_seg_ssg``, ``dgcnn`` (``--dgcnn_k`` 20),
    ``pointnet_part_seg`` and ``reconstruction`` (the last two with
    ``--ss_loss contrastive``), every iteration's launches checked
    exactly (``model_iteration_counts``), each beside its bare steps and
    with its peak memory, and ``cli/testing.py`` on each checkpoint on
    the card against the CPU.
  - the registry's other models and the ModelNet40 probe (``registry``
    phase, ``registry_phase``), on synthetic ModelNet40 (40 categories
    of 8 train and 2 test shapes of 2500 points with normals), S3DIS
    (areas 1-5) and ACD trees: ``pretrain_partseg.main --modelnet_val``
    at B=24, N=2048, the default dtype, 2 epochs of 4 iterations, each
    ending with the linear-SVM probe (launches of each iteration, val
    batch and probe checked exactly), with the probe's features and SVM
    on the card against the CPU; then 8 f32 Adam steps at B=24, N=1024
    of ``pointnet_cls``, ``pointnet2_cls_ssg`` and ``pointnet2_cls_msg``
    on ModelNet40 batches and 20 at B=16, N=4096 of ``pointnet_sem_seg``
    and ``pointnet2_sem_seg`` on S3DIS blocks (launches checked every
    step, block accuracy above 0.55 in one of the last 10), each with
    one f32 step card against CPU (xyz on an exact grid, and the MSG
    classifier's also off it, its ball queries compared); and FPS and
    the gather bit for bit at the registry's shapes (FPS 1024 -> 512 at
    B=24 and 4096 -> 1024 -> 256 -> 64 -> 16 at B=16; the gather at every
    table one forward of each PointNet++ model gives it).
  - the fitting demo (``fitting`` phase, ``fitting_phase``):
    ``prifit_torch.cli.fitting.main`` at the JAX defaults (B=16 scenes of
    3 ellipsoids of 500 points, 8-wide embeddings, quantile 0.01, 20
    mean-shift steps, 8 slots, 256 samples a primitive), 3 timed calls
    with exact launches (bandwidth 1, mean-shift 20 forward and 20
    backward, NMS 3 a call; the backward's cotangents live in at most 8
    rows a shape), the fitted axes within the JAX package's limits, the
    card against the CPU, and the four clustering kernels at its shapes.
  - the library surface (``library`` phase): the chamfer family,
    ``lstsq``, ``cluster_single`` (gaussian and epanechnikov, launches
    exact), ``compute_bandwidth``, the viz exporters and ``StepTimer``,
    card against CPU.
  - the encoder dtypes (``dtypes`` phase, ``dtype_phase``):
    ``--encoder_dtype`` ``bf16``, ``sa_bf16`` and ``mx`` and
    ``--stage_dtypes`` all-stage ``fq``, all-stage ``q`` and
    ``sa1:bf16,fp2:q``, the supervised and the self-sup step of each at
    B=24, N=2048 (a warm-up and 3 timed, launches exact: the K-max pair 6
    times a step under ``mx`` only, ``sr_bf16`` never), and one B=2
    supervised step each card against CPU within twice the CPU's own
    spread; and in the trainer phase an 8-iteration ``train_partseg``
    run with ``--encoder_dtype mx`` (the K-max pair 12 times an
    iteration, ``sr_bf16`` never).
  - the f32-storage K-max region (``max_region`` phase,
    ``max_region_phase``; the JAX package's ``PRIFIT_MAX_REGION=on``):
    kernels #7 and #8 at f32 storage bit for bit against their plain
    versions at the five SA-scale regions of one f32 step (B=24,
    N=2048), and refusing other storage dtypes; the f32 supervised step
    with the region on and off from the same weights (first-step loss
    and gradients agree; a warm-up and 3 timed steps each; the K-max
    pair exactly 5 times a step with the region, never without); and a
    B=2 step with the region, card against CPU.
  - data and point parallelism (``parallel`` phase, ``parallel_phase``):
    ``entry.dryrun_multichip`` in one process and on a one-rank NCCL
    group (the same losses); then two ranks on the one card (NCCL if it
    takes two ranks on one device, else gloo with host transfers; the
    phase logs which and why), ``cluster_and_fit_point_sharded`` on
    4-blob embeddings and two ``--sp_points 2`` self-sup steps at B=24,
    N=2048 at the default dtype (FPS, gather, the K-max pair under
    ``mxsr``, bandwidth and NMS on the gathered modes on the card), held
    against world size 1 and the unsharded clustering and self-sup
    step.
  - the few-shot lift experiment (``lift`` phase, ``lift_phase``): the
    port's generator writes a reduced lift benchmark (8 categories of 12
    labelled shapes and 96 ACD shapes, N=2048), then
    ``prifit_torch.tools.run_fewshot_matrix`` at k=1, seed 786, arms
    ``sup``, ``con`` and ``pre_con`` (a 1-epoch contrastive pretrain) for
    2 epochs of 8 iterations at B=8, each record well formed, every
    iteration's launches exact; then ``prifit_torch.tools.
    probe_embedding`` on 8 test shapes in ``feat`` space at random init
    and on the pretrain's ``best_model``, each batch's launches exact
    (bandwidth 1, mean-shift 10, NMS 3), in under 150 s.
  - the ball-query A/B and the bf16 bisection (``tools`` phase,
    ``tools_phase``): ``prifit_torch.tools.ab_ball_query.run`` at B=16,
    N=1024 for 6 steps at the default dtype, fused and first-k by index,
    seed 0 (each step's launches exact: FPS 2, gather 10, the K-max pair
    6 each, ``sr_bf16`` 40; the held-out forward FPS 2, gather 10); then
    ``prifit_torch.tools.run_bf16_bisect`` on a reduced lift tree with
    ``--modes bf16,fq --full_encoders mxsr``, one seed, one epoch of 3
    iterations at B=24, N=2048 (seven runs; each record well formed, each
    iteration's launches exact: FPS 2 and gather 10, and at ``mxsr`` the
    K-max pair and ``sr_bf16`` as above), in under 150 s.

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
(the loss and every gradient), each with the same draws on both sides;
and for the pretrainer's models one B=2 f32 self-sup step each of the
pretrain model with ``l2_norm`` and of ``extra_layers``, on 3 blobs with
more than one cluster a shape (losses, every gradient and the returned
embedding, the pretrain one of unit rows), a ``reconstruct`` forward's
``total_loss`` and ``chamfer_loss_dense``; and for the trainer's other
models one B=2 f32 supervised step each and a DGCNN self-sup step on the
blobs (losses and every gradient).  The gather is also held bit for bit
at DGCNN's three tables and the K-max pair at SSG's sa1 region, and
DGCNN's two kNN graphs are timed.
It prints:

  - the card's name and power limit (nvidia-smi);
  - the paths' times, peak memory and launch counts;
  - the trainer's ms per iteration beside the bare steps' sum, its
    launches per iteration and the eval's clouds/s;
  - the pretrainer's ms per iteration beside the bare self-sup step and
    per val batch, with the launches of each;
  - one JSON line ``{"kernels": [...]}`` with, per kernel, its launches on
    the fifty-one paths (and their sum; ``max_region_f32`` the region's
    three timed f32 steps, ``parallel_dryrun`` the one-rank NCCL dry run,
    ``parallel_sp_cluster`` and ``parallel_sp_step`` rank 0's sharded
    clustering and its second point-SP step; ``fitting``, ``library`` and
    ``dtype_<mode>`` are those phases' runs, ``trainer_mx`` the trainer's
    ``--encoder_dtype mx`` run, ``trainer`` the whole first
    trainer run with its eval, ``pretrainer`` and ``pretrain_val`` the
    pretrain run's iterations and val batches, ``extra_layers`` and
    ``reconstruct`` those trainer runs, ``model_<name>`` the ``models``
    phase's runs, ``lift_<run>`` and ``lift_probe_<tag>`` the ``lift``
    phase's runs and probes, ``ab_<semantics>`` and ``bisect_<variant>``
    the ``tools`` phase's runs) and per trainer iteration, per pretrain
    iteration, per pretrain val batch and per iteration of each of the
    ``models``, ``lift`` and ``tools`` phases' runs (``probe`` is the two probes'
    launches of the ``registry`` phase, ``model_<name>`` also each
    registry model's run), its error against the
    plain version, and the times of the calls one forward or one step
    makes (kernel, plain version, library call) beside the least time the
    card could take for that work; ``sr_bf16`` has no TPU kernel (``tpu_kernel``
    false); the mean-shift backward's row also has, under ``sparse``, the
    same numbers for cotangents live in 1 and in 25 rows a shape, NMS's
    under ``inputs`` its numbers on each of its four inputs, the
    gather's its device-only time (``device_ms``) and its time with int32
    indices (``int32_ms``), bandwidth's its f32 bound
    (``bound_f32_ms``) and its time on rows that are all equal
    (``equal_rows_ms``), and FPS's each call's time (``per_call_ms``),
    device-only time (``device_ms``), device microseconds a step
    (``us_per_step``) and ``(T, P)`` (``launch_shapes``); FPS's and the
    gather's rows also their times at the registry's shapes
    (``registry``); the four clustering kernels' rows their numbers at
    the fitting demo's shapes (``fitting``) and the K-max pair's those of
    one ``mx`` step (``mx``) and of one f32 step's region at f32 storage
    (``f32_storage``);
  - as the last line, ``{"ok": true, "device": {...}}``.

With ``--four-cards`` (a machine with four cards) it builds the kernels
and runs only ``four_cards``: the dry run at world size 4, a
data-parallel ``mxsr`` supervised step at B=24, N=2048 over NCCL (6 a
rank) against one card's on the whole batch, and the point-SP
clustering and steps on a (1, 4) mesh against world size 1.

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


def check_gather_dgcnn():
    """The gather at DGCNN's three tables of one forward at B=24, N=2048
    and ``--dgcnn_k`` 20 (edge convolution 1 gathers the raw 3-wide
    cloud, 2 its 64-wide projection, 3 the raw 64-wide features, each by
    the ``[B, N, 20]`` int64 kNN graph), bit-equal to the plain version;
    times the three calls beside the plain version and ``torch.gather``.
    Returns ``(ms, plain_ms, library_ms, bound_ms)`` of the three."""
    from prifit_torch.kernels import gather
    gen = torch.Generator().manual_seed(16)
    calls = [(torch.randn((B, N, c), generator=gen).cuda(),
              torch.randint(0, N, (B, N, 20), generator=gen).cuda())
             for c in (3, 64, 64)]
    for t, i in calls:
        if not torch.equal(gather.gather_rows(t, i).view(torch.uint8),
                           gather.gather_plain(t, i).view(torch.uint8)):
            raise AssertionError(f"gather differs at DGCNN's table "
                                 f"{tuple(t.shape)}")
    lib_idx = [(t, i.reshape(B, -1, 1).expand(-1, -1, t.shape[-1]))
               for t, i in calls]
    byt = sum(nbytes(t, i) + i.numel() * t.shape[-1] * t.element_size()
              for t, i in calls)
    return (cuda_ms(lambda: [gather.gather_rows(t, i) for t, i in calls]),
            cuda_ms(lambda: [gather.gather_plain(t, i) for t, i in calls]),
            cuda_ms(lambda: [torch.gather(t, 1, i) for t, i in lib_idx]),
            bound_ms(byt, 0)[0])


def time_dgcnn_knn():
    """DGCNN's two kNN graphs of one forward at B=24, N=2048, k=20 (on
    the 3-wide cloud and on the 64-wide features): ms of each whole
    graph (the ``[B, N, N]`` distances and the port's stable full sort)
    and of its distances alone."""
    from prifit_torch.ops.pairwise import knn_with_dilation, \
        square_distance
    gen = torch.Generator().manual_seed(17)
    out = {}
    for c in (3, 64):
        x = torch.randn((B, N, c), generator=gen).cuda()
        out[c] = (cuda_ms(lambda: knn_with_dilation(x, 20, 20), reps=5),
                  cuda_ms(lambda: square_distance(x, x), reps=5))
    return out


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
# the three K-max regions of one SSG step: sa1 (512 centres, K = 32,
# F = 128), sa2 (128 centres, K = 64, F = 256) and sa3's group-all chain;
# the last two have MSG shapes
SSG_MAX_BWD_SHAPES = [(B * 512, 32, 128), (B * 128, 64, 256),
                      (B, 128, 1024)]
KEY_255, KEY_0 = (0x1234ABCD, 0x9E3779B9), (0xCAFEBABE, 12345)
# the kernels that only a train step's backward runs; the last three only
# at the mixed-precision dtypes
MIXED_ONLY = ("max_bwd_cnt_gsm", "max_bwd_dz", "sr_bf16")
TRAIN_ONLY = ("mean_shift_bwd",) + MIXED_ONLY
# launched by eval forwards alone: the eval epilogue, once a layer of the
# MSG encoder (24 an eval forward)
EVAL_ONLY = ("bn_relu_eval",)
BN_EVAL_CALLS = 24


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
    plain version does, and take the same hash bits); also at SSG's sa1
    region (``SSG_MAX_BWD_SHAPES``).  Times the six calls of one MSG
    ``mxsr`` step of each, and under ``"mx"`` those of one ``mx`` step
    (rounding off, an f32 cotangent); no single PyTorch call computes
    either function."""
    from prifit_torch.kernels import max_bwd
    gen = torch.Generator(device="cuda").manual_seed(7)
    timed = {}
    for sr in (True, False):
        k255, k0 = (KEY_255, KEY_0) if sr else (None, None)
        for shape in MAX_BWD_SHAPES + [
                sh for sh in SSG_MAX_BWD_SHAPES if sh not in MAX_BWD_SHAPES]:
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
            if shape in MAX_BWD_SHAPES:
                timed.setdefault(sr, []).append((args, dargs, cnt, gsm, dz))
            del x, cnt_p, gsm_p, dz_p
    out = {}
    for name, fn, plain, reads, writes in (
            ("max_bwd_cnt_gsm", lambda c: max_bwd.cnt_gsm(*c[0]),
             lambda c: max_bwd.cnt_gsm_plain(*c[0]),
             lambda c: c[0][:4], lambda c: (c[2], c[3])),
            ("max_bwd_dz", lambda c: max_bwd.dz(*c[1]),
             lambda c: max_bwd.dz_plain(*c[1]),
             lambda c: c[1][:7], lambda c: (c[4],))):
        for sr, calls in timed.items():
            ms = cuda_ms(lambda: [fn(c) for c in calls])
            plain_ms = cuda_ms(lambda: [plain(c) for c in calls], reps=3)
            # each input read once, each output written once; the f32
            # arithmetic (a compare per element for pass 1, six flops per
            # element for pass 2) is far below the byte time
            byt = sum(nbytes(*reads(c), *writes(c)) for c in calls)
            per_elem = 1 if name == "max_bwd_cnt_gsm" else 6
            ops = sum(per_elem * c[0][0].numel() for c in calls)
            r = dict(ms=ms, plain_ms=plain_ms, bound=bound_ms(byt, ops))
            if sr:
                out[name] = dict(max_abs_err=0.0, library_ms=None, **r)
            else:
                out[name]["mx"] = dict(ms=ms, plain_ms=plain_ms,
                                       bound_ms=r["bound"][0],
                                       bound_by=r["bound"][1])
    return out


class record_sr_calls:
    """While active, records the number of elements of every stochastic
    rounding cast the mixed-precision region makes (``nn/mixed.py``
    calls ``sr_bf16`` by that module's name)."""

    def __enter__(self):
        import prifit_torch.nn.mixed as mixed
        self.mixed, self.orig, self.numels = mixed, mixed.sr_bf16, []

        def sr_bf16(key, x, *a):
            self.numels.append(x.numel())
            return self.orig(key, x, *a)

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


class record_bn_eval_calls:
    """While active, keeps the arguments of every eval-epilogue call the
    encoder makes (``nn/pointnet2.py`` calls ``bn_relu_eval`` by that
    module's name): ``(z, mean, var, eps, weight, bias, dense_bias,
    storage, kmax)``."""

    def __enter__(self):
        import prifit_torch.nn.pointnet2 as p2
        self.p2, self.orig, self.calls = p2, p2.bn_relu_eval, []

        def bn_relu_eval(*args):
            self.calls.append(args)
            return self.orig(*args)

        p2.bn_relu_eval = bn_relu_eval
        return self

    def __exit__(self, *exc):
        self.p2.bn_relu_eval = self.orig


def _bn_eval_plain(args):
    from prifit_torch.kernels.bn_eval import bn_relu_eval_plain
    z, mean, var, eps, weight, bias, dense_bias, storage, kmax = args
    return bn_relu_eval_plain(z, mean, torch.rsqrt(var + eps), weight, bias,
                              dense_bias, storage, kmax)


def _bn_eval_odd_inputs(gen):
    """Calls on NaN and -0.0 inputs, with a zero BN weight and a -0.0 BN
    bias on the first 8 features (so that zeros of both signs reach the
    relu), in bf16 and f32 storage and from an f32 input rounded to bf16,
    with and without the K-max."""
    out = []
    F = 64
    mean = torch.randn(F, generator=gen, device="cuda") * 0.3
    var = torch.rand(F, generator=gen, device="cuda") + 0.1
    weight = torch.randn(F, generator=gen, device="cuda")
    bias = torch.randn(F, generator=gen, device="cuda")
    weight[:8], bias[:8] = 0.0, -0.0
    dense_bias = torch.randn(F, generator=gen, device="cuda")
    z = torch.randn((4, 33, F), generator=gen, device="cuda")
    z[0, 3, 5] = z[1, 7, 40] = float("nan")
    z[2, :, 10:20] = -0.0
    z[3, 5, :] = -0.0
    for src, storage in ((torch.bfloat16, None), (torch.float32, None),
                         (torch.float32, torch.bfloat16)):
        for db in (dense_bias, None):
            for kmax in (False, True):
                out.append((z.to(src), mean, var, 1e-5, weight, bias, db,
                            storage, kmax))
    return out


def check_bn_eval(entry):
    """The eval epilogue kernel (``bn_relu_eval``) against its plain
    version, bit for bit, at the 24 calls of the MSG eval forward at B=24,
    N=2048 (recorded from the flagship's forward with no gradient
    recorded; 6 with the K-max) and at the odd inputs of
    :func:`_bn_eval_odd_inputs`; times the forward's 24 calls together and
    each alone.  No single PyTorch call computes the function."""
    from prifit_torch.kernels import bn_eval as be
    model, points, cls = entry.flagship(B, N)
    with record_bn_eval_calls() as rec, torch.no_grad():
        model(points, cls)
    calls = rec.calls
    del model
    if len(calls) != BN_EVAL_CALLS or sum(bool(a[8]) for a in calls) != 6:
        raise AssertionError(f"the eval forward made {len(calls)} epilogue "
                             f"calls, {sum(bool(a[8]) for a in calls)} with "
                             f"the K-max, not 24 and 6")
    gen = torch.Generator(device="cuda").manual_seed(21)
    relu_zero = 0xFFFF & int(_bits(torch.relu(torch.tensor(
        [-0.0], dtype=torch.bfloat16, device="cuda")))[0])
    outs = []
    for i, args in enumerate(calls + _bn_eval_odd_inputs(gen)):
        got, want = be.bn_relu_eval(*args), _bn_eval_plain(args)
        if not (got.dtype == want.dtype and torch.equal(_bits(got),
                                                        _bits(want))):
            diff = int((_bits(got) != _bits(want)).sum()) \
                if got.shape == want.shape else "shape"
            raise AssertionError(
                f"bn_relu_eval differs from its plain version at call {i}: "
                f"z {tuple(args[0].shape)} {args[0].dtype}, storage "
                f"{args[7]}, dense bias {args[6] is not None}, kmax "
                f"{args[8]}: {diff} of {want.numel()} elements (relu(-0.0) "
                f"reads {relu_zero:#06x})")
        if i < len(calls):
            outs.append(got)
    ms = cuda_ms(lambda: [be.bn_relu_eval(*a) for a in calls])
    plain_ms = cuda_ms(lambda: [_bn_eval_plain(a) for a in calls], reps=3)
    # each call alone: CUDA events (at the small calls, the host's launch
    # time), and the kernel's device time from the profiler, the mean of
    # the launches it kept (one a call; a session may drop some)
    per_call = [cuda_ms(lambda a=a: be.bn_relu_eval(*a)) for a in calls]
    device = []
    for a in calls:
        us = [t for name, t in device_kernels(
            lambda a=a: be.bn_relu_eval(*a), reps=5)
            if "rows_kernel" in name or "max_kernel" in name]
        if not us:
            raise AssertionError("the profiler saw no bn_relu_eval kernel")
        device.append(sum(us) / len(us) / 1e3)
    # each input element read once at its dtype, each output written once,
    # and the parameters; 6-7 flops an element
    byt = sum(nbytes(a[0], o, *(t for t in (a[1], a[2], a[4], a[5], a[6])
                                if t is not None))
              for a, o in zip(calls, outs))
    ops = sum(7 * a[0].numel() for a in calls)
    shapes = [dict(z=list(a[0].shape), z_dtype=str(a[0].dtype),
                   storage=str(o.dtype), dense_bias=a[6] is not None,
                   kmax=bool(a[8]), ms=t, device_ms=d,
                   bound_ms=bound_ms(nbytes(a[0], o), 0)[0])
              for a, o, t, d in zip(calls, outs, per_call, device)]
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound=bound_ms(byt, ops), device_ms=sum(device),
                per_call_ms=shapes,
                relu_of_negative_zero=f"{relu_zero:#06x}")


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
    if counts["bn_relu_eval"] != BN_EVAL_CALLS * 3:
        raise AssertionError(f"bn_relu_eval launched "
                             f"{counts['bn_relu_eval']} times in 3 forwards, "
                             f"not once per BN layer")
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
    if c["bn_relu_eval"]:
        raise AssertionError(f"the eval epilogue launched "
                             f"{c['bn_relu_eval']} times in 3 {what} steps")
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
    missing = [k for k, v in c.items() if v == 0 and k not in EVAL_ONLY
               and (mixed or k not in MIXED_ONLY)]
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
                    "encoder_dtype_mx": (["--encoder_dtype", "mx"], 8),
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
    (which starts the prefetch streams), the counts of the whole run, of
    its last iteration and of each iteration."""
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
    per_iter = [{k: b[1][k] - a[1].get(k, 0) for k in counts}
                for a, b in zip([(0, {}, 0)] + marks, marks)]
    for k, v in metrics.items():
        if not np.isfinite(v) and k != "best_chamfer_loss":
            raise AssertionError(f"trainer metric {k} = {v}")
    if not 0.0 <= metrics["instance_avg_iou"] <= 1.0:
        raise AssertionError(f"trainer metrics {metrics}")
    return metrics, walls, counts, per_iter[-1], per_iter


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
        metrics, walls, counts, last, _ = _trainer_run(
            train_partseg, args, kernels)
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
        _, rwalls, _, _, _ = _trainer_run(train_partseg, args, kernels)
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
            _, vwalls, vcounts, vlast, vper = _trainer_run(
                train_partseg, vargs, kernels)
            clustering = [vlast[k] for k in CLUSTERING]
            if (name == "contrastive") == any(clustering) or not vlast["fps"]:
                raise AssertionError(f"{name} iteration launched {vlast}")
            # mx: the K-max pair 6 times a step with rounding off, twice
            # an iteration (supervised and self-sup), no rounding cast
            if name == "encoder_dtype_mx" and any(
                    (c["max_bwd_cnt_gsm"], c["max_bwd_dz"], c["sr_bf16"])
                    != (12, 12, 0) for c in vper):
                raise AssertionError(f"{name} iterations launched {vper}")
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


# the pretrainer phase: ACD shapes (8 iterations an epoch and 2 val
# batches at B), epochs, the ShapeNet-Part shapes a category of its
# fine-tuning tree, and the iterations of each trainer run
PRETRAIN_SHAPES = 240
PRETRAIN_EPOCHS = 5
FINETUNE_SHAPES = 16
VARIANT_ITERS = 8
PRETRAIN_FLAGS = ["--model", "pretrain_pointnet2_part_seg_msg", "--l2_norm"]


def expected_step_counts(r, backward=True):
    """One ``mxsr`` self-sup step's launches (``backward``) or one eval
    forward's with the convex loss, where the clustering ran ``r``
    bandwidth candidates for some shape (2 when a shape overflowed the 25
    slots at the first)."""
    c = {"fps": 2, "gather": 10, "bandwidth": r, "mean_shift": 10 * r,
         "nms": 3 * r, "mean_shift_bwd": 10 * r if backward else 0,
         "max_bwd_cnt_gsm": 6 if backward else 0,
         "max_bwd_dz": 6 if backward else 0,
         "sr_bf16": 40 if backward else 0,
         "bn_relu_eval": 0 if backward else BN_EVAL_CALLS}
    return c


def _check_counts(got, what, backward=True):
    """``got`` is one step's or val batch's launches for 1 or 2 bandwidth
    candidates; returns that number."""
    for r in (1, 2):
        if got == expected_step_counts(r, backward):
            return r
    raise AssertionError(f"{what} launched {got}, not "
                         f"{expected_step_counts(1, backward)}")


def _pretrain_run(pretrain, args, kernels):
    """``pretrain.main(args)`` on the card with the launch counts reset
    just before; per train iteration, per val batch and per ModelNet40
    probe (through its hooks, after a synchronize) the wall clock and the
    counts.  Returns the best val loss, the iteration walls within an
    epoch (an epoch's first iteration waits for its new prefetch stream,
    so the walls after it), the walls of each epoch's first val batch
    (which waits for the val stream's first batch) and of the others,
    each iteration's, val batch's and probe's launches, and each probe's
    result."""
    marks = []

    def mark(kind):
        def hook(epoch, i):
            torch.cuda.synchronize()
            marks.append((kind, epoch, i, time.perf_counter(),
                          kernels.launch_counts()))
        return hook

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    zero = kernels.launch_counts()
    best = pretrain.main(args, device="cuda", on_iteration=mark("it"),
                         on_val_batch=mark("val"), on_probe=mark("probe"))
    out = dict(best=best, total_s=time.perf_counter() - t0, walls=[],
               val_first_walls=[], val_walls=[], it_counts=[], val_counts=[],
               probe_counts=[], probes=[])
    prev = ("start", -1, -1, t0, zero)
    for m in marks:
        diff = {k: m[4][k] - prev[4][k] for k in zero}
        if m[0] == "probe":
            out["probe_counts"].append(diff)
            out["probes"].append(m[2])
        else:
            (out["it_counts"] if m[0] == "it" else
             out["val_counts"]).append(diff)
        if m[0] == "it" and prev[0] == "it" and prev[1] == m[1]:
            out["walls"].append(m[3] - prev[3])
        elif m[0] == "val":
            out["val_walls" if m[2] else "val_first_walls"].append(
                m[3] - prev[3])
        prev = m
    return out


def _sum_counts(counts):
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def pretrainer_phase(kernels, bare):
    """The self-supervised pretrainer (``python -m
    prifit_torch.cli.pretrain_partseg``) on the card at B=24, N=2048 with
    ``--model pretrain_pointnet2_part_seg_msg --l2_norm``, the recipe's
    self-sup settings and the default dtype (``mxsr``), on a synthetic
    ACD tree of ``PRETRAIN_SHAPES`` shapes of 6000 points (192 train, 8
    iterations an epoch; 48 val, 2 batches), for ``PRETRAIN_EPOCHS``
    epochs: it must write ``model_005``, ``best_model`` and one
    ``metrics.jsonl`` line an epoch; each iteration launches what one
    ``mxsr`` self-sup step does and each val batch what an eval forward
    with the convex loss does (:func:`expected_step_counts`); ``beta``
    decays once a step.  Then a contrastive pretrain epoch (no clustering
    kernel), ``train_partseg`` warm-started from the pretrain's
    ``best_model`` (the restored weights equal the file's before the
    first step; entries it lacks keep the fresh init) for
    ``VARIANT_ITERS`` iterations, and ``train_partseg`` runs with
    ``--extra_layers`` and with ``--reconstruct`` of ``VARIANT_ITERS``
    iterations, on a small ShapeNet-Part tree.  Times each iteration
    and val batch against ``bare``, the same call's bare-step medians."""
    import shutil
    import tempfile

    from prifit_torch.cli import pretrain_partseg, train_partseg
    from prifit_torch.cli.args_parser import parse_args

    os.makedirs(os.path.join(ROOT, "log"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pre_",
                           dir=os.path.join(ROOT, "log"))
    try:
        t0 = time.perf_counter()
        acd = write_acd_tree(os.path.join(tmp, "acd"), PRETRAIN_SHAPES)
        sn = write_shapenet_tree(os.path.join(tmp, "shapenet"),
                                 FINETUNE_SHAPES)
        out = {"write_s": time.perf_counter() - t0, "bare": bare}

        def pre_args(name, *extra):
            return parse_args(TRAINER_FLAGS + PRETRAIN_FLAGS + [
                "--ss_path", acd, "--experiment_root",
                os.path.join(tmp, name), *extra])

        args = pre_args("pretrain", "--epoch", str(PRETRAIN_EPOCHS))
        run = _pretrain_run(pretrain_partseg, args, kernels)
        exp = os.path.join(args.experiment_root, "pretrain_"
                           + train_partseg.experiment_name(args))
        names = sorted(os.listdir(os.path.join(exp, "checkpoints")))
        if names != ["best_model", f"model_{PRETRAIN_EPOCHS:03d}"]:
            raise AssertionError(f"pretrain checkpoints {names}")
        with open(os.path.join(exp, "metrics.jsonl")) as f:
            lines = [json.loads(line) for line in f]
        vals = [line["val_loss"] for line in lines]
        iters = len(run["it_counts"])
        if len(lines) != PRETRAIN_EPOCHS or not all(np.isfinite(vals)) \
                or run["best"] != min(vals) \
                or iters != PRETRAIN_EPOCHS * (PRETRAIN_SHAPES * 4 // 5 // B):
            raise AssertionError(f"pretrain metrics {lines}, {iters} "
                                 f"iterations")
        last = torch.load(os.path.join(exp, "checkpoints",
                                       f"model_{PRETRAIN_EPOCHS:03d}"),
                          weights_only=False)
        beta = last["model_state_dict"]["beta"].item()
        if last["step"] != iters or abs(beta - 0.99 ** iters) > 1e-6:
            raise AssertionError(f"pretrain step {last['step']} beta {beta}")
        run["retries"] = [_check_counts(c, f"pretrain iteration {i}") - 1
                          for i, c in enumerate(run["it_counts"])]
        run["val_retries"] = [
            _check_counts(c, f"pretrain val batch {i}", backward=False) - 1
            for i, c in enumerate(run["val_counts"])]
        run.update(vals=vals, beta=beta)
        out["pretrain"] = run

        cargs = pre_args("contrastive", "--epoch", "1", "--ss_loss",
                         "contrastive")
        crun = _pretrain_run(pretrain_partseg, cargs, kernels)
        for c in crun["it_counts"] + crun["val_counts"]:
            if any(c[k] for k in CLUSTERING) or c["fps"] != 2:
                raise AssertionError(f"a contrastive pretrain step "
                                     f"launched {c}")
        out["contrastive"] = crun

        # fine-tuning from the pretrain's best_model: the restore is
        # checked where the trainer makes it, before its first step
        best = os.path.join(exp, "checkpoints", "best_model")
        saved = torch.load(best, weights_only=False)["model_state_dict"]
        restore = train_partseg.restore_params_only
        restored = {}

        def checked_restore(d, n, state, log=print):
            fresh = {k: v.cpu().clone()
                     for k, v in state.model.state_dict().items()}
            state = restore(d, n, state, log=log)
            for k, v in state.model.state_dict().items():
                if not torch.equal(v.cpu(), saved.get(k, fresh[k])):
                    raise AssertionError(f"warm start: {k} differs")
            restored.update(n=len(fresh), from_file=sum(
                k in saved for k in fresh))
            return state

        def args_for(name, *extra):
            return parse_args(TRAINER_FLAGS + [
                "--data_root", sn, "--ss_path", acd, "--experiment_root",
                os.path.join(tmp, name), "--epoch", "1", "--epoch_iters",
                str(VARIANT_ITERS), *extra])

        train_partseg.restore_params_only = checked_restore
        try:
            fargs = args_for("finetune", "--pretrained_model", best)
            _, fwalls, fcounts, flast, _ = _trainer_run(
                train_partseg, fargs, kernels)
        finally:
            train_partseg.restore_params_only = restore
        if not restored or restored["from_file"] != restored["n"]:
            raise AssertionError(f"warm start restored {restored}")
        out["finetune"] = dict(walls=[w for w, _ in fwalls], counts=fcounts,
                               last=flast, restored=restored)

        for name in ("extra_layers", "reconstruct"):
            vargs = args_for(name, f"--{name}")
            _, vwalls, vcounts, vlast, _ = _trainer_run(
                train_partseg, vargs, kernels)
            missing = [k for k, v in vlast.items() if v == 0
                       and k not in EVAL_ONLY
                       and not (name == "extra_layers" and k == "sr_bf16")]
            if missing or vlast["fps"] != 4 \
                    or vlast["mean_shift_bwd"] != vlast["mean_shift"]:
                raise AssertionError(f"a {name} iteration launched {vlast}")
            out[name] = dict(walls=[w for w, _ in vwalls], counts=vcounts,
                             last=vlast)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# the trainer's other part-seg models: --model -> its flags beside
# TRAINER_FLAGS (the recipe's self-sup settings, --dgcnn_k at its default
# 20), and the kernels one iteration (a supervised step and a self-sup
# step) launches beside the clustering's
MODEL_RUNS = {
    "pointnet2_part_seg_ssg": ([], dict(fps=4, gather=10, max_bwd_cnt_gsm=3,
                                        max_bwd_dz=3, sr_bf16=30)),
    "dgcnn": ([], dict(gather=6)),
    "pointnet_part_seg": (["--ss_loss", "contrastive"], {}),
    "reconstruction": (["--ss_loss", "contrastive"], dict(fps=4, gather=20)),
}
MODEL_ITERS = 8


def model_iteration_counts(name, r):
    """The launches of one trainer iteration of ``--model name``, where
    the convex loss (``dgcnn`` only) ran ``r`` bandwidth candidates:

    - SSG at ``mxsr``: FPS twice and the gather 5 times a forward (sa1's
      xyz and its 3-wide features, sa2's projection, fp2, fp1), and in
      the supervised step's backward the K-max pair once per K-max
      region (sa1, sa2, sa3) and 30 rounding casts; its self-sup step has
      a zero loss and no backward;
    - DGCNN: the gather once per edge convolution (3 a forward), and in
      the self-sup step the clustering, as the MSG step's;
    - PointNet: no kernel;
    - reconstruction (f32): FPS twice and the gather 10 times a forward,
      as the MSG encoder's."""
    from prifit_torch import kernels
    c = dict.fromkeys(kernels.KERNELS, 0)
    c.update(MODEL_RUNS[name][1])
    if name == "dgcnn":
        c.update(bandwidth=r, mean_shift=10 * r, mean_shift_bwd=10 * r,
                 nms=3 * r)
    return c


def models_phase(kernels):
    """The trainer's other part-seg models through ``train_partseg.main``
    on the card at B=24, N=2048 and full width, the default dtype, with
    the recipe's self-sup settings (``MODEL_RUNS``), ``MODEL_ITERS``
    iterations each, on a small synthetic tree (``FINETUNE_SHAPES``
    shapes a category; the ACD tree of 48 shapes).  Every iteration's
    launches must equal :func:`model_iteration_counts` (DGCNN's with 1
    or 2 bandwidth candidates).  For each model: ms an iteration, its
    peak memory, the bare supervised and self-sup steps of that model on
    the trainer's own batches (:func:`trainer_breakdown`, which also
    checks the ``last_model`` restore), and ``cli/testing.py`` on its
    ``best_model`` on the card against the CPU (instance-avg mIoU within
    1e-2)."""
    import shutil
    import tempfile

    from prifit_torch.cli import testing, train_partseg
    from prifit_torch.cli.args_parser import parse_args

    os.makedirs(os.path.join(ROOT, "log"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_models_",
                           dir=os.path.join(ROOT, "log"))
    try:
        sn = write_shapenet_tree(os.path.join(tmp, "shapenet"),
                                 FINETUNE_SHAPES)
        acd = write_acd_tree(os.path.join(tmp, "acd"))
        out = {}
        for name, (extra, _) in MODEL_RUNS.items():
            args = parse_args(TRAINER_FLAGS + [
                "--model", name, "--data_root", sn, "--ss_path", acd,
                "--experiment_root", os.path.join(tmp, name), "--epoch", "1",
                "--epoch_iters", str(MODEL_ITERS), *extra])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            metrics, walls, counts, _, per_iter = _trainer_run(
                train_partseg, args, kernels)
            peak = torch.cuda.max_memory_allocated()
            retries = []
            for i, c in enumerate(per_iter):
                for r in (1, 2):
                    if c == model_iteration_counts(name, r):
                        retries.append(r - 1)
                        break
                else:
                    raise AssertionError(
                        f"{name} iteration {i} launched {c}, not "
                        f"{model_iteration_counts(name, 1)}")
            exp = os.path.join(args.experiment_root,
                               train_partseg.experiment_name(args))
            host, bare = trainer_breakdown(train_partseg, args, exp)
            targs = parse_args(TRAINER_FLAGS + [
                "--model", name, "--data_root", sn, *extra,
                "--pretrained_model",
                os.path.join(exp, "checkpoints", "best_model")])
            res = {side: testing.main(targs, device=dev, log=lambda *_: None)
                   for side, dev in (("card", "cuda"), ("cpu", "cpu"))}
            d_iou = abs(res["card"]["instance_avg_iou"]
                        - res["cpu"]["instance_avg_iou"])
            if not d_iou <= 1e-2:
                raise AssertionError(f"{name} eval card vs cpu: {res}")
            out[name] = dict(metrics=metrics, walls=[w for w, _ in walls],
                             counts=counts, last=per_iter[-1], peak=peak,
                             retries=retries, host=host, bare=bare,
                             card_vs_cpu=res)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def model_state(name, dev):
    """An f32 train state of ``--model name`` on ``dev``, built as the
    trainer builds it (``build_model``, seed 0, ``--dgcnn_k`` 20), with
    dropout off."""
    from prifit_torch.cli import train_partseg
    from prifit_torch.cli.args_parser import parse_args
    from prifit_torch.models import get_module
    from prifit_torch.train.state import create_train_state
    args = parse_args(["--model", name, "--encoder_dtype", "f32",
                       "--seed", "0"])
    mod = get_module(name)
    model = train_partseg.build_model(args, mod, dev)
    if hasattr(model, "dropout_rate"):
        model.dropout_rate = 0.0
    return create_train_state(model.train()), mod


def _model_zero_grad_bias(name):
    """Biases with an analytically zero gradient in the trainer's other
    models: those of :func:`_zero_grad_bias`, PointNet's dense biases a
    batch norm follows, and its ``bn5`` bias, whose shift reaches the
    head as one constant on every row ``bns1`` normalizes."""
    import re
    return _zero_grad_bias(name) or name == "bn5.bias" or (
        re.fullmatch(r"((f?stn)\.)?(conv\w+|fc[12])\.bias", name)
        is not None and name != "convs4.bias")


class dgcnn_graphs:
    """While active, DGCNN's kNN graphs are recorded (``graphs`` None at
    entry: each graph the port computes is kept, on the CPU) or replayed
    (``graphs`` a list: handed out in call order, on the caller's
    device)."""

    def __init__(self, graphs=None):
        self.graphs, self.record = ([], True) if graphs is None \
            else (list(graphs), False)

    def __enter__(self):
        import prifit_torch.nn.dgcnn as dg
        self.dg, self.orig = dg, {n: getattr(dg, n) for n in (
            "knn_with_dilation", "knn_points_normals")}
        it = iter(self.graphs)
        for name, fn in self.orig.items():
            def wrap(x, *a, fn=fn):
                if not self.record:
                    return next(it).to(x.device)
                idx = fn(x, *a)
                self.graphs.append(idx.cpu())
                return idx
            setattr(dg, name, wrap)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.dg, name, fn)


# the DGCNN self-sup comparison's precondition: the CPU's relative loss
# change under the input scaled by 1 +- 2^-20, well below its 1e-4 limit
DGCNN_SPREAD = 1e-5


def models_card_vs_cpu(entry):
    """Card against CPU at B=2, N=2048, f32, from the same seeded weights
    (dropout off, FPS from index 0): one supervised step of each of the
    trainer's other models (the loss within 1e-5 relative, every
    gradient within 5e-2 of the CPU gradient's norm, the limits of
    :func:`train_card_vs_cpu`), and a DGCNN self-sup step with the convex
    loss on the blob cloud (the recipe's clustering at quantile 0.15, see
    below; the eigenvector signs aligned): ss_loss within 1e-4 relative and every gradient within
    5e-2, once the CPU's own loss moves by at most ``DGCNN_SPREAD`` under
    the input scaled by 1 +- 2^-20 and each of the 3 blobs is a
    cluster.  A kNN graph is discrete,
    and cuBLAS and the CPU
    round the distances differently, so a near-tie may pick another
    neighbour: the supervised steps compute their own graphs on each
    side, the self-sup step runs on the CPU's graphs on both sides, and
    the card's own graphs give ``own_ss_loss``, with the share of its
    graph entries that differ (``graph_diff``), for the record."""
    from prifit_torch.train.steps import make_selfsup_step, \
        make_supervised_step
    ts = entry.TRAIN_SETTINGS
    # DGCNN's random-weight embedding is nearly constant within a blob,
    # so (a) after one mean-shift step, as the MSG variants take, the NMS
    # representative is a near-tie of member counts, and a 2^-20 change of
    # the input moves the loss by 0.3-3% (after 10 steps the modes
    # converge: 3e-6); (b) at the recipe's quantile 0.05 the bandwidth is
    # a chordal distance of about 0.03, whose square the bisection grid
    # (2^-22) and the 3xTF32 dot products resolve to about 3e-4, and the
    # card's loss was 1.35e-4 off the CPU's; (c) at 0.2 two of shape 0's
    # blobs merge into one cluster under the JAX package's init, whose
    # representative is a near-tie (a 2^-20 change of the input moves the
    # CPU's loss by 24%).  At 0.15 each blob is a cluster: the CPU's own
    # spread is checked before the card is compared.
    kwargs = dict(entry.BENCH_KWARGS, quantile=0.15)
    _, points, cls, target = entry.train_flagship(2, N, device="cpu",
                                                  compute_dtype="f32")
    blobs = blob_points()

    def cpu_forward(x):
        with torch.no_grad():
            return model_state("dgcnn", "cpu")[0].model(
                x, cls, chamfer_points=x, include_convex_loss=True,
                **kwargs).convex

    base = cpu_forward(blobs)
    nc = base.clusters.num_clusters
    spread = max(abs(cpu_forward(blobs * s).total.item() - base.total.item())
                 for s in SPREAD_SCALES[:2]) / base.total.item()
    if not bool((nc == 3).all()) or not spread <= DGCNN_SPREAD:
        raise AssertionError(f"dgcnn on the blobs: {nc} clusters (one a "
                             f"blob wanted), loss spread {spread:.3g} under "
                             f"the input x (1 +- 2^-20)")

    def selfsup(dev, graphs=None):
        state, _ = model_state("dgcnn", dev)
        b = blobs.to(dev)
        with eigh_signs_from_card(), dgcnn_graphs(graphs) as rec:
            _, m = make_selfsup_step(**kwargs)(
                state, b, cls.to(dev), b, ts["lr"], ts["bn_momentum"],
                ts["lmbda"])
        return (m["ss_loss"].item(),
                {n: p.grad.float().cpu()
                 for n, p in state.model.named_parameters()}), rec.graphs

    res = {}
    for side, dev in (("cpu", "cpu"), ("card", "cuda")):
        r = res[side] = {}
        for name in MODEL_RUNS:
            state, mod = model_state(name, dev)
            _, m = make_supervised_step(mod.get_loss)(
                state, points.to(dev), cls.to(dev), target.to(dev),
                ts["lr"], ts["bn_momentum"])
            r[name] = (m["loss"].item(),
                       {n: p.grad.float().cpu()
                        for n, p in state.model.named_parameters()})
    res["cpu"]["dgcnn_selfsup"], graphs = selfsup("cpu")
    res["card"]["dgcnn_selfsup"], _ = selfsup("cuda", graphs)
    (own_loss, _), own = selfsup("cuda")
    out = {"clusters": nc.tolist(), "spread": spread, "own_ss_loss": own_loss,
           "graph_diff": [float((a != b).float().mean())
                          for a, b in zip(own, graphs)]}
    for what, (lg, gg) in res["card"].items():
        lc, gc = res["cpu"][what]
        tol = 1e-4 if what == "dgcnn_selfsup" else 1e-5
        if not abs(lg - lc) <= tol * abs(lc):
            raise AssertionError(f"{what} loss card {lg} cpu {lc}")
        err = 0.0
        for n, rc in gc.items():
            if _model_zero_grad_bias(n):
                continue
            if not bool(rc.any()):
                if bool(gg[n].any()):
                    raise AssertionError(f"{what}: {n} has a gradient where "
                                         f"the CPU has none")
                continue
            err = max(err, float((gg[n] - rc).norm() / rc.norm()))
        if not err <= 5e-2:
            raise AssertionError(f"{what} gradients card vs cpu: largest "
                                 f"error {err} of the norm")
        out[what] = dict(loss=(lg, lc), grad_err=err)
    return out


def variant_state(dev, pretrain=False, xyz_gain=None, **kw):
    """An f32 train state of a model variant on ``dev`` from the seed-0
    weights, dropout off: the pretrain model (``pretrain``, with ``kw``
    such as ``l2_norm``), or ``pointnet2_part_seg_msg`` with ``kw``
    (``extra_layers``, ``reconstruct``); ``xyz_gain`` scales the weights
    on the xyz inputs of the first layer that reads fp1's skip
    (``fp1_embed_conv1`` under ``extra_layers``, else fp1's first
    conv)."""
    from prifit_torch.entry import init_weights
    from prifit_torch.models import pointnet2_part_seg_msg as msg
    from prifit_torch.models import pretrain_pointnet2_part_seg_msg as pre
    from prifit_torch.train.state import create_train_state
    mod = pre if pretrain else msg
    model = mod.get_model(num_parts=50, compute_dtype="f32",
                          dropout_rate=0.0, device="cpu", **kw)
    init_weights(model, torch.Generator().manual_seed(0))
    if xyz_gain is not None:
        layer = model.fp1_embed_conv1 if kw.get("extra_layers") \
            else model.fp1.mlp_convs[0]
        with torch.no_grad():
            layer.weight[:, 16:22] *= xyz_gain
    return create_train_state(model.to(dev).train())


def blob_points(n=N, seed=31):
    """``[2, n, 3]``: each cloud 3 gaussian blobs 4 apart (spread 0.3),
    so that an embedding that follows position gives 3 clusters."""
    rng = np.random.default_rng(seed)
    lab = np.arange(n) % 3
    return torch.as_tensor(np.stack([
        np.eye(3)[rng.permutation(lab)] * 4.0 + rng.normal(size=(n, 3)) * 0.3
        for _ in range(2)]).astype(np.float32))


# one mean-shift step, as the CPU tests of the variants: after two, the
# modes of a cluster agree to f32 rounding and which one is the center is
# a rounding tie that the card and the CPU may break differently
ONE_STEP = dict(quantile=0.05, msc_iterations=1, max_num_clusters=6,
                n_per_prim=256, num_bandwidth_candidates=2)


def variants_card_vs_cpu(entry, sides=(("card", "cuda"), ("cpu", "cpu"))):
    """Card against CPU at B=2, f32, the same draws on both sides
    (dropout off, FPS from index 0, the eigenvector signs aligned):

    - the pretrain model's self-sup step with ``l2_norm`` and an
      ``extra_layers`` self-sup step, each on the blob cloud with the
      xyz weights of the first layer after fp1's skip scaled by 30 so
      that the embedding follows position (more than 1 cluster a shape,
      asserted; with 1 the loss does not depend on the embedding, nor on
      ``l2_norm``, and the encoder's gradients are rounding noise), one
      mean-shift step: ss_loss and chamfer within 1e-4 relative, every
      gradient within 5e-2 of the CPU gradient's norm, and an eval
      forward's embedding within 1e-4 of the CPU's largest entry; the
      pretrain embedding's rows of norm 1 within 1e-5 (the convex loss
      normalizes the embedding itself, so ``l2_norm`` moves its loss
      only by rounding);
    - a ``reconstruct`` train-mode forward's ``total_loss`` (the convex
      loss plus the AtlasNet chamfer) within 1e-4 relative;
    - ``chamfer_loss_dense`` of 3025 against 2048 points within 1e-5
      relative."""
    from prifit_torch.models.common import chamfer_loss_dense
    from prifit_torch.train.steps import make_selfsup_step
    ts = entry.TRAIN_SETTINGS
    _, points, cls, _ = entry.train_flagship(2, N, device="cpu",
                                             compute_dtype="f32")
    blobs = blob_points()
    steps = {"pretrain": dict(pretrain=True, l2_norm=True),
             "extra_layers": dict(extra_layers=True)}
    res = {"clusters": {}}
    for what, kw in steps.items():
        with torch.no_grad():
            nc = variant_state("cpu", xyz_gain=30.0, **kw).model(
                blobs, cls, chamfer_points=blobs, include_convex_loss=True,
                **ONE_STEP).convex.clusters.num_clusters
        if not bool((nc > 1).all()):
            raise AssertionError(f"{what} on the blobs: {nc} clusters")
        res["clusters"][what] = nc.tolist()
    for side, dev in sides:
        r = res[side] = {}
        p, c, b = points.to(dev), cls.to(dev), blobs.to(dev)
        for what, kw in steps.items():
            state = variant_state(dev, xyz_gain=30.0, **kw)
            with torch.no_grad(), eigh_signs_from_card():
                r[what + "_embedding"] = state.model.eval()(
                    b, c, chamfer_points=b, include_convex_loss=True,
                    **ONE_STEP).embedding.cpu()
            state.model.train()
            with eigh_signs_from_card():
                _, m = make_selfsup_step(**ONE_STEP)(
                    state, b, c, b, ts["lr"], ts["bn_momentum"], ts["lmbda"])
            r[what] = (m["ss_loss"].item(), m["chamfer_loss"].item())
            r[what + "_grads"] = {n: q.grad.float().cpu() for n, q in
                                  state.model.named_parameters()}

        model = variant_state(dev, reconstruct=True).model
        with torch.no_grad(), eigh_signs_from_card():
            out = model(p, c, chamfer_points=p, include_convex_loss=True,
                        **entry.BENCH_KWARGS)
        r["reconstruct"] = (out.total_loss.item(),
                            out.recon_points.shape[1])

        g = torch.Generator().manual_seed(15)
        x, y = torch.randn((2, 3025, 3), generator=g), points
        r["chamfer"] = chamfer_loss_dense(x.to(dev), y.to(dev)).item()
    g, c = res["card"], res["cpu"]
    for what, i in (("pretrain", 0), ("pretrain", 1), ("extra_layers", 0),
                    ("extra_layers", 1), ("reconstruct", 0)):
        a, b = g[what][i], c[what][i]
        if not abs(a - b) <= 1e-4 * abs(b):
            raise AssertionError(f"card vs cpu {what}[{i}] card {a} cpu {b}")
    if g["reconstruct"][1] != 25 * 121:
        raise AssertionError(f"AtlasNet gave {g['reconstruct'][1]} points")
    if not abs(g["chamfer"] - c["chamfer"]) <= 1e-5 * abs(c["chamfer"]):
        raise AssertionError(f"chamfer_loss_dense card {g['chamfer']} cpu "
                             f"{c['chamfer']}")
    err, unit = {}, None
    for what in steps:
        err[what] = _worst_grad_err(g[what + "_grads"], c[what + "_grads"],
                                    f"{what} card vs cpu")
        if not err[what] <= 5e-2:
            raise AssertionError(f"{what} gradients card vs cpu: largest "
                                 f"error {err[what]} of the norm")
        ge, ce = g.pop(what + "_embedding"), c.pop(what + "_embedding")
        if not float((ge - ce).abs().max()) <= 1e-4 * float(ce.abs().max()):
            raise AssertionError(f"{what} embedding card vs cpu")
        del g[what + "_grads"], c[what + "_grads"]
        if what == "pretrain":
            unit = float((torch.linalg.norm(ge, dim=-1) - 1).abs().max())
    # the convex loss normalizes the embedding itself, so l2_norm shows
    # only in the embedding the model returns
    if not unit <= 1e-5:
        raise AssertionError(f"pretrain l2_norm: embedding norms off 1 by "
                             f"{unit}")
    return dict(card=g, cpu=c, grad_err=err, clusters=res["clusters"],
                unit_err=unit)


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
# sides: the dense biases a batch norm follows (also the extra_layers
# tower's), and sa3's last batch-norm bias, whose shift fp3's first batch
# norm removes
def _zero_grad_bias(name):
    return name.endswith(".bias") and (
        ".conv_blocks." in name or ".mlp_convs." in name
        or name in ("conv1.bias", "sa3.mlp_bns.2.bias", "conv1_embed.bias",
                    "conv2_embed.bias"))


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
    return spread_train_card_vs_cpu(entry, {}, SR_BASE, (777, 999))


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


# ------------------------------------------------------------- fitting

# the fitting demo at the JAX package's defaults
# (prifit_tpu/cli/args_parser.py): B=16 scenes of 3 ellipsoids of 500
# points, 8-wide embeddings, quantile 0.01, 20 mean-shift steps,
# min(25, 8) slots, 256 samples a primitive
FIT_B, FIT_N, FIT_D = 16, 1500, 8
FIT_STEPS = 20
# its launches a call: the 3 exact clusters of every scene fit the 8
# slots, so one bandwidth candidate runs (no retry): bandwidth once, 20
# mean-shift steps forward and back, 3 NMS passes
FITTING_COUNTS = dict(bandwidth=1, mean_shift=FIT_STEPS,
                      mean_shift_bwd=FIT_STEPS, nms=3)
FIT_CALLS = 3
# the JAX package's own recovery limits (tests/test_geometry.py) and the
# scene they were set on
FIT_AXES_RTOL, FIT_CENTER_ATOL, FIT_LIMIT_SCENE = 0.08, 0.6, (2, 3)


class record_live_rows:
    """While active, records the largest live-row count a shape of each
    cotangent the mean-shift backward kernel takes
    (``kernels/mean_shift.py::live_rows``)."""

    def __enter__(self):
        from prifit_torch.kernels import mean_shift
        self.mod, self.orig, self.counts = mean_shift, mean_shift.live_rows, []

        def live_rows(g):
            order, count = self.orig(g)
            self.counts.append(int(count.max()))
            return order, count

        mean_shift.live_rows = live_rows
        return self

    def __exit__(self, *exc):
        self.mod.live_rows = self.orig


def demo_grad_norm(dev, dtype=torch.float32):
    """The fitting demo's convex loss and ``|grad|`` (``cli/fitting.py``'s
    second half) on ``dev`` in ``dtype``."""
    from prifit_torch.geometry import convex_loss, create_synthetic_dataset
    scene = create_synthetic_dataset(FIT_B, seed=0)
    points = torch.from_numpy(scene.points).to(dev, dtype)
    emb = (torch.from_numpy(scene.weights[:, :, :FIT_D]) + 0.05).to(
        dev, dtype).requires_grad_(True)
    out = convex_loss(points, points, emb, quantile=0.01,
                      iterations=FIT_STEPS, max_num_clusters=8,
                      n_per_prim=256)
    out.total.backward()
    return out.total.item(), emb.grad.norm().item()


def fitting_kernels(gen):
    """The four clustering kernels at the demo's shapes (B=16, N=1500,
    D=8, its embeddings normalized) against their plain versions, and
    their times a launch beside the plain version's and the bound:
    bandwidth at the demo's rank 15 (1e-5, the main path's limit); NMS
    on the modes after 20 steps, held by the partition it makes (every
    mode of a scene's cluster is an exact tie there).  The mean-shift
    step at the demo's bandwidth (1e-3, its floor: the K-th distances of
    identical rows are 0) and its backward for a cotangent live in the 3
    rows a shape the demo gives it (the centers) are held against the
    plain version evaluated in float64 on the same inputs: each within
    twice the f32 plain version's own error there plus 1e-4 (of the
    largest entry; ``s`` relative).  At b^2 = 1e-6 the f32 rounding of a
    zero distance (1e-7) moves an exponent by 0.05 and each term of the
    backward is scaled by 1 / b^2, so any f32 evaluation is far from the
    float64 one (at B=2 on the CPU the plain backward is 9% of its
    largest entry off); the demo's f32 ``|grad|`` misses float64 for that
    reason."""
    from prifit_torch.clustering.mean_shift import mean_shift_iterations
    from prifit_torch.geometry import create_synthetic_dataset
    from prifit_torch.kernels import bandwidth, mean_shift, nms
    scene = create_synthetic_dataset(FIT_B, seed=0)
    X = torch.from_numpy(scene.weights[:, :, :FIT_D]) + 0.05
    X = (X / X.norm(dim=-1, keepdim=True)).cuda().contiguous()
    ks = [int(0.01 * FIT_N)]
    err, kth = bandwidth_err(X, ks)
    bw = torch.sqrt(torch.clamp_min(kth[:, 0], 1e-6)).mean(-1)
    bw2 = (bw ** 2).contiguous()
    pairs, d = FIT_B * FIT_N * FIT_N, FIT_D
    out = {"bandwidth": dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: bandwidth.kth_nn_distance(X, ks)),
        plain_ms=cuda_ms(lambda: bandwidth.kth_nn_plain(X, ks), reps=3),
        bound=bound_ms(nbytes(X) + FIT_B * FIT_N * 4, 4 * pairs,
                       3 * 2 * pairs * d))}
    m, s = mean_shift.mean_shift_step(X, X, bw2)
    mr, sr = mean_shift.mean_shift_step_plain(X, X, bw2)
    m64, s64 = mean_shift.mean_shift_step_plain(X.double(), X.double(),
                                                bw2.double())
    e, own = ((u.double() - m64).abs().max().item() for u in (m, mr))
    se, sown = (((u.double() - s64).abs() / s64).max().item()
                for u in (s, sr))
    if not (e <= 2 * own + 1e-4 and se <= 2 * sown + 1e-4):
        raise AssertionError(f"fitting mean_shift max abs err {e} (f32 "
                             f"plain {own}), s {se} (f32 plain {sown})")
    out["mean_shift"] = dict(
        max_abs_err=e, ms=cuda_ms(lambda: mean_shift.mean_shift_step(
            X, X, bw2)),
        plain_ms=cuda_ms(lambda: mean_shift.mean_shift_step_plain(
            X, X, bw2), reps=3),
        bound=bound_ms(2 * nbytes(X) + nbytes(bw2, m, s), pairs,
                       3 * 4 * pairs * d))
    m, s = mean_shift.mean_shift_step_fwd(X, X, bw2)
    g = sparse_cotangent(gen, 3, shape=(FIT_B, FIT_N, FIT_D))
    got = mean_shift.mean_shift_step_bwd(X, X, bw2, m, s, g)
    e, top, own, _ = bwd_plain_err(got, X, bw2, m, s, g)
    if not e <= 2 * own + 1e-4 * top:
        raise AssertionError(f"fitting mean_shift_bwd max abs err {e} "
                             f"(largest entry {top}, f32 plain {own})")
    live = FIT_B * 3
    out["mean_shift_bwd"] = dict(
        max_abs_err=e,
        ms=cuda_ms(lambda: mean_shift.mean_shift_step_bwd(X, X, bw2, m, s,
                                                          g)),
        plain_ms=cuda_ms(lambda: mean_shift.mean_shift_step_bwd_plain(
            X, X, bw2, m, s, g), reps=3),
        bound=bound_ms(4 * nbytes(X) + live * (2 * d + 1) * 4 + nbytes(bw2),
                       live * FIT_N, 3 * 10 * live * FIT_N * d))
    with torch.no_grad():
        modes = mean_shift_iterations(X, bw, FIT_STEPS).contiguous()
    b = bw.float().contiguous()
    (lg, vg, ng), (lc, vc, nc) = (
        nms_partition(modes, o, K=8) for o in (
            nms.nms_passes(modes, b), nms.nms_passes_plain(modes, b)))
    if not (torch.equal(vg.sum(-1), vc.sum(-1)) and torch.equal(ng, nc)):
        raise AssertionError("fitting nms: slot counts differ")
    for i in range(FIT_B):
        slot_perm(lg[i].cpu(), lc[i].cpu(), f"fitting nms shape {i}")
    counts, is_center, _ = nms.nms_passes_plain(modes, b)
    occ = (counts > 0).sum(-1)
    npairs = pairs + int((occ * occ).sum()) + FIT_N * int(is_center.sum())
    out["nms"] = dict(
        max_abs_err=0.0, ms=cuda_ms(lambda: nms.nms_passes(modes, b)),
        plain_ms=cuda_ms(lambda: nms.nms_passes_plain(modes, b), reps=3),
        bound=bound_ms(nbytes(modes, b) + 6 * FIT_B * FIT_N, 0,
                       3 * 2 * npairs * d))
    return out


def fitting_phase(kernels):
    """``prifit_torch.cli.fitting.main`` (``python -m
    prifit_torch.cli.fitting``) on the card at the JAX defaults: one
    warm-up call, then ``FIT_CALLS`` timed ones with the launch counts
    reset just before (each exactly ``FITTING_COUNTS``; every cotangent
    of the mean-shift backward live in at most 8 rows a shape, so the
    live-row route takes it).  Checks every fitted axis within the JAX
    package's ``rtol`` 0.08 of the true one; its center limit (0.6) holds
    on the scene it was set on (B=2, seed 3), where the card's fits are
    checked against both limits, while at the default scene (seed 0) the
    JAX package's own fit is 1.11 off on one center, so there the largest
    center error is reported and the card held to the CPU.  Card against
    CPU (eigenvector signs aligned): fitted radii and centers within 1e-4
    relative, the loss and chamfer within 1e-4 relative.  ``|grad|`` is
    held against the CPU's float64 evaluation: at the demo's bandwidth
    (b^2 = 1e-6, the floor: the clusters are exact) every term of the
    mean-shift backward and the membership is scaled by 1 / b^2, so f32
    rounding moves ``|grad|`` by 2-12% (on the CPU the port's f32 is 8.7%
    and JAX's 6.6% off the port's float64 1.196e-6; its spread under the
    embeddings scaled by 1 +- 2^-20 is 0.2%, so no spread rule holds it);
    the card must be within twice the CPU f32 evaluation's own error
    there plus 5e-2.  Then the kernels at these shapes
    (:func:`fitting_kernels`)."""
    import contextlib
    import io

    from prifit_torch.cli import fitting
    from prifit_torch.cli.args_parser import parse_args
    from prifit_torch.geometry import create_synthetic_dataset, \
        fit_ellipsoids_batch
    args = parse_args([])
    if (args.batch_size, args.quantile, args.msc_iterations,
            args.n_per_prim) != (FIT_B, 0.01, FIT_STEPS, 256):
        raise AssertionError(f"the demo's defaults changed: {args}")
    with contextlib.redirect_stdout(io.StringIO()):
        fitting.main(args, device="cuda")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    walls = []
    with record_live_rows() as live:
        for _ in range(FIT_CALLS):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                card = fitting.main(args, device="cuda")
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    counts = kernels.launch_counts()
    want = {k: FIT_CALLS * FITTING_COUNTS.get(k, 0) for k in counts}
    if counts != want:
        raise AssertionError(f"fitting demo launched {counts} in "
                             f"{FIT_CALLS} calls, not {want}")
    if len(live.counts) != FIT_CALLS * FIT_STEPS or max(live.counts) > 8:
        raise AssertionError(f"fitting demo backward live rows "
                             f"{live.counts}")
    text = buf.getvalue()
    if text.count("fitted") != 3 * FIT_B or "fit pipeline OK" not in text:
        raise AssertionError(f"fitting demo printed {text[-300:]}")
    rel = np.abs(np.sort(card["r"], -1) / np.sort(card["true_r"], -1) - 1)
    if not rel.max() <= FIT_AXES_RTOL:
        raise AssertionError(f"fitted axes {rel.max()} off the true ones")
    center_err = float(np.abs(card["center"] - card["true_center"]).max())
    b0, seed0 = FIT_LIMIT_SCENE
    sc = create_synthetic_dataset(b0, seed=seed0)
    with torch.no_grad():
        p = fit_ellipsoids_batch(torch.from_numpy(sc.points).cuda(),
                                 torch.from_numpy(sc.weights).cuda())
    r0 = np.sort(p.r[:, :3].cpu().numpy(), -1)
    c0 = np.abs(p.center[:, :3].cpu().numpy() - sc.centers).max()
    if not (np.abs(r0 / np.sort(sc.params, -1) - 1).max() <= FIT_AXES_RTOL
            and c0 <= FIT_CENTER_ATOL):
        raise AssertionError(f"fit of the limits' scene: center err {c0}")
    with eigh_signs_from_card(), contextlib.redirect_stdout(io.StringIO()):
        cpu = fitting.main(args, device="cpu")
    for k in ("r", "center"):
        e = np.abs(card[k] - cpu[k]).max() / np.abs(cpu[k]).max()
        if not e <= 1e-4:
            raise AssertionError(f"fitting {k} card vs cpu {e}")
    for k in ("total", "chamfer"):
        if not abs(card[k] - cpu[k]) <= 1e-4 * abs(cpu[k]):
            raise AssertionError(f"fitting {k} card {card[k]} cpu {cpu[k]}")
    with eigh_signs_from_card():
        g64 = demo_grad_norm("cpu", torch.float64)[1]
    own = abs(cpu["grad_norm"] - g64)
    if not abs(card["grad_norm"] - g64) <= 2 * own + 5e-2 * g64:
        raise AssertionError(f"fitting |grad| card {card['grad_norm']} cpu "
                             f"{cpu['grad_norm']} cpu float64 {g64}")
    return dict(walls=walls, counts=counts, live=max(live.counts),
                axes_rel=float(rel.max()), center_err=center_err,
                limit_scene=(float(np.abs(r0 / np.sort(sc.params, -1)
                                          - 1).max()), float(c0)),
                card=card, cpu=cpu, grad64=g64,
                kernels=fitting_kernels(torch.Generator().manual_seed(8)))


def log_fitting(fit, smi):
    c, g = fit["card"], fit["cpu"]
    log(f"fitting demo (python -m prifit_torch.cli.fitting, B={FIT_B}, "
        f"N={FIT_N}, D={FIT_D}, {FIT_STEPS} steps, 8 slots): "
        f"{_ms(fit['walls'])} ms a call (median of {FIT_CALLS}: "
        f"{[round(w * 1e3, 1) for w in fit['walls']]}) [{smi}]; launches in "
        f"{FIT_CALLS} calls {fit['counts']}; backward cotangents live in at "
        f"most {fit['live']} rows a shape; axes at most "
        f"{fit['axes_rel']:.4f} relative off the true ones, centers "
        f"{fit['center_err']:.4f} (the limits' scene: "
        f"{fit['limit_scene'][0]:.4f}, {fit['limit_scene'][1]:.4f})")
    log(f"fitting card vs cpu: loss {c['total']:.7f} / {g['total']:.7f}, "
        f"chamfer {c['chamfer']:.7f} / {g['chamfer']:.7f}, |grad| "
        f"{c['grad_norm']:.6g} / {g['grad_norm']:.6g} (cpu float64 "
        f"{fit['grad64']:.6g}), radii "
        f"{np.abs(c['r'] - g['r']).max():.3g} apart")
    for name, k in fit["kernels"].items():
        log(f"fitting {name} at B={FIT_B} N={FIT_N} D={FIT_D}: max_abs_err "
            f"{k['max_abs_err']:.3g} kernel_ms {k['ms']:.4f} plain_ms "
            f"{k['plain_ms']:.4f} bound_ms {k['bound'][0]:.4f} "
            f"({k['bound'][1]}) a launch [{smi}]")


# ------------------------------------------------------------- library

# cluster_single's launches on one structured shape (4 clusters, no retry)
# at the main path's settings: bandwidth once and 3 NMS passes; 10
# mean-shift steps with the gaussian kernel, none with the epanechnikov
# one (plain PyTorch in the JAX package too)
SINGLE_KW = dict(quantile=0.05, iterations=10, max_num_clusters=25,
                 num_candidates=2)
SINGLE_COUNTS = {"gaussian": dict(bandwidth=1, mean_shift=10, nms=3),
                 "epanechnikov": dict(bandwidth=1, nms=3)}


def _rel(a, b):
    """The largest ``|a - b|`` over the largest ``|b|`` (tensors or
    floats, ``a`` on any device)."""
    a = torch.as_tensor(a).detach().double().cpu()
    b = torch.as_tensor(b).detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max())


def library_phase(kernels):
    """The library surface, card against CPU: the chamfer family within
    1e-5 relative; ``lstsq`` and its gradients (full rank within 1e-4 of
    the largest entry; rank-deficient, where ``A^T A + lambda I`` has
    condition number ~1e5, the solution and the gradient in ``Y`` within
    5e-4 and each side within 5e-4 of the float64 ridge solve, and the
    gradient in ``A`` in float64 within 1e-8: the f32 ones are O(1) off,
    that condition number squared, as in tests/test_torch_library.py);
    ``cluster_single`` with both kernel types (:func:`same_clustering`,
    launches exactly ``SINGLE_COUNTS``); ``compute_bandwidth`` within
    1e-5 relative; the viz exporters' files byte-equal from a card tensor
    and a CPU one; and ``StepTimer`` and ``sync`` around a card step.
    Returns the launches of the whole phase and the errors."""
    import shutil
    import tempfile

    from prifit_torch import ops, utils
    from prifit_torch.clustering import cluster_single, compute_bandwidth
    from prifit_torch.ops.lstsq import best_lambda
    from prifit_torch.utils import viz
    kernels.reset_launch_counts()
    rng = np.random.default_rng(41)
    res = {}
    pred = torch.from_numpy(rng.normal(size=(4, 2048, 3)).astype(np.float32))
    gt = torch.from_numpy(rng.normal(size=(4, 5000, 3)).astype(np.float32))
    pm = torch.from_numpy(rng.random((4, 2048)) < 0.8)
    gm = torch.from_numpy(rng.random((4, 5000)) < 0.7)
    cases = {
        "chamfer_distance": lambda p, g, a, b: ops.chamfer_distance(
            p, g, sqrt=True, pred_mask=a, gt_mask=b),
        "chamfer_distance_one_side": lambda p, g, a, b:
            ops.chamfer_distance_one_side(p, g, side=0),
        "chamfer_distance_single_shape": lambda p, g, a, b:
            ops.chamfer_distance_single_shape(p[0], g[0], sqrt=True),
        "chamfer_distance_pairwise_batch": lambda p, g, a, b:
            ops.chamfer_distance_pairwise_batch(p, g),
    }
    for name, fn in cases.items():
        e = _rel(fn(pred.cuda(), gt.cuda(), pm.cuda(), gm.cuda()),
                 fn(pred, gt, pm, gm))
        if not e <= 1e-5:
            raise AssertionError(f"{name} card vs cpu {e}")
        res[name] = e

    col = rng.normal(size=(64, 1))
    inputs = {"full_rank": rng.normal(size=(64, 8)),
              "rank_deficient": np.concatenate(
                  [col, 2.0 * col, rng.normal(size=(64, 1))], 1)}
    Y = torch.from_numpy(rng.normal(size=(64, 3)).astype(np.float32))
    for kind, A in inputs.items():
        A = torch.from_numpy(A.astype(np.float32))
        sides = {}
        for side, dev, dt in (("cuda", "cuda", torch.float32),
                              ("cpu", "cpu", torch.float32),
                              ("cuda64", "cuda", torch.float64),
                              ("cpu64", "cpu", torch.float64)):
            a = A.to(dev, dt, copy=True).requires_grad_(True)
            y = Y.to(dev, dt, copy=True).requires_grad_(True)
            x = ops.lstsq(a, y)
            (x ** 2).sum().backward()
            sides[side] = (x, a.grad, y.grad)
        full = kind == "full_rank"
        tol = 1e-4 if full else 5e-4
        errs = [_rel(g, c) for g, c in zip(sides["cuda"], sides["cpu"])]
        held = errs if full else [errs[0], errs[2]]   # x, dA, dY
        if not (max(held) <= tol
                and _rel(sides["cuda64"][1], sides["cpu64"][1]) <= 1e-8):
            raise AssertionError(f"lstsq {kind} card vs cpu {errs}")
        if not full:
            lg = float(best_lambda(A.cuda().T @ A.cuda()))
            if lg != float(best_lambda(A.T @ A)):
                raise AssertionError(f"lstsq lambda card {lg}")
            for dev in ("cuda", "cpu"):
                e = _rel(sides[dev][0], sides["cpu64"][0])
                if not e <= tol:
                    raise AssertionError(f"lstsq {kind} {dev} vs float64 "
                                         f"{e}")
        res[f"lstsq_{kind}"] = errs

    X, expected = structured_embeddings(5)
    x = X[1]
    for kt, want in SINGLE_COUNTS.items():
        before = kernels.launch_counts()
        g = cluster_single(x.cuda(), kernel_type=kt, **SINGLE_KW)
        got = {k: v - before[k] for k, v in kernels.launch_counts().items()}
        if got != {k: want.get(k, 0) for k in got}:
            raise AssertionError(f"cluster_single {kt} launched {got}")
        c = cluster_single(x, kernel_type=kt, **SINGLE_KW)
        res[f"cluster_single_{kt}"] = same_clustering(
            type(g)(*(t[None].cpu() for t in g)),
            type(c)(*(t[None] for t in c)), [expected[1]])
    Xn = x / x.norm(dim=-1, keepdim=True)
    bg = compute_bandwidth(Xn.cuda(), 0.05).item()
    bc = compute_bandwidth(Xn, 0.05).item()
    if not abs(bg - bc) <= 1e-5 * bc:
        raise AssertionError(f"compute_bandwidth card {bg} cpu {bc}")
    res["compute_bandwidth"] = (bg, bc)

    os.makedirs(os.path.join(ROOT, "log"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_viz_",
                           dir=os.path.join(ROOT, "log"))
    try:
        pts = torch.from_numpy(rng.normal(size=(500, 3)).astype(np.float32))
        labels = torch.from_numpy(rng.integers(0, 6, 500))
        for side, p, lab in (("card", pts.cuda(), labels.cuda()),
                             ("cpu", pts, labels)):
            colors = viz.labels_to_colors(lab)
            viz.save_xyz(os.path.join(tmp, f"{side}.xyz"), p, colors)
            viz.save_ply(os.path.join(tmp, f"{side}.ply"), p, colors)
        for ext in ("xyz", "ply"):
            with open(os.path.join(tmp, f"card.{ext}"), "rb") as f, \
                    open(os.path.join(tmp, f"cpu.{ext}"), "rb") as h:
                if f.read() != h.read():
                    raise AssertionError(f"viz .{ext} differs card vs cpu")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    timer = utils.StepTimer()
    xc = x.cuda()
    step_s = timer.time_fn(lambda: cluster_single(xc, **SINGLE_KW).centers,
                           warmup=1, reps=3)
    with timer.step() as done:
        done(cluster_single(xc, **SINGLE_KW))
    top = cluster_single(xc, **SINGLE_KW).centers
    if not (timer.summary()["n"] == 2 and min(timer.times) > 0
            and utils.sync(top) == top.reshape(-1)[0].item()):
        raise AssertionError(f"StepTimer {timer.summary()}")
    res["step_timer"] = dict(time_fn_ms=step_s * 1e3,
                             step_ms=timer.times[-1] * 1e3)
    return dict(counts=kernels.launch_counts(), checks=res)


def log_library(lib, smi):
    c = lib["checks"]
    log(f"library card vs cpu: chamfer family "
        f"{ {k: f'{v:.2g}' for k, v in c.items() if k.startswith('chamfer')} }"
        f" relative; lstsq (solution, dA, dY) full rank "
        f"{[f'{e:.2g}' for e in c['lstsq_full_rank']]}, rank-deficient "
        f"{[f'{e:.2g}' for e in c['lstsq_rank_deficient']]}; cluster_single "
        f"gaussian / epanechnikov same partition (weights, centers err "
        f"{c['cluster_single_gaussian']} / "
        f"{c['cluster_single_epanechnikov']}); compute_bandwidth "
        f"{c['compute_bandwidth'][0]:.7f} / {c['compute_bandwidth'][1]:.7f};"
        f" viz exporters byte-equal; StepTimer cluster_single "
        f"{c['step_timer']['time_fn_ms']:.2f} ms (time_fn), "
        f"{c['step_timer']['step_ms']:.2f} ms (step) [{smi}]; launches in "
        f"the phase { {k: v for k, v in lib['counts'].items() if v} }")


# -------------------------------------------------------------- dtypes

# the encoder dtypes the trainer accepts besides mxsr and f32: name ->
# train_flagship's dtype arguments
ALL_STAGES = ("sa1", "sa2", "sa3", "fp3", "fp2", "fp1")
DTYPE_MODES = {
    "bf16": dict(compute_dtype="bf16"),
    "sa_bf16": dict(compute_dtype="sa_bf16"),
    "mx": dict(compute_dtype="mx"),
    "fq": dict(compute_dtype="f32",
               stage_dtypes=",".join(f"{s}:fq" for s in ALL_STAGES)),
    "q": dict(compute_dtype="f32",
              stage_dtypes=",".join(f"{s}:q" for s in ALL_STAGES)),
    "sa1_bf16_fp2_q": dict(compute_dtype="f32",
                           stage_dtypes="sa1:bf16,fp2:q"),
}


def check_dtype_counts(c, kmax, what):
    """3 steps' launches ``c`` of a dtype mode: FPS twice and the gather
    10 times a step; the K-max backward pair 6 times a step under ``mx``
    (rounding off), never otherwise; the rounding cast never."""
    want = dict(fps=6, gather=30, max_bwd_cnt_gsm=18 if kmax else 0,
                max_bwd_dz=18 if kmax else 0, sr_bf16=0, bn_relu_eval=0)
    got = {k: c[k] for k in want}
    if got != want:
        raise AssertionError(f"{what}: launched {got} in 3 steps, not "
                             f"{want}")


def spread_train_card_vs_cpu(entry, model_kw, key=None, other_key=None):
    """One B=2 supervised step with the encoder dtypes ``model_kw`` on the
    card and on the CPU from the same seeded weights (and rounding key),
    dropout off and FPS from index 0; four more CPU steps on the cloud
    scaled by ``SPREAD_SCALES``; with ``other_key`` one more CPU step
    with that key.  The loss within 1e-3 relative; each gradient within
    twice the CPU's own spread under those scales plus 5e-2 of its norm
    (:func:`mxsr_train_card_vs_cpu` says why).  Returns the losses, the
    CPU's loss spread, the parameter worst against its limit and the
    medians over the parameters of the card's error, the CPU's spread
    (and the change the other key makes)."""
    from prifit_torch.models.pointnet2_part_seg_msg import get_loss
    from prifit_torch.train.steps import make_supervised_step
    ts = entry.TRAIN_SETTINGS
    runs = [("cuda", 1.0, key), ("cpu", 1.0, key)] + [
        ("cpu", s, key) for s in SPREAD_SCALES]
    if other_key is not None:
        runs.append(("cpu", 1.0, other_key))
    res = []
    for dev, s, k in runs:
        state, points, cls, target = entry.train_flagship(
            2, N, device=dev, **model_kw)
        state.model.dropout_rate = 0.0
        _, sm = make_supervised_step(get_loss)(
            state, points * s, cls, target, ts["lr"], ts["bn_momentum"],
            sr_key=k)
        res.append((sm["loss"].item(),
                    {n: p.grad.float().cpu()
                     for n, p in state.model.named_parameters()}))
    keyed_run = res.pop() if other_key is not None else None
    (lg, gg), (lc, gc) = res[0], res[1]
    l_spread = max(abs(r[0] - lc) for r in res[2:])
    if not abs(lg - lc) <= 1e-3 * abs(lc):
        raise AssertionError(f"{model_kw} supervised loss card {lg} cpu {lc}")
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
        if keyed_run is not None:
            keyed.append(float((keyed_run[1][name] - r).norm() / r.norm()))
        if not err <= 2 * spread + 5e-2:
            raise AssertionError(f"{model_kw} gradient of {name}: card vs "
                                 f"cpu {err} of the norm, cpu spread "
                                 f"{spread}")
        if err / (spread + 1e-30) >= worst[0] / (worst[1] + 1e-30):
            worst = (err, spread, name)
    return dict(loss=(lg, lc), loss_spread=l_spread, worst=worst,
                medians=tuple(float(np.median(v))
                              for v in (errs, spreads, keyed) if v))


def dtype_phase(entry, kernels):
    """Each of ``DTYPE_MODES``: the supervised and the self-sup step of
    the flagship at B=24, N=2048 (``entry.train_flagship`` with those
    dtypes), a warm-up and three timed steps each (:func:`timed_steps`),
    launches exact (:func:`check_dtype_counts`; the self-sup step also
    launches every clustering kernel, the mean-shift backward once a
    forward step); then one B=2 supervised step each card against CPU
    (:func:`spread_train_card_vs_cpu`).  The ``mxsr`` and f32 steps of
    the same call are :func:`train_path`'s."""
    from prifit_torch.models.pointnet2_part_seg_msg import get_loss
    from prifit_torch.train.steps import make_selfsup_step, \
        make_supervised_step
    ts = entry.TRAIN_SETTINGS
    out = {}
    for mode, kw in DTYPE_MODES.items():
        state, points, cls, target = entry.train_flagship(B, N, **kw)
        gen = torch.Generator(device="cuda").manual_seed(0)
        sup = make_supervised_step(get_loss)
        ss = make_selfsup_step(**entry.BENCH_KWARGS)
        runs = {
            "supervised": lambda: sup(state, points, cls, target, ts["lr"],
                                      ts["bn_momentum"], gen),
            "selfsup": lambda: ss(state, points, cls, points, ts["lr"],
                                  ts["bn_momentum"], ts["lmbda"], gen),
        }
        r = {name: timed_steps(state, run, kernels, f"{mode} {name}")
             for name, run in runs.items()}
        for name in runs:
            check_dtype_counts(r[name]["counts"], mode == "mx",
                               f"{mode} {name}")
        check_selfsup_counts(r["selfsup"]["counts"], False,
                             f"{mode} self-sup")
        r["card_vs_cpu"] = spread_train_card_vs_cpu(entry, kw)
        out[mode] = r
        del state, runs
        torch.cuda.empty_cache()
    return out


def log_dtypes(dt, train, smi):
    """The dtype modes' lines, after the ``mxsr`` (``auto``) and f32 steps
    of :func:`train_path` in the same call."""
    for mode, r in [("mxsr", train["auto"]), ("f32", train["f32"])] + list(
            dt.items()):
        spec = DTYPE_MODES.get(mode, {})
        for name in ("supervised", "selfsup"):
            s = r[name]
            t = sorted(s["times"])[1]
            log(f"dtype {mode} {spec}, {name} step B={B} N={N}: "
                f"{t * 1e3:.1f} ms (median of 3; "
                f"{', '.join(f'{x * 1e3:.1f}' for x in s['times'])}) "
                f"[{smi}]; peak memory {s['peak'] / 2**30:.2f} GiB; "
                f"launches in 3 steps "
                f"{ {k: v for k, v in s['counts'].items() if v} }")
        if "card_vs_cpu" in r:
            c = r["card_vs_cpu"]
            err, spread, name = c["worst"]
            log(f"dtype {mode} card vs cpu B=2 supervised: loss "
                f"{c['loss'][0]:.7f} / {c['loss'][1]:.7f} (cpu spread "
                f"{c['loss_spread']:.3g}); worst gradient {name}: "
                f"{err:.4f} of the norm, cpu spread {spread:.4f}; medians "
                f"card vs cpu {c['medians'][0]:.4f}, cpu spread "
                f"{c['medians'][1]:.4f}")


# per-kernel numbers beyond the common ones: the mean-shift backward's on
# sparse cotangents, NMS's on each input, the gather's device-only time and
# its time with int32 indices, bandwidth's f32 bound and its time on rows
# that are all equal, and FPS's time per call (events and device-only), per
# step and launch shapes
# ------------------------------------------------------------ registry

# the registry's other five models: B, N and steps of each phase run (the
# models' own recipes: ModelNet40 at 1024 points with normals, S3DIS
# blocks of 4096 points with rgb), and the kernels one f32 train step
# (forward and backward) launches
REGISTRY = {
    "pointnet_cls": (24, 1024, 8, {}),
    "pointnet2_cls_ssg": (24, 1024, 8, dict(fps=2, gather=3)),
    "pointnet2_cls_msg": (24, 1024, 8, dict(fps=2, gather=9)),
    "pointnet_sem_seg": (16, 4096, 20, {}),
    "pointnet2_sem_seg": (16, 4096, 20, dict(fps=4, gather=9)),
}
CLS_CLASSES, SEM_CLASSES = 40, 13
# the card-against-CPU step's batch: B=8 where batch norms normalize B
# rows after a max (the classifiers' heads, PointNet's transformers)
REGISTRY_CHECK_B = {"pointnet2_sem_seg": 4}
# the probe run: ModelNet40-layout shapes a category (train, test), the
# ACD shapes (96 train: 4 iterations at B; 24 val: one batch) and epochs
MODELNET_SPLIT = (8, 2)
PROBE_ACD_SHAPES = 120
PROBE_EPOCHS = 2
# one probe batch: the pretrain model's eval forward (no convex loss)
PROBE_BATCH = dict(fps=2, gather=10, bn_relu_eval=BN_EVAL_CALLS)


def write_modelnet_tree(root, n_cats=CLS_CLASSES, split=MODELNET_SPLIT,
                        n_points=2500, seed=3):
    """A synthetic ModelNet40 tree in the layout of ``tools/
    synthetic_primitive_dataset.py::make_modelnet_benchmark`` (the
    ``modelnet40_normal_resampled`` layout): ``modelnet40_shape_names
    .txt``, the train and test id lists and a csv file a shape of rows
    x,y,z,nx,ny,nz.  A category is a fixed layout of 3 to 6 gaussian
    blobs, jittered shape by shape; normals are random unit vectors."""
    rng = np.random.default_rng(seed)
    names = [f"cat{c:02d}" for c in range(n_cats)]
    os.makedirs(root)
    with open(os.path.join(root, "modelnet40_shape_names.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    ids = {"train": [], "test": []}
    for c, name in enumerate(names):
        os.makedirs(os.path.join(root, name))
        centers = rng.normal(size=(3 + c % 4, 3))
        for i in range(sum(split)):
            token = f"{name}_{i:04d}"
            ctr = centers + 0.1 * rng.normal(size=centers.shape)
            pts = ctr[rng.integers(0, len(ctr), n_points)] \
                + 0.2 * rng.normal(size=(n_points, 3))
            nrm = rng.normal(size=(n_points, 3))
            nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
            np.savetxt(os.path.join(root, name, token + ".txt"),
                       np.concatenate([pts, nrm], 1), fmt="%.6f",
                       delimiter=",")
            ids["train" if i < split[0] else "test"].append(token)
    for s, items in ids.items():
        with open(os.path.join(root, f"modelnet40_{s}.txt"), "w") as f:
            f.write("\n".join(items) + "\n")
    return root


def write_s3dis_rooms(root, n_points=100000, seed=4):
    """Synthetic S3DIS rooms in the layout of ``tools/
    synthetic_primitive_dataset.py::make_s3dis_rooms``: one
    ``Area_<a>_room<a>.npy`` of ``[n_points, 7]`` rows (xyz, rgb in
    0-255, label) in each of areas 1-5, 4 x 4 x 3 m: floor, ceiling and
    four walls as planes, a table, two chairs, a wall board and three
    clutter boxes, each class with its own height and extent, as in a
    real scan."""
    rng = np.random.default_rng(seed)
    os.makedirs(root)
    W, D, H = 4.0, 4.0, 3.0

    def plane(n, extent, axis, value):
        p = rng.uniform(0, 1, (n, 3)) * np.asarray(extent)
        p[:, axis] = value
        return p

    def box(n, center, size):
        p = rng.uniform(-0.5, 0.5, (n, 3))
        ax = rng.integers(0, 3, n)
        p[np.arange(n), ax] = np.sign(p[np.arange(n), ax] + 1e-9) * 0.5
        return np.asarray(center) + p * np.asarray(size)

    for area in range(1, 6):
        tc = rng.uniform(1.2, 2.8, 2)
        parts = [  # (sampler, label, weight)
            (lambda n: plane(n, (W, D, 0), 2, 0.0), 1, W * D),
            (lambda n: plane(n, (W, D, 0), 2, H), 0, W * D),
            (lambda n: plane(n, (0, D, H), 0, 0.0), 2, D * H),
            (lambda n: plane(n, (0, D, H), 0, W), 2, D * H),
            (lambda n: plane(n, (W, 0, H), 1, 0.0), 2, W * H),
            (lambda n: plane(n, (W, 0, H), 1, D), 2, W * H),
            (lambda n, c=tuple(tc): box(n, (c[0], c[1], 0.74),
                                        (1.2, 0.7, 0.06)), 7, 1.7)]
        for _ in range(2):
            cc = rng.uniform(0.6, 3.4, 2)
            parts.append((lambda n, c=tuple(cc): box(
                n, (c[0], c[1], 0.45), (0.45, 0.45, 0.9)), 8, 1.6))
        by = rng.uniform(1.0, 3.0)
        parts.append((lambda n, y=by: box(
            n, (W - 0.02, y, 1.5), (0.04, 1.2, 0.9)), 11, 1.1))
        for _ in range(3):
            cc, sz = rng.uniform(0.3, 3.7, 2), rng.uniform(0.1, 0.5, 3)
            parts.append((lambda n, c=tuple(cc), s=tuple(sz): box(
                n, (c[0], c[1], s[2] / 2), s), 12, 0.6))
        weights = np.array([w for _, _, w in parts])
        counts = np.maximum((weights / weights.sum() * n_points).astype(int),
                            48)
        rows = []
        for (sampler, label, _), n in zip(parts, counts):
            rgb = np.clip(rng.normal(0.45 + 0.03 * label, 0.08, (n, 3)), 0,
                          1) * 255.0
            rows.append(np.concatenate([sampler(int(n)), rgb,
                                        np.full((n, 1), label)], 1))
        data = np.concatenate(rows).astype(np.float32)
        rng.shuffle(data, axis=0)
        np.save(os.path.join(root, f"Area_{area}_room{area}.npy"), data)
    return root


def registry_model(name, dev, train_dropout=True):
    """``--model name`` of the registry on ``dev`` at its recipe's width
    (40 classes with normals, or 13 classes with rgb), the JAX package's
    initializers from seed 0; with ``train_dropout`` false its dropout
    off."""
    from prifit_torch.entry import init_weights
    from prifit_torch.models import get_module
    mod = get_module(name)
    if name == "pointnet_cls":
        model = mod.get_model(k=CLS_CLASSES, device="cpu")
    elif "_cls_" in name:
        model = mod.get_model(num_class=CLS_CLASSES, device="cpu")
    elif name == "pointnet2_sem_seg":
        model = mod.get_model(num_classes=SEM_CLASSES, device="cpu")
    else:
        model = mod.get_model(num_class=SEM_CLASSES, device="cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    if not train_dropout:
        for attr in ("dropout_rate", "dropout_rates"):
            if hasattr(model, attr):
                setattr(model, attr, 0.0 if attr == "dropout_rate"
                        else (0.0, 0.0))
    return model.to(dev), mod


def registry_batches(name, roots, b, n, count, seed=0):
    """``count`` host batches ``(points, target)`` of ``name``'s data:
    ModelNet40 train clouds (``ModelNetDataLoader``, shuffled, the class
    the target) or S3DIS train blocks (``S3DISDataset`` items drawn in
    turn, the point labels the target)."""
    from prifit_torch.data import DataLoader, ModelNetDataLoader, \
        S3DISDataset
    if "_cls" in name:
        loader = DataLoader(ModelNetDataLoader(roots["modelnet"], npoint=n,
                                               split="train"),
                            b, shuffle=True, seed=seed)
        out = []
        while len(out) < count:
            out += [(p, c[:, 0].astype(np.int64)) for p, c in loader]
        return out[:count]
    ds = S3DISDataset(roots["s3dis"], num_point=n,
                      rng=np.random.default_rng(seed))
    out = []
    for _ in range(count):
        xs, ys = zip(*(ds[0] for _ in range(b)))
        out.append((np.stack(xs), np.stack(ys).astype(np.int64)))
    return out


def registry_train(name, roots, kernels):
    """``name`` trained on the card for its recipe's steps with Adam (lr
    1e-3, the trainers' coupled decay 1e-4) at its B and N, dropout and
    the FPS starts drawn from a seeded generator; the launch counts reset
    just before the first step, and every step's launches must equal
    ``REGISTRY``'s.  Returns each step's wall (synchronized), loss and
    accuracy (of the class, or of the points), the run's launches and its
    peak memory."""
    from prifit_torch.train.state import create_train_state
    b, n, steps, expected = REGISTRY[name]
    want = dict.fromkeys(kernels.KERNELS, 0)
    want.update(expected)
    batches = [tuple(torch.as_tensor(a, device="cuda") for a in bt)
               for bt in registry_batches(name, roots, b, n, steps)]
    model, mod = registry_model(name, "cuda")
    state = create_train_state(model.train())
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    walls, losses, accs = [], [], []
    for i, (points, target) in enumerate(batches):
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        state.optimizer.zero_grad(set_to_none=True)
        for g in state.optimizer.param_groups:
            g["lr"] = 1e-3
        logp, aux = model(points, generator=gen)
        loss = mod.get_loss(logp, target, aux)
        loss.backward()
        state.optimizer.step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        got = {k: v - before[k] for k, v in kernels.launch_counts().items()}
        if got != want:
            raise AssertionError(f"{name} step {i} launched {got}, not "
                                 f"{want}")
        losses.append(loss.item())
        accs.append((logp.argmax(-1) == target).float().mean().item())
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"{name} losses {losses}")
    return dict(walls=walls, losses=losses, accs=accs,
                counts=kernels.launch_counts(),
                peak=torch.cuda.max_memory_allocated())


def _registry_zero_grad_bias(model, name):
    """A bias of a registry model whose gradient is analytically 0: a
    dense bias a batch norm follows (all but the last layer's), and a
    batch-norm bias before a max over points or neighbours whose shift a
    later batch norm removes (an SA layer's last, the PointNet encoder's
    and its transformers' ``bn3``)."""
    import re
    last = {"pointnet2_sem_seg": "conv2.bias",
            "pointnet_sem_seg": "conv4.bias"}.get(model, "fc3.bias")
    if name != last and re.search(
            r"(conv\d|conv_blocks\.\d+\.\d+|mlp_convs\.\d+|fc[12])\.bias$",
            name):
        return True
    return re.fullmatch(r"sa\d\.(mlp_bns\.2|bn_blocks\.\d+\.2)\.bias|"
                        r"feat\.(f?stn\.)?bn3\.bias", name) is not None


def snap_xyz(points):
    """``points`` with the xyz columns rounded to a grid of step 2^-k, the
    largest step with every coordinate at most 1024 steps from 0: then
    every squared distance the ball query and FPS compute (``|a|^2 +
    |b|^2 - 2 a.b``, each term below 2^24 steps^2) is exact in f32, on
    the card's matmul and the CPU's alike, so both pick the same
    neighbours.  Off the grid a point within a rounding of a radius
    falls on either side: the MSG classifier's B=8 loss read 8.3e-5
    apart on an H100 80GB HBM3 (this check without the grid), and
    :func:`registry_unsnapped_msg` holds that step off the grid."""
    xyz = points[..., :3]
    scale = 2.0 ** np.floor(np.log2(1024.0 / np.abs(xyz).max()))
    out = points.copy()
    out[..., :3] = np.round(xyz * scale) / scale
    return out


def _registry_step(name, dev, points, target):
    """One f32 train-mode step of ``name`` on ``dev`` from the seeded
    weights, dropout off, FPS from index 0: its loss and gradients."""
    model, mod = registry_model(name, dev, train_dropout=False)
    logp, aux = model.train()(torch.as_tensor(points, device=dev))
    loss = mod.get_loss(logp, torch.as_tensor(target, device=dev), aux)
    loss.backward()
    return loss.item(), {k: p.grad.float().cpu()
                         for k, p in model.named_parameters()}


def _registry_steps_agree(name, card, cpu, what="card vs cpu"):
    """The loss of step ``card`` within 1e-5 relative of ``cpu``'s and
    every gradient within 5e-2 of the CPU gradient's norm (the limits of
    ``train_card_vs_cpu``); returns the largest gradient error."""
    (lg, gg), (lc, gc) = card, cpu
    if not abs(lg - lc) <= 1e-5 * abs(lc):
        raise AssertionError(f"{name} {what}: loss {lg} against {lc}")
    err = 0.0
    for k, r in gc.items():
        if _registry_zero_grad_bias(name, k):
            continue
        if not bool(r.any()):
            # behind a transformer's last dense, which starts at 0
            if bool(gg[k].any()):
                raise AssertionError(f"{name}: {k} has a gradient where the "
                                     f"CPU has none")
            continue
        err = max(err, float((gg[k] - r).norm() / r.norm()))
    if not err <= 5e-2:
        raise AssertionError(f"{name} gradients {what}: largest error {err} "
                             f"of the norm")
    return err


def registry_card_vs_cpu(name, roots):
    """One f32 step of ``name`` (forward, ``get_loss``, backward) on the
    card and on the CPU from the same seeded weights and batch (xyz on a
    grid, :func:`snap_xyz`), at ``REGISTRY_CHECK_B`` clouds of the
    recipe's N, held by :func:`_registry_steps_agree`."""
    b, n, _, _ = REGISTRY[name]
    b = REGISTRY_CHECK_B.get(name, 8)
    points, target = registry_batches(name, roots, b, n, 1, seed=1)[0]
    points = snap_xyz(points)
    card = _registry_step(name, "cuda", points, target)
    cpu = _registry_step(name, "cpu", points, target)
    return dict(b=b, loss=(card[0], cpu[0]),
                grad_err=_registry_steps_agree(name, card, cpu))


# a point of the card's or the CPU's neighbour set, not both, must lie
# within this of the decision's threshold in float64 (squared distances of
# clouds in the unit sphere: f32 rounding of |a|^2 + |b|^2 - 2 a.b is near
# 1e-6, a TF32 matmul's near 1e-3)
BOUNDARY_GAP = 1e-5


def _ball_query_differences(card, cpu):
    """The groups (centroid and scale) whose neighbour multisets differ
    between the ball queries ``card`` and ``cpu`` (lists of ``(radii,
    nsamples, xyz, new_xyz, indices)`` in call order), and in float64
    the largest distance of a point in only one of the two sets from the
    threshold that decides it: the squared radius, or the squared
    distance of the k-th nearest point (for one beyond it) or the
    (k+1)-th (for one before it); where the nearest point differs, the
    two nearest points' distances apart."""
    groups, entries, gap = 0, 0, 0.0
    for (radii, ks, xyz, new_xyz, ia), (_, _, _, _, ib) in zip(card, cpu):
        d = ((new_xyz[:, :, None] - xyz[:, None]) ** 2).sum(-1)
        ranked = d.sort(-1).values
        for r, k, a, b in zip(radii, ks, ia, ib):
            unequal = a.sort(-1).values != b.sort(-1).values
            entries += int(unequal.sum())
            rows = unequal.any(-1)
            groups += int(rows.sum())
            kk = min(k, xyz.shape[1])
            for bi, si in rows.nonzero().tolist():
                ga, gb = a[bi, si], b[bi, si]
                dg = d[bi, si]
                # the nearest point pads a group: a flip there is a tie of
                # the two nearest
                gaps = [float((dg[ga[0]] - dg[gb[0]]).abs())]
                only = sorted(set(ga.tolist()) ^ set(gb.tolist()))
                if only:
                    dj, kth = dg[only], ranked[bi, si, kk - 1]
                    # outside the k nearest: how far past the k-th; inside:
                    # how far before the (k+1)-th
                    beyond = ranked[bi, si, kk] if kk < xyz.shape[1] \
                        else torch.tensor(float("inf"), dtype=dg.dtype)
                    rank = torch.where(dj > kth, dj - kth, beyond - dj)
                    near = torch.minimum((dj - r * r).abs(), rank)
                    gaps.append(float(near.max()))
                gap = max(gap, *gaps)
    return dict(groups=groups, entries=entries, gap=gap)


def registry_unsnapped_msg(roots):
    """The MSG classifier's step of :func:`registry_card_vs_cpu` on the
    clouds as loaded, off :func:`snap_xyz`'s grid, where a point within
    a rounding of a radius (or of the k-th nearest distance) falls on
    either side.  Each ball query's indices are recorded on both devices:
    :func:`_ball_query_differences` counts the groups that differ and
    every point in only one set must lie within ``BOUNDARY_GAP`` of its
    threshold.  The CPU step then runs again on the card's indices and
    must agree with the card's by :func:`_registry_steps_agree`."""
    from prifit_torch.nn import pointnet2
    name = "pointnet2_cls_msg"
    b, n = REGISTRY_CHECK_B.get(name, 8), REGISTRY[name][1]
    points, target = registry_batches(name, roots, b, n, 1, seed=1)[0]
    query = pointnet2.ball_query_nearest_shared

    def step(dev, replay=None):
        calls = []

        def recorded(radii, nsamples, xyz, new_xyz):
            out = (query(radii, nsamples, xyz, new_xyz) if replay is None
                   else [i.to(dev) for i in replay[len(calls)][4]])
            calls.append((radii, nsamples, xyz.detach().double().cpu(),
                          new_xyz.detach().double().cpu(),
                          [i.cpu() for i in out]))
            return out

        pointnet2.ball_query_nearest_shared = recorded
        try:
            return _registry_step(name, dev, points, target), calls
        finally:
            pointnet2.ball_query_nearest_shared = query

    card, card_calls = step("cuda")
    cpu, cpu_calls = step("cpu")
    diff = _ball_query_differences(card_calls, cpu_calls)
    if not diff["gap"] <= BOUNDARY_GAP:
        raise AssertionError(f"{name} ball query card vs cpu: a point "
                             f"{diff['gap']} from its threshold falls on "
                             f"either side ({diff})")
    replayed, _ = step("cpu", replay=card_calls)
    return dict(b=b, loss=(card[0], cpu[0], replayed[0]), **diff,
                grad_err=_registry_steps_agree(
                    name, card, replayed, "card vs cpu on the card's "
                    "neighbours"))


def probe_card_vs_cpu(exp, args):
    """The probe of the run's ``best_model`` on the card and the CPU: the
    feature forward (default dtype, bf16 in eval) on 8 test clouds
    within 2^-6 of the largest pooled feature on the card (four bf16
    steps of it); then the SVM on the card's features
    of every cloud fitted on the card and on the CPU in float64: equal
    test predictions and weights within 1e-6 of their norm, each
    classifier's."""
    from prifit_torch.cli import pretrain_partseg, train_partseg
    from prifit_torch.eval.svm_probe import LinearSVC, \
        extract_global_features, make_feature_forward
    from prifit_torch.models import get_module
    ckpt = torch.load(os.path.join(exp, "checkpoints", "best_model"),
                      weights_only=False)
    feats, models = {}, {}
    for dev in ("cuda", "cpu"):
        model = train_partseg.build_model(args, get_module(args.model), dev)
        model.load_state_dict(ckpt["model_state_dict"])
        models[dev] = make_feature_forward(model)
    loaders = pretrain_partseg.modelnet_loaders(args, log)
    first = next(iter(loaders[1]))[0][:8]
    for dev, fwd in models.items():
        f = fwd(torch.as_tensor(first, device=dev)).float()
        feats[dev] = torch.cat([f.amax(1), f.mean(1)], 1).cpu()
    feat_err = float((feats["cuda"] - feats["cpu"]).abs().max())
    scale = float(feats["cuda"].abs().max())
    if not feat_err <= 2.0 ** -6 * scale:
        raise AssertionError(f"probe features card vs cpu: max abs err "
                             f"{feat_err} (largest {scale})")
    (x_tr, y_tr, _), (x_te, _, _) = (
        extract_global_features(models["cuda"], ld, "cuda") for ld in loaders)
    fits = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        svm = LinearSVC(args.svm_c).fit(x_tr.to(dev), y_tr.to(dev))
        pred = svm.predict(x_te.to(dev)).cpu()
        fits[dev] = (svm, pred, (time.perf_counter() - t0) * 1e3)
    (sg, pg, ms_g), (sc, pc, ms_c) = fits["cuda"], fits["cpu"]
    if not torch.equal(pg, pc):
        raise AssertionError("probe SVM card vs cpu: predictions differ")
    wg = torch.cat([sg.coef_, sg.intercept_[:, None]], 1).cpu()
    wc = torch.cat([sc.coef_, sc.intercept_[:, None]], 1)
    w_err = float(((wg - wc).norm(dim=1) / wc.norm(dim=1)).max())
    if not w_err <= 1e-6:
        raise AssertionError(f"probe SVM card vs cpu: weights {w_err} of "
                             f"their norm apart")
    return dict(feat_err=feat_err, feat_scale=scale, w_err=w_err,
                svm_ms=(ms_g, ms_c), newton=(sg.n_iter_, sc.n_iter_),
                rel_grad=(sg.rel_grad_, sc.rel_grad_), n_train=len(y_tr))


def registry_gathers(name, roots):
    """Every gather table and index of one train-mode forward of ``name``
    on the card, at its recipe's B and N on its own data: as many calls
    as ``REGISTRY`` counts a step."""
    from prifit_torch.ops import sampling
    b, n, _, expected = REGISTRY[name]
    points, _ = registry_batches(name, roots, b, n, 1, seed=2)[0]
    model, _ = registry_model(name, "cuda")
    rows, calls = sampling.gather_rows, []

    def recorded(t, i):
        calls.append((t.detach().clone(), i.clone()))
        return rows(t, i)

    sampling.gather_rows = recorded
    try:
        with torch.no_grad():
            model.train()(torch.as_tensor(points, device="cuda"),
                          generator=torch.Generator(
                              device="cuda").manual_seed(2))
    finally:
        sampling.gather_rows = rows
    if len(calls) != expected["gather"]:
        raise AssertionError(f"{name}: a forward gathered {len(calls)} "
                             f"tables, not {expected['gather']}")
    return calls


def check_registry_kernels(roots):
    """FPS and the gather at the registry's shapes, bit for bit against
    their plain versions: FPS (indices and coordinates, random starts) at
    the classifiers' sa1 (B=24, 1024 -> 512) and the sem-seg model's four
    calls (B=16, 4096 -> 1024 -> 256 -> 64 -> 16); the gather at every
    table and index one forward of each PointNet++ model gives it
    (:func:`registry_gathers`: the classifiers' sa1 xyz and normals and
    sa2 projections, the sem-seg model's sa1-sa4 tables and fp4-fp1 3-NN
    tables).  Times each set beside the plain version, ``torch.gather``
    and its bound."""
    from prifit_torch.kernels import fps, gather
    gen = torch.Generator().manual_seed(21)
    cgen = torch.Generator(device="cuda").manual_seed(21)
    out = {"fps": []}
    for b, chain in ((24, (1024, 512)), (16, (4096, 1024, 256, 64, 16))):
        x = torch.randn((b, chain[0], 3), generator=gen).cuda()
        for n, k in zip(chain, chain[1:]):
            start = torch.randint(0, n, (b,), generator=cgen, device="cuda")
            got = fps.farthest_point_sample(x, k, start)
            ref = fps.fps_plain(x, k, start)
            for g, r, what in zip(got, ref, ("indices", "coordinates")):
                if not torch.equal(g, r):
                    raise AssertionError(
                        f"fps {what} differ at ({b}, {n}) -> {k}: "
                        f"{int((g != r).sum())} entries")
            ops = 9 * b * n * (k - 1)
            byt = nbytes(x, start) + b * k * (8 + 12)
            out["fps"].append(dict(
                shape=(b, n, k), launch_shape=fps.launch_shape(n),
                ms=cuda_ms(lambda: fps.farthest_point_sample(x, k, start),
                           reps=20),
                plain_ms=cuda_ms(lambda: fps.fps_plain(x, k, start), reps=2,
                                 warmup=1),
                bound=bound_ms(byt, ops)))
            x = got[1].contiguous()

    out["gather"] = {}
    for name in ("pointnet2_cls_ssg", "pointnet2_cls_msg",
                 "pointnet2_sem_seg"):
        calls = registry_gathers(name, roots)
        for t, i in calls:
            if not torch.equal(gather.gather_rows(t, i).view(torch.uint8),
                               gather.gather_plain(t, i).view(torch.uint8)):
                raise AssertionError(f"gather differs at {name}'s table "
                                     f"{tuple(t.shape)} / {tuple(i.shape)}")
        lib = [(t, i.reshape(i.shape[0], -1, 1).expand(-1, -1, t.shape[-1]))
               for t, i in calls]
        byt = sum(nbytes(t, i) + i.numel() * t.shape[-1] * t.element_size()
                  for t, i in calls)
        out["gather"][name] = dict(
            calls=[(tuple(t.shape), tuple(i.shape)) for t, i in calls],
            ms=cuda_ms(lambda: [gather.gather_rows(t, i) for t, i in calls]),
            plain_ms=cuda_ms(lambda: [gather.gather_plain(t, i)
                                      for t, i in calls]),
            library_ms=cuda_ms(lambda: [torch.gather(t, 1, i)
                                        for t, i in lib]),
            bound=bound_ms(byt, 0))
    return out


def registry_phase(kernels):
    """The registry's other five models and the pretrainer's ModelNet40
    probe on the card (``registry`` phase), on synthetic trees written
    from seeds under ``log/`` (removed after): a ModelNet40-layout tree
    (40 categories of 8 train and 2 test shapes of 2500 points with
    normals), S3DIS-layout rooms (areas 1-5, 100000 points each) and an
    ACD tree of ``PROBE_ACD_SHAPES`` shapes beside the ModelNet one.

    - The probe: ``pretrain_partseg.main`` with ``--modelnet_val`` and
      ``PRETRAIN_FLAGS`` at B=24, N=2048, the default dtype and the
      recipe's self-sup settings, ``PROBE_EPOCHS`` epochs of 4
      iterations; each iteration and val batch launches what the
      pretrainer phase's do, each probe 18 feature-forward batches of
      ``PROBE_BATCH``; ``metrics.jsonl`` holds each probe's accuracy;
      then :func:`probe_card_vs_cpu` on its ``best_model``.
    - Each model: :func:`registry_train` (launches checked every step)
      and :func:`registry_card_vs_cpu`; the MSG classifier's step also
      off the grid (:func:`registry_unsnapped_msg`).  The sem-seg models
      must reach a block accuracy above 0.55 in one of their last 10
      steps (the JAX package's bar on its room generator,
      ``tests/test_data.py:492``; 13-class chance is below 0.08).
    - The kernels at the registry's shapes (:func:`check_registry_kernels`).
    """
    import shutil
    import tempfile

    from prifit_torch.cli import pretrain_partseg, train_partseg
    from prifit_torch.cli.args_parser import parse_args

    os.makedirs(os.path.join(ROOT, "log"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_registry_",
                           dir=os.path.join(ROOT, "log"))
    try:
        t0 = time.perf_counter()
        roots = {"modelnet": write_modelnet_tree(
                     os.path.join(tmp, "modelnet40_normal_resampled")),
                 "s3dis": write_s3dis_rooms(os.path.join(tmp, "s3dis"))}
        acd = write_acd_tree(os.path.join(tmp, "acd"), PROBE_ACD_SHAPES)
        out = {"write_s": time.perf_counter() - t0}

        args = parse_args(TRAINER_FLAGS + PRETRAIN_FLAGS + [
            "--ss_path", acd, "--experiment_root", os.path.join(tmp, "probe"),
            "--epoch", str(PROBE_EPOCHS), "--modelnet_val"])
        run = _pretrain_run(pretrain_partseg, args, kernels)
        exp = os.path.join(args.experiment_root, "pretrain_"
                           + train_partseg.experiment_name(args))
        with open(os.path.join(exp, "metrics.jsonl")) as f:
            lines = [json.loads(line) for line in f]
        accs = [line["modelnet_svm_acc"] for line in lines]
        if accs != [p["accuracy"] for p in run["probes"]] \
                or len(accs) != PROBE_EPOCHS:
            raise AssertionError(f"probe metrics {lines}, probes "
                                 f"{run['probes']}")
        for i, c in enumerate(run["it_counts"]):
            _check_counts(c, f"probe run iteration {i}")
        for i, c in enumerate(run["val_counts"]):
            _check_counts(c, f"probe run val batch {i}", backward=False)
        n_batches = sum(-(-n * CLS_CLASSES // B) for n in MODELNET_SPLIT)
        want = dict.fromkeys(kernels.KERNELS, 0)
        want.update({k: v * n_batches for k, v in PROBE_BATCH.items()})
        for i, c in enumerate(run["probe_counts"]):
            if c != want:
                raise AssertionError(f"probe {i} launched {c}, not {want}")
        out["probe"] = run
        out["probe_check"] = probe_card_vs_cpu(exp, args)

        out["models"] = {}
        for name in REGISTRY:
            r = registry_train(name, roots, kernels)
            if "sem_seg" in name and not max(r["accs"][-10:]) > 0.55:
                raise AssertionError(f"{name} block accuracy {r['accs']}")
            r["check"] = registry_card_vs_cpu(name, roots)
            out["models"][name] = r
        out["msg_unsnapped"] = registry_unsnapped_msg(roots)
        out["kernels"] = check_registry_kernels(roots)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def log_registry(reg, smi):
    run, chk = reg["probe"], reg["probe_check"]
    log(f"registry: trees written in {reg['write_s']:.1f} s")
    for e, p in enumerate(run["probes"]):
        log(f"registry probe epoch {e + 1} (pretrain_partseg --modelnet_val, "
            f"B={B} N={N}, mxsr): accuracy {p['accuracy']:.4f} (C={p['C']}, "
            f"train {p['train_accuracy']:.4f}); {p['clouds']} clouds in "
            f"{p['extract_s'] * 1e3:.1f} ms, {p['clouds'] / p['extract_s']:.1f}"
            f" clouds/s ({p['load_s'] * 1e3:.1f} ms waiting for batches); SVM "
            f"{p['svm_ms']:.1f} ms ({p['newton_steps']} Newton steps) [{smi}]")
    log(f"registry probe run: {_ms(run['walls'])} ms an iteration; launches "
        f"an iteration {run['it_counts'][-1]}, a probe "
        f"{run['probe_counts'][-1]}")
    log(f"registry probe card vs cpu: pooled features (8 clouds, bf16 eval) "
        f"max abs err {chk['feat_err']:.3g} (largest {chk['feat_scale']:.3g}); "
        f"SVM on {chk['n_train']} card features: predictions equal, weights "
        f"{chk['w_err']:.3g} of their norm apart, card {chk['svm_ms'][0]:.1f} "
        f"ms / cpu {chk['svm_ms'][1]:.1f} ms, Newton steps {chk['newton']}, "
        f"final gradient {chk['rel_grad']} of the weights [{smi}]")
    for name, r in reg["models"].items():
        b, n, steps, _ = REGISTRY[name]
        c = r["check"]
        log(f"registry {name} B={b} N={n} ({steps} Adam steps, f32): "
            f"{_ms(r['walls'][1:])} ms a step ({_spread(r['walls'][1:])}, "
            f"the first left out); peak memory {r['peak'] / 2**30:.2f} GiB "
            f"[{smi}]; losses {[round(x, 4) for x in r['losses']]}; accuracy "
            f"{[round(x, 3) for x in r['accs']]}; launches in the run "
            f"{ {k: v for k, v in r['counts'].items() if v} }; card vs cpu "
            f"B={c['b']}: loss {c['loss'][0]:.7f} / {c['loss'][1]:.7f}, "
            f"largest gradient error {c['grad_err']:.4g} of the norm")
    u = reg["msg_unsnapped"]
    log(f"registry pointnet2_cls_msg card vs cpu off the grid, B={u['b']}: "
        f"loss card {u['loss'][0]:.7f} / cpu {u['loss'][1]:.7f}; ball-query "
        f"groups that differ {u['groups']} ({u['entries']} indices), "
        f"largest float64 distance of such a point from its threshold "
        f"{u['gap']:.3g}; cpu on the card's neighbours: loss "
        f"{u['loss'][2]:.7f}, largest gradient error {u['grad_err']:.4g} of "
        f"the norm")
    k = reg["kernels"]
    for f in k["fps"]:
        log(f"registry fps {f['shape'][:2]} -> {f['shape'][2]}, (T, P) = "
            f"{f['launch_shape']}: bit-equal; kernel_ms {f['ms']:.4f} "
            f"plain_ms {f['plain_ms']:.4f} bound_ms {f['bound'][0]:.4f} "
            f"({f['bound'][1]}) [{smi}]")
    for name, g in k["gather"].items():
        log(f"registry gather, {name}'s forward, tables {g['calls']}: "
            f"bit-equal; "
            f"kernel_ms {g['ms']:.4f} plain_ms {g['plain_ms']:.4f} "
            f"library_ms {g['library_ms']:.4f} bound_ms {g['bound'][0]:.4f} "
            f"[{smi}]")


# ------------------------------------------------ the f32-storage K-max
# region (max_region phase)

# (rows, K, F) of the five K-max regions of an f32 step with the region
# on: the SA scales only (sa3's group-all chain keeps its autodiff max,
# as the JAX package's call_max does)
MAX_REGION_SHAPES = MAX_BWD_SHAPES[:5]


def max_bwd_inputs_f32(gen, rows, K, F):
    """:func:`max_bwd_inputs` in f32 storage: z [rows*K, F] f32 off the
    bf16 grid, ties planted, the BN affine, zsel and out in f32, g f32."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    scale, mean = randn(F), 0.1 * randn(F)
    inv = 0.5 + torch.rand((F,), generator=gen, device="cuda")
    a, c = scale * inv, 0.5 * randn(F)
    zk = randn(rows, K, F)
    zsel = torch.where(a > 0, zk.amax(1), zk.amin(1))
    tie = torch.rand((rows, K, F), generator=gen, device="cuda") < 0.05
    zk = torch.where(tie, zsel[:, None, :], zk)
    out = torch.relu(zsel * a + c)
    return dict(z=zk.reshape(rows * K, F), zsel=zsel, out_bf=out,
                g=randn(rows, F), scale=scale, mean=mean, inv=inv,
                n=float(rows * K))


def check_max_bwd_f32():
    """Kernels #7 and #8 at f32 storage (the f32-storage K-max region's
    z, zsel and out) against their plain versions at the five regions of
    one f32 step with the region on (B=24, N=2048): cnt, gsm and dz bit
    for bit; the five calls timed, kernel and plain version.  The bound
    is bytes: z [rows*K, F] f32 is read once by each pass and dz written
    once, twice the bf16 bytes."""
    from prifit_torch.kernels import max_bwd
    gen = torch.Generator(device="cuda").manual_seed(11)
    calls = []
    for shape in MAX_REGION_SHAPES:
        x = max_bwd_inputs_f32(gen, *shape)
        args = (x["z"], x["zsel"], x["g"], x["out_bf"], None)
        cnt, gsm = max_bwd.cnt_gsm(*args)
        cnt_p, gsm_p = max_bwd.cnt_gsm_plain(*args)
        if not (torch.equal(cnt, cnt_p) and torch.equal(_bits(gsm),
                                                        _bits(gsm_p))):
            raise AssertionError(f"max_bwd_cnt_gsm at f32 storage differs "
                                 f"from its plain version at {shape}")
        if gsm.dtype != torch.float32 or not bool((cnt > 1).any()):
            raise AssertionError(f"f32 storage at {shape}: gsm {gsm.dtype}, "
                                 f"ties {bool((cnt > 1).any())}")
        a, c1, c2 = max_bwd_consts(x, cnt, gsm)
        dargs = (x["z"], x["zsel"], gsm, a, c1, x["mean"], c2, None)
        dz, dz_p = max_bwd.dz(*dargs), max_bwd.dz_plain(*dargs)
        if not torch.equal(_bits(dz), _bits(dz_p)):
            raise AssertionError(
                f"max_bwd_dz at f32 storage differs from its plain version "
                f"at {shape}: {int((_bits(dz) != _bits(dz_p)).sum())} of "
                f"{dz.numel()} elements")
        calls.append((args, dargs, cnt, gsm, dz))
        del x, cnt_p, gsm_p, dz_p
    for bad in (torch.float16, torch.float64):
        z = calls[0][0][0][:64].to(bad)
        try:
            max_bwd.cnt_gsm(z, z[:2], calls[0][0][2][:2], z[:2], None)
        except ValueError:
            continue
        raise AssertionError(f"max_bwd_cnt_gsm took {bad} storage")
    out = {}
    for name, fn, plain, reads, writes, per_elem in (
            ("max_bwd_cnt_gsm", lambda c: max_bwd.cnt_gsm(*c[0]),
             lambda c: max_bwd.cnt_gsm_plain(*c[0]),
             lambda c: c[0][:4], lambda c: (c[2], c[3]), 1),
            ("max_bwd_dz", lambda c: max_bwd.dz(*c[1]),
             lambda c: max_bwd.dz_plain(*c[1]),
             lambda c: c[1][:7], lambda c: (c[4],), 6)):
        ms = cuda_ms(lambda: [fn(c) for c in calls])
        plain_ms = cuda_ms(lambda: [plain(c) for c in calls], reps=3)
        byt = sum(nbytes(*reads(c), *writes(c)) for c in calls)
        ops = sum(per_elem * c[0][0].numel() for c in calls)
        bound, by = bound_ms(byt, ops)
        out[name] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound, bound_by=by, library_ms=None,
                         mbytes=byt / 1e6)
    return out


def max_region_phase(entry, kernels):
    """The f32-storage K-max region (``max_region``, the JAX package's
    ``PRIFIT_MAX_REGION=on``) on the card: kernels #7 and #8 at f32
    storage against their plain versions at its shapes; the f32
    supervised step at B=24, N=2048 with the region on and off, from the
    same weights (dropout off, FPS from index 0): the first step's loss
    within 1e-5 relative and every gradient within 1e-2 of its norm of
    the other's (the region's closed-form batch-norm backward sums in
    another order), then a warm-up and 3 timed steps each, the K-max
    pair launched exactly 5 times a step with the region (once per SA
    scale) and never without it; and one B=2 f32 step with the region on
    the card against the CPU (loss within 1e-5 relative, gradients within
    5e-2 of the norm, as ``train_card_vs_cpu``)."""
    from prifit_torch.models.pointnet2_part_seg_msg import get_loss
    from prifit_torch.train.steps import make_supervised_step
    ts = entry.TRAIN_SETTINGS
    kern = check_max_bwd_f32()
    sup = make_supervised_step(get_loss)
    steps = {}
    for on in (True, False):
        state, points, cls, target = entry.train_flagship(
            B, N, compute_dtype="f32", max_region=on)
        state.model.dropout_rate = 0.0

        def run():
            return sup(state, points, cls, target, ts["lr"],
                       ts["bn_momentum"])

        kernels.reset_launch_counts()
        _, m = run()
        first = dict(loss=m["loss"].item(), counts=kernels.launch_counts(),
                     grads={n: p.grad.detach().clone()
                            for n, p in state.model.named_parameters()})
        r = timed_steps(state, run, kernels, f"f32 max_region={on}")
        want = 15 if on else 0
        for c in (r["counts"], {k: 3 * v for k, v in
                                first["counts"].items()}):
            if not (c["max_bwd_cnt_gsm"] == c["max_bwd_dz"] == want):
                raise AssertionError(f"f32 step max_region={on}: the K-max "
                                     f"pair launched {c} in 3 steps, not "
                                     f"{want} each")
            if c["sr_bf16"] or c["fps"] != 6:
                raise AssertionError(f"f32 step max_region={on}: {c}")
        r.update(first=first)
        steps[on] = r
        del state, points, cls, target
    a, b = steps[True]["first"], steps[False]["first"]
    if not abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"]):
        raise AssertionError(f"f32 step loss with the region {a['loss']}, "
                             f"without {b['loss']}")
    on_off = _worst_grad_err(a["grads"], b["grads"], "region on vs off")
    if not on_off <= 1e-2:
        raise AssertionError(f"f32 step gradients, region on vs off: "
                             f"largest error {on_off} of the norm")
    res = {}
    for dev in ("cuda", "cpu"):
        state, points, cls, target = entry.train_flagship(
            2, N, device=dev, compute_dtype="f32", max_region=True)
        state.model.dropout_rate = 0.0
        _, m = sup(state, points, cls, target, ts["lr"], ts["bn_momentum"])
        res[dev] = (m["loss"].item(), {n: p.grad.float().cpu() for n, p in
                                       state.model.named_parameters()})
    (lg, gg), (lc, gc) = res["cuda"], res["cpu"]
    if not abs(lg - lc) <= 1e-5 * abs(lc):
        raise AssertionError(f"max_region B=2 step loss card {lg} cpu {lc}")
    cvc = _worst_grad_err(gg, gc, "max_region card vs cpu")
    if not cvc <= 5e-2:
        raise AssertionError(f"max_region B=2 step gradients card vs cpu: "
                             f"largest error {cvc} of the norm")
    return dict(kernels=kern, steps=steps, on_off_err=on_off,
                card_vs_cpu=(lg, lc, cvc),
                counts=steps[True]["counts"])


def log_max_region(mr, smi):
    for name, k in mr["kernels"].items():
        log(f"{name} at f32 storage (the five regions of one f32 step with "
            f"max_region, B={B} N={N}): max_abs_err {k['max_abs_err']:.3g} "
            f"kernel_ms {k['ms']:.4f} plain_ms {k['plain_ms']:.4f} "
            f"bound_ms {k['bound_ms']:.4f} ({k['bound_by']}, "
            f"{k['mbytes']:.0f} MB) [{smi}]")
    for on, r in mr["steps"].items():
        t = sorted(r["times"])[1]
        log(f"max_region phase: f32 supervised step B={B} N={N} region "
            f"{'on' if on else 'off'}: {t * 1e3:.1f} ms (median of 3; "
            f"{', '.join(f'{x * 1e3:.1f}' for x in r['times'])}) [{smi}]; "
            f"peak memory {r['peak'] / 2**30:.2f} GiB; launches in 3 steps "
            f"{r['counts']}")
    lg, lc, err = mr["card_vs_cpu"]
    log(f"max_region phase: first-step gradients region on vs off, largest "
        f"error {mr['on_off_err']:.3g} of the norm; B=2 f32 step with the "
        f"region card vs cpu: loss {lg:.7f} / {lc:.7f}, largest gradient "
        f"error {err:.3g} of the norm")


# ------------------------------------------- data and point parallelism
# (parallel phase)

SP_KW = dict(quantile=0.05, msc_iterations=10, max_num_clusters=25,
             n_per_prim=256)
PARALLEL_DIR = os.path.join(ROOT, "log", "parallel")


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _init_group(backend, port, rank, world):
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)


def _nccl_probe(rank, port, errors):
    """One NCCL all-reduce and one ring exchange between two ranks on
    device 0; what NCCL raised goes to the ``errors`` queue."""
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    from prifit_torch.parallel.collectives import ppermute
    try:
        _init_group("nccl", port, rank, 2)
        t = torch.ones(4, device="cuda") * (rank + 1)
        dist.all_reduce(t)
        y = ppermute(t, dist.group.WORLD, 1)
        torch.cuda.synchronize()
        if not (float(t[0]) == 3.0 and float(y[0]) == 3.0):
            raise RuntimeError(f"wrong sums {t.tolist()} {y.tolist()}")
        dist.destroy_process_group()
    except Exception as e:          # noqa: BLE001 - reported, then refused
        lines = [ln for ln in str(e).splitlines() if ln.strip()]
        errors.put(lines[-1] if lines else type(e).__name__)
        sys.exit(1)


def two_rank_backend():
    """``nccl`` if two NCCL ranks on the one card can all-reduce and pass
    a ring (checked in two processes with a 120 s limit), else ``gloo``
    (its collectives take CUDA tensors through host memory,
    ``collectives.through_host``); and what the NCCL attempt gave."""
    ctx = torch.multiprocessing.get_context("spawn")
    port, errors = _free_port(), ctx.Queue()
    procs = [ctx.Process(target=_nccl_probe, args=(r, port, errors))
             for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.time() + 120
    for p in procs:
        p.join(max(1.0, deadline - time.time()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    codes = [p.exitcode for p in procs]
    if not alive and codes == [0, 0]:
        return "nccl", "NCCL took two ranks on one device"
    said = set()
    while not errors.empty():
        said.add(errors.get())
    return "gloo", (f"NCCL refused two ranks on one device: "
                    f"{'; '.join(sorted(said)) or 'no message'} (exit codes "
                    f"{codes}{', timed out' if alive else ''})")


def _sp_inputs(entry, dev):
    """The point-SP inputs at B=24, N=2048: the flagship's train state
    (default dtype, dropout off) and cloud, and blob embeddings and
    points for the sharded clustering."""
    state, points, cls, _ = entry.train_flagship(B, N, device=dev)
    state.model.dropout_rate = 0.0
    emb, xyz = entry.blob_embeddings(B, N)
    return state, points, cls, torch.as_tensor(emb, device=dev), \
        torch.as_tensor(xyz, device=dev)


def _sp_run(entry, kernels, mesh):
    """``cluster_and_fit_point_sharded`` on the blob embeddings and two
    point-SP self-sup steps (``make_selfsup_step_point_sp``, the
    ``--sp_points`` step; the second timed, with the launch counts reset
    just before), on ``mesh``."""
    from prifit_torch.parallel.point_sp import cluster_and_fit_point_sharded
    from prifit_torch.train.steps import make_selfsup_step_point_sp
    ts = entry.TRAIN_SETTINGS
    state, points, cls, emb, xyz = _sp_inputs(entry, "cuda")
    kernels.reset_launch_counts()
    res, prims = cluster_and_fit_point_sharded(
        emb, xyz, mesh=mesh, quantile=0.05, iterations=10,
        max_num_clusters=25)
    torch.cuda.synchronize()
    fit_counts = kernels.launch_counts()
    step = make_selfsup_step_point_sp(mesh=mesh, **SP_KW)
    gen = torch.Generator(device="cuda")
    losses, times = [], []
    for i in range(2):
        gen.manual_seed(5 + i)
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = step(state, points, cls, points, ts["lr"], ts["bn_momentum"],
                    ts["lmbda"], gen, sr_key=entry.DRYRUN_KEY)
        losses.append(m["ss_loss"].item())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return dict(
        weights=res.weights.cpu(), valid=res.valid.cpu(),
        nc=res.num_clusters.tolist(), bw=res.bandwidth.cpu(),
        r=prims.r.detach().cpu(), center=prims.center.detach().cpu(),
        fit_counts=fit_counts, step_counts=kernels.launch_counts(),
        losses=losses, step_ms=times[1] * 1e3,
        params=torch.cat([p.detach().reshape(-1).cpu()
                          for p in state.model.parameters()]),
        peak=torch.cuda.max_memory_allocated())


def _parallel_rank(rank, backend, port, out_dir):
    """One of the two ranks of the parallel phase: the point-SP run on a
    (1, 2) mesh, its results saved for the parent."""
    sys.path.insert(0, ROOT)
    import prifit_torch.entry as entry
    from prifit_torch import kernels
    from prifit_torch.parallel.point_sp import make_dp_sp_mesh
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    _init_group(backend, port, rank, 2)
    try:
        out = _sp_run(entry, kernels, make_dp_sp_mesh(1, 2))
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _slot_match(w_got, v_got, w_ref, v_ref, what):
    """Per shape, the permutation of the valid slots that matches the
    weights ``w_got`` to ``w_ref`` (their columns' cosine), which must
    be a permutation; returns the per-shape permutations."""
    perms = []
    for b in range(w_got.shape[0]):
        gv, rv = v_got[b], v_ref[b]
        if int(gv.sum()) != int(rv.sum()):
            raise AssertionError(f"{what}: shape {b} has {int(gv.sum())} "
                                 f"clusters, the reference {int(rv.sum())}")
        gw, rw = w_got[b][:, gv], w_ref[b][:, rv]
        gn = gw / (gw.norm(dim=0, keepdim=True) + 1e-12)
        rn = rw / (rw.norm(dim=0, keepdim=True) + 1e-12)
        perm = (gn.T @ rn).argmax(0)
        if len(set(perm.tolist())) != len(perm):
            raise AssertionError(f"{what}: shape {b}'s slots do not match")
        perms.append(perm)
    return perms


def parallel_phase(entry, kernels):
    """Data and point parallelism on the card.

    1. The dry run (``entry.dryrun_multichip``: a data-parallel
       supervised and self-sup step, ``cluster_and_fit_point_sharded``
       and a point-SP step, at the default dtype) in one process with no
       process group and on a one-rank NCCL group: the same losses
       (1e-5 relative) and slot counts.
    2. Two ranks on the one card (NCCL if it takes them, else gloo with
       host transfers): ``cluster_and_fit_point_sharded`` on 4-blob
       embeddings at B=24, N=2048 and two ``--sp_points 2`` self-sup
       steps at B=24, N=2048 (the flagship at ``mxsr``, quantile 0.05,
       10 mean-shift steps, 25 slots, 256 samples a primitive), every
       kernel of that path on the card; both ranks hold the same fit and
       parameters; against the same run at world size 1 (a (1, 1) mesh
       in this process): slot counts equal, weights (1e-4), radii and
       centers (1e-3) after slot matching, step losses within 1e-4
       relative; the fit against the unsharded clustering
       (``cluster_batch`` with its kernels, one bandwidth candidate) and
       ``fit_ellipsoids_batch``, and the first step's loss against the
       unsharded self-sup step's (``make_selfsup_step`` with one
       bandwidth candidate; its mean-shift is the 3xTF32 kernel, the
       ring's a plain f32 matmul: 1e-3 relative)."""
    import torch.distributed as dist
    from prifit_torch.clustering.mean_shift import cluster_batch
    from prifit_torch.geometry.fitting import fit_ellipsoids_batch
    from prifit_torch.parallel.point_sp import make_dp_sp_mesh
    from prifit_torch.train.steps import make_selfsup_step
    out = {}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    plain = entry.dryrun_multichip("cuda")
    out["dry_plain_s"] = time.perf_counter() - t0
    _init_group("nccl", _free_port(), 0, 1)
    try:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        one = entry.dryrun_multichip("cuda")
        out["dry_nccl_s"] = time.perf_counter() - t0
        out["dry_counts"] = kernels.launch_counts()
    finally:
        dist.destroy_process_group()
    for k in ("sup_loss", "ss_loss", "sp_loss"):
        if not abs(one[k] - plain[k]) <= 1e-5 * abs(plain[k]):
            raise AssertionError(f"dry run {k}: one-rank NCCL {one[k]}, no "
                                 f"group {plain[k]}")
    if one["sp_clusters"] != plain["sp_clusters"] or min(
            one["sp_clusters"]) < 3:
        raise AssertionError(f"dry run clusters {one['sp_clusters']} / "
                             f"{plain['sp_clusters']}")
    out["dry"] = {k: (one[k], plain[k]) for k in
                  ("sup_loss", "ss_loss", "sp_loss", "sp_clusters")}

    backend, why = two_rank_backend()
    out["backend"], out["backend_why"] = backend, why
    log(f"parallel phase: two ranks on one device use {backend} ({why})")
    os.makedirs(PARALLEL_DIR, exist_ok=True)
    t0 = time.perf_counter()
    torch.multiprocessing.spawn(_parallel_rank,
                                args=(backend, _free_port(), PARALLEL_DIR),
                                nprocs=2, join=True)
    out["two_rank_s"] = time.perf_counter() - t0
    r0, r1 = (torch.load(os.path.join(PARALLEL_DIR, f"rank{r}.pt"))
              for r in range(2))
    for k in ("nc", "losses"):
        if r0[k] != r1[k]:
            raise AssertionError(f"two ranks differ in {k}: {r0[k]} "
                                 f"{r1[k]}")
    for k in ("r", "center", "params"):
        if not torch.equal(r0[k], r1[k]):
            raise AssertionError(f"two ranks differ in {k}")
    counts = r0["step_counts"]
    for k in ("fps", "gather", "max_bwd_cnt_gsm", "max_bwd_dz", "sr_bf16"):
        if counts[k] == 0:
            raise AssertionError(f"the point-SP step never launched {k}: "
                                 f"{counts}")
    if r0["fit_counts"]["nms"] == 0 or r0["fit_counts"]["bandwidth"] == 0:
        raise AssertionError(f"the sharded clustering launched "
                             f"{r0['fit_counts']}")
    if counts["max_bwd_cnt_gsm"] != 6 or counts["fps"] != 2:
        raise AssertionError(f"point-SP step launches {counts}")

    # world size 1, and the unsharded pipelines, in this process
    ref = _sp_run(entry, kernels, make_dp_sp_mesh(1, 1))
    w0 = torch.cat([r0["weights"], r1["weights"]], dim=1)
    _, _, _, emb, xyz = _sp_inputs(entry, "cuda")
    unsh = cluster_batch(emb, quantile=0.05, iterations=10,
                         max_num_clusters=25, num_candidates=1)
    unsh_fit = fit_ellipsoids_batch(xyz, unsh.weights, unsh.valid)
    errs = {}
    for what, (w_ref, v_ref, r_ref, c_ref) in (
            ("world 1", (ref["weights"], ref["valid"], ref["r"],
                         ref["center"])),
            ("unsharded", (unsh.weights.cpu(), unsh.valid.cpu(),
                           unsh_fit.r.detach().cpu(),
                           unsh_fit.center.detach().cpu()))):
        perms = _slot_match(w0, r0["valid"], w_ref, v_ref, what)
        e = [0.0, 0.0, 0.0]
        for b, perm in enumerate(perms):
            gv, rv = r0["valid"][b], v_ref[b]
            e[0] = max(e[0], float((w0[b][:, gv][:, perm]
                                    - w_ref[b][:, rv]).abs().max()))
            e[1] = max(e[1], float((r0["r"][b][gv][perm]
                                    - r_ref[b][rv]).abs().max()))
            e[2] = max(e[2], float((r0["center"][b][gv][perm]
                                    - c_ref[b][rv]).abs().max()))
        if not (e[0] <= 1e-4 and e[1] <= 1e-3 and e[2] <= 1e-3):
            raise AssertionError(f"two-rank fit against {what}: weights, "
                                 f"radii, centers off by {e}")
        errs[what] = e
    for i, (a, b) in enumerate(zip(r0["losses"], ref["losses"])):
        if not abs(a - b) <= 1e-4 * abs(b):
            raise AssertionError(f"point-SP step {i} loss: two ranks {a}, "
                                 f"world 1 {b}")
    ts = entry.TRAIN_SETTINGS
    state, points, cls, _, _ = _sp_inputs(entry, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    kw = {k: SP_KW[k] for k in ("quantile", "max_num_clusters",
                                "n_per_prim")}
    _, m = make_selfsup_step(msc_iterations=SP_KW["msc_iterations"],
                             num_bandwidth_candidates=1, **kw)(
        state, points, cls, points, ts["lr"], ts["bn_momentum"],
        ts["lmbda"], gen, sr_key=entry.DRYRUN_KEY)
    unsh_loss = m["ss_loss"].item()
    if not abs(r0["losses"][0] - unsh_loss) <= 1e-3 * abs(unsh_loss):
        raise AssertionError(f"point-SP step loss {r0['losses'][0]}, the "
                             f"unsharded self-sup step's {unsh_loss}")
    out.update(two=r0, ref=ref, errs=errs, unsh_loss=unsh_loss,
               counts=counts, fit_counts=r0["fit_counts"])
    return out


def log_parallel(par, smi):
    d = par["dry"]
    log(f"parallel phase: dry run (B=2, N=512) one-rank NCCL vs no group: "
        f"{ {k: v for k, v in d.items()} }; {par['dry_nccl_s']:.1f} s / "
        f"{par['dry_plain_s']:.1f} s; launches {par['dry_counts']}")
    two, ref = par["two"], par["ref"]
    log(f"parallel phase: two ranks ({par['backend']}) at B={B} N={N}: "
        f"sharded clustering num_clusters {two['nc']}, fit against world 1 "
        f"and unsharded (weights, radii, centers max abs err) "
        f"{par['errs']}; point-SP step losses {two['losses']} (world 1 "
        f"{ref['losses']}, unsharded self-sup step {par['unsh_loss']:.7f}); "
        f"second step {two['step_ms']:.1f} ms a rank (world 1 "
        f"{ref['step_ms']:.1f} ms) [{smi}]; peak memory a rank "
        f"{two['peak'] / 2**30:.2f} GiB; the two-rank run "
        f"{par['two_rank_s']:.1f} s; launches of the clustering "
        f"{par['fit_counts']}, of one point-SP step {par['counts']}")


# ------------------------------------------------- the lift experiment

# the reduced lift benchmark: the matrix's 8 categories at full width, 12
# labelled shapes a category (6 train, 3 val, 3 test) and 96 ACD shapes
LIFT_TREE = dict(n_cats=8, n_per_cat=12, n_acd=96, n_points=N, seed=0)
# k=1 gives B = min(8, 1 x 8) = 8; the pretrain takes --batch_size too,
# and at 8 its 20% val split of the 96 ACD shapes is 2 batches
LIFT_FLAGS = ["--k_shots", "1", "--seeds", "786", "--arms", "sup,con,pre_con",
              "--pre_epochs", "1", "--epochs", "2", "--epoch_iters", "8",
              "--batch_size", "8", "--npoint", str(N)]
LIFT_PROBE = ["--n", "8", "--batch", "4", "--space", "feat",
              "--npoint", str(N)]
# launches of one mxsr step at any batch: the supervised step, the
# contrastive step (the encoder's alone); of one train-mode forward (a
# step with no backward kernel); and of one eval forward without the
# convex loss
SUP_STEP = dict(fps=2, gather=10, max_bwd_cnt_gsm=6, max_bwd_dz=6,
                sr_bf16=40)
FORWARD = dict(fps=2, gather=10)
EVAL_FORWARD = dict(FORWARD, bn_relu_eval=BN_EVAL_CALLS)
# a lift run's iteration: sup and pre_con a supervised step, con a
# supervised and a contrastive step, the contrastive pretrain one
# contrastive step
LIFT_ITERATION = {"sup": SUP_STEP, "pre_con": SUP_STEP,
                  "con": {k: 2 * v for k, v in SUP_STEP.items()},
                  "pretrain": SUP_STEP}
# a probe batch: the eval forward, then cluster_batch's first bandwidth
# candidate (bandwidth, 10 mean-shift steps, NMS)
LIFT_PROBE_BATCH = dict(EVAL_FORWARD, bandwidth=1, mean_shift=10, nms=3)


def _expected(counts, want):
    return {k: want.get(k, 0) for k in counts}


def _flag(flags, name):
    return flags[flags.index(name) + 1]


class _LiftHooks:
    """Wraps the two CLIs' ``main`` for the matrix tool's in-process
    runs: a synchronize, the host clock and the launch counts after each
    train iteration, per run."""

    def __init__(self, kernels, modules):
        self.kernels, self.modules, self.runs = kernels, modules, []

    def __enter__(self):
        self.saved = [m.main for m in self.modules]
        for m, main in zip(self.modules, self.saved):
            m.main = self._wrap(m.__name__.rsplit(".", 1)[1], main)
        return self

    def __exit__(self, *exc):
        for m, main in zip(self.modules, self.saved):
            m.main = main

    def _wrap(self, cli, main):
        def run(args, device=None, on_iteration=None, **kw):
            marks = []

            def hook(epoch, i):
                torch.cuda.synchronize()
                marks.append((epoch, time.perf_counter(),
                              self.kernels.launch_counts()))
                if on_iteration is not None:
                    on_iteration(epoch, i)

            t0 = time.perf_counter()
            start = self.kernels.launch_counts()
            try:
                return main(args, device=device, on_iteration=hook, **kw)
            finally:
                self.runs.append(dict(
                    cli=cli, args=args, marks=marks, start=start,
                    end=self.kernels.launch_counts(),
                    wall_s=time.perf_counter() - t0))
        return run


def _lift_run_summary(r):
    """Each iteration's launches, the median ms an iteration (the walls
    within an epoch, after its first iteration) and the run's launches."""
    counts, walls = [], []
    prev = (None, None, r["start"])
    for m in r["marks"]:
        counts.append({k: m[2][k] - prev[2][k] for k in m[2]})
        if prev[0] == m[0]:
            walls.append(m[1] - prev[1])
        prev = m
    total = {k: r["end"][k] - r["start"][k] for k in r["end"]}
    return counts, walls, total


def lift_phase(kernels):
    """The few-shot lift experiment (``prifit_torch.tools``) on the card at
    full width: the reduced lift benchmark written by the port's generator
    (``LIFT_TREE``: 8 categories, 12 labelled shapes a category, 96 ACD
    shapes, N=2048), then ``run_fewshot_matrix`` at k=1, seed 786, arms
    ``sup``, ``con`` and ``pre_con`` (a 1-epoch contrastive pretrain) for
    2 epochs of 8 iterations at B=8, each run's record well formed with a
    finite class-average mIoU and each iteration's launches exact
    (``LIFT_ITERATION``); then ``probe_embedding`` on 8 test shapes in
    ``feat`` space at random init and on the pretrain's ``best_model``,
    each batch's launches exact (``LIFT_PROBE_BATCH``)."""
    import shutil
    import tempfile

    from prifit_torch.cli import pretrain_partseg, train_partseg
    from prifit_torch.tools import probe_embedding, run_fewshot_matrix
    from prifit_torch.tools.synthetic_primitive_dataset import \
        make_lift_benchmark

    t_phase = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "log"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="lift_", dir=os.path.join(ROOT, "log"))
    try:
        t0 = time.perf_counter()
        make_lift_benchmark(root, **LIFT_TREE)
        write_s = time.perf_counter() - t0
        kernels.reset_launch_counts()
        with _LiftHooks(kernels, (train_partseg, pretrain_partseg)) as hooks:
            run_fewshot_matrix.main(["--data", root, "--device", "cuda"]
                                    + LIFT_FLAGS)
        with open(os.path.join(root, "results.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        if [r["config"]["arm"] for r in recs] != ["sup", "con", "pre_con"]:
            raise AssertionError(f"lift records {recs}")
        for r in recs:
            keys = {"config", "metrics", "wall_s", "exp_dir"} | (
                {"pretrain_ckpt"} if r["config"]["arm"] == "pre_con"
                else set())
            if set(r) != keys or r["config"]["batch_size"] != int(
                    _flag(LIFT_FLAGS, "--batch_size")) or not (
                    0.0 <= r["metrics"]["class_avg_iou"] <= 1.0):
                raise AssertionError(f"lift record {r}")
        if [h["cli"] for h in hooks.runs] != ["train_partseg", "train_partseg",
                                              "pretrain_partseg",
                                              "train_partseg"]:
            raise AssertionError(f"lift runs {[h['cli'] for h in hooks.runs]}")
        runs = {}
        for name, h in zip(("sup", "con", "pretrain", "pre_con"), hooks.runs):
            counts, walls, total = _lift_run_summary(h)
            want = _expected(counts[0], LIFT_ITERATION[name])
            bad = [c for c in counts if c != want]
            if bad or not counts:
                raise AssertionError(f"lift {name} iteration launched "
                                     f"{bad[:1] or counts}, not {want}")
            runs[name] = dict(iters=len(counts), walls=walls, total=total,
                              wall_s=h["wall_s"], last=counts[-1])
        for name, r in zip(("sup", "con", "pre_con"), recs):
            runs[name].update(miou=r["metrics"]["class_avg_iou"],
                              record_wall_s=r["wall_s"])

        probes = {}
        for tag, ckpt in (("random-init", []), (
                "pre_con pretrain", ["--ckpt", recs[2]["pretrain_ckpt"]])):
            marks = []
            cluster = probe_embedding.cluster_batch

            def counted(*a, **kw):
                out = cluster(*a, **kw)
                torch.cuda.synchronize()
                marks.append(kernels.launch_counts())
                return out

            probe_embedding.cluster_batch = counted
            kernels.reset_launch_counts()
            zero = kernels.launch_counts()
            t0 = time.perf_counter()
            try:
                nmi, clusters = probe_embedding.main(
                    ["--data", root, "--device", "cuda"] + LIFT_PROBE + ckpt)
            finally:
                probe_embedding.cluster_batch = cluster
            wall = time.perf_counter() - t0
            per_batch = [{k: b[k] - a[k] for k in b}
                         for a, b in zip([zero] + marks, marks)]
            want = _expected(zero, LIFT_PROBE_BATCH)
            n, b = (int(_flag(LIFT_PROBE, f)) for f in ("--n", "--batch"))
            if len(per_batch) != -(-n // b) or any(c != want
                                                   for c in per_batch):
                raise AssertionError(f"probe batches launched {per_batch}, "
                                     f"not {want}")
            if not (np.isfinite(nmi).all() and len(nmi) == n):
                raise AssertionError(f"probe NMI {nmi}")
            probes[tag] = dict(nmi=nmi, clusters=clusters, wall_s=wall,
                               counts=_sum_counts(per_batch))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    if phase_s > 150:
        raise AssertionError(f"the lift phase took {phase_s:.1f} s")
    return dict(runs=runs, probes=probes, write_s=write_s, phase_s=phase_s)


def log_lift(lift, smi):
    for name, r in lift["runs"].items():
        miou = (f"; class-avg mIoU {r['miou']:.4f}, record wall_s "
                f"{r['record_wall_s']}" if "miou" in r else "")
        log(f"lift {name} (B={_flag(LIFT_FLAGS, '--batch_size')}, N={N}, "
            f"{r['iters']} iterations): "
            f"{r['wall_s']:.1f} s, {_ms(r['walls'])} ms an iteration "
            f"({_spread(r['walls'])}) [{smi}]{miou}; launches an iteration "
            f"{r['last']}, in the run {r['total']}")
    for tag, p in lift["probes"].items():
        log(f"lift probe [{tag}] {' '.join(LIFT_PROBE)}: NMI "
            f"{np.round(p['nmi'], 4).tolist()} (mean {np.mean(p['nmi']):.4f})"
            f", clusters a shape {p['clusters'].tolist()}; {p['wall_s']:.1f} "
            f"s [{smi}]; launches {p['counts']}")
    log(f"lift phase: {lift['phase_s']:.1f} s (tree written in "
        f"{lift['write_s']:.1f} s)")


# ------------------------------------ the ball-query A/B and the bisection

# ab_ball_query at its own size (B=16, N=1024), its 60 steps cut to 6
AB_STEPS = 6
# run_bf16_bisect on the reduced lift tree (LIFT_TREE), cut to one epoch
# of 3 iterations at its B=24, one seed, with the coarse groups in bf16
# and fq and the whole encoder at mxsr beside its two baselines
BISECT_FLAGS = ["--seeds", "786", "--epochs", "1", "--epoch_iters", "3",
                "--modes", "bf16,fq", "--full_encoders", "mxsr"]
BISECT_VARIANTS = ("f32", "full_bf16", "full_mxsr", "sa_all_bf16",
                   "sa_all_fq", "fp_all_bf16", "fp_all_fq")
# a bisection iteration is one supervised step: at mxsr SUP_STEP; at f32,
# bf16 and fq stages the forward's FPS and gathers alone (no K-max
# backward, no rounding cast)
BISECT_ITERATION = {v: SUP_STEP if v == "full_mxsr" else FORWARD
                    for v in BISECT_VARIANTS}


def _ab_run(ab_ball_query, kernels, fused):
    """``ab_ball_query.run(fused, 0)`` on the card with ``AB_STEPS`` steps
    and the launch counts reset just before; each step's launches and
    wall (after a synchronize), and the held-out forward's launches."""
    make = ab_ball_query.make_supervised_step
    marks = []

    def counted(*a, **kw):
        step = make(*a, **kw)

        def run(*sa, **skw):
            out = step(*sa, **skw)
            torch.cuda.synchronize()
            marks.append((time.perf_counter(), kernels.launch_counts()))
            return out
        return run

    ab_ball_query.make_supervised_step = counted
    kernels.reset_launch_counts()
    zero = kernels.launch_counts()
    t0 = time.perf_counter()
    try:
        losses, train_acc, eval_acc = ab_ball_query.run(
            fused, 0, device="cuda", steps=AB_STEPS)
    finally:
        ab_ball_query.make_supervised_step = make
    wall = time.perf_counter() - t0
    end = kernels.launch_counts()
    counts = [{k: b[1][k] - a[1][k] for k in b[1]}
              for a, b in zip([(t0, zero)] + marks, marks)]
    walls = [b[0] - a[0] for a, b in zip(marks, marks[1:])]
    evalc = {k: end[k] - marks[-1][1][k] for k in end}
    return dict(losses=losses, train_acc=train_acc, eval_acc=eval_acc,
                counts=counts, walls=walls, eval_counts=evalc, wall_s=wall,
                total={k: end[k] - zero[k] for k in end})


def tools_phase(kernels):
    """The ball-query A/B and the bf16 bisection (``prifit_torch.tools``)
    on the card at full width: ``ab_ball_query.run`` at B=16, N=1024 for
    ``AB_STEPS`` steps at the default ``mxsr``, fused and first-k by
    index, seed 0, each step's launches exact (``SUP_STEP``) and the
    held-out forward's (``FORWARD``), finite losses; then
    ``run_bf16_bisect`` on the reduced lift tree (``LIFT_TREE``) with
    ``BISECT_FLAGS``: seven runs of 3 iterations at B=24, N=2048, each
    record well formed with a class-average mIoU in [0, 1], the f32
    baseline and the stage groups on the f32 encoder, and each
    iteration's launches exact (``BISECT_ITERATION``)."""
    import shutil
    import tempfile

    from prifit_torch.cli import train_partseg
    from prifit_torch.tools import ab_ball_query, run_bf16_bisect
    from prifit_torch.tools.synthetic_primitive_dataset import \
        make_lift_benchmark

    t_phase = time.perf_counter()
    ab = {}
    for fused in (True, False):
        r = _ab_run(ab_ball_query, kernels, fused)
        want = _expected(r["counts"][0], SUP_STEP)
        bad = [c for c in r["counts"] if c != want]
        if bad or len(r["counts"]) != AB_STEPS:
            raise AssertionError(f"ab fused={fused} steps launched "
                                 f"{bad[:1] or r['counts']}, not {want}")
        if r["eval_counts"] != _expected(r["eval_counts"], EVAL_FORWARD):
            raise AssertionError(f"ab fused={fused} held-out forward "
                                 f"launched {r['eval_counts']}")
        if not (len(r["losses"]) == AB_STEPS
                and np.isfinite(r["losses"]).all()
                and 0.0 <= r["train_acc"] <= 1.0
                and 0.0 <= r["eval_acc"] <= 1.0):
            raise AssertionError(f"ab fused={fused}: {r['losses']}, "
                                 f"{r['train_acc']}, {r['eval_acc']}")
        ab["fused" if fused else "exact"] = r

    os.makedirs(os.path.join(ROOT, "log"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="bisect_", dir=os.path.join(ROOT, "log"))
    try:
        make_lift_benchmark(root, **LIFT_TREE)
        kernels.reset_launch_counts()
        with _LiftHooks(kernels, (train_partseg,)) as hooks:
            run_bf16_bisect.main(["--data", root, "--device", "cuda"]
                                 + BISECT_FLAGS)
        with open(os.path.join(root, "bisect.jsonl")) as f:
            recs = [json.loads(line) for line in f]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if [r["config"]["variant"] for r in recs] != list(BISECT_VARIANTS) or \
            len(hooks.runs) != len(BISECT_VARIANTS):
        raise AssertionError(f"bisect records {recs}")
    bisect = {}
    for name, rec, h in zip(BISECT_VARIANTS, recs, hooks.runs):
        enc = {"full_bf16": "bf16", "full_mxsr": "mxsr"}.get(name, "f32")
        if set(rec) != {"config", "metrics", "wall_s"} or \
                rec["config"]["encoder_dtype"] != enc or not (
                    0.0 <= rec["metrics"]["class_avg_iou"] <= 1.0):
            raise AssertionError(f"bisect record {rec}")
        counts, walls, total = _lift_run_summary(h)
        want = _expected(counts[0], BISECT_ITERATION[name])
        bad = [c for c in counts if c != want]
        if bad or len(counts) != int(_flag(BISECT_FLAGS, "--epoch_iters")):
            raise AssertionError(f"bisect {name} iteration launched "
                                 f"{bad[:1] or counts}, not {want}")
        bisect[name] = dict(miou=rec["metrics"]["class_avg_iou"],
                            wall_s=h["wall_s"], walls=walls, total=total,
                            last=counts[-1])
    phase_s = time.perf_counter() - t_phase
    if phase_s > 150:
        raise AssertionError(f"the tools phase took {phase_s:.1f} s")
    return dict(ab=ab, bisect=bisect, phase_s=phase_s)


def log_tools(tools, smi):
    for tag, r in tools["ab"].items():
        log(f"ab_ball_query {tag} (B=16, N=1024, {AB_STEPS} steps, seed 0): "
            f"loss {r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}, train acc "
            f"{r['train_acc']:.4f}, held-out acc {r['eval_acc']:.4f}; "
            f"{r['wall_s']:.1f} s, {_ms(r['walls'])} ms a step "
            f"({_spread(r['walls'])}) [{smi}]; launches a step "
            f"{r['counts'][-1]}, held-out forward {r['eval_counts']}")
    for name, r in tools["bisect"].items():
        log(f"run_bf16_bisect {name} (B=24, N={N}, "
            f"{_flag(BISECT_FLAGS, '--epoch_iters')} iterations): class-avg "
            f"mIoU {r['miou']:.4f}; {r['wall_s']:.1f} s, {_ms(r['walls'])} "
            f"ms an iteration [{smi}]; launches an iteration {r['last']}, "
            f"in the run {r['total']}")
    log(f"tools phase: {tools['phase_s']:.1f} s")


# ------------------------------------------ four cards (--four-cards)

FOUR_DIR = os.path.join(ROOT, "log", "four_cards")


def _dp_sup_run(entry, group=None, rank=0, world=1):
    """Four ``mxsr`` supervised steps at B=24, N=2048 from the seed-0
    weights (dropout off, FPS from index 0, one rounding key), each rank
    on its ``B / world`` shard: the losses and the median of the last
    three steps' ms."""
    from prifit_torch.models.pointnet2_part_seg_msg import get_loss
    from prifit_torch.nn.norm import set_process_group
    from prifit_torch.train.steps import make_supervised_step
    ts = entry.TRAIN_SETTINGS
    state, points, cls, target = entry.train_flagship(B, N)
    state.model.dropout_rate = 0.0
    b = B // world
    p, c, t = (x[rank * b:(rank + 1) * b] for x in (points, cls, target))
    set_process_group(state.model, group)
    step = make_supervised_step(get_loss)
    losses, times = [], []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = step(state, p, c, t, ts["lr"], ts["bn_momentum"],
                    sr_key=entry.DRYRUN_KEY)
        losses.append(m["loss"].item())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return dict(losses=losses, ms=sorted(times[1:])[1] * 1e3)


def _four_rank(rank, port):
    """One of four ranks, one card each, on NCCL: the dry run, the
    data-parallel supervised steps and the point-SP run on a (1, 4)
    mesh."""
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    import prifit_torch.entry as entry
    from prifit_torch import kernels
    from prifit_torch.parallel.point_sp import make_dp_sp_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=4)
    try:
        dry = entry.dryrun_multichip("cuda")
        dry = {k: dry[k] for k in ("sup_loss", "ss_loss", "sp_loss",
                                   "sp_clusters", "sp_mesh")}
        sup = _dp_sup_run(entry, dist.group.WORLD, rank, 4)
        sp = _sp_run(entry, kernels, make_dp_sp_mesh(1, 4))
        torch.save(dict(dry=dry, sup=sup, sp=sp),
                   os.path.join(FOUR_DIR, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def four_cards(entry, kernels, smi):
    """Data and point parallelism across four cards on NCCL (``python3
    chip_smoke.py --four-cards``): the dry run at world size 4; the
    data-parallel ``mxsr`` supervised step at B=24, N=2048 (6 a rank)
    against one card's on the whole batch (the first step's loss within
    1e-4 relative; later steps drift apart, bf16 storage being chaotic);
    and the point-SP clustering and steps on a (1, 4) mesh against world
    size 1 (slot counts, weights within 1e-4 after slot matching, losses
    within 1e-4).  Every rank holds the same losses and parameters."""
    from prifit_torch.parallel.point_sp import make_dp_sp_mesh
    if torch.cuda.device_count() < 4:
        raise SystemExit(f"--four-cards needs 4 cards, "
                         f"{torch.cuda.device_count()} found")
    os.makedirs(FOUR_DIR, exist_ok=True)
    one_sup = _dp_sup_run(entry)
    one_sp = _sp_run(entry, kernels, make_dp_sp_mesh(1, 1))
    t0 = time.perf_counter()
    torch.multiprocessing.spawn(_four_rank, args=(_free_port(),), nprocs=4)
    log(f"four ranks ran in {time.perf_counter() - t0:.1f} s")
    rs = [torch.load(os.path.join(FOUR_DIR, f"rank{r}.pt"))
          for r in range(4)]
    for r in rs[1:]:
        if (r["dry"] != rs[0]["dry"] or r["sup"]["losses"] !=
                rs[0]["sup"]["losses"] or r["sp"]["losses"] !=
                rs[0]["sp"]["losses"] or not torch.equal(
                    r["sp"]["params"], rs[0]["sp"]["params"])):
            raise AssertionError("the four ranks differ")
    d = rs[0]["dry"]
    log(f"four cards (NCCL), dry run (B=8, N=512, point-SP mesh "
        f"{d['sp_mesh']}): sup {d['sup_loss']:.7f}, ss {d['ss_loss']:.7f}, "
        f"sp {d['sp_loss']:.7f}, clusters {d['sp_clusters']}")
    a, b = rs[0]["sup"]["losses"][0], one_sup["losses"][0]
    if not abs(a - b) <= 1e-4 * abs(b):
        raise AssertionError(f"four-card supervised loss {a}, one card {b}")
    log(f"four cards, data-parallel mxsr supervised step B={B} N={N} "
        f"({B // 4} a rank): {rs[0]['sup']['ms']:.1f} ms (one card "
        f"{one_sup['ms']:.1f}) [{smi}]; losses {rs[0]['sup']['losses']} "
        f"(one card {one_sup['losses']})")
    w = torch.cat([r["sp"]["weights"] for r in rs], dim=1)
    v = rs[0]["sp"]["valid"]
    perms = _slot_match(w, v, one_sp["weights"], one_sp["valid"],
                        "four cards vs one")
    err = max(float((w[i][:, v[i]][:, p] - one_sp["weights"][i][
        :, one_sp["valid"][i]]).abs().max()) for i, p in enumerate(perms))
    if err > 1e-4:
        raise AssertionError(f"four-card point-SP weights off by {err}")
    for a, b in zip(rs[0]["sp"]["losses"], one_sp["losses"]):
        if not abs(a - b) <= 1e-4 * abs(b):
            raise AssertionError(f"four-card point-SP loss {a}, world 1 {b}")
    log(f"four cards, point-SP (1, 4) at B={B} N={N}: clusters "
        f"{rs[0]['sp']['nc']}, weights {err:.3g} off world 1's; losses "
        f"{rs[0]['sp']['losses']} (world 1 {one_sp['losses']}); second "
        f"step {rs[0]['sp']['step_ms']:.1f} ms a rank (one card "
        f"{one_sp['step_ms']:.1f}) [{smi}]; launches of that step "
        f"{rs[0]['sp']['step_counts']}")


EXTRA_KEYS = ("sparse", "inputs", "device_ms", "int32_ms", "bound_f32_ms",
              "equal_rows_ms", "per_call_ms", "us_per_step", "launch_shapes",
              "registry", "fitting", "mx", "f32_storage")
# what each kernel phase times
CALLS_OF = {"mean_shift_bwd": "one self-sup step",
            "max_bwd_cnt_gsm": "one mxsr train step",
            "max_bwd_dz": "one mxsr train step",
            "sr_bf16": "one mxsr supervised step"}
# the kernels with no TPU counterpart: in the JAX package each is an XLA
# fusion
FUSION_REPLACES = {
    "sr_bf16": "prifit_tpu/nn/mixed.py:115 (sr_bf16, an XLA fusion)",
    "bn_relu_eval": "prifit_tpu/nn/pointnet2.py PointMLP's eval chain with "
                    "prifit_tpu/nn/norm.py BatchNorm (an XLA fusion)"}


def log_kernels(results, smi):
    for name, r in results.items():
        log(f"{name}: max_abs_err {r['max_abs_err']:.3g} kernel_ms "
            f"{r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms "
            f"{r['library_ms']} bound_ms {r['bound'][0]:.4f} "
            f"({r['bound'][1]}) [calls of "
            f"{CALLS_OF.get(name, 'one forward')}, {smi}]")
        if "mx" in r:
            m = r["mx"]
            log(f"  {name}, one mx step (rounding off): kernel_ms "
                f"{m['ms']:.4f} plain_ms {m['plain_ms']:.4f} bound_ms "
                f"{m['bound_ms']:.4f} ({m['bound_by']})")
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


def log_pretrainer(pre, smi):
    run, bare = pre["pretrain"], pre["bare"]
    it = sorted(run["walls"])[len(run["walls"]) // 2]
    iters = len(run["it_counts"]) // PRETRAIN_EPOCHS
    log(f"pretrainer B={B} N={N} (pretrain_partseg.main, "
        f"{' '.join(PRETRAIN_FLAGS[1:])}, mxsr, {PRETRAIN_EPOCHS} epochs of "
        f"{iters} iterations): {it * 1e3:.1f} ms an iteration "
        f"({_spread(run['walls'])}, each epoch's first left out), bare mxsr "
        f"self-sup step {bare['selfsup'] * 1e3:.1f} ms (this call's median), "
        f"gap {(it - bare['selfsup']) * 1e3:+.1f} ms; "
        f"a val batch: an epoch's first {_spread(run['val_first_walls'])}, "
        f"the others {_spread(run['val_walls'])} [{smi}]; launches an "
        f"iteration {run['it_counts'][-1]}, a val batch "
        f"{run['val_counts'][-1]}; second bandwidth candidate in "
        f"{sum(run['retries'])} iterations and {sum(run['val_retries'])} val "
        f"batches; val losses {run['vals']}; beta {run['beta']:.6f}; the "
        f"run {run['total_s']:.1f} s; trees written in "
        f"{pre['write_s']:.1f} s")
    c = pre["contrastive"]
    log(f"pretrainer --ss_loss contrastive (1 epoch): {_ms(c['walls'])} ms "
        f"an iteration ({_spread(c['walls'])}), val batches "
        f"{[round(w * 1e3, 1) for w in c['val_first_walls'] + c['val_walls']]}"
        f" ms [{smi}]; launches an iteration {c['it_counts'][-1]}")
    f = pre["finetune"]
    log(f"train_partseg --pretrained_model <pretrain best_model>: "
        f"{f['restored']['from_file']} of {f['restored']['n']} entries "
        f"restored from the file, equal to it before the first step; "
        f"{_ms(f['walls'])} ms an iteration [{smi}]")
    for name in ("extra_layers", "reconstruct"):
        v = pre[name]
        log(f"train_partseg --{name} ({VARIANT_ITERS} iterations): "
            f"{_ms(v['walls'])} ms an iteration ({_spread(v['walls'])}) "
            f"[{smi}]; launches an iteration {v['last']}")


def log_models(models, smi):
    for name, r in models.items():
        bare = r["bare"]
        steps = bare["supervised"] + bare["selfsup"]
        it = sorted(r["walls"])[len(r["walls"]) // 2]
        c = r["card_vs_cpu"]
        log(f"models: train_partseg "
            f"{' '.join(['--model', name] + MODEL_RUNS[name][0])} B={B} N={N} "
            f"({MODEL_ITERS} iterations): {it * 1e3:.1f} ms an iteration "
            f"({_spread(r['walls'])}, the first left out), bare steps "
            f"{bare['supervised'] * 1e3:.1f} + {bare['selfsup'] * 1e3:.1f} = "
            f"{steps * 1e3:.1f} ms (this call's medians), gap "
            f"{(it - steps) * 1e3:+.1f} ms; host pipeline alone "
            f"{r['host'] * 1e3:.1f} ms; peak memory "
            f"{r['peak'] / 2**30:.2f} GiB [{smi}]; launches an iteration "
            f"{r['last']} (second bandwidth candidate in "
            f"{sum(r['retries'])} of {len(r['retries'])}); final eval "
            f"instance-avg mIoU {r['metrics']['instance_avg_iou']:.6f}; eval "
            f"CLI card vs cpu instance-avg mIoU "
            f"{c['card']['instance_avg_iou']:.6f} / "
            f"{c['cpu']['instance_avg_iou']:.6f}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    import prifit_torch.entry as entry
    from prifit_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi_all = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    smi = smi_all[0]
    log(" | ".join(smi_all))
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    build_s = kernels.build_all()
    log(f"kernels built in {build_s:.1f} s")
    if sys.argv[1:] == ["--four-cards"]:
        four_cards(entry, kernels, smi)
        return

    results = {}
    results["fps"] = check_fps()
    results["gather"] = check_gather()
    dg = check_gather_dgcnn()
    log(f"  gather, DGCNN's three tables (B={B}, N={N}, k=20), bit-equal: "
        f"kernel_ms {dg[0]:.4f} plain_ms {dg[1]:.4f} library_ms "
        f"{dg[2]:.4f} bound_ms {dg[3]:.4f}")
    for c, (knn_ms, dist_ms) in time_dgcnn_knn().items():
        log(f"  DGCNN kNN graph B={B} N={N} C={c} k=20: {knn_ms:.3f} ms "
            f"(the distances alone {dist_ms:.3f} ms, the rest the stable "
            f"sort) [{smi}]")
    X = unit_rows(torch.Generator().manual_seed(3), (B, N, 128))
    results["bandwidth"], kth = check_bandwidth(X)
    bw = torch.sqrt(torch.clamp_min(kth[:, 0], 1e-6)).mean(-1)
    results["mean_shift"] = check_mean_shift(X, bw)
    results["mean_shift_bwd"] = check_mean_shift_bwd(X, bw)
    results["nms"] = check_nms(X, bw)
    del X, kth
    check_ragged()
    results.update(check_max_bwd())
    results["bn_relu_eval"] = check_bn_eval(entry)
    log_kernels(results, smi)
    for c in results["bn_relu_eval"]["per_call_ms"]:
        log(f"  bn_relu_eval call {c}")

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
    pre = pretrainer_phase(kernels, bare)
    log_pretrainer(pre, smi)
    models = models_phase(kernels)
    log_models(models, smi)
    reg = registry_phase(kernels)
    log_registry(reg, smi)
    results["fps"]["registry"] = reg["kernels"]["fps"]
    results["gather"]["registry"] = reg["kernels"]["gather"]
    fit = fitting_phase(kernels)
    log_fitting(fit, smi)
    for name, k in fit["kernels"].items():
        results[name]["fitting"] = dict(
            max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"],
            bound_ms=k["bound"][0], bound_by=k["bound"][1])
    lib = library_phase(kernels)
    log_library(lib, smi)
    dts = dtype_phase(entry, kernels)
    log_dtypes(dts, train, smi)
    mr = max_region_phase(entry, kernels)
    log_max_region(mr, smi)
    for name, k in mr["kernels"].items():
        results[name]["f32_storage"] = {
            key: k[key] for key in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by")}
    par = parallel_phase(entry, kernels)
    log_parallel(par, smi)
    lift = lift_phase(kernels)
    log_lift(lift, smi)
    tools = tools_phase(kernels)
    log_tools(tools, smi)
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
    vc = variants_card_vs_cpu(entry)
    g, c = vc["card"], vc["cpu"]
    log(f"card vs cpu B=2 f32 on blobs (clusters {vc['clusters']}): "
        f"pretrain l2_norm self-sup step (ss_loss, chamfer) "
        f"{g['pretrain']} / {c['pretrain']}, extra_layers self-sup step "
        f"{g['extra_layers']} / {c['extra_layers']}, largest gradient "
        f"errors {vc['grad_err']} of the norm, pretrain embedding norms "
        f"off 1 by {vc['unit_err']:.3g}; reconstruct forward "
        f"total_loss "
        f"{g['reconstruct'][0]:.7f} / {c['reconstruct'][0]:.7f} "
        f"({g['reconstruct'][1]} AtlasNet points); chamfer_loss_dense "
        f"{g['chamfer']:.7f} / {c['chamfer']:.7f}")

    omc = models_card_vs_cpu(entry)
    log(f"card vs cpu B=2 f32, the trainer's other models (DGCNN self-sup "
        f"on blobs, clusters {omc.pop('clusters')}, CPU loss spread "
        f"{omc.pop('spread'):.3g} under the input x (1 +- 2^-20), on the "
        f"CPU's kNN "
        f"graphs; on the card's own graphs ss_loss "
        f"{omc.pop('own_ss_loss'):.7f}, graph entries that differ "
        f"{omc.pop('graph_diff')}): " + "; ".join(
            f"{what} loss {r['loss'][0]:.7f} / {r['loss'][1]:.7f}, largest "
            f"gradient error {r['grad_err']:.4g} of the norm"
            for what, r in omc.items()))

    paths = {"eval_forward": counts}
    for dt, tag in (("auto", "mxsr"), ("f32", "f32")):
        paths[f"supervised_step_{tag}"] = train[dt]["supervised"]["counts"]
        paths[f"selfsup_step_{tag}"] = train[dt]["selfsup"]["counts"]
    paths.update({name: r["counts"] for name, r in objectives.items()})
    paths["trainer"] = tr["counts"]
    paths["pretrainer"] = _sum_counts(pre["pretrain"]["it_counts"])
    paths["pretrain_val"] = _sum_counts(pre["pretrain"]["val_counts"])
    paths["extra_layers"] = pre["extra_layers"]["counts"]
    paths["reconstruct"] = pre["reconstruct"]["counts"]
    paths.update({f"model_{name}": r["counts"] for name, r in models.items()})
    paths["probe"] = _sum_counts(reg["probe"]["probe_counts"])
    paths.update({f"model_{name}": r["counts"]
                  for name, r in reg["models"].items()})
    paths["trainer_mx"] = tr["encoder_dtype_mx"]["counts"]
    paths["fitting"] = fit["counts"]
    paths["library"] = lib["counts"]
    paths.update({f"dtype_{mode}": _sum_counts(
        [r["supervised"]["counts"], r["selfsup"]["counts"]])
        for mode, r in dts.items()})
    paths["max_region_f32"] = mr["counts"]
    paths["parallel_dryrun"] = par["dry_counts"]
    paths["parallel_sp_cluster"] = par["fit_counts"]
    paths["parallel_sp_step"] = par["counts"]
    paths.update({f"lift_{name}": r["total"]
                  for name, r in lift["runs"].items()})
    paths.update({f"lift_probe_{tag.split()[0]}": p["counts"]
                  for tag, p in lift["probes"].items()})
    paths.update({f"ab_{tag}": r["total"] for tag, r in tools["ab"].items()})
    paths.update({f"bisect_{name}": r["total"]
                  for name, r in tools["bisect"].items()})
    rows = []
    for name, k in kernels.KERNELS.items():
        r = results[name]
        rows.append(dict(
            name=name, route="cuda", source=k.source_path,
            replaces=k.replaces or FUSION_REPLACES[name],
            tpu_kernel=bool(k.replaces),
            launches=sum(c[name] for c in paths.values()),
            launches_by_path={p: c[name] for p, c in paths.items()},
            launches_per_trainer_iteration=tr["last"][name],
            launches_per_pretrain_iteration=pre["pretrain"]["it_counts"][-1][
                name],
            launches_per_pretrain_val_batch=pre["pretrain"]["val_counts"][-1][
                name],
            launches_per_model_iteration={
                m: r["last"][name] for m, r in models.items()},
            launches_per_lift_iteration={
                m: r["last"][name] for m, r in lift["runs"].items()},
            launches_per_tools_iteration={
                **{f"ab_{t}": r["counts"][-1][name]
                   for t, r in tools["ab"].items()},
                **{f"bisect_{m}": r["last"][name]
                   for m, r in tools["bisect"].items()}},
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
