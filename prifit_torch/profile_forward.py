"""Where the device time of the flagship's eval forward with fit, and of
one self-sup train step, goes.

    python -m prifit_torch.profile_forward

Builds the flagship at B=24, N=2048 with seeded random weights, warms it
up, and profiles with ``torch.profiler``.  It prints the card's name and
power limit, then for one eval forward (``entry.flagship``, default dtype):

  1. per stage, its span on the device (from its first kernel's start to
     its last kernel's end: the device-side mirror of its profiler range),
     the device time of the kernels that start within that span, and the
     stage's host time.  The encoder stages are the model's submodules
     (sa1..fp1), given profiler ranges by forward hooks; the clustering,
     geometry and contrastive-loss stages are the ``record_function``
     ranges in ``clustering/mean_shift.py``, ``geometry/convex_loss.py``
     and ``models/common.py``.  A stage that the run should show and
     does not appear on both sides of the profile raises.
     (The kernels launched through ``ctypes`` are not linked to the CPU
     range around them, so a range's own device total leaves them out;
     its device-side mirror does not.)
  2. the device's busy and idle share of the forward's wall time;
  3. device time by kernel, the largest first.

Then the same for each train step of :data:`STEPS`
(``entry.train_flagship`` at the default encoder dtype, ``"auto"`` =
``mxsr``), each after a warm-up step: the self-sup step at the bench
settings, the same with every option of the convex loss (entropy,
intersection, pruning; ``alpha`` 0.01) for ellipsoids and for cuboids,
and the contrastive step.  For each, the stage table of its forward (the
``train_forward`` range of ``train/steps.py``), the busy and idle share,
and its backward by kernel: the device kernels that start after the
forward's device span ends and before the optimizer's
(``optimizer_step``) begins.  The backward runs on autograd's own
thread, so a range around it would have no device-side mirror.

Needs a CUDA device.
"""

import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from prifit_torch import entry

ENCODER_STAGES = ("sa1", "sa2", "sa3", "fp3", "fp2", "fp1")
# the ranges of convex_loss in order, each with the ranges nested in it
CONVEX_STAGES = {
    "entropy_loss": (),
    "cluster_batch": ("bandwidth_candidates", "mean_shift_iterations",
                      "nms_fixed_slots", "membership"),
    "fit_ellipsoids_batch": (),
    "sample_primitives_batch": (),
    "prune_mask": (),
    "analytic_chamfer": (),
    "intersection_loss": (),
}
# the ranges only the convex loss's options open
OPTION_STAGES = ("entropy_loss", "prune_mask", "intersection_loss")
CONVEX = tuple(s for top, inner in CONVEX_STAGES.items()
               for s in (top,) + inner)
# the contrastive step's loss (models/common.py)
CONTRASTIVE = ("pairwise_contrastive_loss",)
STAGES = ENCODER_STAGES + CONVEX + CONTRASTIVE
DEFAULT_STAGES = ENCODER_STAGES + tuple(s for s in CONVEX
                                        if s not in OPTION_STAGES)
STEP_RANGES = ("train_forward", "optimizer_step")
# the profiled train steps: (name, kind, convex-loss arguments beyond the
# bench settings, the stages its forward must show)
STEPS = (
    ("self-sup", "selfsup", {}, DEFAULT_STAGES),
    ("self-sup with every option", "selfsup", entry.SELFSUP_OPTIONS,
     ENCODER_STAGES + CONVEX),
    ("self-sup with every option, cuboids", "selfsup",
     dict(entry.SELFSUP_OPTIONS, if_cuboid=True), ENCODER_STAGES + CONVEX),
    ("contrastive", "contrastive", None, ENCODER_STAGES + CONTRASTIVE),
)
RANGES = STAGES + STEP_RANGES
TOP_KERNELS = 25


def _encoder_ranges(model):
    """Forward hooks that open a profiler range around each encoder
    stage; returns their handles."""
    hooks = []
    for name in ENCODER_STAGES:
        rng = record_function(name)

        def pre(_m, _a, rng=rng):
            rng.__enter__()

        def post(_m, _a, _o, rng=rng):
            rng.__exit__(None, None, None)

        sub = getattr(model, name)
        hooks += [sub.register_forward_pre_hook(pre),
                  sub.register_forward_hook(post)]
    return hooks


def _profile(model, run):
    """``run()`` once under the profiler with the encoder ranges hooked
    in: ``(wall_s, events, key_averages)``."""
    hooks = _encoder_ranges(model)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for h in hooks:
            h.remove()
    return wall, prof.events(), prof.key_averages()


def _ranges(events, names):
    """Each range's host intervals and device-side intervals; raises if
    one of ``names`` is missing from either side."""
    host, spans = {}, {}
    for e in events:
        if e.name in RANGES:
            side = host if e.device_type == DeviceType.CPU else spans
            side.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    missing = [s for s in names if s not in host or s not in spans]
    if missing:
        raise RuntimeError(f"ranges missing from the profile: {missing}")
    return host, spans


def _device_kernels(events):
    """Device-side kernels and copies, without the ranges' mirrors."""
    return [e for e in events if e.device_type == DeviceType.CUDA
            and e.name not in RANGES]


def _stage_times(events, names):
    """Each stage of ``names``' (device span us, device busy us, host
    us)."""
    host, spans = _ranges(events, names)
    device = _device_kernels(events)
    stages = {}
    for name in names:
        busy = sum(k.time_range.elapsed_us() for k in device
                   if any(a <= k.time_range.start < b
                          for a, b in spans[name]))
        stages[name] = (sum(b - a for a, b in spans[name]), busy,
                        sum(b - a for a, b in host[name]))
    return stages


def _by_kernel(averages):
    """(name, device us, count) of every device kernel, the largest
    first.  An aten op's row repeats the time of the kernels it launched,
    so only device-side rows are summed."""
    return sorted(((e.key, e.self_device_time_total, e.count)
                   for e in averages
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0
                   and e.key not in RANGES), key=lambda r: -r[1])


def profile_forward(model, points, cls):
    """Profiles one eval forward: ``(wall_s, stages, kernels)``, where
    ``stages`` maps each stage to its (device span us, device busy us,
    host us) and ``kernels`` lists (name, device us, count), the largest
    first."""
    wall, events, averages = _profile(model, lambda: entry.eval_forward(
        model, points, cls, **entry.BENCH_KWARGS))
    return wall, _stage_times(events, DEFAULT_STAGES), _by_kernel(averages)


def profile_step(state, run, stages):
    """Profiles one train step ``run()`` whose forward shows the ranges
    ``stages``: ``(wall_s, stages, kernels, backward, optimizer_us)``;
    ``backward`` lists the (name, device us, count) of the kernels between
    the forward's and the optimizer's device spans, the largest first."""
    wall, events, averages = _profile(state.model, run)
    _, spans = _ranges(events, ("train_forward", "optimizer_step"))
    fwd_end = max(b for _, b in spans["train_forward"])
    opt_start = min(a for a, _ in spans["optimizer_step"])
    backward = {}
    for k in _device_kernels(events):
        if fwd_end <= k.time_range.start < opt_start:
            us, n = backward.get(k.name, (0.0, 0))
            backward[k.name] = (us + k.time_range.elapsed_us(), n + 1)
    backward = sorted(((name, us, n) for name, (us, n) in backward.items()),
                      key=lambda r: -r[1])
    opt_us = sum(b - a for a, b in spans["optimizer_step"])
    return (wall, _stage_times(events, stages), _by_kernel(averages),
            backward, opt_us)


def _print_stages(stages, busy_ms):
    print("stage: device span ms, device busy ms (kernels in the span), "
          "host ms")
    tops = ENCODER_STAGES + tuple(CONVEX_STAGES) + CONTRASTIVE
    for top in tops:
        for name in (top,) + CONVEX_STAGES.get(top, ()):
            if name not in stages:
                continue
            span, dev, host = stages[name]
            indent = "  " if name == top else "    . "
            print(f"{indent}{name:28s} {span / 1e3:9.3f} {dev / 1e3:9.3f} "
                  f"{host / 1e3:9.3f}")
    outside = busy_ms - sum(stages[s][1] for s in tops
                            if s in stages) / 1e3
    print(f"  {'busy outside the stages':28s} {outside:19.3f}")


def _print_kernels(title, kernels):
    print(title)
    for key, us, count in kernels[:TOP_KERNELS]:
        print(f"  {us / 1e3:9.3f}  x{count:<5d} {key[:100]}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    B, N = entry.BENCH_BATCH, entry.BENCH_NPOINT
    print(f"card: {card}; B={B} N={N}", flush=True)
    model, points, cls = entry.flagship(B, N)
    for _ in range(2):
        entry.eval_forward(model, points, cls, **entry.BENCH_KWARGS)
    torch.cuda.synchronize()

    wall, stages, kernels = profile_forward(model, points, cls)
    busy = sum(r[1] for r in kernels) / 1e3
    print("== eval forward with fit")
    _print_stages(stages, busy)
    print(f"profiled forward: wall {wall * 1e3:.3f} ms, device busy "
          f"{busy:.3f} ms ({100 * busy / (wall * 1e3):.1f}%), idle "
          f"{100 - 100 * busy / (wall * 1e3):.1f}%")
    _print_kernels("device ms by kernel (self), top:", kernels)
    del model

    from prifit_torch.models.pointnet2_part_seg_msg import get_selfsup_loss
    from prifit_torch.train.steps import make_contrastive_step, \
        make_selfsup_step
    ts = entry.TRAIN_SETTINGS
    for title, kind, options, names in STEPS:
        state, points, cls, _ = entry.train_flagship(B, N)
        gen = torch.Generator(device="cuda").manual_seed(0)
        if kind == "selfsup":
            step = make_selfsup_step(**entry.BENCH_KWARGS, **options)
            args = (points, cls, points)
        else:
            step = make_contrastive_step(get_selfsup_loss)
            args = (points, cls, entry.acd_labels(points))

        def run():
            step(state, *args, ts["lr"], ts["bn_momentum"], ts["lmbda"],
                 gen)

        run()
        torch.cuda.synchronize()
        wall, stages, kernels, backward, opt_us = profile_step(state, run,
                                                               names)
        busy = sum(r[1] for r in kernels) / 1e3
        bwd = sum(r[1] for r in backward) / 1e3
        print(f"== {title} train step (default encoder dtype, mxsr), "
              f"forward stages")
        _print_stages(stages, busy)
        print(f"profiled step: wall {wall * 1e3:.3f} ms, device busy "
              f"{busy:.3f} ms ({100 * busy / (wall * 1e3):.1f}%), idle "
              f"{100 - 100 * busy / (wall * 1e3):.1f}%; backward kernels "
              f"{bwd:.3f} ms busy; optimizer span {opt_us / 1e3:.3f} ms")
        _print_kernels("backward device ms by kernel, top:", backward)
        _print_kernels("step device ms by kernel (self), top:", kernels)
        del state, step, run


if __name__ == "__main__":
    main()
