"""Where the device time of the flagship eval forward with fit goes.

    python -m prifit_torch.profile_forward

Builds the flagship model at B=24, N=2048 with seeded random weights
(``entry.flagship``), warms it up, and profiles one forward with
``torch.profiler``.  It prints the card's name and power limit, then:

  1. per stage, its span on the device (from its first kernel's start to
     its last kernel's end: the device-side mirror of its profiler range),
     the device time of the kernels that start within that span, and the
     stage's host time.  The encoder stages are the model's submodules
     (sa1..fp1), given profiler ranges by forward hooks; the clustering
     and geometry stages are the ``record_function`` ranges in
     ``clustering/mean_shift.py`` and ``geometry/convex_loss.py``.  A
     stage that does not appear on both sides of the profile raises.
     (The kernels launched through ``ctypes`` are not linked to the CPU
     range around them, so a range's own device total leaves them out;
     its device-side mirror does not.)
  2. the device's busy and idle share of the forward's wall time;
  3. device time by kernel, the largest first.

Needs a CUDA device.
"""

import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from prifit_torch import entry

ENCODER_STAGES = ("sa1", "sa2", "sa3", "fp3", "fp2", "fp1")
# the ranges of convex_loss, each with the ranges nested in it
CONVEX_STAGES = {
    "cluster_batch": ("bandwidth_candidates", "mean_shift_iterations",
                      "nms_fixed_slots", "membership"),
    "fit_ellipsoids_batch": (),
    "sample_primitives_batch": (),
    "analytic_chamfer": (),
}
STAGES = ENCODER_STAGES + tuple(
    s for top, inner in CONVEX_STAGES.items() for s in (top,) + inner)
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


def profile_forward(model, points, cls):
    """Profiles one forward: ``(wall_s, stages, kernels)``, where
    ``stages`` maps each stage to its (device span us, device busy us,
    host us) and ``kernels`` lists (name, device us, count), the largest
    first."""
    hooks = _encoder_ranges(model)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            entry.eval_forward(model, points, cls, **entry.BENCH_KWARGS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for h in hooks:
            h.remove()
    events = prof.events()
    # device-side kernels and copies, without the ranges' mirrors
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and e.name not in STAGES]
    host, spans = {}, {}
    for e in events:
        if e.name in STAGES:
            side = host if e.device_type == DeviceType.CPU else spans
            side.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    missing = [s for s in STAGES if s not in host or s not in spans]
    if missing:
        raise RuntimeError(f"stages missing from the profile: {missing}")
    stages = {}
    for name in STAGES:
        busy = sum(k.time_range.elapsed_us() for k in device
                   if any(a <= k.time_range.start < b
                          for a, b in spans[name]))
        stages[name] = (sum(b - a for a, b in spans[name]), busy,
                        sum(b - a for a, b in host[name]))
    # an aten op's row repeats the time of the kernels it launched, so
    # only device-side rows are summed
    kernels = sorted(((e.key, e.self_device_time_total, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0
                      and e.key not in STAGES), key=lambda r: -r[1])
    return wall, stages, kernels


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
    print("stage: device span ms, device busy ms (kernels in the span), "
          "host ms")
    for top in ENCODER_STAGES + tuple(CONVEX_STAGES):
        for name in (top,) + CONVEX_STAGES.get(top, ()):
            span, dev, host = stages[name]
            indent = "  " if name == top else "    . "
            print(f"{indent}{name:28s} {span / 1e3:9.3f} {dev / 1e3:9.3f} "
                  f"{host / 1e3:9.3f}")
    outside = busy - sum(stages[s][1] for s in ENCODER_STAGES
                         + tuple(CONVEX_STAGES)) / 1e3
    print(f"  {'busy outside the stages':28s} {outside:19.3f}")
    print(f"profiled forward: wall {wall * 1e3:.3f} ms, device busy "
          f"{busy:.3f} ms ({100 * busy / (wall * 1e3):.1f}%), idle "
          f"{100 - 100 * busy / (wall * 1e3):.1f}%")
    print("device ms by kernel (self), top:")
    for key, us, count in kernels[:TOP_KERNELS]:
        print(f"  {us / 1e3:9.3f}  x{count:<5d} {key[:100]}")


if __name__ == "__main__":
    main()
