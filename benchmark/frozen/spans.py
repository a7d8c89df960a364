"""Frozen copy of ``prifit_torch/profile_forward.py``'s device-span
arithmetic at commit 0adee2a (``_encoder_ranges``, ``_ranges``,
``_device_kernels``, ``_stage_times``), with the set of range names an
argument instead of that module's constant.

A range's device span runs from its first kernel's start to its last
kernel's end (the device-side mirror of a ``record_function`` range);
its device busy time is the time of the kernels that START within that
span.  Kernels launched through ``ctypes`` are not linked to the CPU
range around them, so a range's own device total would leave them out;
its device-side mirror does not."""

from torch.autograd import DeviceType
from torch.profiler import record_function


def encoder_ranges(modules):
    """Forward hooks that open a profiler range around each ``(name,
    module)``; returns their handles."""
    hooks = []
    for name, sub in modules:
        rng = record_function(name)

        def pre(_m, _a, rng=rng):
            rng.__enter__()

        def post(_m, _a, _o, rng=rng):
            rng.__exit__(None, None, None)

        hooks += [sub.register_forward_pre_hook(pre),
                  sub.register_forward_hook(post)]
    return hooks


def ranges(events, names):
    """Each range of ``names``' host intervals and device-side intervals,
    ``({name: [(start_us, end_us)]}, {name: [...]})``; a range that shows
    on neither side is absent."""
    host, spans = {}, {}
    for e in events:
        if e.name in names:
            side = host if e.device_type == DeviceType.CPU else spans
            side.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    return host, spans


def device_kernels(events, names):
    """Device-side kernels and copies, without the ranges' mirrors:
    ``[(name, start_us, end_us)]`` sorted by start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in events if e.device_type == DeviceType.CUDA
                   and e.name not in names), key=lambda k: k[1])


def busy_in(kernels, intervals):
    """Device us of the kernels that start within any of ``intervals``."""
    return sum(b - a for _, a, b in kernels
               if any(s <= a < e for s, e in intervals))
