"""The mean-shift forward's share of its roofline, %: the least time of
the steps the traced iterations ran (the shapes of each call of
``mean_shift_iterations``, retries included, counted by
:mod:`benchmark.frozen.roofline`) over the device time in the
``mean_shift_iterations`` ranges.  The time is read through the range,
not a kernel's name, so a replaced kernel is measured on the same work.
The range holds the forward only: the backward runs after the forward's
span."""

from benchmark.frozen.roofline import mean_shift_bound_ms


def read(run):
    t = run.trace
    calls = run.entry.mean_shift.calls
    if t is None or not calls:
        return None
    busy = t.busy_ms(["mean_shift_iterations"])
    if not busy:
        return None
    bound = sum(mean_shift_bound_ms(B, N, D, steps)[0]
                for (B, N, D), steps in calls) / t.n_iterations
    return 100.0 * bound / busy
