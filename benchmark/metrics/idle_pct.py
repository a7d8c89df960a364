"""Share of an untraced iteration in which the device runs no kernel, %:
one minus the device busy time an iteration (the union of the kernels'
intervals in the profiled stretch, over its iterations) over the median
of the window's untraced iteration times.  The profiler's own host cost
stretches the profiled iterations (a third, on the MSG trainer), so the
stretch's own idle share would read the profiler; the device's kernel
times it reads are the program's."""

import statistics


def read(run):
    t = run.trace
    times = run.untraced_ms()
    if t is None or not t.n_iterations or not times:
        return None
    busy_ms = t.busy_s * 1e3 / t.n_iterations
    return 100.0 * (1.0 - busy_ms / statistics.median(times))
