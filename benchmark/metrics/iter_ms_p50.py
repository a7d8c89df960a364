"""The median of the window's iteration times (the CUDA events of
``iter_ms_p90``)."""

import statistics


def read(run):
    return statistics.median(run.iter_ms)
