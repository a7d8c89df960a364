"""The 90th percentile (nearest rank) of the window's iteration times,
each the interval between consecutive CUDA events recorded after each
iteration (the first from one recorded before the window)."""

from benchmark.harness import percentile


def read(run):
    return percentile(run.iter_ms, 90)
