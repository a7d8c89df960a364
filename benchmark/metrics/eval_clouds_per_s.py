"""Clouds the eval cell's forwards consumed in the window, over the
window's host seconds (the arithmetic of ``train_clouds_per_s``, a metric
of its own: the eval's runs spread far less than the trainer's, whose
host pipeline stalls, so it holds a tighter bound)."""

from benchmark.metrics.train_clouds_per_s import read  # noqa: F401
