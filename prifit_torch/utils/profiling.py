"""Tracing, step timing and a NaN sanitizer.

Port of ``prifit_tpu/utils/profiling.py``:

  - :func:`trace`: a ``torch.profiler`` trace of a block (CPU, and CUDA
    where a card is present), written into ``logdir`` as a
    TensorBoard-readable Chrome trace;
  - :func:`sync` and :class:`StepTimer`: wall-clock step times that wait
    for the result's CUDA device (on the CPU there is nothing to wait
    for);
  - :func:`debug_nans`: ``torch.autograd`` anomaly detection with its NaN
    check, which raises where a backward function returns NaN (the JAX
    package's ``jax_debug_nans`` also checks forward values).
"""

import contextlib
import time

import numpy as np
import torch
from torch.utils._pytree import tree_leaves


@contextlib.contextmanager
def trace(logdir: str):
    """Profile a block: ``with trace('/tmp/prof'): step(...)``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Anomaly detection with the NaN check on (or off) within a block."""
    with torch.autograd.set_detect_anomaly(enable, check_nan=True):
        yield


def sync(x) -> float:
    """Wait for the first tensor of ``x`` (a tensor or a nest of them) and
    return its first element: its CUDA device is synchronized first."""
    leaf = tree_leaves(x)[0]
    if isinstance(leaf, torch.Tensor):
        if leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
        return float(leaf.detach().reshape(-1)[0])
    return float(np.ravel(np.asarray(leaf))[0])


class StepTimer:
    """Accumulates device-synced step times; reports mean/p50/p95."""

    def __init__(self, sync_overhead_s: float = 0.0):
        self.times = []
        self.overhead = sync_overhead_s

    @contextlib.contextmanager
    def step(self, result_getter=None):
        t0 = time.perf_counter()
        holder = {}

        def done(result):
            holder["r"] = result

        yield done
        if "r" in holder:
            sync(holder["r"])
        self.times.append(time.perf_counter() - t0 - self.overhead)

    def time_fn(self, fn, *args, warmup: int = 1, reps: int = 10):
        """Time ``fn(*args)`` (returning a tensor or a nest of them);
        returns seconds a call."""
        for _ in range(warmup):
            sync(fn(*args))
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        sync(out)
        dt = (time.perf_counter() - t0 - self.overhead) / reps
        self.times.append(dt)
        return dt

    def summary(self) -> dict:
        t = np.asarray(self.times)
        if t.size == 0:
            return {}
        return {"mean_s": float(t.mean()), "p50_s": float(np.median(t)),
                "p95_s": float(np.percentile(t, 95)), "n": int(t.size)}
