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
    package's ``jax_debug_nans`` also checks forward values);
  - the program's counters (:func:`count`, :func:`add_seconds`,
    :func:`keep`, read by :func:`counters`).

The counters record only while a ``torch.profiler`` session records, on
every thread: they test the profiler's process-wide flag, since its
per-thread state reads off on a thread started before the session (a
data loader's producer).  Outside a session a call is that one test.
The first call that records after a call that saw no session clears
them, so that they hold one session's work, readable after it ends.
"""

import contextlib
import threading
import time

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler
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


_lock = threading.Lock()
_counts: dict = {}
_kept: dict = {}
_stale = True


def recording() -> bool:
    """Whether a profiler session records, on any thread."""
    global _stale
    if not _autograd_profiler._is_profiler_enabled:
        if not _stale:
            # marked under the lock after reading the flag again, so that
            # a thread that saw no session cannot mark one that has
            # started since (and has cleared the counters) as stale
            with _lock:
                if not _autograd_profiler._is_profiler_enabled:
                    _stale = True
        return False
    if _stale:
        with _lock:
            if _stale and _autograd_profiler._is_profiler_enabled:
                _counts.clear()
                _kept.clear()
                _stale = False
    return True


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name``."""
    if not recording():
        return
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def add_seconds(name: str, s: float) -> None:
    """Add ``s`` host seconds to the counter ``name``."""
    count(name, s)


def keep(name: str, tensor: torch.Tensor) -> None:
    """Add the sum of ``tensor`` (a small device tensor, held by
    reference) to the counter ``name`` when the counters are read, so
    that counting never waits for the device."""
    if not recording():
        return
    with _lock:
        _kept.setdefault(name, []).append(tensor.detach())


def counters() -> dict:
    """The counters of the last session, ``{name: number}``, each kept
    counter summed (which waits for the device).  Read outside a
    session, like any call, it lets the next session start from zero."""
    recording()
    with _lock:
        out = dict(_counts)
        kept = {k: list(v) for k, v in _kept.items()}
    for name, ts in kept.items():
        out[name] = sum(t.sum().item() for t in ts)
    return out
