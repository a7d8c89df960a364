"""What the program records of itself, for the metric readers: its host
ranges in the traced stretch and its counters
(``prifit_torch.utils.profiling``).

:class:`benchmark.traced.Trace` keeps only the ranges that show on both
sides of the profile; a range that launches no device work (a host
sync's wait, the data wait) has no device mirror, so these readers take
the host events themselves.  Host and device events share the
profiler's clock.  A program that records none of this (an earlier
commit) gives None, and raises nothing."""

import bisect

from benchmark.traced import ITERATION_RANGE

SYNC = "sync."


def iterations(trace) -> int:
    """The profiled iterations, counted on the host side of the
    harness's iteration ranges (on the CPU they have no device side)."""
    return sum(1 for _, _, name in trace._cpu if name == ITERATION_RANGE)


def host_spans(trace, match):
    """``[(start_us, end_us)]`` of the host ranges whose name ``match``
    accepts."""
    return [(a, b) for a, b, name in trace._cpu if match(name)]


def host_ms(run, match) -> float | None:
    """Host ms an iteration inside the ranges whose name ``match``
    accepts; None where none ran."""
    t = run.trace
    if t is None:
        return None
    spans, n = host_spans(t, match), iterations(t)
    if not spans or not n:
        return None
    return sum(b - a for a, b in spans) / 1e3 / n


def is_sync(name: str) -> bool:
    return name.startswith(SYNC)


def counters() -> dict | None:
    """The program's counters of the profiled stretch (its only profiler
    session), or None where the program keeps none."""
    try:
        from prifit_torch.utils.profiling import counters as read
    except ImportError:
        return None
    return read()


def idle_gaps_ending(busy, ends) -> float:
    """us of the gaps between the intervals of ``busy`` (a sorted union
    of ``[start, end]``) that hold one of the times ``ends``, each gap
    counted once; an end inside a busy interval, or outside the first
    and last interval, holds no gap."""
    starts = [a for a, _ in busy]
    held = set()
    for t in ends:
        # busy[i - 1] is the last interval that starts at or before t
        i = bisect.bisect_right(starts, t)
        if 0 < i < len(busy) and busy[i - 1][1] <= t:
            held.add(i)
    return sum(busy[i][0] - busy[i - 1][1] for i in held)
