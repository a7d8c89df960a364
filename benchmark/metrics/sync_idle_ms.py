"""Device idle ms an iteration that the program's host syncs cause: the
gaps of the device's busy union (every kernel and copy of the traced
stretch) that hold the end of a ``sync.*`` range, each gap counted once.
The device drains before a sync returns and waits until the host
launches again; a sync that ends while other work (a side stream's
copy) runs leaves no gap and counts 0.  Its share of ``idle_pct``."""

from benchmark.program import host_spans, idle_gaps_ending, is_sync


def read(run):
    t = run.trace
    if t is None or not t._busy or not t.n_iterations:
        return None
    ends = [b for _, b in host_spans(t, is_sync)]
    if not ends:
        return None
    return idle_gaps_ending(t._busy, ends) / 1e3 / t.n_iterations
