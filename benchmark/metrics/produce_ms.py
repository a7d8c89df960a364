"""Host ms an iteration of the prefetch producer threads' own work, the
batch transform and the placement (pinning and the copy's launch): the
program's counters ``data.transform_s`` and ``data.place_s`` a batch
placed (``data.batches``), times the batches an iteration takes (its
``data.wait`` ranges): a mean a batch, so that batches placed ahead of
use, or begun before the profiled stretch, do not skew it.  That work
competes with the launching thread for the interpreter."""

from benchmark.program import counters, host_spans, iterations

KEYS = ("data.transform_s", "data.place_s")


def read(run):
    c = counters()
    if run.trace is None or not c or not c.get("data.batches"):
        return None
    n = iterations(run.trace)
    taken = len(host_spans(run.trace, lambda name: name == "data.wait"))
    if not n or not taken:
        return None
    per_batch = sum(c.get(k, 0.0) for k in KEYS) / c["data.batches"]
    return per_batch * 1e3 * taken / n
