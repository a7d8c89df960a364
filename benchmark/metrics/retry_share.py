"""Share of the shapes clustered that the clustering ran again at the
wider bandwidth candidates, %: the program's counters
``cluster.retry_shapes`` over ``cluster.shapes`` in the profiled
iterations."""

from benchmark.program import counters


def read(run):
    c = counters()
    if not c or not c.get("cluster.shapes"):
        return None
    return 100.0 * c.get("cluster.retry_shapes", 0) / c["cluster.shapes"]
