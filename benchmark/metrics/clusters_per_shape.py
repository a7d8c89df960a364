"""Clusters a shape clustered in the profiled iterations: the program's
counters ``cluster.clusters`` (the valid slots) over ``cluster.shapes``.
A count of the work the fit takes on: a change that moves it has changed
the clustering's result."""

from benchmark.program import counters


def read(run):
    c = counters()
    if not c or not c.get("cluster.shapes") or "cluster.clusters" not in c:
        return None
    return c["cluster.clusters"] / c["cluster.shapes"]
