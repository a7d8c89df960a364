"""Device ms an iteration in ``cluster_batch`` (bandwidth, mean-shift,
NMS, membership)."""


def read(run):
    return None if run.trace is None else \
        run.trace.busy_ms(["cluster_batch"])
