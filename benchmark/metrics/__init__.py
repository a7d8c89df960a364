"""One reader a metric: ``<metric>.py``'s ``read(run)`` returns the
metric's value from a :class:`benchmark.harness.Run`, or None where the
run has nothing to read it from."""
