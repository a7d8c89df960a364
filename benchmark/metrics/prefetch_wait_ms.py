"""Host ms an iteration that the trainer waits in the prefetch streams'
``next()`` (the program's ``data.wait`` range, on the launching thread):
the program's own reading of ``data_wait_ms``."""

from benchmark.program import host_ms


def read(run):
    return host_ms(run, lambda name: name == "data.wait")
