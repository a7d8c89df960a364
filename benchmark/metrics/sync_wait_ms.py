"""Host ms an iteration inside the program's host syncs (its ``sync.*``
ranges: a read that waits for the device's queue to drain)."""

from benchmark.program import host_ms, is_sync


def read(run):
    return host_ms(run, is_sync)
