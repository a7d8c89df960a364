"""Frozen copy of ``chip_smoke.py::_WaitTimed`` at commit 0adee2a."""

import time


class WaitTimed:
    """A prefetch stream that adds the host seconds its consumer spends
    in ``__next__`` (waiting for the producer thread) to ``waits``."""

    def __init__(self, stream, waits):
        self.stream, self.waits = stream, waits

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        try:
            return next(self.stream)
        finally:
            self.waits.append(time.perf_counter() - t0)

    def close(self):
        self.stream.close()
