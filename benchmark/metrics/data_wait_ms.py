"""Host ms an iteration spent in ``next()`` on the trainer's two
prefetched streams (the frozen ``_WaitTimed``), over the window's
iterations."""


def read(run):
    waits = run.entry.waits
    if not waits or not run.n_iters:
        return None
    return sum(waits[-2 * run.n_iters:]) * 1e3 / run.n_iters
