"""Device ms an iteration in the mean-shift step's hand-written backward
(the program's ``bwd.mean_shift`` ranges, on autograd's thread: the
live-row ordering and the backward kernel)."""


def read(run):
    return None if run.trace is None else \
        run.trace.busy_ms(["bwd.mean_shift"])
