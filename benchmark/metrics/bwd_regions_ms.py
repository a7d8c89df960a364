"""Device ms an iteration in the encoder regions' hand-written backward
(the program's ``bwd.regions`` ranges, on autograd's thread: the K-max
backward kernels, ``sr_bf16`` and the regions' products)."""


def read(run):
    return None if run.trace is None else run.trace.busy_ms(["bwd.regions"])
