"""Device ms an iteration in the optimizer: the ``optimizer_step``
ranges (the gradients a loss does not reach set to zero) and the
optimizer's own ``Optimizer.step#Adam.step`` ranges nested in them
(Adam's ``multi_tensor_apply`` kernels).  A range's device span holds
the kernels launched directly in it, so the nested range is read too."""


def read(run):
    return None if run.trace is None else run.trace.busy_ms(
        ["optimizer_step", "Optimizer.step#Adam.step"])
