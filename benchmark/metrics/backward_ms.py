"""Device ms an iteration of the kernels between the end of each train
step's forward (``train_forward``'s device span) and the start of its
``optimizer_step``: the steps' backward."""


def read(run):
    t = run.trace
    return None if t is None else t.between_ms("train_forward",
                                               "optimizer_step")
