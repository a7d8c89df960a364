"""Seconds from the start of the process to the start of the window:
imports, the kernels' build or load, the data tree, the model and
weights, the first steps and the warm-up iterations."""


def read(run):
    return run.setup_s
