"""Device ms an iteration in ``pairwise_contrastive_loss``."""


def read(run):
    return None if run.trace is None else \
        run.trace.busy_ms(["pairwise_contrastive_loss"])
