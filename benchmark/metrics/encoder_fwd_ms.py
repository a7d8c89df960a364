"""Device ms an iteration in the forward spans of the model's top
encoder modules (the configuration's ``encoder_modules``, given ranges
by forward hooks the benchmark attaches)."""


def read(run):
    if run.trace is None:
        return None
    return run.trace.busy_ms(
        [f"encoder.{n}" for n in run.cell.config["encoder_modules"]])
