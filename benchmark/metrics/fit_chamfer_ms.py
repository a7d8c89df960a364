"""Device ms an iteration in ``fit_ellipsoids_batch``,
``sample_primitives_batch`` and ``analytic_chamfer``."""


def read(run):
    return None if run.trace is None else run.trace.busy_ms(
        ["fit_ellipsoids_batch", "sample_primitives_batch",
         "analytic_chamfer"])
