"""The whole iteration's share of the configuration's peak, %: the
operations one iteration needs (``benchmark/counts/<config>.py``) times
the window's iterations outside the profiled stretch, over their summed
times and the peak the configuration file states."""


def read(run):
    times = run.untraced_ms()
    if not times:
        return None
    flops = run.cell.counts().iteration_flops(run.cell.params,
                                              run.entry.kind)
    return 100.0 * flops * len(times) / (sum(times) / 1e3) \
        / run.cell.config["peak_flops"]
