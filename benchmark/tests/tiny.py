"""A cell at a size the CPU runs in seconds, for the benchmark's tests:
the harness's whole run (set-up, window, check) with the program's and
the reference's plain paths."""

import time

TINY = {"tree": {"n_cats": 3, "n_per_cat": 8, "n_acd": 12, "n_points": 128},
        "params": {"batch_size": 2, "npoint": 128, "chamfer_npoints": 256,
                   "k_shot": 2, "num_workers": 1, "msc_iterations": 2,
                   "max_num_clusters": 4, "n_per_prim": 16},
        "traffic": {"warmup_iterations": 1}}


def dry_run(workload: str, trace: bool = False, seed: int = 5,
            params: dict | None = None):
    """``(result, checks)`` of one run of ``workload`` at the tiny size on
    the CPU, with a window of 0.5 s; ``params`` override the traffic's
    further."""
    from benchmark import harness
    over = {**TINY, "params": {**TINY["params"], **(params or {})}}
    return harness.run_cell(workload, seed, 0.5, trace, time.perf_counter(),
                            device="cpu", overrides=over)


def tiny_params(cell) -> dict:
    return {**cell.params, **TINY["params"]}


def tiny_tree(cell) -> dict:
    from benchmark import data
    return data.ensure_tree({**cell.traffic["tree"], **TINY["tree"]})
