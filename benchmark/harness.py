"""One run of one benchmark cell: set up, measure for a fixed time, check
what the timed path produced against the reference, print one result line.

Everything a cell is lives in data files that the harness finds by name:
``BENCHMARK.json`` names the cell's configuration and traffic and lists
the metrics the cell reports; ``benchmark/workloads/<cell>.json`` holds
the limits of its correctness check; ``benchmark/configs/<config>.json``
the model, ``benchmark/traffic/<traffic>.json`` the entry
(``benchmark/entries/<entry>.py``) and its parameters;
``benchmark/metrics/<metric>.py`` reads one metric from the run
(:class:`Run`, :func:`reader`), and ``benchmark/counts/<config>.py``
counts a configuration's operations.  A later cell, configuration or
metric is one more file of each kind, and no edit.

A run (see :func:`run_cell`):

1. Set-up, from the start of the process: imports, the kernels' build
   (``prifit_torch.kernels.build.build_all``, cached in the checkout), the
   data tree (generated once into ``benchmark/_cache``), the entry's
   model, weights, data and first steps (whose readings the check
   compares), and warm-up iterations, then one ``synchronize()``.
2. The window: iterations in a closed loop for ``--seconds`` of host
   time, a CUDA event recorded after each and no host synchronization
   inside the loop; then one ``synchronize()``.  With ``--trace 1`` a few
   iterations inside the window run under ``torch.profiler``.
3. The peak memory is read, the program's state freed, and the entry's
   check run against the reference; the numbers compared are printed
   with their limits on standard error and, last, in the result line.
"""

import argparse
import gc
import importlib
import importlib.util
import json
import os
import os.path as osp
import sys
import time

BENCH = osp.dirname(osp.abspath(__file__))
ROOT = osp.dirname(BENCH)
# modules that no run may load: the JAX package and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "prifit_tpu")
# the profiled stretch of a traced run: iterations PROFILE_AT ..
# PROFILE_AT + PROFILE_N - 1 of the window
PROFILE_AT, PROFILE_N = 8, 3


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


class Cell:
    """A cell as its files describe it."""

    def __init__(self, name: str):
        spec = load_json(osp.join(ROOT, "BENCHMARK.json"))
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json "
                             f"has {sorted(cells)}")
        self.name = name
        self.chips = int(cells[name]["chips"])
        cfg = {c["name"]: c for c in spec["configs"]}[cells[name]["config"]]
        self.config = load_json(osp.join(ROOT, cfg["file"]))
        self.config_name = cfg["name"]
        self.traffic_name = cells[name]["traffic"]
        self.traffic = load_json(osp.join(BENCH, "traffic",
                                          self.traffic_name + ".json"))
        self.workload = load_json(osp.join(BENCH, "workloads",
                                           name + ".json"))
        self.limits = self.workload["limits"]

        def applies(m):
            return "workloads" not in m or name in m["workloads"]

        self.end_to_end = [m for m in spec["end_to_end"] if applies(m)]
        self.per_layer = [m for m in spec["per_layer"] if applies(m)]

    @property
    def params(self) -> dict:
        """The traffic's parameters and the configuration's, merged."""
        return {**self.traffic["params"], **self.config["params"]}

    def counts(self):
        return importlib.import_module(
            f"benchmark.counts.{self.config_name}")


class Run:
    """What the metric readers read (``benchmark/metrics/<name>.py``'s
    ``read(run)``): the window's iteration times, the host's waits, the
    traced stretch, and the cell."""

    def __init__(self, cell: Cell, entry):
        self.cell = cell
        self.entry = entry
        self.setup_s = None
        self.window_s = None
        self.iter_ms = []
        self.profiled = set()
        self.trace = None

    @property
    def n_iters(self) -> int:
        return len(self.iter_ms)

    def untraced_ms(self):
        """Iteration times outside the profiled stretch."""
        return [t for i, t in enumerate(self.iter_ms)
                if i not in self.profiled]


class Clock:
    """Iteration end marks: CUDA events on the card (no host sync until
    :meth:`intervals_ms`), the host clock on the CPU (the tests' dry
    run)."""

    def __init__(self, device):
        import torch
        self.cuda = device.type == "cuda"
        self.marks = []
        self._torch = torch

    def mark(self):
        if self.cuda:
            ev = self._torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self):
        if self.cuda:
            self._torch.cuda.synchronize()
            return [a.elapsed_time(b)
                    for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize()


def forbidden_modules():
    return sorted({k.split(".")[0] for k in sys.modules
                   if k.split(".")[0] in FORBIDDEN})


def set_cache_dirs():
    """Build and kernel caches at fixed paths inside the checkout.  The
    program builds its kernels under ``prifit_torch/kernels/_build`` and
    its parser under ``prifit_torch/native/_build`` itself; these cover
    the caches of torch's own extension builder and of Triton."""
    cache = osp.join(BENCH, "_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = osp.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = osp.join(cache, "triton")


def _profile(device):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def measure(run: Run, seconds: float, trace: bool, device):
    """The window (module docstring, step 2)."""
    from torch.profiler import record_function

    from benchmark.frozen.spans import encoder_ranges
    from benchmark.traced import ITERATION_RANGE, Trace
    entry = run.entry
    clock = Clock(device)
    prof, hooks, results = None, [], []
    clock.mark()
    t0 = time.perf_counter()
    i = 0
    while True:
        if trace and i == PROFILE_AT:
            hooks = encoder_ranges(entry.encoder_modules())
            entry.start_counting()
            prof = _profile(device)
            prof.__enter__()
        if prof is not None and PROFILE_AT <= i < PROFILE_AT + PROFILE_N:
            run.profiled.add(i)
            with record_function(ITERATION_RANGE):
                results.append(entry.iterate())
        else:
            results.append(entry.iterate())
        clock.mark()
        i += 1
        if prof is not None and i == PROFILE_AT + PROFILE_N:
            prof.__exit__(None, None, None)
            for h in hooks:
                h.remove()
            entry.stop_counting()
        done = time.perf_counter() - t0 >= seconds
        if done and (not trace or i >= PROFILE_AT + PROFILE_N):
            break
    sync(device)
    run.window_s = time.perf_counter() - t0
    run.iter_ms = clock.intervals_ms()
    if prof is not None:
        run.trace = Trace(prof, device)
    return results


def reader(name: str):
    """The reader module of the metric ``name``:
    ``benchmark/metrics/<name>.py``; a metric ``<quantity>.<cells>``
    that has no file of its own, a quantity split by the end-to-end
    metric it moves, is read by ``benchmark/metrics/<quantity>.py``."""
    for stem in (name, name.split(".")[0]):
        path = osp.join(BENCH, "metrics", stem + ".py")
        if not osp.exists(path):
            continue
        if "." not in stem:
            return importlib.import_module(f"benchmark.metrics.{stem}")
        key = "benchmark.metrics." + stem.replace(".", "__")
        if key not in sys.modules:
            spec = importlib.util.spec_from_file_location(key, path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            sys.modules[key] = module
        return sys.modules[key]
    raise SystemExit(f"no reader for metric {name!r} under "
                     f"benchmark/metrics")


def read_metrics(run: Run, metrics) -> dict:
    """Each metric's reading, by its reader module; a reader that finds
    nothing to read returns None and the metric is left out."""
    out = {}
    for m in metrics:
        value = reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t0: float, device=None, overrides=None):
    """One run; returns ``(result dict, checks)``.  ``device`` and
    ``overrides`` (traffic parameters, for the tests' dry run at a tiny
    size on the CPU) are not reachable from the command line."""
    import torch

    cell = Cell(workload)
    if overrides:
        cell.traffic = {**cell.traffic, **overrides.get("traffic", {}),
                        "params": {**cell.traffic["params"],
                                   **overrides.get("params", {})}}
        cell.traffic["tree"] = {**cell.traffic["tree"],
                                **overrides.get("tree", {})}
    device = torch.device(device or "cuda")
    set_cache_dirs()
    # the program first: a checkout without it stops here
    from prifit_torch.kernels.build import build_all
    if device.type == "cuda":
        build_all()
    from benchmark import data
    tree = data.ensure_tree(cell.traffic["tree"])
    entry_mod = importlib.import_module(
        f"benchmark.entries.{cell.traffic['entry']}")
    entry = entry_mod.Entry(cell, seed, tree, device)
    entry.setup()
    for _ in range(int(cell.traffic.get("warmup_iterations", 3))):
        entry.iterate()
    sync(device)
    run = Run(cell, entry)
    run.setup_s = time.perf_counter() - t0

    results = measure(run, seconds, trace, device)
    attempted = run.n_iters
    failed = entry.count_failed(results)
    del results
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    metrics = read_metrics(run, cell.per_layer if trace
                           else cell.end_to_end)
    trace_view = run.trace
    entry.free()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    # the numbers the workload file gives a limit; one the check did not
    # read is not a number, and fails
    gaps = entry.check()
    checks = {k: gaps.get(k, float("nan")) for k in cell.limits}
    correct = bool(checks) and all(
        v == v and v <= cell.limits[k] for k, v in checks.items())
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {
                  "platform": "gpu" if device.type == "cuda" else "cpu",
                  "kind": (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu"),
                  "count": cell.chips,
                  "memory_peak_bytes": int(peak)}}
    if trace_view is not None:
        result["device"]["busy_s"] = trace_view.busy_s
        result["device"]["window_s"] = trace_view.window_s
        result["breakdown"] = trace_view.breakdown()
    result["checks"] = {k: {"value": v if v == v else None,
                            "limit": cell.limits[k]}
                        for k, v in checks.items()}
    return result, checks


def parse(argv):
    ap = argparse.ArgumentParser(description="One run of one benchmark "
                                 "cell of BENCHMARK.json.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t0: float) -> int:
    a = parse(argv)
    import torch
    if not torch.cuda.is_available():
        print("benchmark: no CUDA device", file=sys.stderr)
        return 2
    chips = Cell(a.workload).chips
    if torch.cuda.device_count() < chips:
        print(f"benchmark: {a.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result, _ = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), t0)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {found}", file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of ``values`` by nearest rank."""
    s = sorted(values)
    k = max(int(-(-q * len(s) // 100)) - 1, 0)
    return s[k]
