"""Which host syncs one window iteration of each cell makes, and whether
each lies inside one of the program's ``sync.*`` ranges.

    python3 benchmark/sync_sweep.py --seed <n> [--workload <cell> ...] \\
        [--out <file.json>]

from the root of a checkout, on a card.  Each cell is set up as a run
does (:mod:`benchmark.harness`: the kernels, the data tree, the entry and
its warm-up iterations); then one iteration runs under
``torch.cuda.set_sync_debug_mode("warn")``, which warns at every call
that waits for the device.  Each warning is placed by the Python stack
that raised it: the innermost frame in ``prifit_torch/`` and the
innermost frame overall, and whether that program frame's line lies in
the body of a ``with record_function("sync.<what>")`` block (one of the
program's ``sync.*`` ranges).  A
warning raised on another thread (autograd's, a producer's) is placed by
that thread's Python stack.

Prints one JSON object: ``{cell: [{"program": "file:line", "at":
"file:line", "code": ..., "inside": bool, "message": ..., "n":
count}]}``, and writes it to ``--out`` when given.  The first call that
sets the mode also warns once that the mode is a prototype; that
warning is no sync."""

import argparse
import ast
import functools
import json
import os.path as osp
import sys
import time
import traceback
import warnings

T0 = time.perf_counter()
ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
PROGRAM = osp.join(ROOT, "prifit_torch") + osp.sep


@functools.lru_cache(maxsize=None)
def _sync_blocks(path: str):
    """``[(first, last)]`` body lines of the ``with
    record_function("sync.<what>")`` blocks of the file at ``path``."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.With) and any(
                _is_sync_range(i.context_expr) for i in node.items):
            out.append((node.body[0].lineno, node.body[-1].end_lineno))
    return out


def _is_sync_range(expr) -> bool:
    """Whether ``expr`` is ``record_function("sync.<what>")``."""
    return (isinstance(expr, ast.Call) and expr.args
            and getattr(expr.func, "id", getattr(expr.func, "attr", None))
            == "record_function"
            and isinstance(expr.args[0], ast.Constant)
            and str(expr.args[0].value).startswith("sync."))


def _place(stack):
    """The innermost program frame and the innermost frame of a warning's
    stack, and whether the program frame's line is inside a sync
    range."""
    frames = [f for f in stack if "warnings.py" not in f.filename]
    prog = [f for f in frames if f.filename.startswith(PROGRAM)]
    inner = frames[-1] if frames else None
    at = prog[-1] if prog else inner
    inside = bool(prog) and any(a <= at.lineno <= b
                                for a, b in _sync_blocks(at.filename))

    def name(f):
        return f"{osp.relpath(f.filename, ROOT)}:{f.lineno}" if f else "?"

    return name(at), name(inner), (at.line or "") if at else "", inside


def sweep(workload: str, seed: int) -> list:
    import importlib

    import torch

    from benchmark import data, harness
    from prifit_torch.kernels.build import build_all

    cell = harness.Cell(workload)
    device = torch.device("cuda")
    harness.set_cache_dirs()
    build_all()
    tree = data.ensure_tree(cell.traffic["tree"])
    entry = importlib.import_module(
        f"benchmark.entries.{cell.traffic['entry']}").Entry(
            cell, seed, tree, device)
    entry.setup()
    for _ in range(int(cell.traffic.get("warmup_iterations", 3))):
        entry.iterate()
    torch.cuda.synchronize()

    found = {}

    def show(message, category, filename, lineno, file=None, line=None):
        key = _place(traceback.extract_stack()[:-1]) + (str(message)[:120],)
        found[key] = found.get(key, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            entry.iterate()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    entry.free()
    del entry
    torch.cuda.empty_cache()
    return [{"program": p, "at": a, "code": c, "inside": i, "message": m,
             "n": n} for (p, a, c, i, m), n in sorted(found.items())]


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--workload", action="append")
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    sys.path[0] = ROOT
    from benchmark import harness
    cells = a.workload or [w["name"] for w in harness.load_json(
        osp.join(ROOT, "BENCHMARK.json"))["workloads"]]
    out = {c: sweep(c, a.seed) for c in cells}
    text = json.dumps(out, indent=1)
    if a.out:
        with open(a.out, "w") as f:
            f.write(text + "\n")
    print(text)
    print(f"sync_sweep: {time.perf_counter() - T0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
