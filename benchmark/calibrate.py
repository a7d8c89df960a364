"""The readings the correctness check's limits are set from, for one cell:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 7,8,9] [--faults fit_one_shape,...]

For each of ``--seeds``, the program's readings (training: set-up's first
steps, no window; eval: one forward of each test batch) against the
reference's: the lower readings.  For each of ``--control-seeds``, the
reference put in the program's place: computed one precision below the
configuration's (the control), and for a training cell with each step
taking the first half of its batch only (a planted fault), each against
the sound reference; and the program with each of ``--faults``
(:mod:`benchmark.faults`) planted: the upper readings.  One JSON line a
reading on standard output, with the readings behind it.  The
benchmark's runs do not run this; it needs a CUDA card.
"""

import argparse
import gc
import importlib
import json
import os.path as osp
import sys
import time

sys.path[0] = osp.dirname(osp.dirname(osp.abspath(__file__)))

import torch  # noqa: E402

from benchmark import data, faults, harness  # noqa: E402
from benchmark.reference import evaluate, train  # noqa: E402
from benchmark.reference.compare import convex_readings, eval_gaps, \
    training_detail, training_gaps  # noqa


def _eval_detail(kept, ref) -> dict:
    """The eval's convex readings of each shape, over the kept batches."""
    rs = [convex_readings(got, ref[k][2], ref[k][1])
          for k, (_, _, got) in enumerate(kept)]
    return {key: [x for r in rs for x in r[key]]
            for key in ("emb", "bandwidth", "mode", "slots", "own_slots",
                        "cluster", "weight", "fit")} | {
                "chamfer": [r["chamfer"] for r in rs]}


def program_gaps(cell, seed, tree, device) -> dict:
    entry = importlib.import_module(
        f"benchmark.entries.{cell.traffic['entry']}").Entry(
            cell, seed, tree, device)
    entry.setup()
    if entry.kind == "eval":
        for _ in range(len(entry.batches)):
            entry.keep_at.add(entry.i)
            entry.iterate()
    harness.sync(device)
    entry.free()
    gc.collect()
    if entry.kind == "train":
        ref = train.readings(cell.params, seed, tree, device,
                             judge=entry.readings["ss"])
        return {**training_gaps(entry.readings, ref),
                "detail": training_detail(entry.readings, ref)}
    ref = evaluate.judged(cell.params, seed, tree, device, entry.kept)
    return {**eval_gaps(entry.kept, ref),
            "detail": _eval_detail(entry.kept, ref)}


def reference_gaps(cell, seed, tree, device, mode) -> dict:
    p, cfg = cell.params, cell.config
    kw = dict(encoder_modules=cfg["encoder_modules"],
              control_precision=cfg["control_precision"])
    if cell.traffic["entry"] == "eval":
        n = len(evaluate.test_batches(p, seed, tree))
        got = evaluate.outputs(p, seed, tree, device, range(n), mode, **kw)
        kept = [(i, lp, g) for i, (lp, g) in got.items()]
        ref = evaluate.judged(p, seed, tree, device, kept)
        return {**eval_gaps(kept, ref), "detail": _eval_detail(kept, ref)}
    got = train.readings(p, seed, tree, device, mode, **kw)
    ref = train.readings(p, seed, tree, device, judge=got["ss"])
    return {**training_gaps(got, ref), "detail": training_detail(got, ref)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    a = ap.parse_args()
    device = torch.device("cuda")
    cell = harness.Cell(a.workload)
    harness.set_cache_dirs()
    tree = data.ensure_tree(cell.traffic["tree"])
    from prifit_torch.kernels.build import build_all
    build_all()
    seeds = [int(s) for s in a.seeds.split(",") if s]
    controls = [int(s) for s in a.control_seeds.split(",") if s]
    modes = ["lower"] + (["half_batch"] if cell.traffic["entry"] == "train"
                         else [])
    planted = [f for f in a.faults.split(",") if f]
    jobs = [("program", s) for s in seeds] + \
        [(m, s) for s in controls for m in modes + planted]
    for kind, seed in jobs:
        t = time.perf_counter()
        if kind in faults.FAULTS:
            with faults.FAULTS[kind]():
                gaps = program_gaps(cell, seed, tree, device)
        elif kind == "program":
            gaps = program_gaps(cell, seed, tree, device)
        else:
            gaps = reference_gaps(cell, seed, tree, device, kind)
        torch.cuda.empty_cache()
        print(json.dumps({"workload": a.workload, "kind": kind,
                          "seed": seed, "gaps": gaps,
                          "s": time.perf_counter() - t}), flush=True)


if __name__ == "__main__":
    main()
