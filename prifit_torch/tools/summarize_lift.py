"""Aggregate lift-matrix / bisect results into tables.

The port's copy of ``tools/summarize_lift.py``: the same tables from the
same rows, character for character.

For :mod:`prifit_torch.tools.run_fewshot_matrix` output: per (k_shot,
knobs) the per-seed class-average mIoU of every arm present (sup / joint
/ con / pre / pre_joint / pre_con), plus the mean of the paired per-seed
deltas of each arm against sup.

For ``tools/run_bf16_bisect.py`` output (records with a ``variant``
config key): per-variant seed values and delta vs the f32 baseline.

Usage:
  python -m prifit_torch.tools.summarize_lift <data>/results.jsonl
  python -m prifit_torch.tools.summarize_lift <data>/bisect.jsonl
"""

import json
import sys
from collections import defaultdict


def load(path):
    rows = []
    with open(path) as f:
        for line in f:
            d = json.loads(line)
            if d.get("metrics"):
                rows.append(d)
    return rows


def summarize_bisect(rows):
    by_var = defaultdict(dict)            # variant -> {seed: miou}
    order = []
    for d in rows:
        v = d["config"]["variant"]
        if v not in order:
            order.append(v)
        by_var[v][d["config"]["seed"]] = d["metrics"]["class_avg_iou"]
    f32 = by_var.get("f32", {})
    f32_mean = (sum(f32.values()) / len(f32)) if f32 else float("nan")
    print(f"{'variant':>14} | {'per seed':>16} | {'mean':>6} | vs f32")
    for v in order:
        vals = [by_var[v][s] for s in sorted(by_var[v])]
        mean = sum(vals) / len(vals)
        seeds = " ".join(f"{x:.3f}" for x in vals)
        print(f"{v:>14} | {seeds:>16} | {mean:.3f} | {mean - f32_mean:+.3f}")


def summarize_matrix(rows):
    base = defaultdict(dict)   # (k, knobs) -> {(arm, seed): miou}
    arms_seen = []
    for d in rows:
        c = d["config"]
        knobs = (c.get("lmbda"), c.get("quantile"), c.get("alpha"),
                 c.get("step_size", 1), c.get("pre_epochs", 0))
        if c["arm"] not in arms_seen:
            arms_seen.append(c["arm"])
        base[(c["k_shot"], knobs)][(c["arm"], c["seed"])] = \
            d["metrics"]["class_avg_iou"]
    arms = [a for a in ("sup", "joint", "con", "pre", "pre_joint",
                        "pre_con") if a in arms_seen]

    hdr = f"{'k':>3} {'lmbda':>6} {'q':>5} {'alpha':>6} {'ss':>3} {'pe':>3}"
    for a in arms:
        hdr += f" | {a + ' (per seed)':>22}"
    for a in arms:
        if a != "sup":
            hdr += f" | d({a})"
    print(hdr)
    for (k, knobs), cell in sorted(base.items()):
        seeds = sorted({s for (_, s) in cell})
        lm, q, al, ss, pe = knobs
        line = f"{k:>3} {lm:>6} {q:>5} {al:>6} {ss:>3} {pe:>3}"
        # pre arms live in a pe>0 cell; their sup comparator (pe=0,
        # same schedule) is the baseline cell
        sup_cell = base.get((k, (lm, q, al, ss, 0)), {})
        vals = {}
        for a in arms:
            vals[a] = [cell[(a, s)] if (a, s) in cell
                       else sup_cell.get((a, s)) for s in seeds]
            txt = " ".join("  -  " if x is None else f"{x:.3f}"
                           for x in vals[a])
            line += f" | {txt:>22}"
        for a in arms:
            if a == "sup":
                continue
            deltas = [j - s for j, s in zip(vals[a], vals["sup"])
                      if j is not None and s is not None]
            if deltas:
                line += f" | m={sum(deltas) / len(deltas):+.3f}"
            else:
                line += " |   -  "
        print(line)


def main(path):
    rows = load(path)
    if not rows:
        print("no complete rows")
        return
    if "variant" in rows[0]["config"]:
        summarize_bisect(rows)
    else:
        summarize_matrix(rows)


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit("usage: python -m prifit_torch.tools.summarize_lift "
                 "<results.jsonl>")
    main(sys.argv[1])
