"""Few-shot lift matrix: supervised-only vs joint self-sup, on the port.

The port's copy of ``tools/run_fewshot_matrix.py``.  It runs the
canonical recipe (reference ``README.md:59-63``) on the
paper-proportioned synthetic lift benchmark
(:func:`prifit_torch.tools.synthetic_primitive_dataset.
make_lift_benchmark`) across k_shot x seed x arm at MATCHED supervised
budgets: every arm shares the exact epoch structure via
``--epoch_iters`` (the joint arm's natural epoch length), the same
LR/BN schedules and the same number of supervised steps; the only
difference is the interleaved self-sup step (reference
``train_partseg_shapenet.py:404-451``).  The arms:

  - ``sup``: supervised only;
  - ``joint``: with the convex self-sup loss on the ACD shapes;
  - ``con``: with the ACD pairwise contrastive loss instead;
  - ``pre``, ``pre_joint``, ``pre_con``: ``sup``, ``joint`` and ``sup``
    warm-started (``--pretrained_model``) from an ACD pretrain of the
    seed, convex for the first two, contrastive for ``pre_con``
    (:func:`ensure_pretrain`).

The plan (batch ``min(--batch_size, k * 8)``, ``--epoch_iters``, the
sweep product and its pruning of ``sup``), the run keys, the
``results.jsonl`` record (``config``, ``metrics``, ``wall_s``,
``exp_dir``, ``pretrain_ckpt``) and resume by key are the JAX tool's;
:func:`build_cmd` gives its flag lists with the port's modules
(``prifit_torch.cli.train_partseg``, ``prifit_torch.cli.
pretrain_partseg``).  Records append to ``--out`` (default
``<data>/results.jsonl``) and finished runs are skipped on a restart.
Split a matrix across calls by seed, each with its own ``--out``, and
join the files.  One repair: a swept knob the plan already sets
(``lmbda``, ``quantile``, ``alpha``) replaces that value here, where the
JAX tool passes it to ``dict`` twice and raises ``TypeError``, so its
sweeps of those knobs, and with them its pruning of ``sup``, never ran.

Each run calls the CLI's ``main(parse_args(flags), device=...)`` in this
process (:func:`run_cli`), not in a subprocess as the JAX tool does: a
run's ``main`` leaves nothing behind that the next one reads (its
weights come from ``--seed``, its draws from a generator it seeds each
epoch, its logger handlers are replaced, its prefetch threads closed and
its CUDA memory freed once it returns), the kernels are loaded once for
the whole matrix, and each run's launches can be counted by the caller.
A run that raises is reported and left out of the results, as the JAX
tool leaves out a subprocess that fails; there is no per-run timeout.
The final test-split metrics are read back from the run's
``metrics.jsonl``, as the JAX tool reads them.

Usage (on the card; ``--device cpu`` runs the plain PyTorch path):
  python -m prifit_torch.tools.run_fewshot_matrix --data <lift8> \\
      --k_shots 1,5,10 --seeds 786,787,788 --epochs 20
  # sweep mode (joint arm only), e.g.:
  python -m prifit_torch.tools.run_fewshot_matrix --data <lift8> \\
      --k_shots 5 --seeds 786 --sweep lmbda=0.5,1,2 quantile=0.02,0.05,0.1
"""

import argparse
import glob
import importlib
import itertools
import json
import os
import os.path as osp
import sys
import time
import traceback

import numpy as np

from prifit_torch.utils.device import resolve_device

N_CATS = 8  # LIFT_ORDER[:8]
PRE_ARMS = ("pre", "pre_joint", "pre_con")


def tool_device(name: str):
    """The device a tool's ``--device`` names: ``cuda`` (the default)
    raises without a GPU, as every entry point of the port does."""
    return resolve_device(None if name == "cuda" else name)


def run_key(cfg):
    return "|".join(f"{k}={cfg[k]}" for k in sorted(cfg))


def load_done(out_path):
    done = set()
    if osp.exists(out_path):
        with open(out_path) as f:
            for line in f:
                try:
                    done.add(run_key(json.loads(line)["config"]))
                except (json.JSONDecodeError, KeyError):
                    pass
    return done


def final_metrics(exp_dir):
    path = osp.join(exp_dir, "metrics.jsonl")
    final = None
    with open(path) as f:
        for line in f:
            d = json.loads(line)
            if "final_eval" in d:
                final = d["final_eval"]
    return final


def run_cli(cmd, device, **hooks):
    """Run the port CLI that ``cmd`` names (``[python, "-m", module,
    *flags]``, as :func:`build_cmd` gives it) in this process:
    ``module.main(module.parse_args(flags), device=device, **hooks)``;
    returns what ``main`` returns."""
    mod = importlib.import_module(cmd[2])
    return mod.main(mod.parse_args(cmd[3:]), device=device, **hooks)


def ensure_pretrain(seed, args, ss_loss="convex"):
    """Run (or reuse) the ACD self-sup pretrain for this seed; return the
    best_model checkpoint path (reference recipe step 1,
    ``pretrain_partseg_shapenet.py`` -> ``--pretrained_model``).

    ``ss_loss="contrastive"`` pretrains with the ACD pairwise
    contrastive loss instead (reference ``pretrain:212``).  Raises
    RuntimeError if the pretrain fails or writes no ``best_model``."""
    suffix = "_con" if ss_loss == "contrastive" else ""
    root = osp.join(args.data, "pretrain",
                    f"s{seed}_e{args.pre_epochs}{suffix}")
    found = glob.glob(osp.join(root, "**", "best_model"), recursive=True)
    if found:
        return found[0]
    cmd = [sys.executable, "-m", "prifit_torch.cli.pretrain_partseg",
           "--model", "pretrain_pointnet2_part_seg_msg",
           "--seed", str(seed), "--selfsup", "--ss_dataset", "acd",
           "--ss_path", args.ss_path,
           "--epoch", str(args.pre_epochs),
           "--batch_size", str(args.batch_size),
           "--npoint", str(args.npoint),
           "--chamfer_npoints", str(args.npoint),
           # reference pretrain schedule: step_size default 20 (constant
           # LR across a 15-epoch pretrain), NOT the finetune recipe's
           # every-epoch decay
           "--learning_rate", "0.01",
           "--lmbda", str(args.lmbda),
           "--quantile", str(args.quantile),
           "--alpha", str(args.alpha),
           "--msc_iterations", "10", "--max_num_clusters", "25",
           "--ss_loss", ss_loss,
           "--experiment_root", root]
    print(f"  pretraining (seed {seed}, {args.pre_epochs} epochs)...",
          flush=True)
    t0 = time.time()
    try:
        run_cli(cmd, args.device)
    except Exception:  # noqa: BLE001 - reported, the matrix goes on
        raise RuntimeError(
            f"pretrain failed\n{traceback.format_exc()[-2000:]}") from None
    found = glob.glob(osp.join(root, "**", "best_model"), recursive=True)
    if not found:
        raise RuntimeError(f"pretrain wrote no best_model under {root} "
                           f"(an ACD val split shorter than one batch "
                           f"has no val loss)")
    print(f"  pretrain done in {time.time() - t0:.0f}s", flush=True)
    return found[0]


def build_cmd(cfg, args, run_root):
    cmd = [sys.executable, "-m", "prifit_torch.cli.train_partseg",
           "--seed", str(cfg["seed"]),
           "--k_shot", str(cfg["k_shot"]),
           "--batch_size", str(cfg["batch_size"]),
           "--epoch", str(args.epochs),
           "--epoch_iters", str(cfg["epoch_iters"]),
           "--learning_rate", "0.01",
           "--step_size", str(cfg.get("step_size", 1)),
           "--split", "train",
           "--eval_split", "test",
           "--npoint", str(args.npoint),
           "--chamfer_npoints", str(args.npoint),
           "--data_root", args.data_root,
           "--experiment_root", run_root,
           "--encoder_dtype", cfg.get("encoder_dtype", "auto"),
           ]
    if cfg["arm"] in ("joint", "pre_joint"):
        cmd += ["--selfsup", "--ss_dataset", "acd",
                "--ss_path", args.ss_path,
                "--lmbda", str(cfg["lmbda"]),
                "--quantile", str(cfg["quantile"]),
                "--alpha", str(cfg["alpha"]),
                "--msc_iterations", "10",
                "--max_num_clusters", "25"]
    if cfg["arm"] == "con":
        # joint with the ACD pairwise contrastive self-sup loss — the
        # component labels carry the part structure directly
        cmd += ["--selfsup", "--ss_loss", "contrastive",
                "--ss_dataset", "acd", "--ss_path", args.ss_path,
                "--lmbda", str(cfg["lmbda"])]
    if cfg["arm"] in PRE_ARMS:
        cmd += ["--pretrained_model", cfg["ckpt"]]
        if args.ft_lr:
            cmd[cmd.index("--learning_rate") + 1] = str(args.ft_lr)
    return cmd


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", required=True,
                    help="root containing shapenet/ and acd/ "
                         "(make_lift_benchmark output)")
    ap.add_argument("--out", default=None,
                    help="results jsonl (default <data>/results.jsonl)")
    ap.add_argument("--k_shots", default="1,5,10")
    ap.add_argument("--seeds", default="786,787,788")
    ap.add_argument("--arms", default="sup,joint")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--npoint", type=int, default=2048)
    ap.add_argument("--batch_size", type=int, default=24)
    ap.add_argument("--n_acd", type=int, default=2000,
                    help="for the default epoch_iters computation")
    ap.add_argument("--epoch_iters", type=int, default=0,
                    help="0 = n_acd // batch_size (joint's natural length)")
    ap.add_argument("--lmbda", type=float, default=1.0)
    ap.add_argument("--quantile", type=float, default=0.05)
    ap.add_argument("--alpha", type=float, default=0.01)
    ap.add_argument("--encoder_dtype", default="auto")
    ap.add_argument("--pre_epochs", type=int, default=15,
                    help="ACD pretrain epochs for the pre* arms")
    ap.add_argument("--ft_lr", type=float, default=0.0,
                    help="finetune LR override for pre arms (0 = keep "
                         "the recipe LR)")
    ap.add_argument("--sweep", nargs="*", default=[],
                    help="knob=v1,v2,... sweep entries (joint arm only)")
    ap.add_argument("--device", default="cuda",
                    help="where the runs train (cuda, or cpu for the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)
    args.data_root = osp.join(args.data, "shapenet")
    args.ss_path = osp.join(args.data, "acd")
    return args


def plan(args):
    """The runs of the matrix, in order: one config dict a run."""
    k_shots = [int(k) for k in args.k_shots.split(",")]
    seeds = [int(s) for s in args.seeds.split(",")]
    arms = args.arms.split(",")

    sweeps = [{}]

    def _num(v):
        return int(v) if float(v) == int(float(v)) else float(v)

    swept_knobs = set()
    for entry in args.sweep:
        knob, vals = entry.split("=")
        swept_knobs.add(knob)
        sweeps = [dict(s, **{knob: _num(v)}) for s in sweeps
                  for v in vals.split(",")]
    # joint-only knobs don't change the sup command — keep sup in the
    # sweep only when a shared knob (e.g. step_size) is swept
    if args.sweep and not (swept_knobs - {"lmbda", "quantile", "alpha"}):
        arms = [a for a in arms if a != "sup"] or ["joint"]

    runs = []
    for k, seed, arm, sw in itertools.product(k_shots, seeds, arms,
                                              sweeps):
        bs = min(args.batch_size, k * N_CATS)
        cfg = dict(k_shot=k, seed=seed, arm=arm, batch_size=bs,
                   epoch_iters=args.epoch_iters or args.n_acd // bs,
                   lmbda=args.lmbda, quantile=args.quantile,
                   alpha=args.alpha, epochs=args.epochs,
                   encoder_dtype=args.encoder_dtype)
        cfg.update(sw)
        if arm in PRE_ARMS:
            cfg["pre_epochs"] = args.pre_epochs
            if args.ft_lr:
                cfg["ft_lr"] = args.ft_lr
        runs.append(cfg)
    return runs


def run_tag(cfg):
    """The run's directory name under ``<data>/runs``."""
    tag = f"k{cfg['k_shot']}_s{cfg['seed']}_{cfg['arm']}"
    for knob in ("lmbda", "quantile", "alpha"):
        tag += f"_{knob[0]}{cfg[knob]}"
    if cfg.get("step_size", 1) != 1:
        tag += f"_ss{cfg['step_size']}"
    if cfg.get("pre_epochs"):
        tag += f"_pe{cfg['pre_epochs']}"
    return tag


class IterationClock:
    """``on_iteration`` hook of the trainer: the host clock at the end of
    each iteration.  :meth:`ms` is the median over epochs of an epoch's
    mean ms an iteration (its first iteration, which starts the prefetch
    streams, and the checkpoints between epochs left out)."""

    def __init__(self):
        self.marks = {}

    def __call__(self, epoch, i):
        self.marks.setdefault(epoch, []).append(time.perf_counter())

    def ms(self):
        means = [(t[-1] - t[0]) / (len(t) - 1) * 1e3
                 for t in self.marks.values() if len(t) > 1]
        return float(np.median(means)) if means else float("nan")


def main(argv=None):
    args = parse_args(argv)
    args.device = tool_device(args.device)
    out_path = args.out or osp.join(args.data, "results.jsonl")
    done = load_done(out_path)
    runs = plan(args)

    for i, cfg in enumerate(runs):
        key = run_key(cfg)
        if key in done:
            print(f"[{i + 1}/{len(runs)}] skip (done): {key}", flush=True)
            continue
        run_root = osp.join(args.data, "runs", run_tag(cfg))
        t0 = time.time()
        print(f"[{i + 1}/{len(runs)}] {key}", flush=True)
        if cfg["arm"] in PRE_ARMS:
            try:
                cfg["ckpt"] = ensure_pretrain(
                    cfg["seed"], args,
                    ss_loss="contrastive" if cfg["arm"] == "pre_con"
                    else "convex")
            except RuntimeError as e:
                print(f"  {e}", flush=True)
                continue
        cmd = build_cmd(cfg, args, run_root)
        clock = IterationClock()
        try:
            run_cli(cmd, args.device, on_iteration=clock)
        except Exception:  # noqa: BLE001 - reported, the matrix goes on
            print(f"  FAILED\n{traceback.format_exc()[-2000:]}", flush=True)
            continue
        exp_dirs = [osp.join(run_root, d) for d in os.listdir(run_root)]
        exp_dir = max(exp_dirs, key=osp.getmtime)
        metrics = final_metrics(exp_dir)
        ckpt = cfg.pop("ckpt", None)  # not part of the resume key
        rec = {"config": cfg, "metrics": metrics,
               "wall_s": round(time.time() - t0, 1), "exp_dir": exp_dir}
        if ckpt:
            rec["pretrain_ckpt"] = ckpt
        with open(out_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        miou = metrics["class_avg_iou"] if metrics else float("nan")
        print(f"  done in {rec['wall_s']}s: class_avg_iou={miou:.4f}; "
              f"{clock.ms():.1f} ms an iteration", flush=True)


if __name__ == "__main__":
    main()
