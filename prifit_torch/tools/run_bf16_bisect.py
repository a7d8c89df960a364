"""Per-stage bf16-instability bisection, on the port.

The port's copy of ``tools/run_bf16_bisect.py``.  A bf16 encoder
destabilizes few-shot supervised training; this script isolates the
mechanism on the supervised few-shot arm.  For each encoder stage
{sa1, sa2, sa3, fp3, fp2, fp1} (or stage groups) it trains with

  <stage>:bf16   the stage's MLP chain in bf16 (fwd+bwd rounding)
  <stage>:q      stage f32, OUTPUT quantized to bf16 with exact
                 gradients (straight-through): forward-value rounding
                 only
  <stage>:fq     bf16-equivalent forward with exact f32 gradients

plus f32 and full-bf16 baselines (and ``--full_encoders``' whole-encoder
dtypes), at matched budgets and seeds, and records the final test-split
class-average mIoU per run.  If ``q`` is benign where ``bf16`` degrades,
the mechanism is compute/gradient rounding inside the stage, not the
activation values it passes downstream (and vice versa).

The plan (coarse groups ``sa_all``/``fp_all``, or ``--phase fine`` over
``--stages``, where ``sa1+sa2`` is one compound group), ``--modes``,
``--tag`` (suffixing every variant but the two baselines), the run keys,
the record (``config``, ``metrics``, ``wall_s``; ``metrics`` the
``final_eval`` of the run's ``metrics.jsonl``) and resume by key from
``--out`` (default ``<data>/bisect.jsonl``) are the JAX script's; each
run's flags are the JAX script's with the port's trainer,
``prifit_torch.cli.train_partseg``.  ``python -m
prifit_torch.tools.summarize_lift <data>/bisect.jsonl`` prints the table.

One repair: the ``f32`` baseline and the stage-group variants run the
f32 encoder (``--encoder_dtype f32``), as the bisection's round-3
measurements did.  The JAX script passes ``--encoder_dtype auto`` to
them, and ``auto`` has meant ``mxsr`` since round 5, so its "f32" runs
``mxsr`` and its group variants put one stage group in a reduced
precision on an ``mxsr`` encoder.  The variant names are kept.

Each run calls the trainer's ``main(parse_args(flags), device=...)`` in
this process (:func:`prifit_torch.tools.run_fewshot_matrix.run_cli`),
not in a subprocess as the JAX script does: a run's ``main`` leaves
nothing behind that the next one reads, the kernels are loaded once for
the whole plan, and each run's launches can be counted by the caller.
A run that raises is reported and left out of the records, as the JAX
script leaves out a subprocess that fails; there is no per-run timeout
(the JAX script's ``--timeout``), since a run in this process cannot be
stopped from outside it.  ``--data`` is required: the runs write under
it.

Usage (on the card; ``--device cpu`` runs the plain PyTorch path):
  python -m prifit_torch.tools.run_bf16_bisect --data <lift8> \\
      --seeds 786,787 --phase coarse     # sa-all / fp-all groups
  python -m prifit_torch.tools.run_bf16_bisect --data <lift8> \\
      --seeds 786,787 --phase fine --stages sa1,sa2,sa3
"""

import argparse
import json
import os
import os.path as osp
import sys
import time
import traceback

from prifit_torch.tools.run_fewshot_matrix import IterationClock, \
    final_metrics, load_done, run_cli, run_key, tool_device

SA = ["sa1", "sa2", "sa3"]
FP = ["fp3", "fp2", "fp1"]
# the encoder of the f32 baseline and the stage-group variants
BASE_ENCODER = "f32"


def spec(stages, mode):
    return ",".join(f"{s}:{mode}" for s in stages)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", required=True,
                    help="root containing shapenet/ (make_lift_benchmark "
                         "output)")
    ap.add_argument("--out", default=None,
                    help="records jsonl (default <data>/bisect.jsonl)")
    ap.add_argument("--seeds", default="786,787")
    ap.add_argument("--k_shot", type=int, default=10)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--epoch_iters", type=int, default=83)
    ap.add_argument("--batch_size", type=int, default=24)
    ap.add_argument("--phase", choices=["coarse", "fine"],
                    default="coarse")
    ap.add_argument("--stages", default="",
                    help="fine phase: comma list of stages to bisect")
    ap.add_argument("--full_encoders", default="",
                    help="extra whole-encoder dtype variants to run "
                         "(e.g. 'mx')")
    ap.add_argument("--modes", default="bf16,q",
                    help="per-group modes to run (bf16 = fwd+bwd "
                         "rounding, q = output-value rounding only, fq = "
                         "bf16-equivalent fwd with exact f32 grads)")
    ap.add_argument("--tag", default="",
                    help="suffix for variant names: fresh run dirs + "
                         "cache keys (e.g. re-validating mxsr under a "
                         "different rounding-bit source)")
    ap.add_argument("--device", default="cuda",
                    help="where the runs train (cuda, or cpu for the "
                         "plain PyTorch path)")
    return ap.parse_args(argv)


def variants(args):
    """``[(name, stage_dtypes, encoder_dtype)]`` of the plan, in order."""
    out = [("f32", "", BASE_ENCODER), ("full_bf16", "", "bf16")]
    for enc in (args.full_encoders.split(",")
                if args.full_encoders else []):
        out.append((f"full_{enc}", "", enc))
    if args.phase == "coarse":
        groups = [("sa_all", SA), ("fp_all", FP)]
    else:
        # "sa1" bisects one stage; "sa1+sa2" runs a compound group
        # (candidate fast modes, e.g. bf16 SA with an f32 reset island)
        stages = args.stages.split(",") if args.stages else SA + FP
        groups = [(s.replace("+", "_"), s.split("+")) for s in stages]
    for name, group in groups:
        for mode in args.modes.split(","):
            if mode:
                out.append((f"{name}_{mode}", spec(group, mode),
                            BASE_ENCODER))
    if args.tag:
        # baselines (f32 / full_bf16) keep their cached identity: the
        # tag marks the variants whose behavior changed (e.g. sr bits)
        out = out[:2] + [(f"{n}{args.tag}", sdt, enc)
                         for n, sdt, enc in out[2:]]
    return out


def build_cmd(cfg, args, run_root):
    cmd = [sys.executable, "-m", "prifit_torch.cli.train_partseg",
           "--seed", str(cfg["seed"]), "--k_shot", str(args.k_shot),
           "--batch_size", str(args.batch_size),
           "--epoch", str(args.epochs),
           "--epoch_iters", str(args.epoch_iters),
           "--learning_rate", "0.01", "--step_size", "1",
           "--split", "train", "--eval_split", "test",
           "--npoint", "2048",
           "--data_root", osp.join(args.data, "shapenet"),
           "--experiment_root", run_root,
           "--encoder_dtype", cfg["encoder_dtype"]]
    if cfg["stage_dtypes"]:
        cmd += ["--stage_dtypes", cfg["stage_dtypes"]]
    return cmd


def main(argv=None):
    args = parse_args(argv)
    device = tool_device(args.device)
    out_path = args.out or osp.join(args.data, "bisect.jsonl")
    done = load_done(out_path)

    seeds = [int(s) for s in args.seeds.split(",")]
    runs = [(v, s) for v in variants(args) for s in seeds]
    for i, ((vname, sdt, enc), seed) in enumerate(runs):
        cfg = dict(variant=vname, stage_dtypes=sdt, encoder_dtype=enc,
                   seed=seed, k_shot=args.k_shot, epochs=args.epochs,
                   epoch_iters=args.epoch_iters,
                   batch_size=args.batch_size)
        key = run_key(cfg)
        if key in done:
            print(f"[{i + 1}/{len(runs)}] skip: {vname} s{seed}",
                  flush=True)
            continue
        run_root = osp.join(args.data, "bisect_runs",
                            f"{vname}_s{seed}")
        t0 = time.time()
        print(f"[{i + 1}/{len(runs)}] {vname} seed {seed}", flush=True)
        clock = IterationClock()
        try:
            run_cli(build_cmd(cfg, args, run_root), device,
                    on_iteration=clock)
        except Exception:  # noqa: BLE001 - reported, the plan goes on
            print(f"  FAILED\n{traceback.format_exc()[-1500:]}", flush=True)
            continue
        exp_dirs = [osp.join(run_root, d) for d in os.listdir(run_root)]
        exp_dir = max(exp_dirs, key=osp.getmtime)
        final = final_metrics(exp_dir)
        rec = {"config": cfg, "metrics": final,
               "wall_s": round(time.time() - t0, 1)}
        with open(out_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        miou = final["class_avg_iou"] if final else float("nan")
        print(f"  done in {rec['wall_s']}s: mIoU={miou:.4f}; "
              f"{clock.ms():.1f} ms an iteration", flush=True)


if __name__ == "__main__":
    main()
