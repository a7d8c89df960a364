"""One-command real-data parity harness, on the port.

The port's copy of ``tools/run_real_parity.py``.  The few-shot mIoU
parity target (``BASELINE.json``: within 0.5 of the PyTorch reference
under the canonical recipe, ``README.md:59-63``) waits only for the real
ShapeNet-Part and ACD data; this tool makes parity one command once they
are there:

  1. ``check``   — validate a ShapeNet-Part root and an ACD root against
     the exact on-disk expectations of the reference loaders
     (``data_utils/ShapeNetDataLoader.py:29-52`` for the labeled set:
     ``synsetoffset2category.txt`` + ``train_test_split`` jsons +
     per-synset ``.txt`` files; ``:302-327`` for ACD: per-category
     folders of ``.npy`` with the last column = component id).  The same
     tree gives the same list of problems as the JAX tool's.
  2. ``run``     — the canonical recipe (``RECIPE``) through the port's
     trainer (``prifit_torch.cli.train_partseg``), then the port's
     standalone eval (``prifit_torch.cli.testing``) of its
     ``best_model``, optionally the same eval of a reference ``.pth``
     (``--ref_pth``, read as the reference's ``{model_state_dict, ...}``
     wrapper), and ``--export_pth``: the ``best_model``'s weights as a
     reference-format ``{"model_state_dict": ...}`` file.  The port's
     names are the reference's, so nothing is converted; the self-sup
     entropy weight ``beta``, which the reference model lacks, is left
     out, as the JAX tool's export leaves it out.
  3. ``dryrun``  — write a small lift benchmark in the real layout with
     the port's generator and run ``check`` and a micro-budget ``run``
     end to end (proves the procedure before the data exists).

Each CLI runs in this process on ``--device`` (CUDA by default) through
:func:`prifit_torch.tools.run_fewshot_matrix.run_cli`; each is printed
as the command line that does the same.  Where this differs from the JAX
tool: the trainers write under ``--experiment_root`` and never read
``--log_dir``, so ``run`` passes ``--experiment_root <log_dir>`` and
finds ``<log_dir>/<run>/checkpoints/best_model`` (the JAX tool passes
``--log_dir`` and looks for ``<log_dir>/best_model``); and ``dryrun``
writes a lift tree of 2 categories of 4 shapes and 4 ACD shapes of 128
points and trains one iteration at batch 1, so that it takes seconds on
the CPU (the JAX tool asks for 6 shapes a category, 8 ACD shapes and 256
points without ``--lift``, so its generator writes its default tree, and
trains 2 iterations at batch 4).

Usage:
  python -m prifit_torch.tools.run_real_parity check \\
      --data_root D --ss_path A
  python -m prifit_torch.tools.run_real_parity run \\
      --data_root D --ss_path A [--ref_pth model.pth] \\
      [--export_pth out.pth] [--log_dir L]
  python -m prifit_torch.tools.run_real_parity dryrun [--keep]
"""

import argparse
import glob
import json
import os
import os.path as osp
import shlex
import shutil
import sys
import tempfile

import numpy as np
import torch

from prifit_torch.data.shapenet import SEG_CLASSES
from prifit_torch.tools.run_fewshot_matrix import run_cli, tool_device
from prifit_torch.tools.synthetic_primitive_dataset import \
    make_lift_benchmark

# the canonical recipe, flag for flag (reference README.md:59-63)
RECIPE = ("--seed 786 --alpha 0.01 --split val --k_shot 10 "
          "--batch_size 24 --step_size 1 --selfsup --epoch 20 "
          "--learning_rate 0.01 --lmbda 1 --quantile 0.05 "
          "--msc_iterations 10 --max_num_clusters 25")


def _fail(problems):
    for p in problems:
        print(f"  FAIL: {p}")
    return 1


def check_shapenet(root: str) -> list:
    """Problems list (empty = the reference loader would accept it)."""
    problems = []
    catfile = osp.join(root, "synsetoffset2category.txt")
    if not osp.isfile(catfile):
        return [f"missing {catfile} (ShapeNetDataLoader.py:29)"]
    cat = {}
    with open(catfile) as f:
        for line in f:
            ls = line.strip().split()
            if len(ls) != 2:
                problems.append(f"malformed category line: {line!r}")
                continue
            cat[ls[0]] = ls[1]
    if not cat:
        problems.append("synsetoffset2category.txt is empty")

    for split in ("train", "val", "test"):
        p = osp.join(root, "train_test_split",
                     f"shuffled_{split}_file_list.json")
        if not osp.isfile(p):
            problems.append(
                f"missing {p} (ShapeNetDataLoader.py:46-52)")
            continue
        with open(p) as f:
            ids = json.load(f)
        bad = [d for d in ids[:50] if len(d.split("/")) != 3]
        if bad:
            problems.append(
                f"{p}: entries must be 'shape_data/<synset>/<token>', "
                f"got e.g. {bad[0]!r}")

    n_total = 0
    for name, synset in sorted(cat.items()):
        d = osp.join(root, synset)
        if not osp.isdir(d):
            problems.append(f"missing category dir {d} ({name})")
            continue
        fns = [f for f in os.listdir(d) if f.endswith(".txt")]
        n_total += len(fns)
        if not fns:
            problems.append(f"{d}: no .txt point files")
            continue
        sample = osp.join(d, sorted(fns)[0])
        try:
            data = np.loadtxt(sample, max_rows=32).astype(np.float32)
        except Exception as e:  # noqa: BLE001
            problems.append(f"{sample}: unparseable ({e})")
            continue
        if data.ndim != 2 or data.shape[1] != 7:
            problems.append(
                f"{sample}: expected 7 columns (xyz + normal + part "
                f"label), got {data.shape}")
            continue
        labels = data[:, -1].astype(np.int64)
        if (labels != data[:, -1]).any():
            problems.append(f"{sample}: non-integer part labels")
        valid = SEG_CLASSES.get(name)
        if valid is not None and not np.isin(labels, valid).all():
            problems.append(
                f"{sample}: part labels {sorted(set(labels.tolist()))} "
                f"outside {name}'s range {valid} "
                f"(testing.py-style category masking would misscore)")
        print(f"  {name:12s} {synset}  {len(fns):5d} shapes  ok")
    print(f"  shapenet total: {len(cat)} categories, {n_total} shapes")
    return problems


def check_acd(root: str) -> list:
    problems = []
    if not osp.isdir(root):
        return [f"missing ACD root {root}"]
    subfolders = sorted(
        d for d in os.listdir(root) if osp.isdir(osp.join(root, d)))
    if not subfolders:
        return [f"{root}: no category subfolders "
                "(ShapeNetDataLoader.py:302-311 lists subdirs)"]
    n_total = 0
    for item in subfolders:
        d = osp.join(root, item)
        fns = [f for f in os.listdir(d) if f.endswith(".npy")]
        n_total += len(fns)
        if not fns:
            problems.append(f"{d}: no .npy files")
            continue
        sample = osp.join(d, sorted(fns)[0])
        try:
            data = np.load(sample)
        except Exception as e:  # noqa: BLE001
            problems.append(f"{sample}: unloadable ({e})")
            continue
        if data.ndim != 2 or data.shape[1] < 4:
            problems.append(
                f"{sample}: expected [n, >=4] (xyz + ... + component "
                f"id), got {data.shape}")
            continue
        comp = data[:, -1]
        if not np.all(comp == comp.astype(np.int64)):
            problems.append(f"{sample}: non-integer ACD component ids")
        print(f"  {item:12s} {len(fns):5d} clouds  "
              f"{int(comp.max()) + 1:3d} components in sample  ok")
    print(f"  acd total: {len(subfolders)} categories, {n_total} clouds")
    return problems


def _run(module: str, flags: str, device):
    """Run ``python -m <module> <flags>`` in this process on ``device``;
    returns what the CLI's ``main`` returns."""
    print(f"+ python -m {module} {flags}", flush=True)
    return run_cli([sys.executable, "-m", module] + shlex.split(flags),
                   device)


def cmd_run(args) -> int:
    problems = check_shapenet(args.data_root) + check_acd(args.ss_path)
    if problems:
        return _fail(problems)
    device = tool_device(args.device)
    log_dir = args.log_dir or tempfile.mkdtemp(prefix="parity_")
    recipe = args.recipe or RECIPE

    # 1) canonical joint training run (the port's trainer)
    _run("prifit_torch.cli.train_partseg",
         f"{recipe} --ss_dataset acd --ss_path {args.ss_path} "
         f"--data_root {args.data_root} --experiment_root {log_dir} "
         + (args.extra or ""), device)
    found = sorted(glob.glob(osp.join(log_dir, "*", "checkpoints",
                                      "best_model")), key=osp.getmtime)
    if not found:
        return _fail([f"the trainer wrote no best_model under {log_dir}"])
    best = found[-1]

    # 2) standalone eval of the best checkpoint (the port's evaluator)
    eval_flags = (f"--model {args.model} --data_root {args.data_root} "
                  f"--batch_size {args.eval_batch} --npoint {args.npoint}")
    ours = _run("prifit_torch.cli.testing",
                f"--pretrained_model {best} {eval_flags}", device)
    print(f"port best_model: {ours}")

    # 3) cross-eval a reference .pth with the port's evaluator
    if args.ref_pth:
        ref = _run("prifit_torch.cli.testing",
                   f"--pretrained_model {args.ref_pth} {eval_flags}",
                   device)
        print(f"reference .pth: {ref}")

    # 4) export the port's weights as a reference-format .pth: the
    #    PyTorch side evaluates it with its own testing.py
    if args.export_pth:
        ckpt = torch.load(best, map_location="cpu", weights_only=False)
        sd = {k: v for k, v in ckpt["model_state_dict"].items()
              if k != "beta"}
        torch.save({"model_state_dict": sd}, args.export_pth)
        print(f"exported reference-format checkpoint: {args.export_pth}")
    print(f"parity run complete; logs in {log_dir}")
    return 0


def cmd_dryrun(args) -> int:
    """Fixture-scale end-to-end proof of the procedure."""
    root = args.out or tempfile.mkdtemp(prefix="parity_dryrun_")
    print(f"+ python -m prifit_torch.tools.synthetic_primitive_dataset "
          f"{root} --lift --n_cats 2 --n_per_cat 4 --n_acd 4 "
          f"--n_points 128")
    sn, acd = make_lift_benchmark(root, n_cats=2, n_per_cat=4, n_acd=4,
                                  n_points=128)
    problems = check_shapenet(sn) + check_acd(acd)
    if problems:
        return _fail(problems)
    ns = argparse.Namespace(
        data_root=sn, ss_path=acd, log_dir=osp.join(root, "log"),
        model=args.model, eval_batch=1, npoint=128, device=args.device,
        ref_pth=None, export_pth=osp.join(root, "export.pth"),
        recipe=("--seed 786 --alpha 0.01 --split val --k_shot 1 "
                "--batch_size 1 --step_size 1 --selfsup --epoch 1 "
                "--learning_rate 0.01 --lmbda 1 --quantile 0.2 "
                "--msc_iterations 2 --max_num_clusters 4 "
                f"--npoint 128 --model {args.model}"),
        extra="--epoch_iters 1 --num_workers 0 --n_per_prim 16")
    rc = cmd_run(ns)
    if rc == 0 and not args.keep:
        shutil.rmtree(root, ignore_errors=True)
    elif args.keep:
        print(f"kept fixtures at {root}")
    return rc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("check")
    c.add_argument("--data_root", required=True)
    c.add_argument("--ss_path", required=True)

    r = sub.add_parser("run")
    r.add_argument("--data_root", required=True)
    r.add_argument("--ss_path", required=True)
    r.add_argument("--log_dir", default=None)
    r.add_argument("--model", default="pointnet2_part_seg_msg")
    r.add_argument("--ref_pth", default=None,
                   help="reference .pth to evaluate with the port's "
                        "evaluator (reference -> port direction)")
    r.add_argument("--export_pth", default=None,
                   help="write the port's best checkpoint as a "
                        "reference-format .pth (port -> reference)")
    r.add_argument("--eval_batch", type=int, default=24)
    r.add_argument("--npoint", type=int, default=2048)
    r.add_argument("--recipe", default=None,
                   help="override the canonical recipe flags")
    r.add_argument("--extra", default="",
                   help="extra trainer flags appended to the recipe")

    d = sub.add_parser("dryrun")
    d.add_argument("--out", default=None)
    d.add_argument("--keep", action="store_true")
    d.add_argument("--model", default="pointnet2_part_seg_msg")
    for p in (r, d):
        p.add_argument("--device", default="cuda",
                       help="cuda, or cpu for the plain PyTorch path")

    args = ap.parse_args(argv)
    if args.cmd == "check":
        problems = check_shapenet(args.data_root) + check_acd(args.ss_path)
        if problems:
            return _fail(problems)
        print("layout ok: the reference loaders (and ours) accept it")
        return 0
    if args.cmd == "run":
        return cmd_run(args)
    return cmd_dryrun(args)


if __name__ == "__main__":
    sys.exit(main())
