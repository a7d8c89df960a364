"""The eval forward with primitive fit (``prifit_torch.entry.
eval_forward``: the model in eval mode, the convex loss against the
input cloud itself, with the traffic's clustering arguments) on the test
split's full batches, placed on the device at set-up and cycled.

The outputs of a sample of the window's batches, drawn from the seed,
are kept (log-probs and the convex branch) and, after the window, held
against the reference's forward on the same batches and its judgement
of the convex branch (:mod:`benchmark.reference.evaluate`)."""

import numpy as np
import torch

from benchmark import weights
from benchmark.entries.train import MeanShiftCalls, flags
from benchmark.reference import convex
from benchmark.reference import evaluate as reference
from benchmark.reference.compare import eval_gaps
from benchmark.reference.train import build_model

# outputs kept for the check: this many iterations among the first SPAN
KEEP, SPAN = 8, 64


class Entry:
    kind = "eval"

    def __init__(self, cell, seed: int, tree: dict, device):
        self.cell, self.seed, self.tree, self.device = \
            cell, int(seed), tree, device
        self.params = cell.params
        self.clouds_per_iter = int(self.params["batch_size"])
        self.waits = None
        self.mean_shift = MeanShiftCalls()

    def setup(self):
        from prifit_torch.cli import train_partseg as tp
        from prifit_torch.cli.args_parser import parse_args
        from prifit_torch.data import DataLoader, PartNormalDataset
        from prifit_torch.models import get_module

        p = self.params
        args = parse_args(flags({"model": p["model"], "npoint": p["npoint"],
                                 "batch_size": p["batch_size"],
                                 **{k: v for k, v in p.items()
                                    if k in ("encoder_dtype", "dgcnn_k",
                                             "num_parts")}})
                          + ["--seed", str(self.seed)])
        model = tp.build_model(args, get_module(args.model), self.device)
        model.load_state_dict(weights.state_dict(
            lambda d: build_model(p, d), self.seed, self.device),
            strict=True)
        self.model = model.eval()
        ds = PartNormalDataset(self.tree["shapenet"], npoints=p["npoint"],
                               split=p["split"], normal_channel=False,
                               rng=np.random.default_rng(self.seed))
        loader = DataLoader(ds, p["batch_size"], shuffle=False,
                            drop_last=True, seed=self.seed)
        self.batches = [torch.as_tensor(b[0], device=self.device)
                        for b in loader]
        self.cls = torch.zeros((p["batch_size"], p["num_classes"]),
                               dtype=torch.float32, device=self.device)
        self.kwargs = reference.fit_kwargs(p)
        rng = np.random.default_rng([self.seed, 7])
        # the first batch's output, and a sample of the window's
        self.keep_at = {0} | set(rng.choice(SPAN, KEEP,
                                            replace=False).tolist())
        self.kept = []
        self.i = 0

    def iterate(self):
        from prifit_torch.entry import eval_forward
        b = self.i % len(self.batches)
        out = eval_forward(self.model, self.batches[b], self.cls,
                           **self.kwargs)
        if self.i in self.keep_at:
            self.kept.append((b, out.seg_logits, convex.branch(out)))
        self.i += 1
        return torch.isfinite(out.seg_logits).all() & \
            torch.isfinite(out.total_loss)

    def encoder_modules(self):
        return [(f"encoder.{n}", getattr(self.model, n))
                for n in self.cell.config["encoder_modules"]]

    def start_counting(self):
        self.mean_shift.start()

    def stop_counting(self):
        self.mean_shift.stop()

    def count_failed(self, results) -> int:
        if not results:
            return 0
        return int((~torch.stack(results)).sum().item())

    def free(self):
        self.kept = [(b, lp.cpu(), convex.to_cpu(got))
                     for b, lp, got in self.kept]
        del self.model, self.batches

    def check(self) -> dict:
        if not self.kept:
            return {}
        return eval_gaps(self.kept, reference.judged(
            self.params, self.seed, self.tree, self.device, self.kept))
