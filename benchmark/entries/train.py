"""The trainer's iteration: one supervised step, then one self-sup step.

Driven through the trainer's own pieces (``prifit_torch/cli/
train_partseg.py``: ``parse_args`` of the traffic's and configuration's
flags, ``build_loaders``, ``batch_transforms``, ``build_model``,
``build_steps``, ``prefetch_to_device`` over ``cycle``), with the loop
body of ``train_partseg.main``: ``next(sup_stream)``, the supervised step,
``next(ss_stream)``, the self-sup step.  The learning rate, batch-norm
momentum and self-sup weight are epoch 0's; the epoch boundary
(checkpoints, metrics, eval) is not driven.  Set-up reads every file of
both datasets once into the datasets' own caches, as a run's first epoch
does.

The weights are the benchmark's (:mod:`benchmark.weights`), loaded with
``strict=True``.  Set-up drives the state through the window's own calls
for its first two iterations and keeps, for the check: the first three
steps' losses (supervised, self-sup, supervised), what the self-sup
step's convex branch took and gave (read by a forward hook on the model:
the embedding it clustered, memberships, primitives, loss, and the
gradient that reached the embedding), each leaf's norm of the
first gradient as Adam got it (its ``exp_avg`` after one step over
``1 - beta1``), and each leaf's norm of the change after three steps.
The reference (:mod:`benchmark.reference.train`) follows the same three
steps from the same files, weights and seed.
"""

import numpy as np
import torch

from benchmark import weights
from benchmark.frozen.waits import WaitTimed
from benchmark.reference import convex
from benchmark.reference import train as reference
from benchmark.reference.compare import training_gaps

BETA1 = 0.9


def flags(params: dict) -> list:
    """The trainer's command-line flags of ``params``."""
    out = []
    for k, v in params.items():
        if isinstance(v, bool):
            out += [f"--{k}"] if v else []
        else:
            out += [f"--{k}", str(v)]
    return out


class MeanShiftCalls:
    """Counts the shapes each call of the clustering's mean-shift
    iterations takes, while installed (the traced stretch only)."""

    def __init__(self):
        self.calls = []
        self._orig = None

    def start(self):
        from prifit_torch.clustering import mean_shift as ms
        self._orig = orig = ms.mean_shift_iterations

        def counted(X, bandwidth, iterations, kernel_type="gaussian"):
            self.calls.append((tuple(X.shape), int(iterations)))
            return orig(X, bandwidth, iterations, kernel_type)

        ms.mean_shift_iterations = counted

    def stop(self):
        from prifit_torch.clustering import mean_shift as ms
        ms.mean_shift_iterations = self._orig


class Entry:
    kind = "train"

    def __init__(self, cell, seed: int, tree: dict, device):
        self.cell, self.seed, self.tree, self.device = \
            cell, int(seed), tree, device
        self.params = cell.params
        self.waits = []
        self.mean_shift = MeanShiftCalls()
        B = int(self.params["batch_size"])
        self.clouds_per_iter = 2 * B

    # ------------------------------------------------------------ set-up
    def _args(self):
        from prifit_torch.cli.args_parser import parse_args
        return parse_args(flags(self.params) + [
            "--seed", str(self.seed),
            "--data_root", self.tree["shapenet"],
            "--ss_path", self.tree["acd"]])

    def setup(self):
        from prifit_torch.cli import train_partseg as tp
        from prifit_torch.data import prefetch_to_device
        from prifit_torch.models import get_module
        from prifit_torch.train.schedules import bn_momentum_schedule, \
            lambda_schedule, lr_schedule
        from prifit_torch.train.state import create_train_state

        args = self.args = self._args()
        train_loader, ss_loader = tp.build_loaders(args, lambda *a: None)
        mod = get_module(args.model)
        model = tp.build_model(args, mod, self.device)
        model.load_state_dict(weights.state_dict(
            lambda d: reference.build_model(self.params, d), self.seed,
            self.device), strict=True)
        self.state = create_train_state(model, optimizer=args.optimizer,
                                        decay_rate=args.decay_rate)
        self.sup_step, self.ss_step = tp.build_steps(args, mod)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(args.seed * 1000003 + 0)
        self.lr = lr_schedule(0, args.learning_rate, args.lr_decay,
                              args.step_size, args.lr_clip)
        self.momentum = bn_momentum_schedule(0, args.step_size)
        self.lmbda = lambda_schedule(0, args.lmbda, args.anneal_lambda,
                                     args.anneal_rate, args.anneal_step)
        sup_t, ss_t = tp.batch_transforms(args)

        def stream(loader, transform):
            return WaitTimed(prefetch_to_device(
                tp.cycle(loader), transform=transform, device=self.device),
                self.waits)

        # the datasets keep every parsed file: read each once now, so the
        # window sees the steady state of a run past its first epoch (the
        # first epoch's file reads would otherwise fall in the window)
        for ds in (train_loader.dataset, ss_loader.dataset):
            for i in range(len(ds)):
                ds.get(i, rng=np.random.default_rng(0))
        self.sup_stream = stream(train_loader, sup_t)
        self.ss_stream = stream(ss_loader, ss_t)
        self.readings = self._first_steps()

    def _sup(self):
        points, cls_onehot, target = next(self.sup_stream)
        self.state, m = self.sup_step(self.state, points, cls_onehot,
                                      target, self.lr, self.momentum,
                                      self.generator, None)
        return m["loss"]

    def _ss(self):
        pts, cls_zero, third = next(self.ss_stream)
        self.state, m = self.ss_step(self.state, pts, cls_zero, third,
                                     self.lr, self.momentum, self.lmbda,
                                     self.generator, None)
        return m["ss_loss"]

    def _first_steps(self) -> dict:
        """Two iterations through the window's calls, with the readings
        the check compares (module docstring)."""
        model, opt = self.state.model, self.state.optimizer
        names = [n for n, _ in model.named_parameters()]
        w0 = [p.detach().clone() for p in model.parameters()]
        losses = [self._sup()]
        # a leaf the optimizer holds no moment of took no update: 0
        zero = torch.zeros((), device=self.device)
        grad = torch.stack([
            (opt.state[p]["exp_avg"] / (1 - BETA1)).norm()
            if "exp_avg" in opt.state[p] else zero
            for p in model.parameters()])
        hook, seen = convex.capture(model, keep_grad=True)
        losses.append(self._ss())
        hook.remove()
        losses.append(self._sup())
        change = torch.stack([(p.detach() - w).norm() for p, w in
                              zip(model.parameters(), w0)])
        self._ss()
        del w0
        return {"loss": torch.stack(losses).tolist(),
                "ss": convex.to_cpu(seen[0]),
                "grad_norm": dict(zip(names, grad.tolist())),
                "change_norm": dict(zip(names, change.tolist()))}

    # ------------------------------------------------------------ window
    def iterate(self):
        sup = self._sup()
        ss = self._ss()
        return torch.stack([sup, ss])

    def encoder_modules(self):
        model = self.state.model
        return [(f"encoder.{n}", getattr(model, n))
                for n in self.cell.config["encoder_modules"]]

    def start_counting(self):
        self.mean_shift.start()

    def stop_counting(self):
        self.mean_shift.stop()

    def count_failed(self, results) -> int:
        """Iterations whose losses are not finite."""
        if not results:
            return 0
        ok = torch.isfinite(torch.stack(results)).all(-1)
        return int((~ok).sum().item())

    # ------------------------------------------------------------- check
    def free(self):
        self.sup_stream.close()
        self.ss_stream.close()
        del self.state, self.sup_step, self.ss_step
        self.sup_stream = self.ss_stream = None

    def check(self) -> dict:
        ref = reference.readings(self.params, self.seed, self.tree,
                                 self.device, judge=self.readings["ss"])
        return training_gaps(self.readings, ref)
