"""Clouds a training cell consumed in the window (an iteration's
supervised and self-sup batches), over the window's host seconds, from
before the first iteration to the synchronize after the last.  Also
``train_clouds_per_s.dgcnn`` and ``.contrastive``: the same quantity in
those cells, a metric each, whose runs spread less than the MSG convex
trainer's and so hold bounds of their own."""


def read(run):
    return run.entry.clouds_per_iter * run.n_iters / run.window_s
