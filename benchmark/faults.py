"""Faults planted in the program's convex branch, for the check's tests
and its calibration (``benchmark/calibrate.py --faults``).  Each is a
context manager that wraps a function of ``prifit_torch`` while open:

- ``fit_one_shape``: the first shape's fitted centres moved by 0.01;
- ``chamfer_one_shape_out``: the chamfer's mean taken without the
  first shape;
- ``chamfer_grad_halved``: the chamfer's backward passes half its
  gradient;
- ``bandwidth_scaled``: the bandwidth candidates 5% wider;
- ``mean_shift_short``: one mean-shift step fewer;
- ``membership_sharp``: the memberships taken at 90% of the bandwidth.
"""

import contextlib
import importlib

import torch


class _Halved(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return 0.5 * g


def _convex_loss_module():
    # the package exports a function of the module's name
    return importlib.import_module("prifit_torch.geometry.convex_loss")


def _clustering_module():
    return importlib.import_module("prifit_torch.clustering.mean_shift")


@contextlib.contextmanager
def _wrapped(module, name, make):
    real = getattr(module, name)
    setattr(module, name, make(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def fit_one_shape():
    cl = _convex_loss_module()

    def make(real):
        def fit(points, weights, slot_valid=None):
            out = real(points, weights, slot_valid)
            shift = torch.zeros_like(out.center)
            shift[0, :, 0] = 0.01
            return out._replace(center=out.center
                                + shift * out.valid[..., None])
        return fit
    return _wrapped(cl, "fit_ellipsoids_batch", make)


def chamfer_one_shape_out():
    cl = _convex_loss_module()

    def make(real):
        def chamfer(params, samples, sample_w, target, *a, **kw):
            rest = type(params)(*(t[1:] for t in params))
            return real(rest, samples[1:], sample_w[1:], target[1:], *a,
                        **kw)
        return chamfer
    return _wrapped(cl, "analytic_chamfer", make)


def chamfer_grad_halved():
    cl = _convex_loss_module()

    def make(real):
        def chamfer(*a, **kw):
            return _Halved.apply(real(*a, **kw))
        return chamfer
    return _wrapped(cl, "analytic_chamfer", make)


def bandwidth_scaled():
    def make(real):
        def candidates(X, quantile, num_candidates):
            return real(X, quantile, num_candidates) * 1.05
        return candidates
    return _wrapped(_clustering_module(), "bandwidth_candidates", make)


def mean_shift_short():
    def make(real):
        def iterations(X, bandwidth, iterations, kernel_type="gaussian"):
            return real(X, bandwidth, iterations - 1, kernel_type)
        return iterations
    return _wrapped(_clustering_module(), "mean_shift_iterations", make)


def membership_sharp():
    def make(real):
        def membership(centers, valid, X, bandwidth):
            return real(centers, valid, X, 0.9 * bandwidth)
        return membership
    return _wrapped(_clustering_module(), "membership", make)


FAULTS = {f.__name__: f for f in (
    fit_one_shape, chamfer_one_shape_out, chamfer_grad_halved,
    bandwidth_scaled, mean_shift_short, membership_sharp)}
