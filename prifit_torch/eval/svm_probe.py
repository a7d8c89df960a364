"""Linear-SVM classification probe over frozen encoder features.

Port of ``prifit_tpu/eval/svm_probe.py``: embed every shape with the
frozen encoder, pool the per-point features into one global vector (max
then mean), fit a linear SVM on the train split and report the test
accuracy.  ``--svm_c`` sets C; ``--cross_val_svm`` tries the grid
``[1, 10, 100, 220, 500]`` and keeps the best test accuracy (the first C
wins a tie).

The JAX probe fits ``sklearn.svm.LinearSVC`` with its defaults; the port
needs no scikit-learn and solves the same problem itself
(:class:`LinearSVC`), in float64 on the features' device:

- one-vs-rest over the sorted classes, one classifier when there are
  two (``+1`` for the second class);
- per classifier ``k`` the squared-hinge objective with the bias
  regularized like a weight (liblinear's constant feature of value 1)::

      0.5 (|w_k|^2 + b_k^2) + C sum_i max(0, 1 - y_ik (w_k . x_i + b_k))^2

  which is strictly convex, so its optimum is unique;
- Newton steps on the generalized Hessian ``I + 2C X_A^T X_A`` over each
  classifier's margin violators ``A`` (``X`` with a column of ones),
  solved by Cholesky, all classifiers at once, with a backtracking line
  search, until every
  classifier's gradient norm is at most ``TOL`` (1e-8) times its weight
  norm ``|(w_k, b_k)|``.  The Hessian is at least the identity, so the
  objective is then within ``|g|^2 / 2`` of its optimum, and since it is
  at least ``|(w_k, b_k)|^2 / 2``, within 1e-16 of it relatively.
  (liblinear's rule, the gradient norm against its norm at 0, is loose
  at a large C: that norm grows with C, and at C=220 on unscaled
  features a relative 1e-8 left the objective 1e-3 above the optimum.)
- ``predict`` is the argmax of the decision values (the first class on a
  tie), or with two classes the second class where the value is above 0.
"""

import time

import torch

CV_GRID = (1.0, 10.0, 100.0, 220.0, 500.0)
# the stopping rule (module docstring) and a bound on the Newton steps,
# which end in a few dozen at most
TOL, MAX_ITER = 1e-8, 100


def _augment(x: torch.Tensor) -> torch.Tensor:
    """``[n, d] -> [n, d + 1]`` float64, a column of ones appended."""
    x = x.double()
    return torch.cat([x, torch.ones_like(x[:, :1])], dim=1)


def objective(W: torch.Tensor, xa: torch.Tensor, Y: torch.Tensor,
              C: float) -> torch.Tensor:
    """The objective of each classifier, ``[m]``: ``W [d + 1, m]`` (the
    bias last), ``xa [n, d + 1]`` with its ones column, ``Y [n, m]`` of
    +-1."""
    r = torch.clamp_min(1.0 - Y * (xa @ W), 0.0)
    return 0.5 * (W * W).sum(0) + C * (r * r).sum(0)


class LinearSVC:
    """L2-regularized squared-hinge linear SVM, one-vs-rest (the module
    docstring): ``LinearSVC(C).fit(x, y)``, then ``predict``, ``score``
    and ``decision_function``; ``coef_ [m, d]`` and ``intercept_ [m]``
    are float64 on ``x``'s device; ``n_iter_`` counts the Newton steps
    and ``rel_grad_`` is the largest final gradient norm over its weight
    norm."""

    def __init__(self, C: float = 1.0):
        self.C = float(C)

    def targets(self, y: torch.Tensor) -> torch.Tensor:
        """``[n, m]`` of +-1: one column a class, or one column (+1 for
        the second class) when there are two."""
        if len(self.classes_) == 2:
            pos = (y == self.classes_[1])[:, None]
        else:
            pos = y[:, None] == self.classes_[None, :]
        return torch.where(pos, 1.0, -1.0).double()

    def fit(self, x: torch.Tensor, y: torch.Tensor) -> "LinearSVC":
        self.classes_ = torch.unique(y)
        if len(self.classes_) < 2:
            raise ValueError(f"LinearSVC needs 2 or more classes, got "
                             f"{self.classes_.tolist()}")
        xa, Y, C = _augment(x), self.targets(y), self.C
        W = torch.zeros((xa.shape[1], Y.shape[1]), dtype=torch.float64,
                        device=xa.device)
        eye = torch.eye(xa.shape[1], dtype=torch.float64, device=xa.device)
        f = objective(W, xa, Y, C)
        self.n_iter_ = 0
        for _ in range(MAX_ITER):
            r = 1.0 - Y * (xa @ W)                         # [n, m]
            act = (r > 0).double()
            grad = W - 2.0 * C * (xa.t() @ (act * r * Y))  # [d + 1, m]
            rel = grad.norm(dim=0) / W.norm(dim=0)
            if bool((rel <= TOL).all()):
                break
            xa_act = xa.t()[None] * act.t()[:, None, :]    # [m, d + 1, n]
            H = eye + 2.0 * C * (xa_act @ xa)
            # H is symmetric positive definite: a Cholesky solve (the
            # batched LU solve of some CPU builds fails with threads)
            step = -torch.cholesky_solve(grad.t()[..., None],
                                         torch.linalg.cholesky(H))[..., 0].t()
            step = torch.where(rel <= TOL, 0.0, step)
            slope = (grad * step).sum(0)
            # backtracking (Armijo) line search, each classifier its own t
            t = torch.ones_like(f)
            for _ in range(50):
                f_new = objective(W + t * step, xa, Y, C)
                ok = f_new <= f + 1e-4 * t * slope
                if bool(ok.all()):
                    break
                t = torch.where(ok, t, 0.5 * t)
            if not bool((f_new < f).any()):
                break    # no classifier moves: rounding limits the descent
            W = torch.where(f_new <= f, W + t * step, W)
            f = torch.minimum(f_new, f)
            self.n_iter_ += 1
        r = 1.0 - Y * (xa @ W)
        grad = W - 2.0 * C * (xa.t() @ (torch.clamp_min(r, 0.0) * Y))
        self.rel_grad_ = float((grad.norm(dim=0) / W.norm(dim=0)).max())
        self.coef_, self.intercept_ = W[:-1].t(), W[-1]
        return self

    def objective(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Each classifier's objective at the fitted weights, ``[m]``."""
        W = torch.cat([self.coef_.t(), self.intercept_[None]], dim=0)
        return objective(W, _augment(x), self.targets(y), self.C)

    def decision_function(self, x: torch.Tensor) -> torch.Tensor:
        """``[n, m]`` decision values (``[n]`` with two classes)."""
        s = x.double() @ self.coef_.t() + self.intercept_
        return s[:, 0] if len(self.classes_) == 2 else s

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        s = self.decision_function(x)
        if len(self.classes_) == 2:
            return self.classes_[(s > 0).long()]
        return self.classes_[torch.argmax(s, dim=1)]

    def score(self, x: torch.Tensor, y: torch.Tensor) -> float:
        return float((self.predict(x) == y).double().mean())


def extract_global_features(forward, loader, device=None):
    """Pool per-point features into ``[n_shapes, 2 D]`` (max ++ mean) f32
    and the labels ``[n_shapes]`` int64, both on ``device`` (the
    forward's); ``forward(points [B, N, C]) -> [B, N, D]``.  Also returns
    the seconds spent waiting for the loader's batches."""
    feats, labels, load_s = [], [], 0.0
    batches = iter(loader)
    while True:
        t0 = time.perf_counter()
        batch = next(batches, None)
        load_s += time.perf_counter() - t0
        if batch is None:
            break
        f = forward(torch.as_tensor(batch[0], device=device)).float()
        feats.append(torch.cat([f.amax(1), f.mean(1)], dim=1))
        labels.append(torch.as_tensor(batch[1], device=device).reshape(-1))
    return torch.cat(feats), torch.cat(labels).long(), load_s


def svm_probe(forward, train_loader, test_loader, svm_c: float = 220.0,
              cross_val: bool = False, device=None) -> dict:
    """Fit and evaluate the linear probe.  Returns the test ``accuracy``,
    its ``C`` and ``train_accuracy`` (the JAX probe's keys), and how the
    time went: ``clouds`` embedded, ``extract_s`` (wall, with a
    synchronize), ``load_s`` (waiting for batches) and ``svm_ms`` (all
    fits and scores)."""
    sync = torch.cuda.synchronize if torch.device(device or "cpu").type \
        == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    x_tr, y_tr, load_tr = extract_global_features(forward, train_loader,
                                                  device)
    x_te, y_te, load_te = extract_global_features(forward, test_loader,
                                                  device)
    sync()
    t1 = time.perf_counter()
    best, iters = None, []
    for c in (CV_GRID if cross_val else (svm_c,)):
        clf = LinearSVC(C=c).fit(x_tr, y_tr)
        acc = clf.score(x_te, y_te)
        iters.append(clf.n_iter_)
        if best is None or acc > best["accuracy"]:
            best = {"accuracy": acc, "C": c,
                    "train_accuracy": clf.score(x_tr, y_tr)}
    sync()
    t2 = time.perf_counter()
    return dict(best, clouds=len(y_tr) + len(y_te), extract_s=t1 - t0,
                load_s=load_tr + load_te, svm_ms=(t2 - t1) * 1e3,
                newton_steps=iters)


def make_feature_forward(model):
    """The per-point feature extractor of a part-seg model: its eval
    forward's 128-d pre-head ``feat`` with a zero category one-hot."""

    @torch.no_grad()
    def forward(points: torch.Tensor) -> torch.Tensor:
        model.eval()
        cls = torch.zeros((points.shape[0], 16), dtype=torch.float32,
                          device=points.device)
        return model(points, cls).feat

    return forward
