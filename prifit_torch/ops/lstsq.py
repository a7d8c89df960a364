"""Differentiable least squares with an automatic ridge fallback.

Port of ``prifit_tpu/ops/lstsq.py`` (the reference's ``LeastSquares.lstsq``
and ``best_lambda``): a QR solve when ``A`` has full column rank, else the
normal equations regularized by the smallest lambda of ``1e-6 10^k``,
``k < 7``, that makes ``A^T A + lambda I`` full rank.  The JAX package
picks the branch with ``lax.cond``; here a Python ``if`` on the rank reads
one scalar back to the host.  The rank tests take no gradient; the solves
do, through ``torch.linalg.qr`` and ``torch.linalg.solve``.
"""

import torch

RANK_RTOL = 1e-6


def _rank(A: torch.Tensor) -> int:
    """Numerical rank of ``A [m, n]`` (``torch.matrix_rank`` semantics),
    without gradient."""
    with torch.no_grad():
        s = torch.linalg.svdvals(A)
        tol = torch.max(s) * max(A.shape) * RANK_RTOL
        return int(torch.sum(s > tol))


def best_lambda(A: torch.Tensor) -> torch.Tensor:
    """The smallest ``1e-6 10^k`` (``k < 7``) that makes ``A + lambda I``
    of full rank, else the largest; a scalar tensor, no gradient."""
    n = A.shape[0]
    lambs = 1e-6 * (10.0 ** torch.arange(7, dtype=torch.float32,
                                         device=A.device))
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    A = A.detach()
    for lamb in lambs:
        if _rank(A + lamb * eye) == n:
            return lamb
    return lambs[-1]


def lstsq(A: torch.Tensor, Y: torch.Tensor, lamb: float = 0.0
          ) -> torch.Tensor:
    """``argmin_x ||A x - Y||`` for ``A [m, n]`` (``m >= n``) and ``Y [m]``
    or ``[m, k]``, differentiable in both.  ``lamb``: the least ridge
    weight of the fallback branch."""
    n = A.shape[1]
    if _rank(A) == n:
        q, r = torch.linalg.qr(A)
        return torch.linalg.inv(r) @ (q.T @ Y)
    AtA = A.T @ A
    lamb = torch.clamp_min(best_lambda(AtA), lamb)
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    return torch.linalg.solve(AtA + lamb * eye, A.T @ Y)
