"""Normalized mutual information between two labelings, in numpy.

The embedding probe (:mod:`prifit_torch.tools.probe_embedding`) scores
mean-shift clusters against the true parts with it.  The JAX package's
probe calls scikit-learn's ``normalized_mutual_info_score``; the port
keeps its own copy of that function at its default
``average_method="arithmetic"``, with the same special cases and the same
order of operations, so the two agree to rounding
(``tests/test_torch_lift_tools.py`` holds them to 1e-12).
"""

from math import log

import numpy as np


def _entropy(labels) -> float:
    """Natural-log entropy of a labeling (1.0 for an empty one, 0.0 for a
    single class)."""
    labels = np.asarray(labels)
    if labels.shape[0] == 0:
        return 1.0
    pi = np.unique(labels, return_counts=True)[1].astype(np.float64)
    if pi.size == 1:
        return 0.0
    pi_sum = np.sum(pi)
    return float(-np.sum((pi / pi_sum) * (np.log(pi) - log(pi_sum))))


def _mutual_info(class_idx, cluster_idx, n_classes, n_clusters) -> float:
    """Mutual information of two labelings given as indices into their
    distinct values."""
    contingency = np.bincount(class_idx * n_clusters + cluster_idx,
                              minlength=n_classes * n_clusters
                              ).reshape(n_classes, n_clusters)
    contingency = contingency.astype(np.float64)
    nzx, nzy = np.nonzero(contingency)
    nz_val = contingency[nzx, nzy]
    contingency_sum = contingency.sum()
    pi = np.ravel(contingency.sum(axis=1))
    pj = np.ravel(contingency.sum(axis=0))
    # a labeling with one cluster has zero entropy, so MI = 0
    if pi.size == 1 or pj.size == 1:
        return 0.0
    log_contingency_nm = np.log(nz_val)
    contingency_nm = nz_val / contingency_sum
    outer = pi.take(nzx).astype(np.int64) * pj.take(nzy).astype(np.int64)
    log_outer = -np.log(outer) + log(pi.sum()) + log(pj.sum())
    mi = (contingency_nm * (log_contingency_nm - log(contingency_sum))
          + contingency_nm * log_outer)
    mi = np.where(np.abs(mi) < np.finfo(mi.dtype).eps, 0.0, mi)
    return float(np.clip(mi.sum(), 0.0, None))


def normalized_mutual_info(labels_true, labels_pred) -> float:
    """NMI of two labelings of the same points, normalized by the
    arithmetic mean of their entropies: 1.0 when both have one class (or
    none), 0.0 when the mutual information is 0."""
    labels_true = np.asarray(labels_true).ravel()
    labels_pred = np.asarray(labels_pred).ravel()
    if labels_true.shape != labels_pred.shape:
        raise ValueError(f"labelings of {labels_true.shape[0]} and "
                         f"{labels_pred.shape[0]} points")
    classes, class_idx = np.unique(labels_true, return_inverse=True)
    clusters, cluster_idx = np.unique(labels_pred, return_inverse=True)
    if classes.shape[0] == clusters.shape[0] and classes.shape[0] <= 1:
        return 1.0
    mi = _mutual_info(class_idx, cluster_idx, classes.shape[0],
                      clusters.shape[0])
    if mi == 0:
        return 0.0
    normalizer = np.mean([_entropy(labels_true), _entropy(labels_pred)])
    return float(mi / normalizer)
