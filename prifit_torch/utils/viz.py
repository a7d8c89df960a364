"""Visualization and debug helpers (off the training path).

Port of ``prifit_tpu/utils/viz.py``: plain-text ``.xyz`` and ascii
``.ply`` exporters and pastel label colours in numpy, and matplotlib 3-D
scatter renders, grid layouts and TSNE colouring.  matplotlib and
sklearn are imported inside the renders only, so the exporters need
neither (a machine without them can still export).
"""

import os

import numpy as np


def _host(a) -> np.ndarray:
    """``a`` as a numpy array; a tensor (on any device) is copied to the
    host first."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def save_xyz(path: str, points: np.ndarray, colors=None):
    """Write an ``.xyz`` text cloud (+ optional rgb columns); arrays or
    tensors."""
    points = _host(points)
    data = points if colors is None else np.concatenate(
        [points, _host(colors)], axis=1)
    np.savetxt(path, data, fmt="%.6f")


def save_ply(path: str, points: np.ndarray, colors=None):
    """Write a minimal ascii PLY point cloud."""
    points = _host(points)
    colors = None if colors is None else _host(colors)
    n = points.shape[0]
    has_c = colors is not None
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if has_c:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        for i in range(n):
            row = "%.6f %.6f %.6f" % tuple(points[i, :3])
            if has_c:
                c = (np.asarray(colors[i]) * 255).astype(int)
                row += " %d %d %d" % tuple(c)
            f.write(row + "\n")


def labels_to_colors(labels: np.ndarray, seed: int = 0) -> np.ndarray:
    """Pastel color per label id (reference uses ``get_colors``)."""
    import random

    from prifit_torch.utils.meters import get_colors

    rng = random.Random(seed)
    labels = _host(labels)
    uniq = np.unique(labels)
    palette = get_colors(len(uniq), rng=rng)
    lut = {int(u): palette[i] for i, u in enumerate(uniq)}
    return np.asarray([lut[int(l)] for l in labels])


def visualize_point_cloud(points, labels=None, colors=None, path=None,
                          viz=False, s=2.0):
    """Scatter-render one cloud; save to ``path`` or show if ``viz``.

    Matplotlib stand-in for ``src/VisUtils.py`` open3d renders; returns
    the (points, colors) pair so callers can compose grids.
    """
    points = _host(points)
    if colors is None and labels is not None:
        colors = labels_to_colors(_host(labels))
    if path or viz:
        import matplotlib
        matplotlib.use("Agg" if path and not viz else matplotlib.get_backend())
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(4, 4))
        ax = fig.add_subplot(111, projection="3d")
        ax.scatter(points[:, 0], points[:, 1], points[:, 2],
                   c=colors if colors is not None else "steelblue", s=s)
        ax.set_axis_off()
        if path:
            fig.savefig(path, dpi=120, bbox_inches="tight")
        if viz:
            plt.show()
        plt.close(fig)
    return points, colors


def visualize_point_cloud_from_labels(points, labels, path=None,
                                      viz=False):
    """Label-colored render (``src/utils.py`` helper of the same name)."""
    return visualize_point_cloud(points, labels=labels, path=path, viz=viz)


def grid_points_lists_visulation(point_lists, path=None, cols=4, s=2.0):
    """Grid of clouds, one subplot each (``src/VisUtils.py:254-309``;
    reference typo in the name preserved for surface parity)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(point_lists)
    rows = (n + cols - 1) // cols
    fig = plt.figure(figsize=(3 * cols, 3 * rows))
    for i, pts in enumerate(point_lists):
        pts = _host(pts)
        ax = fig.add_subplot(rows, cols, i + 1, projection="3d")
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=s)
        ax.set_axis_off()
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return fig


def tsne_colors(embedding: np.ndarray, seed: int = 0) -> np.ndarray:
    """3-D TSNE of per-point embeddings normalized to [0, 1] rgb
    (``src/VisUtils.py:40-47``)."""
    from sklearn.manifold import TSNE

    emb = TSNE(n_components=3, random_state=seed,
               init="random", perplexity=min(
                   30, max(2, embedding.shape[0] // 4))).fit_transform(
        _host(embedding))
    emb = emb - emb.min(0)
    return emb / np.maximum(emb.max(0), 1e-12)


def save_cluster_visualization(directory, points, labels, batch_id=0,
                               shape_id=0):
    """Dump the inputs/embeddings pair the reference writes when
    ``visualize`` is on (``convex_loss.py:43-53``), as xyz + png."""
    os.makedirs(directory, exist_ok=True)
    base = os.path.join(directory, f"batch_{batch_id}_{shape_id}")
    save_xyz(base + ".xyz", _host(points))
    visualize_point_cloud(points, labels=labels, path=base + ".png")
    return base
