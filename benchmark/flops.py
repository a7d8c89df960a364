"""Operation counts shared by the configurations' counts
(``benchmark/counts/<config>.py``): the products an iteration needs
beyond the encoder.  Each counts the work the mathematics needs at the
cell's shapes, two flops a multiply-add, and nothing a kernel recomputes:
a lower bound, so a share of a peak built on it cannot pass 100%."""


def clustering_forward(B, N, D, steps, K):
    """The clustering of the first bandwidth candidate: the k-th-NN
    distances (one ``N x N`` product of width ``D``), ``steps`` gaussian
    mean-shift steps (two such products a step), the NMS distances of the
    modes (one), the slots' labels and the membership (two ``K x N``)."""
    nn_ = 2 * B * N * N * D
    return nn_ * (1 + 2 * steps + 1) + 2 * 2 * B * K * N * D


def clustering_backward(B, N, D, steps):
    """The mean-shift backward the loss needs: its cotangent is live only
    at the slots' centre rows, counted at the least, one a shape: four
    products of one row against ``N`` rows of width ``D`` a step."""
    return steps * 4 * 2 * B * N * D


def chamfer(B, n_samples, n_target):
    """The analytic chamfer's distances between a shape's primitive
    samples (one primitive's, the least) and its target cloud, xyz."""
    return 2 * B * n_samples * n_target * 3


def convex_forward(p, B, N, D=128):
    return (clustering_forward(B, N, D, p["msc_iterations"],
                               p["max_num_clusters"])
            + chamfer(B, p["n_per_prim"], p.get("chamfer_npoints", N)))


def convex_train(p, B, N, D=128):
    """Forward and backward of the convex loss in a self-sup step."""
    return (convex_forward(p, B, N, D)
            + clustering_backward(B, N, D, p["msc_iterations"])
            + 2 * chamfer(B, p["n_per_prim"], p["chamfer_npoints"]))


def contrastive(B, N, D=128):
    """The pairwise contrastive loss's products, forward and backward:
    the ``N x N`` similarity of the per-point features a shape."""
    return 3 * 2 * B * N * N * D


def iteration(p, kind, encoder_forward, embed_flops):
    """An iteration of ``kind``: ``"train"`` (a supervised step and a
    self-sup step, each forward and backward, the backward twice the
    forward's products) or ``"eval"`` (one forward with fit)."""
    B, N = p["batch_size"], p["npoint"]
    enc = encoder_forward(B, N)
    if kind == "eval":
        return enc + embed_flops(B, N) + convex_forward(p, B, N)
    ss = 3 * enc
    if p["ss_loss"] == "contrastive":
        ss += contrastive(B, N)
    else:
        ss += 3 * embed_flops(B, N) + convex_train(p, B, N)
    return 3 * enc + ss
