"""Operations of ``pointnet2_msg``: PointNet++ MSG part segmentation at
the widths of ``benchmark/configs/pointnet2_msg.json``, counted as the
port computes its products (a grouped first layer gathers the narrower
of its raw inputs and its per-point projection)."""

from benchmark import flops

SA1 = dict(S=512, K=(32, 64, 128), d_in=3,
           mlps=((32, 32, 64), (64, 64, 128), (64, 96, 128)))
SA2 = dict(S=128, K=(64, 128), d_in=320, mlps=((128, 128, 256),
                                                 (128, 196, 256)))
SA3 = (515, 256, 512, 1024)
FP3 = (1536, 256, 256)
FP2 = (576, 256, 128)
FP1 = (150, 128, 128)
HEAD = ((128, 128), (128, 50))
EMBED = (128, 128)


def _chain(rows, widths):
    return sum(2 * rows * a * b for a, b in zip(widths, widths[1:]))


def _sa_msg(B, N, S, K, d_in, mlps):
    f = 2 * B * S * N * 3                      # the ball query's distances
    for k, mlp in zip(K, mlps):
        f0 = mlp[0]
        if 3 + d_in <= f0:
            f += 2 * B * S * k * (3 + d_in) * f0
        else:
            f += 2 * B * N * (3 + d_in) * f0
        f += 2 * B * S * 3 * f0                # the centres' projection
        f += _chain(B * S * k, mlp)
    return f


def encoder_flops(B: int, N: int) -> int:
    """One forward's products: the encoder (sa1..fp1, with the ball
    queries' and the 3-NN interpolations' distances) and the head
    (``conv1``, ``conv2``)."""
    n1, n2 = SA1["S"], SA2["S"]
    return (_sa_msg(B, N, **SA1) + _sa_msg(B, n1, **SA2)
            + _chain(B * n2, SA3)
            + _chain(B * n2, FP3)
            + 2 * B * n1 * n2 * 3 + _chain(B * n1, FP2)
            + 2 * B * N * n1 * 3 + _chain(B * N, FP1)
            + sum(2 * B * N * a * b for a, b in HEAD))


def embed_flops(B: int, N: int) -> int:
    """``extra_conv_emb``, the embedding the convex loss clusters."""
    return 2 * B * N * EMBED[0] * EMBED[1]


def iteration_flops(p: dict, kind: str) -> int:
    return flops.iteration(p, kind, encoder_flops, embed_flops)
