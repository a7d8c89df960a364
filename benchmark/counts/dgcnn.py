"""Operations of ``dgcnn``: DGCNN (``DGCNGn(emb_size=128, nn_nb=20)``) at
the widths of ``benchmark/configs/dgcnn.json``, counted as the port
computes its products (an edge convolution projects every point first
when its input is at least as wide as its output, else the neighbours'
differences)."""

from benchmark import flops

K_NN = 20
EDGE = ((3, 64), (64, 64), (64, 128))
GLOBAL = (256, 1024)
HEAD = ((1280, 512), (512, 256), (256, 256), (256, 50))
EMBED = (256, 128)


def encoder_flops(B: int, N: int, k: int = K_NN) -> int:
    """One forward's products: the two kNN graphs' distances (on xyz and
    on the first edge convolution's output), the three edge
    convolutions, the global layer, the head, the segmentation logits
    and the embedding (which every forward computes)."""
    f = 2 * B * N * N * 3 + 2 * B * N * N * EDGE[0][1]
    for c, out in EDGE:
        if c >= out:
            f += 2 * 2 * B * N * c * out
        else:
            f += 2 * B * N * k * c * out + 2 * B * N * c * out
    f += 2 * B * N * GLOBAL[0] * GLOBAL[1]
    f += sum(2 * B * N * a * b for a, b in HEAD + (EMBED,))
    return f


def embed_flops(B: int, N: int) -> int:
    """Nothing beyond the forward: the embedding is part of it."""
    return 0


def iteration_flops(p: dict, kind: str) -> int:
    return flops.iteration(p, kind, encoder_flops, embed_flops)
