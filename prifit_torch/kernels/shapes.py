"""The shapes the clustering kernels take (bandwidth, mean-shift forward and
backward, NMS), shared by their wrappers.

The kernels hold rows of width ``D`` in shared memory padded with zeros to
``DP``, the least of 32, 64 and 128 that is at least ``D`` (a zero column
adds exactly nothing to a product).  Every point count ``N`` up to
``MAX_N`` is taken: the tail past ``N`` is masked in the kernels.
"""

MAX_D = 128    # every model's embedding is 128 wide
MAX_N = 8192   # NMS lists up to N ints a block in shared memory
WIDTHS = (32, 64, 128)


def padded_width(what: str, n: int, d: int) -> int:
    """``DP`` for ``n`` rows of width ``d``; raises ``ValueError`` naming the
    limit for ``d`` outside ``1..MAX_D`` or ``n`` outside ``1..MAX_N``."""
    if not 1 <= d <= MAX_D:
        raise ValueError(f"{what}: embedding width {d} outside 1..{MAX_D}")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"{what}: point count {n} outside 1..{MAX_N}")
    return next(w for w in WIDTHS if w >= d)
