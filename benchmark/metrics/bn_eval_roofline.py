"""The eval epilogue's share of its roofline, %: the least time of the
epilogues of one eval forward (every PointNet++ layer's dense bias, batch
norm, cast, relu and, ending an SA scale or the group-all layer, the max
over the K neighbours) over the device time an iteration in the program's
``bn_eval`` ranges.

The least time is the least bytes at 3.35 TB/s: each input element read
once at its dtype (a grouped first layer's pre-activation in f32, every
other layer's product in the storage dtype), each output element written
once in the storage dtype (``[groups, F]`` after the max), and each
layer's f32 parameters (running mean and variance, weight, bias, and the
dense bias of layers that add it after the product).  The bytes are
reckoned from the configuration's widths and the traffic's batch and
points, not from the program; the time is read through the range, which
holds the same work whatever computes it.  A program without the range
reads None."""

from benchmark.frozen.roofline import PEAK_BYTES

# the storage dtype's bytes an element, by the configuration's precision
STORAGE_BYTES = {"mxsr": 2, "mx": 2, "bf16": 2, "f32": 4}
F32 = 4


def _layer(rows: int, f: int, in_bytes: int, out_bytes: int, groups: int,
           dense_bias: bool) -> int:
    """Bytes of one layer's epilogue on ``rows`` rows of width ``f``;
    ``groups`` output rows where it ends in the max, else 0."""
    out_rows = groups or rows
    return (rows * f * in_bytes + out_rows * f * out_bytes
            + f * F32 * (5 if dense_bias else 4))


def _chain(rows: int, widths, act: int, first_f32: bool, groups: int):
    """Bytes of a layer chain's epilogues; with ``first_f32`` the first
    layer takes the grouped f32 pre-activation (its dense bias added
    before the gather); with ``groups`` the last layer ends in the max."""
    total = 0
    for i, f in enumerate(widths):
        grouped = first_f32 and i == 0
        total += _layer(rows, f, F32 if grouped else act, act,
                        groups if i == len(widths) - 1 else 0, not grouped)
    return total


def forward_bytes(arch: dict, batch: int, npoint: int, act: int) -> int:
    """The least bytes of one eval forward's epilogues."""
    total = 0
    for name in ("sa1", "sa2"):
        sa = arch[name]
        groups = batch * sa["npoint"]
        for k, mlp in zip(sa["nsample"], sa["mlps"]):
            total += _chain(groups * k, mlp, act, True, groups)
    points = arch["sa2"]["npoint"]
    total += _chain(batch * points, arch["sa3"]["mlp"], act, False, batch)
    for name, n in (("fp3", points), ("fp2", arch["sa1"]["npoint"]),
                    ("fp1", npoint)):
        total += _chain(batch * n, arch[name]["mlp"], act, False, 0)
    return total


def read(run):
    t = run.trace
    if t is None:
        return None
    busy = t.busy_ms(["bn_eval"])
    if not busy:
        return None
    config, p = run.cell.config, run.cell.params
    byt = forward_bytes(config["architecture"], int(p["batch_size"]),
                        int(p["npoint"]), STORAGE_BYTES[config["precision"]])
    return 100.0 * (byt / PEAK_BYTES * 1e3) / busy
