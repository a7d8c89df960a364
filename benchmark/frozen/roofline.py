"""Frozen copy of ``chip_smoke.py::bound_ms``'s roofline arithmetic at
commit 0adee2a, and of its count for the mean-shift forward
(``chip_smoke.py`` ``mean_shift`` check).

H100 SXM peaks (NVIDIA data sheet, 700 W): f32 outside the tensor cores,
dense TF32 on the tensor cores, and HBM3 bandwidth."""

PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12


def bound_ms(nbytes, nops, tf32_flops=0):
    """The least time for the work: ``nbytes`` at the memory rate against
    ``nops`` f32 operations at the f32 rate plus ``tf32_flops`` tensor-core
    flops at the TF32 rate (a 3xTF32 product counts three times).
    Returns ``(ms, "bytes" or "operations")``."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (nops / PEAK_F32_FLOPS + tf32_flops / PEAK_TF32_FLOPS) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def mean_shift_bound_ms(B: int, N: int, D: int, steps: int):
    """The least time of ``steps`` gaussian mean-shift steps of ``B``
    shapes of ``N`` unit rows of width ``D`` (f32): two products of
    ``2 N^2 D`` flops a step, f32-accurate, so three TF32 passes; ``N^2``
    exponentials at the f32 rate; the rows read twice and the means and
    sums written once a step."""
    tf32 = steps * 3 * 4 * B * N * N * D
    rows = B * N * D * 4
    byt = steps * (2 * rows + B * 4 + rows + B * N * 4)
    return bound_ms(byt, steps * B * N * N, tf32)
