"""The benchmark of the PyTorch and CUDA port (``prifit_torch``) on an
NVIDIA H100: see ``BENCHMARK.json`` and :mod:`benchmark.harness`."""
