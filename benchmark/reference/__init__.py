"""The plain reference the correctness check holds the program to.

Plain PyTorch and NumPy, importing neither JAX, the JAX package nor the
program (``prifit_torch``): :mod:`benchmark.reference.port` is a frozen
copy of the port's plain paths at commit 0adee2a (models, encoder
blocks, clustering, fitting, the chamfer, datasets and loader), cut to
what the cells run: the kernel wrappers keep their plain versions only,
the collectives are a one-process stand-in, and the variants no cell
takes (AtlasNet, the extra layers, per-stage dtypes, cuboids, the
entropy, intersection and pruning terms, the epanechnikov kernel, the
device prefetch) are left out; each file's docstring says what its copy
leaves out.  The reference reads the data tree's files itself, draws the
weights from the seed itself (:mod:`benchmark.weights`), and runs with
TF32 off.
"""
