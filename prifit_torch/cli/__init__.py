"""Entry points of the port, mirroring the reference scripts:

  python -m prifit_torch.cli.train_partseg  <-> train_partseg_shapenet.py
  python -m prifit_torch.cli.testing        <-> testing.py
  python -m prifit_torch.cli.pretrain_partseg (the self-sup pretrainer)
  python -m prifit_torch.cli.fitting        <-> fitting.py

Flags are the JAX package's (``args_parser.parse_args``).  Both run on a
CUDA device; ``main(args, device="cpu")`` runs them on the CPU.
"""
