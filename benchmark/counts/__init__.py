"""A configuration's operation counts: ``<config>.py``'s
``iteration_flops(params, kind)`` and ``encoder_flops(B, N)``."""
