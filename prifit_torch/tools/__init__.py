"""The few-shot lift experiment and the real-data parity harness on the
port: the port's copies of the JAX repository's ``tools/`` scripts of
the same names, each run as ``python -m prifit_torch.tools.<name>``.

  - ``synthetic_primitive_dataset``: the primitive-union ShapeNet-Part,
    ACD, lift, ModelNet40 and S3DIS generators (byte-identical files);
  - ``run_fewshot_matrix``: k_shot x seed x arm at matched supervised
    budgets through the port's trainer and pretrainer;
  - ``summarize_lift``: the per-seed mIoU and delta-versus-``sup`` tables;
  - ``probe_embedding``: NMI between an encoder's mean-shift clusters and
    the true parts;
  - ``run_real_parity``: ``check``, ``run`` and ``dryrun`` of the
    real-data parity procedure.

The tools run on CUDA unless ``--device cpu`` is given.

The names below resolve when first read, so that ``python -m`` of a
module of this package does not find it imported already.
"""

import importlib

_MODULE_OF = {
    "probe": "probe_embedding",
    **dict.fromkeys(("build_cmd", "ensure_pretrain", "final_metrics",
                     "load_done", "plan", "run_cli", "run_key"),
                    "run_fewshot_matrix"),
    **dict.fromkeys(("RECIPE", "check_acd", "check_shapenet"),
                    "run_real_parity"),
    **dict.fromkeys(("summarize_bisect", "summarize_matrix"),
                    "summarize_lift"),
    **dict.fromkeys(("make_lift_benchmark", "make_modelnet_benchmark",
                     "make_primitive_acd", "make_primitive_shapenet",
                     "make_s3dis_rooms"), "synthetic_primitive_dataset"),
}

__all__ = sorted(_MODULE_OF)


def __getattr__(name):
    if name not in _MODULE_OF:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    module = importlib.import_module(f"{__name__}.{_MODULE_OF[name]}")
    return getattr(module, name)
