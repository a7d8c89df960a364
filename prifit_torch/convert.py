"""JAX package variables -> the port's state_dict.

The port's copy of the map in ``prifit_tpu/train/torch_port.py``
(``_entries`` and ``export_msg_state_dict``, with the ``extra_layers``
rows), plus AtlasNet's chart-stacked parameters and statistics, which the
JAX package's importer drops and the port names itself
(:mod:`prifit_torch.nn.atlasnet`).  It serves ``pointnet2_part_seg_msg``
(either variant) and ``pretrain_pointnet2_part_seg_msg``, whose
variables have the same names.  Layout facts it encodes:

- an MSG grouped first layer holds ``w_feat [d_in, F]``, ``w_xyz [3, F]``
  and ``b_feat`` (``bias`` when ``d_in == 0``); the reference conv weight
  is ``[F, d_in + 3, 1, 1]`` with the features FIRST;
- other layers are ``[in, out]`` kernels that transpose to 1x1 conv
  weights ``[out, in, 1(, 1)]`` (Conv2d in the SA layers, Conv1d
  elsewhere);
- batch norms map ``scale``/``bias`` params and ``mean``/``var``
  batch_stats to ``weight``/``bias``/``running_mean``/``running_var``;
- under ``extra_layers`` fp1 has no MLP rows, and the fp1 dense chain and
  embedding tower add nine denses and two batch norms (the reference's
  dead ``fp1_embed_conv1_bn1`` is not part of the model);
- AtlasNet's ``atlasnet/VmapPointGenCon_0/Dense_{j}`` kernels are
  ``[charts, in, out]`` and map untransposed to ``atlasnet.decoder.convs
  .{j}``, its ``BatchNorm_{j}`` to ``atlasnet.decoder.bns.{j}``.
"""

import numpy as np
import torch

SA_CFG = (
    ("sa1", 3, [[32, 32, 64], [64, 64, 128], [64, 96, 128]]),
    ("sa2", 320, [[128, 128, 256], [128, 196, 256]]),
)
FP_NAMES = ("fp3", "fp2", "fp1")
EXTRA_DENSES = ("fp1_conv1", "fp1_conv1_bn1", "fp1_conv2", "fp1_conv2_bn2",
                "fp1_embed_conv1", "fp1_embed_conv2", "fp1_embed_conv2_bn2",
                "conv1_embed", "conv2_embed")
EXTRA_BNS = ("conv1_embed_bn", "conv2_embed_bn")
ATLAS = ("atlasnet", "VmapPointGenCon_0")


def _entries(extra_layers: bool = False, atlasnet: bool = False):
    """(torch conv prefix, torch bn prefix, kind, flax path, aux) rows."""
    rows = []
    for name, d_in, mlps in SA_CFG:
        for i, mlp in enumerate(mlps):
            rows.append((f"{name}.conv_blocks.{i}.0",
                         f"{name}.bn_blocks.{i}.0",
                         "gfl", (name, f"GroupedFirstLayer_{i}"), d_in))
            for j in range(1, len(mlp)):
                rows.append((f"{name}.conv_blocks.{i}.{j}",
                             f"{name}.bn_blocks.{i}.{j}",
                             "mlp", (name, f"PointMLP_{i}"), j - 1))
    for j in range(3):
        rows.append((f"sa3.mlp_convs.{j}", f"sa3.mlp_bns.{j}",
                     "mlp", ("sa3", "PointMLP_0"), j))
    for name in FP_NAMES:
        for j in range(0 if extra_layers and name == "fp1" else 2):
            rows.append((f"{name}.mlp_convs.{j}", f"{name}.mlp_bns.{j}",
                         "mlp", (name, "PointMLP_0"), j))
    for nm in ("conv1", "conv2", "extra_conv_emb") + (
            EXTRA_DENSES if extra_layers else ()):
        rows.append((nm, None, "dense", (nm,), None))
    for nm in ("bn1",) + (EXTRA_BNS if extra_layers else ()):
        rows.append((nm, None, "bn", (nm,), None))
    if atlasnet:
        rows += [(f"atlasnet.decoder.convs.{j}", None, "chart",
                  ATLAS + (f"Dense_{j}",), None) for j in range(4)]
        rows += [(f"atlasnet.decoder.bns.{j}", None, "bn",
                  ATLAS + (f"BatchNorm_{j}",), None) for j in range(3)]
    return rows


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return np.asarray(tree, np.float32)


def _conv(w2, conv2d: bool):
    """``[in, out]`` kernel -> conv weight ``[out, in, 1(, 1)]``."""
    w = np.ascontiguousarray(w2.T)[:, :, None]
    return w[..., None] if conv2d else w


def state_dict_from_jax(variables) -> dict:
    """``{"params": ..., "batch_stats": ..., "selfsup_state": ...}``
    nested dicts of arrays of the JAX ``pointnet2_part_seg_msg.get_model``
    (with or without ``extra_layers`` and ``reconstruct``) or
    ``pretrain_pointnet2_part_seg_msg.get_model`` -> the port's state_dict
    (torch f32 tensors); the variant is read from the parameter tree.
    The self-sup entropy weight ``selfsup_state["beta"]`` becomes
    ``beta``; without a ``selfsup_state`` it is 1.0, as at the JAX
    model's init."""
    sd = _convert(variables["params"], variables["batch_stats"])
    beta = variables.get("selfsup_state", {}).get("beta", 1.0)
    sd["beta"] = torch.tensor(np.asarray(beta, np.float32))
    return sd


def params_from_jax(params) -> dict:
    """A JAX ``params`` tree -- or a gradient tree, which has the same
    structure -> ``{name: tensor}`` under the port's parameter names
    (``dict(model.named_parameters())``'s keys)."""
    return _convert(params, None)


def _convert(params, stats) -> dict:
    """The map of :func:`state_dict_from_jax` over the rows of the
    variant the tree holds; without ``stats`` the batch-norm running
    statistics are left out."""
    sd = {}
    rows = _entries(extra_layers="fp1_conv1" in params,
                    atlasnet="atlasnet" in params)

    def bn(prefix, path, scale, bias, mean, var):
        sd[f"{prefix}.weight"] = _get(params, path + (scale,))
        sd[f"{prefix}.bias"] = _get(params, path + (bias,))
        if stats is not None:
            sd[f"{prefix}.running_mean"] = _get(stats, path + (mean,))
            sd[f"{prefix}.running_var"] = _get(stats, path + (var,))

    for conv, bnp, kind, path, aux in rows:
        if kind == "gfl":
            if aux:
                w2 = np.concatenate([_get(params, path + ("w_feat",)),
                                     _get(params, path + ("w_xyz",))], 0)
                b = _get(params, path + ("b_feat",))
            else:
                w2 = _get(params, path + ("w_xyz",))
                b = _get(params, path + ("bias",))
            sd[f"{conv}.weight"] = _conv(w2, True)
            sd[f"{conv}.bias"] = b
            bn(bnp, path, "bn_scale", "bn_bias", "bn_mean", "bn_var")
        elif kind == "mlp":
            j = aux
            sd[f"{conv}.weight"] = _conv(
                _get(params, path + (f"w{j}",)),
                conv.startswith(("sa1.", "sa2.", "sa3.")))
            sd[f"{conv}.bias"] = _get(params, path + (f"b{j}",))
            bn(bnp, path, f"bn{j}_scale", f"bn{j}_bias", f"bn{j}_mean",
               f"bn{j}_var")
        elif kind == "chart":
            sd[f"{conv}.weight"] = _get(params, path + ("kernel",))
            sd[f"{conv}.bias"] = _get(params, path + ("bias",))
        elif kind == "dense":
            sd[f"{conv}.weight"] = _conv(_get(params, path + ("kernel",)),
                                         False)
            sd[f"{conv}.bias"] = _get(params, path + ("bias",))
        else:
            bn(conv, path, "scale", "bias", "mean", "var")
    return {k: torch.tensor(v) for k, v in sd.items()}
