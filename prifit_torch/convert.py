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

It serves the trainer's other models too, read from the tree as well:

- ``pointnet2_part_seg_ssg``: one grouped first layer a SA layer
  (``sa{1,2}/GroupedFirstLayer_0``) whose reference conv weight has the
  xyz FIRST, ``[F, 3 + d_in]``, then ``PointMLP_0``'s rows (the SA
  layers' ``mlp_convs.{j}``/``mlp_bns.{j}``);
- ``pointnet_part_seg``: ``stn``/``fstn`` hold ``Dense_0..2`` (the 1x1
  convs ``conv1..3``), ``Dense_3..5`` (``nn.Linear`` ``fc1..3``, so
  ``fstn/Dense_5`` is ``[256, 16384]``) and ``BatchNorm_0..4``
  (``bn1..5``); then ``conv1..5``/``bn1..5`` and ``convs1..4``/
  ``bns1..3``;
- ``dgcnn``: flax auto-names under ``dgcnn/``.  ``DGCNNEncoderGn_0/
  _EdgeConv_{i}/kernel`` is ``[2C, F]`` (``W_d`` its first C rows) and
  becomes the bias-free Conv2d ``encoder.edge_convs.{i}.conv``; each
  ``GroupNorm_*`` has ``scale`` and ``bias`` and no statistics;
  ``Dense_0..3`` are ``convs.0..2`` and ``seg``, and ``Dense_4``, which
  has no bias, is ``embed``;
- ``reconstruction``: the MSG rows without ``extra_conv_emb`` (and no
  ``beta``), with AtlasNet.

And the registry's other five models:

- ``pointnet2_cls_ssg`` / ``pointnet2_cls_msg``: the SSG or MSG SA rows
  (the MSG classifier's sa2 widths are its own), sa3's ``PointMLP_0``,
  and the head ``fc1..3`` (``nn.Linear``) and ``bn1..2``;
- ``pointnet2_sem_seg``: four SSG SA layers (``sa1..4``, each grouped
  first layer xyz first, sa1's features the whole input), ``fp4..1``,
  ``conv1..2`` and ``bn1``;
- ``pointnet_cls`` / ``pointnet_sem_seg``: the encoder ``feat``
  (``STN_0``/``STN_1`` as ``feat.stn``/``feat.fstn``, ``Dense_0..2`` and
  ``BatchNorm_0..2`` as ``feat.conv1..3``/``feat.bn1..3``), then
  ``fc1..3`` (``nn.Linear``) and ``bn1..2``, or ``conv1..4`` and
  ``bn1..3``.  Their input width is the JAX model's
  (:func:`input_channels`).
"""

import numpy as np
import torch

SA_CFG = (
    ("sa1", [[32, 32, 64], [64, 64, 128], [64, 96, 128]]),
    ("sa2", [[128, 128, 256], [128, 196, 256]]),
)
FP_NAMES = ("fp3", "fp2", "fp1")
EXTRA_DENSES = ("fp1_conv1", "fp1_conv1_bn1", "fp1_conv2", "fp1_conv2_bn2",
                "fp1_embed_conv1", "fp1_embed_conv2", "fp1_embed_conv2_bn2",
                "conv1_embed", "conv2_embed")
EXTRA_BNS = ("conv1_embed_bn", "conv2_embed_bn")
ATLAS = ("atlasnet", "VmapPointGenCon_0")


def _msg_rows(name: str, mlps):
    """Rows of an MSG SA layer ``name`` with the scales' widths ``mlps``:
    a grouped first layer a scale (features first), then its
    ``PointMLP_{i}``'s rows."""
    rows = []
    for i, mlp in enumerate(mlps):
        rows.append((f"{name}.conv_blocks.{i}.0", f"{name}.bn_blocks.{i}.0",
                     "gfl", (name, f"GroupedFirstLayer_{i}"), False))
        for j in range(1, len(mlp)):
            rows.append((f"{name}.conv_blocks.{i}.{j}",
                         f"{name}.bn_blocks.{i}.{j}",
                         "mlp", (name, f"PointMLP_{i}"), j - 1))
    return rows


def _entries(extra_layers: bool = False, atlasnet: bool = False,
             embed: bool = True):
    """(torch conv prefix, torch bn prefix, kind, flax path, aux) rows of
    the MSG models (``embed``: with ``extra_conv_emb``)."""
    rows = []
    for name, mlps in SA_CFG:
        rows += _msg_rows(name, mlps)
    rows += _mlp_rows("sa3", 3)
    for name in FP_NAMES:
        rows += _mlp_rows(name, 0 if extra_layers and name == "fp1" else 2)
    for nm in ("conv1", "conv2") + ("extra_conv_emb",) * embed + (
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


def _mlp_rows(name: str, n: int, first: int = 0):
    """Rows of ``PointMLP_0``'s layers ``first..n-1`` under ``name``, as
    ``{name}.mlp_convs.{j}`` / ``{name}.mlp_bns.{j}``."""
    return [(f"{name}.mlp_convs.{j}", f"{name}.mlp_bns.{j}", "mlp",
             (name, "PointMLP_0"), j - first) for j in range(first, n)]


def _ssg_rows(name: str):
    """Rows of a single-scale SA layer ``name`` of three widths: its
    grouped first layer (xyz first), then ``PointMLP_0``'s two."""
    return [(f"{name}.mlp_convs.0", f"{name}.mlp_bns.0", "gfl",
             (name, "GroupedFirstLayer_0"), True)] \
        + _mlp_rows(name, 3, first=1)


def _head_rows(*names, kind="dense"):
    return [(nm, None, "bn" if nm.startswith("bn") else kind, (nm,), None)
            for nm in names]


def _ssg_entries():
    """Rows of ``pointnet2_part_seg_ssg``."""
    rows = _ssg_rows("sa1") + _ssg_rows("sa2")
    rows += _mlp_rows("sa3", 3) + _mlp_rows("fp3", 2) + _mlp_rows("fp2", 2) \
        + _mlp_rows("fp1", 3)
    return rows + _head_rows("conv1", "conv2", "bn1")


def _cls_entries(msg: bool):
    """Rows of ``pointnet2_cls_msg`` (``msg``) or ``pointnet2_cls_ssg``:
    the SA layers, then the head's ``nn.Linear`` ``fc1..3`` and ``bn1..2``."""
    if msg:
        rows = _msg_rows("sa1", [[32, 32, 64], [64, 64, 128], [64, 96, 128]]) \
            + _msg_rows("sa2", [[64, 64, 128], [128, 128, 256],
                                [128, 128, 256]])
    else:
        rows = _ssg_rows("sa1") + _ssg_rows("sa2")
    return rows + _mlp_rows("sa3", 3) + _head_rows(
        "fc1", "bn1", "fc2", "bn2", "fc3", kind="linear")


def _sem_seg_entries():
    """Rows of ``pointnet2_sem_seg``."""
    rows = []
    for name in ("sa1", "sa2", "sa3", "sa4"):
        rows += _ssg_rows(name)
    for name, n in (("fp4", 2), ("fp3", 2), ("fp2", 2), ("fp1", 3)):
        rows += _mlp_rows(name, n)
    return rows + _head_rows("conv1", "bn1", "conv2")


def _stn_entries(name: str):
    return ([(f"{name}.conv{j + 1}", None, "dense", (name, f"Dense_{j}"),
              None) for j in range(3)]
            + [(f"{name}.fc{j - 2}", None, "linear", (name, f"Dense_{j}"),
                None) for j in range(3, 6)]
            + [(f"{name}.bn{j + 1}", None, "bn", (name, f"BatchNorm_{j}"),
                None) for j in range(5)])


def _encoder_entries(feature_transform: bool):
    """Rows of a ``PointNetEncoder`` named ``feat``: ``STN_0`` (``stn``),
    ``Dense_0..2`` and ``BatchNorm_0..2`` (``conv1..3``, ``bn1..3``), and
    with the feature transform ``STN_1`` (``fstn``)."""
    rows = [(f"feat.conv{j + 1}", None, "dense", ("feat", f"Dense_{j}"),
             None) for j in range(3)]
    rows += [(f"feat.bn{j + 1}", None, "bn", ("feat", f"BatchNorm_{j}"),
              None) for j in range(3)]
    for stn, path in (("stn", "STN_0"),) + ((("fstn", "STN_1"),)
                                           if feature_transform else ()):
        rows += [(f"feat.{r[0]}", None, r[2], ("feat", path) + r[3][1:],
                  r[4]) for r in _stn_entries(stn)]
    return rows


def _pointnet_cls_entries(cls: bool):
    """Rows of ``pointnet_cls`` (``cls``) or ``pointnet_sem_seg``."""
    rows = _encoder_entries(True)
    if cls:
        return rows + _head_rows("fc1", "bn1", "fc2", "bn2", "fc3",
                                 kind="linear")
    return rows + _head_rows("conv1", "bn1", "conv2", "bn2", "conv3", "bn3",
                             "conv4")


def _pointnet_entries():
    """Rows of ``pointnet_part_seg``."""
    rows = _stn_entries("stn") + _stn_entries("fstn")
    for nm in ("1", "2", "3", "4", "5", "s1", "s2", "s3"):
        rows += [(f"conv{nm}", None, "dense", (f"conv{nm}",), None),
                 (f"bn{nm}", None, "bn", (f"bn{nm}",), None)]
    return rows + [("convs4", None, "dense", ("convs4",), None)]


def _dgcnn_entries():
    """Rows of ``dgcnn`` (flax auto-names, module docstring)."""
    enc = ("dgcnn", "DGCNNEncoderGn_0")
    rows = []
    for i in range(3):
        path = enc + (f"_EdgeConv_{i}",)
        rows += [(f"dgcnn.encoder.edge_convs.{i}.conv", None, "conv_nb",
                  path, True),
                 (f"dgcnn.encoder.edge_convs.{i}.norm", None, "gn",
                  path + ("GroupNorm_0",), None)]
    rows += [("dgcnn.encoder.conv", None, "dense", enc + ("Dense_0",), None),
             ("dgcnn.encoder.norm", None, "gn", enc + ("GroupNorm_0",),
              None)]
    for j in range(3):
        rows += [(f"dgcnn.convs.{j}", None, "dense", ("dgcnn", f"Dense_{j}"),
                  None),
                 (f"dgcnn.norms.{j}", None, "gn",
                  ("dgcnn", f"GroupNorm_{j}"), None)]
    return rows + [("dgcnn.seg", None, "dense", ("dgcnn", "Dense_3"), None),
                   ("dgcnn.embed", None, "conv_nb", ("dgcnn", "Dense_4"),
                    False)]


def _model_entries(params):
    """The rows of the model whose parameter tree ``params`` is."""
    if "dgcnn" in params:
        return _dgcnn_entries()
    if "stn" in params:
        return _pointnet_entries()
    if "feat" in params:
        return _pointnet_cls_entries(cls="fc1" in params)
    if "fc1" in params:
        return _cls_entries(msg="GroupedFirstLayer_1" in params["sa1"])
    if "sa4" in params:
        return _sem_seg_entries()
    if "GroupedFirstLayer_1" not in params["sa1"]:
        return _ssg_entries()
    return _entries(extra_layers="fp1_conv1" in params,
                    atlasnet="atlasnet" in params,
                    embed="extra_conv_emb" in params)


def _tree(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _get(tree, path):
    return np.asarray(_tree(tree, path), np.float32)


def _conv(w2, conv2d: bool):
    """``[in, out]`` kernel -> conv weight ``[out, in, 1(, 1)]``."""
    w = np.ascontiguousarray(w2.T)[:, :, None]
    return w[..., None] if conv2d else w


def state_dict_from_jax(variables) -> dict:
    """``{"params": ..., "batch_stats": ..., "selfsup_state": ...}``
    nested dicts of arrays of a JAX part-seg model -> the port's
    state_dict (torch f32 tensors): any of the eleven registry models
    (``pointnet2_part_seg_msg`` with or without ``extra_layers`` and
    ``reconstruct``), read from the parameter tree.  For the models with the self-sup
    ``extra_conv_emb``, the entropy weight ``selfsup_state["beta"]``
    becomes ``beta``; without a ``selfsup_state`` it is 1.0, as at the
    JAX model's init."""
    params = variables["params"]
    sd = _convert(params, variables.get("batch_stats", {}))
    if "extra_conv_emb" in params:
        beta = variables.get("selfsup_state", {}).get("beta", 1.0)
        sd["beta"] = torch.tensor(np.asarray(beta, np.float32))
    return sd


def input_channels(variables) -> int:
    """The input width of a JAX ``pointnet_cls``, ``pointnet_sem_seg`` or
    ``pointnet2_sem_seg`` model, read from its first kernel: those JAX
    models size their first layer from the input they are initialized
    on, the port's from ``channel`` (or ``with_rgb``/``normal_channel``),
    so the port's model must be built for this width."""
    params = variables["params"]
    if "feat" in params:
        return _tree(params, ("feat", "STN_0", "Dense_0", "kernel")).shape[0]
    return _tree(params, ("sa1", "GroupedFirstLayer_0", "w_feat")).shape[0]


def params_from_jax(params) -> dict:
    """A JAX ``params`` tree -- or a gradient tree, which has the same
    structure -> ``{name: tensor}`` under the port's parameter names
    (``dict(model.named_parameters())``'s keys)."""
    return _convert(params, None)


def _convert(params, stats, rows=None) -> dict:
    """The map of :func:`state_dict_from_jax` over ``rows``, by default
    those of the model the tree holds; without ``stats`` the batch-norm
    running statistics are left out."""
    sd = {}

    def bn(prefix, path, scale, bias, mean, var):
        sd[f"{prefix}.weight"] = _get(params, path + (scale,))
        sd[f"{prefix}.bias"] = _get(params, path + (bias,))
        if stats is not None:
            sd[f"{prefix}.running_mean"] = _get(stats, path + (mean,))
            sd[f"{prefix}.running_var"] = _get(stats, path + (var,))

    for conv, bnp, kind, path, aux in rows or _model_entries(params):
        if kind == "gfl":
            # aux: the xyz columns first (SSG), else the features (MSG)
            w_xyz = _get(params, path + ("w_xyz",))
            if "w_feat" in _tree(params, path):
                w_feat = _get(params, path + ("w_feat",))
                w2 = np.concatenate([w_xyz, w_feat] if aux
                                    else [w_feat, w_xyz], 0)
                b = _get(params, path + ("b_feat",))
            else:
                w2 = w_xyz
                b = _get(params, path + ("bias",))
            sd[f"{conv}.weight"] = _conv(w2, True)
            sd[f"{conv}.bias"] = b
            bn(bnp, path, "bn_scale", "bn_bias", "bn_mean", "bn_var")
        elif kind == "mlp":
            j = aux
            sd[f"{conv}.weight"] = _conv(
                _get(params, path + (f"w{j}",)),
                conv.startswith(("sa1.", "sa2.", "sa3.", "sa4.")))
            sd[f"{conv}.bias"] = _get(params, path + (f"b{j}",))
            bn(bnp, path, f"bn{j}_scale", f"bn{j}_bias", f"bn{j}_mean",
               f"bn{j}_var")
        elif kind == "chart":
            sd[f"{conv}.weight"] = _get(params, path + ("kernel",))
            sd[f"{conv}.bias"] = _get(params, path + ("bias",))
        elif kind in ("dense", "linear"):
            w2 = _get(params, path + ("kernel",))
            sd[f"{conv}.weight"] = np.ascontiguousarray(w2.T) \
                if kind == "linear" else _conv(w2, False)
            sd[f"{conv}.bias"] = _get(params, path + ("bias",))
        elif kind == "conv_nb":
            # a bias-free 1x1 conv: Conv2d when aux, else Conv1d
            sd[f"{conv}.weight"] = _conv(_get(params, path + ("kernel",)),
                                         aux)
        elif kind == "gn":
            sd[f"{conv}.weight"] = _get(params, path + ("scale",))
            sd[f"{conv}.bias"] = _get(params, path + ("bias",))
        else:
            bn(conv, path, "scale", "bias", "mean", "var")
    return {k: torch.tensor(v) for k, v in sd.items()}
