"""Checkpoints with ``torch.save`` (port of
``prifit_tpu/train/checkpoint.py``, which writes orbax trees).

The reference saves ``{epoch, train_acc | losses, model_state_dict,
optimizer_state_dict}`` every epoch (``train_partseg_shapenet.py:467-475``)
and auto-resumes from its checkpoint (``:263-274``).  A checkpoint here is
one file ``directory/name`` in that wrapper format, holding

  - ``epoch``;
  - ``model_state_dict``: the parameters, the batch-norm running
    statistics and the self-sup entropy weight ``beta``;
  - ``optimizer_state_dict``;
  - ``step``, the train state's step count;
  - ``extra``: metrics (``train_acc``, ``class_avg_miou``, ...).

Tensors are saved from the CPU and restored onto the model's device.
"""

import os
import os.path as osp

import torch

from prifit_torch.train.state import TrainState


def save_checkpoint(directory: str, name: str, *, epoch: int,
                    state: TrainState, extra: dict | None = None) -> str:
    """Save ``state`` under ``directory/name``; returns the path.  The
    file is written under a temporary name and renamed, so an interrupted
    save never leaves a partial checkpoint."""
    os.makedirs(directory, exist_ok=True)
    path = osp.abspath(osp.join(directory, name))
    payload = {
        "epoch": int(epoch),
        "model_state_dict": {k: v.detach().cpu() for k, v in
                             state.model.state_dict().items()},
        "optimizer_state_dict": _to_cpu(state.optimizer.state_dict()),
        "step": int(state.step),
        "extra": {k: float(v) for k, v in (extra or {}).items()},
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _load(directory: str, name: str):
    path = osp.abspath(osp.join(directory, name))
    if not osp.isfile(path):
        raise FileNotFoundError(path)
    return torch.load(path, map_location="cpu", weights_only=False)


def restore_checkpoint(directory: str, name: str, state: TrainState
                       ) -> tuple[TrainState, int]:
    """Restore a checkpoint into ``state`` (model, optimizer and step, in
    place); returns ``(state, epoch)``.

    Raises FileNotFoundError if the checkpoint doesn't exist (callers
    mirror the reference's try/except resume, ``train:263-274``).
    """
    ckpt = _load(directory, name)
    state.model.load_state_dict(ckpt["model_state_dict"], strict=True)
    # load_state_dict casts the moments to each parameter's device
    state.optimizer.load_state_dict(ckpt["optimizer_state_dict"])
    state.step = int(ckpt["step"])
    return state, int(ckpt["epoch"])


def _merge(fresh: dict, restored: dict):
    """Right-biased merge of two state_dicts: take ``restored`` where a
    name exists in both, keep ``fresh`` elsewhere.  Returns (merged,
    missing, matched) with ``missing`` the fresh-only names (e.g. heads
    absent from a pretrain checkpoint) and ``matched`` the count taken
    from the checkpoint.  A matched entry of another shape raises: that
    is a wrong or incompatible checkpoint, not a missing head."""
    merged, missing, matched = {}, [], 0
    for k, v in fresh.items():
        if k not in restored:
            merged[k] = v
            missing.append(k)
            continue
        r = torch.as_tensor(restored[k])
        if tuple(r.shape) != tuple(v.shape):
            raise ValueError(
                f"warm-start shape mismatch at {k}: checkpoint "
                f"{tuple(r.shape)} vs model {tuple(v.shape)} "
                f"(incompatible architecture/config)")
        merged[k] = r.to(dtype=v.dtype)
        matched += 1
    return merged, missing, matched


def load_params(model: torch.nn.Module, directory: str, name: str,
                log=print) -> list:
    """Merge a checkpoint's weights into ``model`` (in place) and return
    the names the checkpoint lacks, which keep the model's own values.

    Keeps the JAX package's merge semantics: the checkpoint is merged into
    the fresh model, which keeps its own values for entries the
    checkpoint lacks (e.g. a head the pretrainer never had), and zero
    matches raise.  ``name`` may be one of this package's checkpoints or
    a REFERENCE torch ``.pth``: a raw state_dict or the reference's
    ``{model_state_dict, ...}`` training wrapper (``testing.py:96-107``),
    whose names the port's modules carry, so no mapping is needed.
    Entries of the checkpoint that the model does not have are ignored.
    """
    ckpt = _load(directory, name)
    if isinstance(ckpt, dict) and "model_state_dict" in ckpt:
        meta = sorted(k for k in ckpt
                      if k not in ("model_state_dict",
                                   "optimizer_state_dict"))
        if meta:
            log(f"checkpoint metadata keys: {meta}")
        ckpt = ckpt["model_state_dict"]
    merged, missing, matched = _merge(model.state_dict(), ckpt)
    if matched == 0:
        raise ValueError(
            f"warm-start: checkpoint {directory}/{name} matched ZERO "
            f"model parameters — wrong file or incompatible naming "
            f"(first missing: {missing[:3]})")
    for m in missing:
        log(f"warm-start: keeping fresh init for {m} "
            f"(absent from checkpoint)")
    model.load_state_dict(merged, strict=True)
    return missing


def restore_params_only(directory: str, name: str, state: TrainState,
                        log=print) -> TrainState:
    """Warm-start the model's weights from a checkpoint
    (``--pretrained_model``, reference ``train:276-280``): parameters,
    batch-norm statistics and ``beta``, merged as :func:`load_params`
    merges them, with the optimizer left fresh."""
    load_params(state.model, directory, name, log=log)
    return state


def latest_checkpoint(directory: str, prefix: str = "model_") -> str | None:
    """Name of the newest epoch checkpoint in a directory, or None."""
    if not osp.isdir(directory):
        return None
    names = [n for n in os.listdir(directory) if n.startswith(prefix)
             and not n.endswith(".tmp")]
    return max(names) if names else None
