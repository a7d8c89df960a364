"""The port's checkpoints (``prifit_torch/train/checkpoint.py``) on the
CPU.

A round trip restores the weights, the batch-norm statistics, the
self-sup ``beta``, the optimizer state, ``step`` and ``epoch``, and a
step after the restore equals the same step without one.
``restore_params_only`` keeps the JAX package's merge semantics, and a
reference ``.pth`` written by ``prifit_tpu/train/torch_port.py::
export_msg_state_dict`` gives the port the eval logits that the JAX
package's ``restore_params_only`` of the same file gives it (within
1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import prifit_torch.entry as entry
from prifit_torch.models.pointnet2_part_seg_msg import get_loss, get_model
from prifit_torch.train.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    restore_params_only,
    save_checkpoint,
)
from prifit_torch.train.state import create_train_state
from prifit_torch.train.steps import make_selfsup_step, make_supervised_step
from prifit_tpu.models import get_module as j_get_module
from prifit_tpu.train.checkpoint import \
    restore_params_only as j_restore_params_only
from prifit_tpu.train.state import create_train_state as j_create_state
from prifit_tpu.train.state import selfsup_init_kwargs
from prifit_tpu.train.torch_port import export_msg_state_dict

torch.set_num_threads(1)

B, N = 1, 48
SS_KW = dict(quantile=0.2, msc_iterations=2, max_num_clusters=4,
             n_per_prim=16)


def _state():
    return entry.train_flagship(B, N, device="cpu", compute_dtype="f32")


def _trained_state():
    """A state after one supervised and one self-sup step, with ``beta``
    set to 0.5 and the batch-norm statistics moved."""
    state, pts, cls, target = _state()
    gen = torch.Generator().manual_seed(0)
    make_supervised_step(get_loss)(state, pts, cls, target, 1e-3, 0.1, gen)
    state.model.beta.fill_(0.5)
    make_selfsup_step(**SS_KW)(state, pts, cls, pts, 1e-3, 0.1, 1.0, gen)
    return state, pts, cls, target


def _assert_same_state(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0, msg=k)
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert oa["state"].keys() == ob["state"].keys()
    for i in oa["state"]:
        for k, v in oa["state"][i].items():
            torch.testing.assert_close(v, ob["state"][i][k], rtol=0, atol=0)
    assert a.step == b.step


def test_round_trip_restores_everything(tmp_path):
    state, *_ = _trained_state()
    # the self-sup step decayed beta once: 0.5 * 0.99
    assert state.model.beta.item() == pytest.approx(0.495)
    assert state.step == 2
    path = save_checkpoint(str(tmp_path), "last_model", epoch=3,
                           state=state, extra={"train_acc": 0.25})
    assert path.endswith("last_model")
    fresh, *_ = _state()
    assert fresh.model.beta.item() == 1.0
    restored, epoch = restore_checkpoint(str(tmp_path), "last_model", fresh)
    assert epoch == 3 and restored.step == 2
    _assert_same_state(restored, state)
    assert restored.model.beta.item() == pytest.approx(0.495)
    bn = restored.model.bn1
    assert not torch.equal(bn.running_mean, torch.zeros(128))
    raw = torch.load(path, weights_only=False)
    assert set(raw) == {"epoch", "model_state_dict",
                        "optimizer_state_dict", "step", "extra"}
    assert raw["extra"] == {"train_acc": 0.25}
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path), "missing", fresh)


def test_step_after_restore_equals_step_without(tmp_path):
    state, pts, cls, target = _trained_state()
    save_checkpoint(str(tmp_path), "ckpt", epoch=0, state=state)
    other, *_ = _state()
    restore_checkpoint(str(tmp_path), "ckpt", other)
    sup = make_supervised_step(get_loss)
    ss = make_selfsup_step(**SS_KW)
    for s in (state, other):
        gen = torch.Generator().manual_seed(9)
        sup(s, pts, cls, target, 1e-3, 0.1, gen)
        ss(s, pts, cls, pts, 1e-3, 0.1, 1.0, gen)
    _assert_same_state(other, state)


def test_restore_params_only_merges(tmp_path):
    """Fresh heads stand in for what the checkpoint lacks; the optimizer
    stays fresh; zero matches and shape mismatches raise."""
    state, *_ = _trained_state()
    sd = {k: v for k, v in state.model.state_dict().items()
          if not k.startswith(("conv2.", "extra_conv_emb."))}
    torch.save({"model_state_dict": sd, "epoch": 4}, tmp_path / "pre.pth")
    fresh, *_ = _state()
    before = {k: v.clone() for k, v in fresh.model.state_dict().items()}
    logged = []
    restore_params_only(str(tmp_path), "pre.pth", fresh, log=logged.append)
    after = fresh.model.state_dict()
    for k, v in after.items():
        want = before[k] if k.startswith(("conv2.", "extra_conv_emb.")) \
            else state.model.state_dict()[k]
        torch.testing.assert_close(v, want, rtol=0, atol=0, msg=k)
    assert any("conv2.weight" in m for m in logged)
    assert any("epoch" in m for m in logged)
    assert fresh.step == 0 and not fresh.optimizer.state

    # a raw state_dict, and one of this package's checkpoints
    torch.save(sd, tmp_path / "raw.pth")
    raw, *_ = _state()
    restore_params_only(str(tmp_path), "raw.pth", raw, log=lambda *_: None)
    torch.testing.assert_close(raw.model.sa1.conv_blocks[0][0].weight,
                               state.model.sa1.conv_blocks[0][0].weight)
    save_checkpoint(str(tmp_path), "model_001", epoch=0, state=state)
    own, *_ = _state()
    restore_params_only(str(tmp_path), "model_001", own, log=lambda *_: None)
    torch.testing.assert_close(own.model.beta, state.model.beta)

    torch.save({"nothing.weight": torch.zeros(3)}, tmp_path / "bad.pth")
    with pytest.raises(ValueError, match="ZERO"):
        restore_params_only(str(tmp_path), "bad.pth", own)
    wrong = dict(sd, **{"conv1.weight": torch.zeros(3, 3, 1)})
    torch.save(wrong, tmp_path / "wrong.pth")
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_params_only(str(tmp_path), "wrong.pth", own)


def test_latest_checkpoint(tmp_path):
    assert latest_checkpoint(str(tmp_path / "none")) is None
    state, *_ = _state()
    for name in ("model_002", "model_010", "last_model"):
        save_checkpoint(str(tmp_path), name, epoch=0, state=state)
    assert latest_checkpoint(str(tmp_path)) == "model_010"


def test_reference_pth_gives_jax_logits(tmp_path):
    """A reference-format ``.pth`` (``export_msg_state_dict`` of JAX
    variables, in the reference's training wrapper) restored by the port
    and by the JAX package gives the same eval logits within 1e-5."""
    mod = j_get_module("pointnet2_part_seg_msg")
    model = mod.get_model(num_parts=50, compute_dtype="f32")
    zeros = jnp.zeros((2, 64, 3), jnp.float32)
    src = j_create_state(model, (zeros, jnp.zeros((2, 16))),
                         selfsup_init_kwargs(zeros), seed=3)
    rng = np.random.default_rng(4)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.normal(size=a.shape) * 0.1 if str(p[-1].key)
                      .endswith("mean") else rng.uniform(0.5, 1.5, a.shape)
                      ).astype(np.float32), src.batch_stats)
    sd = export_msg_state_dict({"params": src.params, "batch_stats": stats})
    torch.save({"epoch": 7, "model_state_dict": sd}, tmp_path / "ref.pth")

    fresh = j_create_state(model, (zeros, jnp.zeros((2, 16))),
                           selfsup_init_kwargs(zeros), seed=11)
    j_state = j_restore_params_only(str(tmp_path), "ref.pth", fresh)
    x = np.random.default_rng(5).normal(size=(2, 64, 3)).astype(np.float32)
    cls = np.zeros((2, 16), np.float32)
    cls[:, 3] = 1.0
    want = model.apply(j_state.variables(), jnp.asarray(x),
                       jnp.asarray(cls), train=False).seg_logits

    t_model = get_model(num_parts=50, compute_dtype="f32", device="cpu")
    state = create_train_state(t_model)
    restore_params_only(str(tmp_path), "ref.pth", state, log=lambda *_: None)
    with torch.no_grad():
        got = t_model.eval()(torch.from_numpy(x), torch.from_numpy(cls))
    np.testing.assert_allclose(got.seg_logits.numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
