"""The check's control and faults come out not correct: the reference
computed one precision below the configuration's, and whole runs with
the timed path broken underneath (a step that leaves the state
unchanged, half of the batch left out, an answer altered where it is
produced, and the convex branch's faults of :mod:`benchmark.faults`).
The readings at the cells' own size, from which the limits were set,
are in PERF.md; here the sizes are tiny, on the CPU."""

import os.path as osp
import sys

import pytest
import torch

sys.path.insert(0, osp.dirname(osp.dirname(osp.dirname(
    osp.abspath(__file__)))))

from benchmark import faults, harness  # noqa: E402
from benchmark.reference import evaluate, train  # noqa: E402
from benchmark.reference.compare import eval_gaps, \
    training_gaps  # noqa: E402
from benchmark.tests.tiny import dry_run, tiny_params, tiny_tree  # noqa


def _fails(gaps, limits):
    return any(not gaps.get(k, float("nan")) <= v for k, v in limits.items())


@pytest.mark.parametrize("workload", ["msg.semisup_convex",
                                      "dgcnn.semisup_convex",
                                      "msg.semisup_contrastive"])
@pytest.mark.parametrize("mode", ["lower", "half_batch"])
def test_training_control_and_half_batch_fail(workload, mode):
    cell = harness.Cell(workload)
    p, tree, cfg = tiny_params(cell), tiny_tree(cell), cell.config
    got = train.readings(p, 7, tree, "cpu", mode,
                         encoder_modules=cfg["encoder_modules"],
                         control_precision=cfg["control_precision"])
    sound = train.readings(p, 7, tree, "cpu", judge=got["ss"])
    assert _fails(training_gaps(got, sound), cell.limits)


def test_eval_control_fails():
    cell = harness.Cell("msg.eval_fit")
    p, tree, cfg = tiny_params(cell), tiny_tree(cell), cell.config
    got = evaluate.outputs(p, 7, tree, "cpu", [0], "lower",
                           encoder_modules=cfg["encoder_modules"],
                           control_precision=cfg["control_precision"])
    kept = [(0, *got[0])]
    sound = evaluate.judged(p, 7, tree, "cpu", kept)
    assert _fails(eval_gaps(kept, sound), cell.limits)


@pytest.mark.parametrize("workload, fault", [
    ("msg.semisup_convex", "fit_one_shape"),
    ("msg.semisup_convex", "chamfer_one_shape_out"),
    ("msg.semisup_convex", "chamfer_grad_halved"),
    ("msg.semisup_convex", "bandwidth_scaled"),
    ("msg.semisup_convex", "mean_shift_short"),
    ("msg.semisup_convex", "membership_sharp"),
    ("dgcnn.semisup_convex", "fit_one_shape"),
    ("dgcnn.semisup_convex", "chamfer_one_shape_out"),
    ("msg.eval_fit", "fit_one_shape"),
    ("msg.eval_fit", "chamfer_one_shape_out"),
    ("msg.eval_fit", "mean_shift_short"),
    ("msg.eval_fit", "membership_sharp")])
def test_a_fault_in_the_convex_branch_is_caught(workload, fault):
    # at the tiny size the recipe's quantile leaves the training shapes
    # one cluster each, whose memberships and gradient are exact; a
    # smaller one gives them four
    params = {"quantile": 0.01} if "semisup" in workload else None
    with faults.FAULTS[fault]():
        result, _ = dry_run(workload, params=params)
    assert result["correct"] is False


def test_a_step_that_leaves_the_state_unchanged_is_caught(monkeypatch):
    from prifit_torch.train import steps

    def unchanged(state, lr, group=None):
        state.step += 1

    monkeypatch.setattr(steps, "_apply_gradients", unchanged)
    result, checks = dry_run("msg.semisup_convex")
    assert result["correct"] is False
    assert checks["change_norm_gap"] > 0.5


def test_half_of_the_batch_left_out_is_caught(monkeypatch):
    from prifit_torch.train import steps
    real = steps.make_supervised_step

    def halved(model_loss, **kw):
        def loss(pred, target, trans_feat=None):
            h = pred.shape[0] // 2
            return model_loss(pred[:h], target[:h], trans_feat)
        return real(loss, **kw)

    monkeypatch.setattr(steps, "make_supervised_step", halved)
    from prifit_torch.cli import train_partseg
    monkeypatch.setattr(train_partseg, "make_supervised_step", halved)
    result, _ = dry_run("dgcnn.semisup_convex")
    assert result["correct"] is False


def test_an_altered_answer_is_caught(monkeypatch):
    import prifit_torch.entry as entry
    real = entry.eval_forward

    def altered(*a, **kw):
        out = real(*a, **kw)
        logits = out.seg_logits.clone()
        logits[0, 0, 0] += 0.5
        return out._replace(seg_logits=logits)

    monkeypatch.setattr(entry, "eval_forward", altered)
    result, _ = dry_run("msg.eval_fit")
    assert result["correct"] is False


def test_sound_runs_are_correct():
    for workload in ("msg.eval_fit",):
        result, checks = dry_run(workload)
        assert result["correct"] is True, checks
        assert all(v == 0.0 for v in checks.values()), checks
    assert torch.get_num_threads() > 0
