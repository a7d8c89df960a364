"""The port's ball-query A/B and bf16 bisection
(``prifit_torch/tools/ab_ball_query.py``, ``run_bf16_bisect.py``)
against the JAX repository's ``tools/`` scripts of the same names, on
the CPU.  The scripts are loaded by path, under names of their own; the
environment is restored after the A/B script's import, which sets
``JAX_COMPILATION_CACHE_DIR``.

- ``octant_labels`` equals the JAX script's, and the clouds and labels
  ``run`` trains on are the ones JAX's ``run`` hands its step, bit for
  bit;
- ``run`` at B=1, N=512, 2 steps from JAX's initial weights against
  JAX's ``run`` with f32 encoders, dropout 0 and FPS starting at index 0
  on both sides (JAX's ``PRIFIT_DET_FPS=1``, the port's ``fps_start``
  patched), the fused (nearest-k) ball query: the first loss within
  1e-5 relative, the second (after Adam's first update, which moves
  every weight by +-lr whatever its gradient's size) within 5e-4, the
  train accuracy within 4 and the held-out one within 8 of the 512
  points; the models are patched inside the test only (JAX's held-out
  forward also jitted, which op by op takes 18 s);
- ``main`` prints the JAX script's lines from the same runs (its first
  line names the device where JAX's names the backend);
- the bisection's plan for the coarse phase, ``--full_encoders mxsr
  --modes bf16,fq``, and a fine phase with ``sa1+sa2`` and a ``--tag``:
  both ``main``s run with the trainer replaced by a fake that records
  each command and writes a ``metrics.jsonl`` with a ``final_eval``.
  Variant names, stage specs, every trainer flag and the records are
  the JAX script's, with the stated differences only: the encoder
  ``auto`` -> ``f32`` (the port's repair) and the trainer's module;
  a second ``main`` skips every finished key, and ``summarize_bisect``
  prints the same table from either side's records.
"""

import contextlib
import importlib.util
import io
import json
import os
import os.path as osp
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import prifit_torch.nn.pointnet2 as tpn2
import prifit_tpu.models as jmodels
import prifit_tpu.train.state as jstate
from prifit_torch.convert import state_dict_from_jax
from prifit_torch.models import get_module
from prifit_torch.tools import ab_ball_query as A
from prifit_torch.tools import run_bf16_bisect as R
from prifit_torch.tools import summarize_lift as S

torch.set_num_threads(1)

TOOLS = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "tools")


def _load_tool(name):
    env = dict(os.environ)
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", osp.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(env)
    return mod


ENV = dict(os.environ)
JA = _load_tool("ab_ball_query")
JB = _load_tool("run_bf16_bisect")
JS = _load_tool("summarize_lift")

B, N, STEPS = 1, 512, 2
# the first loss is of the same weights on the same cloud; the ones after
# Adam's first update, which moves each weight by the learning rate times
# the sign of its gradient, so that entries whose f32 gradients are near
# 0 on both sides may move apart by 2 x 0.01
FIRST_LOSS_RTOL, LOSS_RTOL = 1e-5, 5e-4
# the train accuracy is the last step's forward (after one update), the
# held-out one after two: points whose two largest logits are that close
# flip
TRAIN_ACC_ATOL, EVAL_ACC_ATOL = 4.0 / (B * N), 8.0 / (B * N)


def test_loading_the_jax_script_leaves_the_environment(monkeypatch):
    """The A/B script sets ``JAX_COMPILATION_CACHE_DIR`` when imported;
    ``_load_tool`` takes it back out."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    seen = {}
    real = os.environ.setdefault

    def setdefault(key, value):
        seen[key] = value
        return real(key, value)

    monkeypatch.setattr(os.environ, "setdefault", setdefault)
    _load_tool("ab_ball_query")
    assert "JAX_COMPILATION_CACHE_DIR" in seen
    assert "JAX_COMPILATION_CACHE_DIR" not in os.environ
    assert os.environ.get("JAX_COMPILATION_CACHE_DIR") == \
        ENV.get("JAX_COMPILATION_CACHE_DIR")


def test_octant_labels_match_jax():
    pts = np.random.default_rng(3).normal(size=(4, 100, 3))
    pts[0, :8] = 0.0      # on the planes: not > 0
    for p in (pts, pts.astype(np.float32)):
        got, want = A.octant_labels(p), JA.octant_labels(p)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert set(np.unique(A.octant_labels(pts))) == set(range(8))


def _f32_no_dropout(mod):
    """The model module ``mod`` with ``get_model`` building the f32
    encoder without dropout."""
    return SimpleNamespace(
        get_model=lambda **kw: mod.get_model(
            **kw, compute_dtype="f32", dropout_rate=0.0),
        get_loss=mod.get_loss)


class _JitEval:
    """A JAX model whose eval-mode ``apply`` (the script's held-out
    forward, op by op otherwise: 18 s on the CPU) runs jitted; ``init``
    and the step's ``apply`` pass through."""

    def __init__(self, model):
        self.model = model
        self.eval = jax.jit(lambda v, *a: model.apply(v, *a, train=False))

    def init(self, *a, **kw):
        return self.model.init(*a, **kw)

    def apply(self, variables, *a, **kw):
        if kw == {"train": False}:
            return self.eval(variables, *a)
        return self.model.apply(variables, *a, **kw)


def _jax_model(mod):
    f32 = _f32_no_dropout(mod)
    return SimpleNamespace(get_model=lambda **kw: _JitEval(
        f32.get_model(**kw)), get_loss=mod.get_loss)


@pytest.fixture(scope="module")
def jax_run():
    """JAX's ``run(False, 4)`` at ``B``, ``N``, ``STEPS``: its result, its
    initial variables, and the clouds and labels its step was given."""
    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PRIFIT_DET_FPS", "1")
        for name, v in (("B", B), ("N", N), ("STEPS", STEPS)):
            mp.setattr(JA, name, v)
        jget = jmodels.get_module
        mp.setattr(jmodels, "get_module",
                   lambda name: _jax_model(jget(name)))
        create = jstate.create_train_state

        def recorded_create(*a, **kw):
            seen["state"] = create(*a, **kw)
            return seen["state"]

        mp.setattr(jstate, "create_train_state", recorded_create)
        import prifit_tpu.train.steps as jsteps
        make = jsteps.make_supervised_step

        def recorded_make(*a, **kw):
            step = make(*a, **kw)

            def run(state, pts, cls, target, *rest):
                seen.setdefault("pts", np.asarray(pts))
                seen.setdefault("target", np.asarray(target))
                return step(state, pts, cls, target, *rest)
            return run

        mp.setattr(jsteps, "make_supervised_step", recorded_make)
        out = JA.run(True, 4)
    s = seen["state"]
    seen["variables"] = jax.tree_util.tree_map(
        np.asarray, {"params": s.params, "batch_stats": s.batch_stats})
    return out, seen


def test_clouds_are_the_jax_scripts(jax_run):
    _, seen = jax_run
    pts, eval_pts = A.clouds(4, B, N)
    np.testing.assert_array_equal(pts, seen["pts"])
    np.testing.assert_array_equal(A.octant_labels(pts), seen["target"])
    rng = np.random.default_rng(4)
    rng.normal(size=(B, N, 3))
    np.testing.assert_array_equal(
        eval_pts, np.asarray(jax.numpy.asarray(rng.normal(size=(B, N, 3)),
                                               jax.numpy.float32)))


def test_run_matches_jax_from_its_weights(jax_run, monkeypatch):
    (j_losses, j_tr, j_ev), seen = jax_run
    monkeypatch.setattr(tpn2, "fps_start", lambda xyz, train, gen: None)
    tget = get_module
    monkeypatch.setattr(A, "get_module",
                        lambda name: _f32_no_dropout(tget(name)))
    # JAX's supervised init makes no self-sup head; the port's model has
    # one, which the supervised path never reads
    sd = dict(get_module("pointnet2_part_seg_msg").get_model(
        num_parts=A.PARTS, device="cpu").state_dict())
    sd.update(state_dict_from_jax(seen["variables"]))
    assert {k for k in sd if k not in state_dict_from_jax(
        seen["variables"])} == {"beta", "extra_conv_emb.weight",
                                "extra_conv_emb.bias"}
    losses, tr, ev = A.run(True, 4, device="cpu", b=B, n=N, steps=STEPS,
                           state_dict=sd)
    assert len(losses) == len(j_losses) == STEPS
    np.testing.assert_allclose(losses[0], j_losses[0], rtol=FIRST_LOSS_RTOL)
    np.testing.assert_allclose(losses[1:], j_losses[1:], rtol=LOSS_RTOL)
    assert abs(tr - j_tr) <= TRAIN_ACC_ATOL
    assert abs(ev - j_ev) <= EVAL_ACC_ATOL
    assert losses[-1] < losses[0]


def test_main_prints_the_jax_scripts_lines(monkeypatch):
    """Both ``main``s from the same canned runs: the same lines after the
    first (the port names the device, JAX the backend)."""
    def fake_run(fused, seed, **kw):
        r = np.random.default_rng(int(fused) * 10 + seed)
        return (list(r.random(60) * 2), float(r.random()),
                float(r.random()))

    monkeypatch.setattr(JA, "run", fake_run)
    monkeypatch.setattr(A, "run", fake_run)
    outs = []
    for main in (JA.main, lambda: A.main(["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main()
        outs.append(buf.getvalue().splitlines())
    assert outs[1][0] == "device: cpu" and outs[0][0].startswith("backend:")
    assert outs[1][1:] == outs[0][1:]
    assert len(outs[0]) == 1 + 4 + 1 + 2 + 2


# ------------------------------------------------------------ bisection

PLANS = {
    "coarse": ["--seeds", "786,787"],
    "coarse_full_mxsr": ["--seeds", "786", "--full_encoders", "mxsr",
                         "--modes", "bf16,fq", "--epochs", "1",
                         "--epoch_iters", "3"],
    "fine_tag": ["--seeds", "786", "--phase", "fine", "--stages",
                 "sa1+sa2,fp1", "--modes", "q", "--tag", "_t2"],
}


class _FakeTrainer:
    """Records each trainer command and writes its run's
    ``metrics.jsonl``, whose ``final_eval`` numbers the call."""

    def __init__(self):
        self.cmds = []

    def write(self, cmd):
        self.cmds.append(list(cmd))
        root = cmd[cmd.index("--experiment_root") + 1]
        exp = osp.join(root, "exp")
        os.makedirs(exp, exist_ok=True)
        n = len(self.cmds)
        with open(osp.join(exp, "metrics.jsonl"), "w") as f:
            f.write(json.dumps({"epoch": 1, "class_avg_iou": 0.1}) + "\n")
            f.write(json.dumps({"final_eval": {
                "class_avg_iou": 0.5 + n / 64, "inctance_avg_iou": 0.6,
                "accuracy": 0.9}}) + "\n")

    def subprocess_run(self, cmd, **kw):
        self.write(cmd)
        return SimpleNamespace(returncode=0, stderr="", stdout="")

    def run_cli(self, cmd, device, **hooks):
        assert device == torch.device("cpu")
        assert set(hooks) == {"on_iteration"}
        self.write(cmd)


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _port_view(cmd):
    """A JAX command as the port's: its module and ``--encoder_dtype
    auto`` replaced (the stated differences)."""
    cmd = list(cmd)
    assert cmd[1:3] == ["-m", "prifit_tpu.cli.train_partseg"]
    cmd[2] = "prifit_torch.cli.train_partseg"
    i = cmd.index("--encoder_dtype") + 1
    if cmd[i] == "auto":
        cmd[i] = "f32"
    return cmd


@pytest.mark.parametrize("plan", list(PLANS))
def test_bisect_plan_matches_jax(plan, tmp_path, monkeypatch):
    flags = PLANS[plan]
    jdata, tdata = tmp_path / "jax", tmp_path / "port"
    jfake, tfake = _FakeTrainer(), _FakeTrainer()
    monkeypatch.setattr(JB.subprocess, "run", jfake.subprocess_run)
    monkeypatch.setattr(sys, "argv",
                        ["run_bf16_bisect.py", "--data", str(jdata)] + flags)
    with contextlib.redirect_stdout(io.StringIO()):
        JB.main()
    monkeypatch.setattr(R, "run_cli", tfake.run_cli)
    with contextlib.redirect_stdout(io.StringIO()):
        R.main(["--data", str(tdata), "--device", "cpu"] + flags)

    assert len(tfake.cmds) == len(jfake.cmds) > 0
    for t, j in zip(tfake.cmds, jfake.cmds):
        assert t == [a.replace(str(jdata), str(tdata))
                     for a in _port_view(j)]
    jrec, trec = (_records(d / "bisect.jsonl") for d in (jdata, tdata))
    assert len(jrec) == len(trec) == len(jfake.cmds)
    for t, j in zip(trec, jrec):
        assert set(t) == set(j) == {"config", "metrics", "wall_s"}
        want = dict(j["config"])
        if want["encoder_dtype"] == "auto":
            want["encoder_dtype"] = "f32"
        assert t["config"] == want and t["metrics"] == j["metrics"]
        assert t["wall_s"] >= 0
    names = [r["config"]["variant"] for r in trec]
    specs = [r["config"]["stage_dtypes"] for r in trec]
    assert names == [r["config"]["variant"] for r in jrec]
    assert specs == [r["config"]["stage_dtypes"] for r in jrec]
    if plan == "coarse":
        assert names[::2] == ["f32", "full_bf16", "sa_all_bf16", "sa_all_q",
                              "fp_all_bf16", "fp_all_q"]
        assert specs[4] == "sa1:bf16,sa2:bf16,sa3:bf16"
    if plan == "fine_tag":
        assert names == ["f32", "full_bf16", "sa1_sa2_q_t2", "fp1_q_t2"]
        assert specs[2] == "sa1:q,sa2:q"
    encs = {r["config"]["variant"]: r["config"]["encoder_dtype"]
            for r in trec}
    assert all(e == ("bf16" if v == "full_bf16" else "mxsr"
                     if v == "full_mxsr" else "f32") for v, e in encs.items())

    # resume by key: nothing runs again, nothing is appended
    before = (tdata / "bisect.jsonl").read_text()
    with contextlib.redirect_stdout(io.StringIO()):
        R.main(["--data", str(tdata), "--device", "cpu"] + flags)
    assert len(tfake.cmds) == len(trec)
    assert (tdata / "bisect.jsonl").read_text() == before

    tables = []
    for mod, recs in ((S, trec), (JS, jrec)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.summarize_bisect(recs)
        tables.append(buf.getvalue())
    assert tables[0] == tables[1] and "f32" in tables[0]


def test_bisect_reports_a_failed_run_and_goes_on(tmp_path, monkeypatch):
    """A run that raises leaves no record, as a JAX run that fails does;
    the plan goes on."""
    fake = _FakeTrainer()

    def run_cli(cmd, device, **hooks):
        if "full_bf16" in cmd[cmd.index("--experiment_root") + 1]:
            raise RuntimeError("boom")
        fake.run_cli(cmd, device, **hooks)

    monkeypatch.setattr(R, "run_cli", run_cli)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        R.main(["--data", str(tmp_path), "--device", "cpu", "--seeds", "1",
                "--modes", ""])
    assert "FAILED" in buf.getvalue() and "boom" in buf.getvalue()
    assert [r["config"]["variant"] for r in
            _records(tmp_path / "bisect.jsonl")] == ["f32"]
