"""The port's lift tools (``prifit_torch/tools/``) against the JAX
repository's ``tools/`` scripts of the same names, on the CPU.

- every generator writes byte-identical files (both lift families);
- the matrix tool's commands, plan and run keys are the JAX tool's with
  the port's modules;
- ``summarize_lift`` prints the same tables;
- ``normalized_mutual_info`` equals scikit-learn's;
- ``check_shapenet`` / ``check_acd`` find the same problems;
- one matrix run end to end on the CPU, resumed by key, and the parity
  harness's ``dryrun`` through the port.

The ``tools/`` scripts are loaded by path, under names of their own.
"""

import contextlib
import importlib.util
import io
import json
import os
import os.path as osp
import runpy
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from sklearn.metrics import normalized_mutual_info_score

from prifit_torch.eval.nmi import normalized_mutual_info
from prifit_torch.models.pointnet2_part_seg_msg import get_model
from prifit_torch.tools import run_fewshot_matrix as M
from prifit_torch.tools import run_real_parity as P
from prifit_torch.tools import summarize_lift as S
from prifit_torch.tools import synthetic_primitive_dataset as G
from tests.fixtures import make_acd_fixture, make_shapenet_fixture

torch.set_num_threads(1)

TOOLS = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "tools")


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", osp.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JG = _load_tool("synthetic_primitive_dataset")
JM = _load_tool("run_fewshot_matrix")
JS = _load_tool("summarize_lift")
JP = _load_tool("run_real_parity")


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = osp.join(d, f)
            with open(p, "rb") as fh:
                out[osp.relpath(p, root)] = fh.read()
    return out


GENERATORS = {
    "shapenet": lambda g, r: g.make_primitive_shapenet(
        r, n_per_cat=4, n_points=256, seed=3),
    "shapenet_hard": lambda g, r: g.make_primitive_shapenet(
        r, n_per_cat=4, n_points=256, seed=3, hard=True),
    "acd": lambda g, r: g.make_primitive_acd(r, n_shapes=6, n_points=256),
    "lift_ellipsoid": lambda g, r: g.make_lift_benchmark(
        r, n_cats=2, n_per_cat=4, n_acd=6, n_points=256, seed=5),
    "lift_superquadric": lambda g, r: g.make_lift_benchmark(
        r, n_cats=2, n_per_cat=4, n_acd=6, n_points=256, seed=5,
        family="superquadric"),
    "modelnet_ellipsoid": lambda g, r: g.make_modelnet_benchmark(
        r, n_cats=2, n_train=2, n_test=1, n_points=256),
    "modelnet_superquadric": lambda g, r: g.make_modelnet_benchmark(
        r, n_cats=2, n_train=2, n_test=1, n_points=256,
        family="superquadric"),
    "s3dis": lambda g, r: g.make_s3dis_rooms(r, n_rooms=2, n_points=2000),
}


@pytest.mark.parametrize("name", GENERATORS)
def test_generator_files_byte_identical(tmp_path, name):
    GENERATORS[name](JG, str(tmp_path / "jax"))
    GENERATORS[name](G, str(tmp_path / "port"))
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert want and sorted(got) == sorted(want)
    for rel in want:
        assert got[rel] == want[rel], rel


def test_generator_main_lift_byte_identical(tmp_path, monkeypatch):
    """``--lift`` through each script's ``__main__``."""
    flags = ["--lift", "--n_cats", "2", "--n_per_cat", "4", "--n_acd", "4",
             "--n_points", "128", "--seed", "2", "--family", "superquadric"]
    for side, run in (("jax", lambda: runpy.run_path(
            osp.join(TOOLS, "synthetic_primitive_dataset.py"),
            run_name="__main__")), ("port", lambda: runpy.run_path(
                G.__file__, run_name="__main__"))):
        monkeypatch.setattr(sys, "argv",
                            ["gen", str(tmp_path / side)] + flags)
        with contextlib.redirect_stdout(io.StringIO()):
            run()
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert len(want) == 2 * 4 + 3 + 1 + 4 and got == want


# ------------------------------------------------------------ the matrix

def _swap_modules(cmd):
    return [c.replace("prifit_tpu.cli.", "prifit_torch.cli.") for c in cmd]


ARMS = ("sup", "joint", "con", "pre", "pre_joint", "pre_con")


@pytest.mark.parametrize("ft_lr", [0.0, 0.003])
def test_build_cmd_is_the_jax_tools(ft_lr):
    args = SimpleNamespace(epochs=20, npoint=2048, data_root="/d/shapenet",
                           ss_path="/d/acd", ft_lr=ft_lr)
    for arm in ARMS:
        cfg = dict(k_shot=2, seed=787, arm=arm, batch_size=16,
                   epoch_iters=125, lmbda=1.0, quantile=0.05, alpha=0.01,
                   epochs=20, encoder_dtype="auto", step_size=2,
                   ckpt="/d/pretrain/best_model")
        want = JM.build_cmd(dict(cfg), args, "/d/runs/x")
        got = M.build_cmd(dict(cfg), args, "/d/runs/x")
        assert got[2].startswith("prifit_torch.cli."), got[2]
        assert got == _swap_modules(want), arm


PLANS = [
    ["--k_shots", "1,2,5", "--seeds", "786,787", "--arms",
     ",".join(ARMS), "--epochs", "3"],
    ["--k_shots", "5", "--seeds", "786", "--arms", "sup,joint",
     "--sweep", "step_size=1,3", "n_per_prim=16"],
    ["--k_shots", "1,10", "--seeds", "1", "--arms", "sup,pre_con",
     "--sweep", "step_size=1,2", "--batch_size", "16", "--epoch_iters",
     "7", "--ft_lr", "0.005", "--encoder_dtype", "f32", "--pre_epochs",
     "3"],
]


@pytest.mark.parametrize("flags", PLANS, ids=["arms", "sweep", "ft_lr"])
def test_plan_and_keys_are_the_jax_tools(tmp_path, monkeypatch, flags):
    """JAX's ``main`` with its subprocesses failing prints every run's key
    in order and hands each non-pre run's command to ``subprocess``; the
    port's plan must give the same keys and, per run, the same command
    with the port's modules."""
    data = str(tmp_path / "lift")
    cmds = []

    def fake_run(cmd, **kw):
        cmds.append(cmd)
        return SimpleNamespace(returncode=1, stderr="", stdout="")

    monkeypatch.setattr(JM.subprocess, "run", fake_run)
    monkeypatch.setattr(sys, "argv", ["m", "--data", data] + flags)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        JM.main()
    want_keys = [line.split("] ", 1)[1] for line in out.getvalue()
                 .splitlines() if line.startswith("[")]

    args = M.parse_args(["--data", data] + flags)
    runs = M.plan(args)
    assert [M.run_key(c) for c in runs] == want_keys
    assert len(set(want_keys)) == len(want_keys)
    sup_cmds = [c for c in cmds if "prifit_tpu.cli.train_partseg" in c]
    pre_cmds = [c for c in cmds if "prifit_tpu.cli.pretrain_partseg" in c]
    got = [M.build_cmd(dict(cfg), args, osp.join(data, "runs",
                                                 M.run_tag(cfg)))
           for cfg in runs if cfg["arm"] not in M.PRE_ARMS]
    assert got == [_swap_modules(c) for c in sup_cmds]
    assert len(pre_cmds) == sum(c["arm"] in M.PRE_ARMS for c in runs)


def test_sweep_of_a_planned_knob(tmp_path, monkeypatch):
    """Sweeping ``lmbda`` or ``quantile`` raises in the JAX tool (the knob
    reaches ``dict`` twice); the port's plan takes the swept values and
    leaves ``sup`` out, which changes under no such knob."""
    flags = ["--data", str(tmp_path), "--k_shots", "5", "--seeds", "786",
             "--sweep", "lmbda=0.5,1,2", "quantile=0.02,0.05"]
    monkeypatch.setattr(sys, "argv", ["m"] + flags)
    with pytest.raises(TypeError, match="multiple values"), \
            contextlib.redirect_stdout(io.StringIO()):
        JM.main()
    runs = M.plan(M.parse_args(flags))
    assert [(c["arm"], c["lmbda"], c["quantile"]) for c in runs] == [
        ("joint", lm, q) for lm in (0.5, 1, 2) for q in (0.02, 0.05)]
    assert all(c["batch_size"] == 24 and c["epoch_iters"] == 83
               for c in runs)


def _rows():
    rows = []
    for k in (1, 2):
        for seed in (786, 787, 788):
            for arm, val in (("sup", 0.33), ("con", 0.39), ("joint", 0.35),
                             ("pre_con", 0.41)):
                cfg = dict(k_shot=k, seed=seed, arm=arm, batch_size=8 * k,
                           epoch_iters=2000 // (8 * k), lmbda=1.0,
                           quantile=0.05, alpha=0.01, epochs=20,
                           encoder_dtype="auto")
                if arm == "pre_con":
                    cfg["pre_epochs"] = 15
                if arm == "joint" and seed == 788:
                    continue                        # a missing run
                miou = val + 0.01 * k + 0.003 * (seed - 786) * (-1) ** k
                rows.append({"config": cfg, "metrics": {
                    "class_avg_iou": miou, "accuracy": 0.5},
                    "wall_s": 1.0, "exp_dir": "x"})
    rows.append({"config": dict(rows[0]["config"], seed=9), "metrics": None,
                 "wall_s": 1.0, "exp_dir": "x"})      # a failed run
    return rows


def _bisect_rows():
    rows = []
    for v, base in (("f32", 0.40), ("bf16", 0.31), ("mxsr", 0.405)):
        for seed in (786, 787):
            rows.append({"config": {"variant": v, "seed": seed},
                         "metrics": {"class_avg_iou": base + 0.01 * seed
                                     - 7.86}})
    return rows


@pytest.mark.parametrize("kind", ["matrix", "bisect"])
def test_summarize_prints_the_jax_tables(tmp_path, kind):
    path = tmp_path / "results.jsonl"
    rows = _rows() if kind == "matrix" else _bisect_rows()
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    outs = []
    for mod in (JS, S):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main(str(path))
        outs.append(buf.getvalue())
    assert outs[0].count("\n") >= 3 and outs[1] == outs[0]


def test_nmi_equals_sklearn():
    rng = np.random.default_rng(0)
    cases = [([0, 0, 0], [1, 1, 1]), ([], []), ([0, 0, 1, 1], [1, 1, 0, 0]),
             ([0, 0, 0, 0], [0, 1, 2, 3]), ([5, 5, 5, 5], [0, 1, 2, 3]),
             ([0, 1, 0, 1], [0, 0, 1, 1]), ([3], [7])]
    for _ in range(200):
        n = int(rng.integers(2, 600))
        a = rng.integers(0, int(rng.integers(1, 8)), n)
        b = rng.integers(0, int(rng.integers(1, 30)), n)
        if rng.random() < 0.4:          # correlated, as clusters and parts
            b = (a * 7 + rng.integers(0, 2, n)) % 5
        cases.append((a, b))
    for a, b in cases:
        want = normalized_mutual_info_score(a, b)
        assert abs(normalized_mutual_info(a, b) - want) <= 1e-12, (a, b)


# ------------------------------------------------ the parity harness

def _valid(tmp_path):
    return (make_shapenet_fixture(str(tmp_path / "shapenet")),
            make_acd_fixture(str(tmp_path / "acd")))


def _no_catfile(tmp_path):
    return str(tmp_path), make_acd_fixture(str(tmp_path / "acd"))


def _no_val_json(tmp_path):
    sn, acd = _valid(tmp_path)
    os.remove(osp.join(sn, "train_test_split",
                       "shuffled_val_file_list.json"))
    return sn, acd


def _no_normals(tmp_path):
    return (make_shapenet_fixture(str(tmp_path / "shapenet"),
                                  normals=False),
            make_acd_fixture(str(tmp_path / "acd")))


def _bad_labels(tmp_path):
    sn, acd = _valid(tmp_path)
    d = osp.join(sn, "02691156")
    fn = osp.join(d, sorted(os.listdir(d))[0])
    data = np.loadtxt(fn).astype(np.float32)
    data[:, -1] = 13.0
    np.savetxt(fn, data, fmt="%.6f")
    return sn, acd


def _flat_acd(tmp_path):
    root = str(tmp_path / "acd")
    os.makedirs(root)
    np.save(osp.join(root, "x.npy"), np.zeros((10, 4), np.float32))
    return make_shapenet_fixture(str(tmp_path / "shapenet")), root


def _narrow_acd(tmp_path):
    root = str(tmp_path / "acd" / "shapes")
    os.makedirs(root)
    np.save(osp.join(root, "x.npy"), np.zeros((10, 3), np.float32))
    return (make_shapenet_fixture(str(tmp_path / "shapenet")),
            str(tmp_path / "acd"))


@pytest.mark.parametrize("fixture", [
    _valid, _no_catfile, _no_val_json, _no_normals, _bad_labels, _flat_acd,
    _narrow_acd], ids=lambda f: f.__name__.strip("_"))
def test_check_finds_the_jax_problems(tmp_path, fixture):
    sn, acd = fixture(tmp_path)
    outs = []
    for mod in (JP, P):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            problems = (mod.check_shapenet(sn), mod.check_acd(acd))
            rc = mod.main(["check", "--data_root", sn, "--ss_path", acd])
        outs.append((problems, rc, buf.getvalue()))
    assert outs[1] == outs[0]
    assert (outs[0][1] == 0) == (fixture is _valid)


# ------------------------------------------------- end to end on the CPU

@pytest.fixture(scope="module")
def tiny_lift(tmp_path_factory):
    """Two categories of 4 shapes (2 train, 1 val, 1 test) and 4 ACD
    shapes of 128 points."""
    root = str(tmp_path_factory.mktemp("lift"))
    G.make_lift_benchmark(root, n_cats=2, n_per_cat=4, n_acd=4,
                          n_points=128, seed=0)
    return root


def test_matrix_end_to_end_and_resume(tiny_lift, capsys):
    """k=1, arms sup and con, one epoch of one iteration at batch 1 and
    N=128 on the CPU: two well-formed records; a second call skips both
    by key."""
    out = osp.join(tiny_lift, "results.jsonl")
    argv = ["--data", tiny_lift, "--k_shots", "1", "--seeds", "786",
            "--arms", "sup,con", "--epochs", "1", "--epoch_iters", "1",
            "--npoint", "128", "--batch_size", "1", "--device", "cpu"]
    M.main(argv)
    recs = [json.loads(line) for line in open(out)]
    assert [r["config"]["arm"] for r in recs] == ["sup", "con"]
    for r in recs:
        assert set(r) == {"config", "metrics", "wall_s", "exp_dir"}
        assert r["config"]["batch_size"] == 1
        assert r["config"]["epoch_iters"] == 1
        assert np.isfinite(r["metrics"]["class_avg_iou"])
        assert 0.0 <= r["metrics"]["class_avg_iou"] <= 1.0
        assert r["exp_dir"].startswith(osp.join(tiny_lift, "runs"))
        assert r["metrics"] == M.final_metrics(r["exp_dir"])
    capsys.readouterr()
    M.main(argv)
    lines = capsys.readouterr().out.splitlines()
    assert sum("skip (done)" in line for line in lines) == 2
    assert len(open(out).readlines()) == 2


def test_matrix_needs_a_device_without_cuda(tiny_lift, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        M.main(["--data", tiny_lift])


def test_real_parity_dryrun_on_the_port(tmp_path, capsys):
    """check -> micro train -> standalone eval -> reference-format export,
    on the CPU."""
    rc = P.main(["dryrun", "--out", str(tmp_path / "d"), "--keep",
                 "--device", "cpu"])
    assert rc == 0
    sd = torch.load(str(tmp_path / "d" / "export.pth"),
                    weights_only=False)["model_state_dict"]
    names = set(get_model(num_parts=50, device="cpu").state_dict())
    assert set(sd) == names - {"beta"}
    out = capsys.readouterr().out
    assert "parity run complete" in out and "class_avg_iou" in out
