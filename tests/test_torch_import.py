"""The port stands alone: it imports without JAX, names nothing of JAX or
of the JAX package, and its entry points refuse to run on the CPU unless
asked.  Its sub-packages export the JAX package's public names."""

import ast
import importlib
import inspect
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import prifit_torch.entry
from prifit_torch.kernels.bandwidth import kth_nn_distance
from prifit_torch.kernels.fps import farthest_point_sample
from prifit_torch.kernels.gather import gather_rows
from prifit_torch.kernels.max_bwd import cnt_gsm, dz
from prifit_torch.kernels.mean_shift import mean_shift_step
from prifit_torch.kernels.nms import nms_passes
from prifit_torch.kernels.stochastic_round import sr_bf16
from prifit_torch.models.pointnet2_part_seg_msg import get_model

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "prifit_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def test_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['prifit_tpu'] = None\n"
        "import prifit_torch\n"
        "for m in pkgutil.walk_packages(prifit_torch.__path__, "
        "'prifit_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import prifit_torch.entry, prifit_torch.convert\n"
        "assert not [k for k in sys.modules if k.startswith('jax')"
        " and sys.modules[k] is not None]\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "prifit_tpu"), (
                f"{path.name} imports {name}")


# the lift experiment's tools and their NMI: none may reach the JAX side's
# ``tools/`` scripts, scikit-learn or matplotlib (the card's machine has
# neither), or hard-code an absolute path
TOOL_FILES = sorted((ROOT / "prifit_torch" / "tools").glob("*.py")) + [
    ROOT / "prifit_torch" / "eval" / "nmi.py"]
TOOL_FORBIDDEN = ("jax", "jaxlib", "flax", "prifit_tpu", "tools", "sklearn",
                  "matplotlib")


@pytest.mark.parametrize("path", TOOL_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_tools_stand_alone(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert not re.match(r"/\w", node.value), (
                f"{path.name} hard-codes the path {node.value!r}")
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in TOOL_FORBIDDEN, (
                f"{path.name} imports {name}")


def test_tools_import_without_sklearn_or_matplotlib():
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'prifit_tpu', 'tools', 'sklearn', "
        "'matplotlib'):\n"
        "    sys.modules[name] = None\n"
        "import prifit_torch.tools as t, prifit_torch.eval.nmi\n"
        "for m in pkgutil.walk_packages(t.__path__, 'prifit_torch.tools.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert all(callable(getattr(t, n)) or isinstance(getattr(t, n), "
        "str) for n in t.__all__)\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


# the names of a JAX sub-package's ``__all__`` that the port does not
# export, each with where its work is or the slice that brings it
NOT_EXPORTED = {
    ("nn", "PointMLP"): "folded into the function nn/pointnet2.py::point_mlp "
                        "over its layer's convs and bns",
}
SUBPACKAGES = ("geometry", "clustering", "ops", "utils", "nn", "models",
               "train", "data", "parallel")


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_the_jax_names(sub):
    """Every name of the JAX sub-package's ``__all__`` is in the port's
    ``__all__`` and bound to an object of the port (a function, class or
    module of ``prifit_torch``, or a constant), but for
    ``NOT_EXPORTED``, which stays out."""
    jax_sub = importlib.import_module(f"prifit_tpu.{sub}")
    port = importlib.import_module(f"prifit_torch.{sub}")
    for name in jax_sub.__all__:
        if (sub, name) in NOT_EXPORTED:
            assert name not in port.__all__, name
            continue
        assert name in port.__all__, f"prifit_torch.{sub} lacks {name}"
        obj = getattr(port, name)
        if inspect.ismodule(obj):
            assert obj.__name__.startswith("prifit_torch."), name
        elif callable(obj):
            assert obj.__module__.startswith("prifit_torch."), name
    assert all(hasattr(port, n) for n in port.__all__)


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        prifit_torch.entry.flagship(2, 64)
    with pytest.raises(RuntimeError, match="CUDA"):
        prifit_torch.entry.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        get_model(num_parts=50)
    get_model(num_parts=50, device="cpu")


def test_kernel_wrappers_never_fall_back():
    """A tensor that is neither on the CPU nor on a CUDA device is
    refused before any launch: only CPU tensors take the plain version."""
    meta = dict(device="meta")
    x = torch.empty(2, 256, 3, **meta)
    X = torch.empty(2, 256, 128, **meta)
    bw = torch.empty(2, **meta)
    z = torch.empty(64, 32, dtype=torch.bfloat16, **meta)
    rows = torch.empty(8, 32, dtype=torch.bfloat16, **meta)
    vec = torch.empty(32, **meta)
    key = (1, 2)
    calls = [
        lambda: farthest_point_sample(x, 16, torch.zeros(2, **meta)),
        lambda: gather_rows(x, torch.zeros(2, 5, dtype=torch.long, **meta)),
        lambda: kth_nn_distance(X, [3]),
        lambda: mean_shift_step(X, X, bw),
        lambda: nms_passes(X, bw),
        lambda: cnt_gsm(z, rows, rows, rows, key),
        lambda: dz(z, rows, rows, vec, vec, vec, vec, key),
        lambda: sr_bf16(key, X),
        # f32 storage (the f32-storage K-max region) takes the kernels too
        lambda: cnt_gsm(z.float(), rows.float(), rows, rows.float(), None),
        lambda: dz(z.float(), rows.float(), vec[None].expand(8, 32),
                   vec, vec, vec, vec, None),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
    # any other storage dtype, and rounding at f32 storage, are refused
    with pytest.raises(ValueError, match="bf16 or f32"):
        cnt_gsm(z.half(), rows.half(), rows, rows.half(), None)
    with pytest.raises(ValueError, match="bf16 storage"):
        dz(z.float(), rows.float(), rows, vec, vec, vec, vec, key)


def test_small_entry_runs_on_cpu_when_asked():
    fn, args = prifit_torch.entry.entry(device="cpu")
    logits, loss = fn(*args)
    assert logits.shape == (4, 512, 50)
    assert torch.isfinite(logits).all() and torch.isfinite(loss)
