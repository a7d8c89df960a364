"""The reference imports neither JAX, the JAX package nor the program."""

import ast
import os
import os.path as osp
import subprocess
import sys

ROOT = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
REFERENCE = osp.join(ROOT, "benchmark", "reference")
BANNED = {"jax", "jaxlib", "flax", "prifit_tpu", "prifit_torch"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_reference_source_imports_a_banned_module():
    found = []
    for d, _, files in os.walk(REFERENCE):
        for f in files:
            if f.endswith(".py"):
                p = osp.join(d, f)
                found += [(p, m) for m in _imports(p)
                          if m.split(".")[0] in BANNED]
    assert found == []


LOAD = """
import importlib, os, sys
sys.path[0] = {root!r}
for d, _, files in os.walk({ref!r}):
    for f in files:
        if f.endswith(".py"):
            rel = os.path.relpath(os.path.join(d, f), {root!r})[:-3]
            importlib.import_module(rel.replace(os.sep, ".")
                                    .replace(".__init__", ""))
print(sorted({{k.split(".")[0] for k in sys.modules}}))
"""


def test_loading_the_reference_loads_no_banned_module():
    p = subprocess.run([sys.executable, "-c",
                        LOAD.format(root=ROOT, ref=REFERENCE)],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    loaded = set(eval(p.stdout.strip().splitlines()[-1]))
    assert not loaded & BANNED
