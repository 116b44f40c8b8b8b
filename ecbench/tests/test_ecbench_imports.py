"""No file of ecbench imports jax or the JAX package (top-level module
names compared whole: the port's name begins with the JAX package's), and
the reference, the generator and the control import nothing of the
program either."""

import ast
import os
import subprocess
import sys

from ecbench import harness

BANNED = {"jax", "jaxlib", "flax", "seaweedfs_tpu"}
PROGRAM = "seaweedfs_tpu_torch"


def _files(*parts):
    top = os.path.join(harness.HERE, *parts)
    if top.endswith(".py"):
        return [top]
    return [os.path.join(d, f) for d, _, fs in os.walk(top) for f in fs
            if f.endswith(".py")]


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_nothing_imports_jax_or_the_jax_package():
    found = {(os.path.relpath(p, harness.ROOT), name)
             for p in _files() for name in _imports(p) if name in BANNED}
    assert not found


def test_the_reference_side_imports_nothing_of_the_program():
    paths = (_files("reference") + _files("control")
             + _files("volume.py") + _files("harness.py")
             + _files("measures.py") + _files("trace.py"))
    found = {(os.path.relpath(p, harness.ROOT), name)
             for p in paths for name in _imports(p) if name == PROGRAM}
    assert not found


def test_a_run_leaves_no_banned_module_loaded():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from ecbench.tests.helpers import run_small\n"
            "from ecbench import harness\n"
            "assert run_small('rs10_4.degraded_read')['correct']\n"
            "print(harness.banned_modules())" % harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_banned_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "seaweedfs_tpu_torch_x", sys)
    assert "seaweedfs_tpu" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "seaweedfs_tpu.ops", sys)
    assert "seaweedfs_tpu" in harness.banned_modules()
