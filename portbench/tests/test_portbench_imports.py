"""What the benchmark may load: no JAX, no JAX package, compared by whole
top-level names (the program's name begins with the JAX package's); the
reference nothing of the program."""
import ast
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
BLOCKED = {"jax", "jaxlib", "flax", "rustpotter_tpu"}
PROGRAM = "rustpotter_tpu_torch"


def sources():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_blocked_import(path):
    assert not set(top_names(path)) & BLOCKED


@pytest.mark.parametrize("path", sorted(p for p in sources() if os.sep + "reference" + os.sep in p),
                         ids=os.path.basename)
def test_the_reference_imports_nothing_of_the_program(path):
    assert set(top_names(path)) <= {"__future__", "contextlib", "dataclasses", "math",
                                    "typing", "numpy", "torch"}


def test_a_run_loads_no_blocked_module():
    """Importing the harness (and with it the program) loads no blocked
    top-level name."""
    code = ("import sys; sys.path.insert(0, %r); from portbench import harness, control; "
            "import rustpotter_tpu_torch; sys.path.insert(0, %r); import run; "
            "print(run.blocked_modules())" % (ROOT, BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_blocked_names_compare_whole(monkeypatch):
    sys.path.insert(0, BENCH)
    try:
        import run
    finally:
        sys.path.remove(BENCH)
    monkeypatch.setitem(sys.modules, "rustpotter_tpu_torch_probe", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert "rustpotter_tpu" not in run.blocked_modules()
    assert "jax" not in run.blocked_modules()
    monkeypatch.setitem(sys.modules, "rustpotter_tpu.ops", object())
    assert "rustpotter_tpu" in run.blocked_modules()
