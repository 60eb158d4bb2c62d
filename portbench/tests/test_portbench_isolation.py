"""Nothing of the benchmark imports JAX or the JAX package, and the
plain reference imports nothing of the program: each import's top-level
name (before the first dot) compared whole."""
import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "transmogrifai_tpu"}
PROGRAM = "transmogrifai_tpu_torch"


def _modules():
    for root, _, files in os.walk(BENCH):
        if "_cache" in root.split(os.sep):
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def imports(path):
    """(top-level name, relative level) of every import in a file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


def test_top_level_names_are_compared_whole():
    # the port's name begins with the JAX package's and must pass
    assert PROGRAM not in FORBIDDEN
    assert PROGRAM.split(".")[0] != "transmogrifai_tpu"


@pytest.mark.parametrize("path", sorted(_modules()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_module_imports_jax_or_the_jax_package(path):
    bad = {n for n, lvl in imports(path) if lvl == 0 and n in FORBIDDEN}
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted(
    p for p in _modules()
    if os.sep + "reference" + os.sep in p),
    ids=lambda p: os.path.relpath(p, BENCH))
def test_the_reference_imports_nothing_of_the_program(path):
    for name, level in imports(path):
        assert name != PROGRAM, f"{path} imports the program"
        # relative imports stay inside reference/ (level 1)
        assert level <= 1, f"{path} imports outside reference/"
        if level == 0:
            assert name in {"math", "typing", "numpy", "torch",
                            "__future__"}, f"{path} imports {name}"


def test_the_run_refuses_a_process_that_loaded_jax(monkeypatch):
    import sys
    import types
    from portbench import run
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "transmogrifai_tpu.models",
                        types.ModuleType("transmogrifai_tpu.models"))
    assert run.forbidden_modules() == ["transmogrifai_tpu"]
