"""Nothing of the benchmark imports JAX or the JAX package, and the
plain reference imports nothing of the program: each import's top-level
name (before the first dot) compared whole."""
import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "transmogrifai_tpu"}
PROGRAM = "transmogrifai_tpu_torch"


def _modules(top=BENCH):
    for root, _, files in os.walk(top):
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


def jax_imports(path):
    """The forbidden top-level names a file imports."""
    return {n for n, lvl in imports(path) if lvl == 0 and n in FORBIDDEN}


def reference_faults(path):
    """What a file of reference/ imports that it may not: the program,
    anything outside reference/ (relative imports stay at level 1), or a
    module beyond the standard few."""
    out = []
    for name, level in imports(path):
        if name == PROGRAM:
            out.append(f"{path} imports the program")
        if level > 1:
            out.append(f"{path} imports outside reference/")
        if level == 0 and name not in {"math", "typing", "numpy", "torch",
                                       "__future__"}:
            out.append(f"{path} imports {name}")
    return out


def _references(top=BENCH):
    return sorted(p for p in _modules(top)
                  if os.sep + "reference" + os.sep in p)


@pytest.mark.parametrize("path", sorted(_modules()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_module_imports_jax_or_the_jax_package(path):
    bad = jax_imports(path)
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", _references(),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_the_reference_imports_nothing_of_the_program(path):
    assert not reference_faults(path)


def test_a_new_entry_or_reference_file_is_checked(tmp_path):
    """The walk takes in every ``.py`` file, so a configuration's new
    ``entry_<name>.py`` and ``reference/<name>.py`` are checked as soon
    as they exist."""
    (tmp_path / "reference").mkdir()
    entry = tmp_path / "entry_planted.py"
    entry.write_text("import jax.numpy as jnp  # noqa: F401\n")
    ref = tmp_path / "reference" / "planted.py"
    ref.write_text("from transmogrifai_tpu_torch.models import ft\n")
    clean = tmp_path / "entry_clean.py"
    clean.write_text("import torch  # noqa: F401\n")
    assert sorted(_modules(str(tmp_path))) == sorted(
        map(str, (entry, ref, clean)))
    assert jax_imports(str(entry)) == {"jax"}
    assert not jax_imports(str(clean))
    assert _references(str(tmp_path)) == [str(ref)]
    assert f"{ref} imports the program" in reference_faults(str(ref))


def test_the_run_refuses_a_process_that_loaded_jax(monkeypatch):
    import sys
    import types
    from portbench import run
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "transmogrifai_tpu.models",
                        types.ModuleType("transmogrifai_tpu.models"))
    assert run.forbidden_modules() == ["transmogrifai_tpu"]
