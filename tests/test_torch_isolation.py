"""The PyTorch/CUDA port stands alone: ``transmogrifai_tpu_torch``,
``chip_smoke.py`` and ``gbt_parity_probe.py`` import neither JAX nor
the JAX package, every entry point resolves its device to CUDA unless
the caller asks for the CPU, and a missing card or a failed kernel
build raises instead of falling back."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.join(_REPO, "transmogrifai_tpu_torch")
_FORBIDDEN = ("jax", "jaxlib", "transmogrifai_tpu")


def _port_sources():
    out = [os.path.join(_REPO, f)
           for f in ("chip_smoke.py", "gbt_parity_probe.py")]
    for root, _dirs, files in os.walk(_PKG):
        out += [os.path.join(root, f) for f in sorted(files)
                if f.endswith(".py")]
    return sorted(out)


def _forbidden_imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [n for n in names if n.split(".")[0] in _FORBIDDEN]
    return bad


@pytest.mark.parametrize(
    "path", _port_sources(), ids=lambda p: os.path.relpath(p, _REPO))
def test_port_source_imports_no_jax(path):
    assert _forbidden_imports(path) == []


def test_ast_scan_catches_a_jax_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import numpy\nfrom jax import numpy as jnp\n"
                     "def f():\n    import transmogrifai_tpu.portable\n")
    assert _forbidden_imports(str(probe)) == ["jax",
                                              "transmogrifai_tpu.portable"]


def test_importing_every_submodule_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import transmogrifai_tpu_torch as P\n"
        "import chip_smoke, gbt_parity_probe\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "P.__path__, P.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'transmogrifai_tpu'))\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad or len(mods) < 20 else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_resolve_device_raises_without_cuda(monkeypatch):
    from transmogrifai_tpu_torch import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """No device argument means CUDA: without a card every entry point
    raises — nothing quietly scores on the CPU."""
    from transmogrifai_tpu_torch import portable
    from transmogrifai_tpu_torch.serving import (ModelRegistry,
                                                 ServingEngine,
                                                 build_registry)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "_SUCCESS").write_text("")
    (tmp_path / "manifest.json").write_text("{}")
    np.savez(tmp_path / "params.npz")
    path = str(tmp_path)
    manifest = {"format": 1, "boundary": [], "responseBoundary": [],
                "resultNames": [], "hostPrefix": [], "stages": []}
    for call in (lambda: portable.from_portable(manifest, {}),
                 lambda: ModelRegistry().register("v", path),
                 lambda: ModelRegistry().register_lazy("v", path),
                 lambda: build_registry(path),
                 lambda: ServingEngine(path)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_kernel_wrapper_never_falls_back_off_cpu():
    """Only a CPU tensor takes the plain version; any other device must
    launch the kernel or raise."""
    from transmogrifai_tpu_torch.models import serving_kernels as sk
    X = torch.empty((4, 3), device="meta")
    W = torch.empty((2, 4, 1), device="meta")
    mid = torch.empty((4,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sk.fused_linear_scores(X, W, mid)


def test_failed_kernel_build_raises(monkeypatch, tmp_path):
    from transmogrifai_tpu_torch import _cuda_build
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no card here' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_cuda_build, "BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(_cuda_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_cuda_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc failed .*exit 3"):
        _cuda_build.load_library("fused_linear_scores")
    with pytest.raises(RuntimeError, match="no card here"):
        _cuda_build.build_all()
    assert not os.listdir(tmp_path / "b")      # no torn library left


def test_kernel_sources_are_found():
    from transmogrifai_tpu_torch import _cuda_build
    assert _cuda_build.kernel_names() == ["fused_linear_scores",
                                          "tree_histogram"]
    assert "sm_90a" in " ".join(_cuda_build.NVCC_FLAGS)
    with pytest.raises(FileNotFoundError):
        _cuda_build.library_path("no_such_kernel")


def test_chip_smoke_refuses_to_run_without_cuda(tmp_path):
    """No card: non-zero exit and no result line. Alone in a directory
    (no package beside it): non-zero exit too."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=_REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(_REPO, "chip_smoke.py")).read())
    res = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
