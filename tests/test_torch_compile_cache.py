"""The port's build-cache policy (``_compile_cache``, ``_cuda_build``),
mirroring the JAX package's ``tests/test_compile_cache.py`` case for
case. The JAX package caches XLA programs; the port caches its CUDA
kernels' shared libraries, under the same precedence: a directory a
caller chose is respected, ``TM_NO_COMPILE_CACHE=1`` builds per process,
``TM_COMPILE_CACHE_DIR`` names the directory, else ``_build/``.
"""
import json
import os
import subprocess
import sys

import jax
import pytest

from transmogrifai_tpu_torch import _compile_cache, _cuda_build

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def no_cache_knobs(monkeypatch):
    for k in ("TM_NO_COMPILE_CACHE", "TM_COMPILE_CACHE_DIR"):
        monkeypatch.delenv(k, raising=False)
    prev = _compile_cache.set_build_dir(None)
    yield monkeypatch
    _compile_cache.set_build_dir(prev)


def test_respects_already_configured_cache(tmp_path, no_cache_knobs):
    """A directory a caller chose stays in effect: the env knobs do not
    redirect it, and repeat calls leave it alone (the JAX side: the
    conftest's cache dir survives the package's import)."""
    assert jax.config.jax_compilation_cache_dir     # the JAX side's own
    chosen = str(tmp_path / "chosen")
    assert _compile_cache.set_build_dir(chosen) is None
    assert _compile_cache.enable_persistent_cache() == chosen
    assert _compile_cache.enable_persistent_cache() == chosen
    no_cache_knobs.setenv("TM_COMPILE_CACHE_DIR", str(tmp_path / "env"))
    no_cache_knobs.setenv("TM_NO_COMPILE_CACHE", "1")
    assert _compile_cache.build_dir() == chosen
    assert os.path.dirname(_cuda_build.library_path("tree_histogram")) == \
        chosen


def test_env_opt_out(no_cache_knobs):
    no_cache_knobs.setenv("TM_NO_COMPILE_CACHE", "1")
    assert _compile_cache.enable_persistent_cache() is None
    d = _compile_cache.build_dir()
    assert d != _compile_cache.DEFAULT_BUILD_DIR
    assert os.path.isdir(d) and not os.listdir(d)
    assert _compile_cache.build_dir() == d          # one per process


def test_env_dir_and_default(tmp_path, no_cache_knobs):
    assert _compile_cache.build_dir() == _compile_cache.DEFAULT_BUILD_DIR
    assert _compile_cache.enable_persistent_cache() == \
        _compile_cache.DEFAULT_BUILD_DIR
    no_cache_knobs.setenv("TM_COMPILE_CACHE_DIR", str(tmp_path / "kernels"))
    assert _compile_cache.enable_persistent_cache() == str(
        tmp_path / "kernels")
    path = _cuda_build.library_path("ring_allreduce")
    assert os.path.dirname(path) == str(tmp_path / "kernels")
    # the cache key: the source and the flags, not the directory
    assert os.path.basename(path) == os.path.basename(
        _cuda_build.library_path("ring_allreduce"))


def test_cache_key_moves_with_the_flags(monkeypatch):
    a = _cuda_build.library_path("fused_linear_scores")
    monkeypatch.setattr(_cuda_build, "NVCC_FLAGS",
                        _cuda_build.NVCC_FLAGS + ("-lineinfo",))
    b = _cuda_build.library_path("fused_linear_scores")
    assert a != b and os.path.dirname(a) == os.path.dirname(b)


def test_loaded_libraries_stay_loaded(monkeypatch, tmp_path):
    """A library a process already loaded is not looked for again when
    the build directory changes."""
    marker = object()
    monkeypatch.setitem(_cuda_build._LIBS, "tree_histogram", marker)
    _compile_cache.set_build_dir(str(tmp_path / "elsewhere"))
    assert _cuda_build.load_library("tree_histogram") is marker
    assert not os.path.exists(tmp_path / "elsewhere")


def test_fresh_import_defaults_cache(tmp_path):
    """Fresh interpreter, no caller's choice: import alone resolves the
    TM_COMPILE_CACHE_DIR directory, and the libraries are named there."""
    code = (
        "import json\n"
        "from transmogrifai_tpu_torch import _compile_cache, _cuda_build\n"
        "print(json.dumps({'dir': _compile_cache.enable_persistent_cache(),"
        " 'lib': _cuda_build.library_path('tree_histogram')}))\n")
    env = dict(os.environ, TM_COMPILE_CACHE_DIR=str(tmp_path / "k"),
               PYTHONPATH=_REPO)
    env.pop("TM_NO_COMPILE_CACHE", None)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=180, cwd=_REPO, env=env)
    assert r.returncode == 0, r.stderr[-800:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["dir"] == str(tmp_path / "k")
    assert os.path.dirname(out["lib"]) == str(tmp_path / "k")


def test_runner_restores_cache_config_when_distributed_init_fails(
        tmp_path, monkeypatch):
    """An exception in initialize_distributed (which runs between the
    build-directory choice and the handler) must not leak the run's
    directory into later runs."""
    from transmogrifai_tpu_torch import parallel
    from transmogrifai_tpu_torch.runner import (OpParams, RunType,
                                                WorkflowRunner)

    def boom(*a, **k):
        raise RuntimeError("coordinator unreachable")

    monkeypatch.setattr(parallel.multihost, "initialize_distributed", boom)
    before = (_compile_cache.chosen_build_dir(), _compile_cache.build_dir())
    runner = WorkflowRunner(workflow=None)
    params = OpParams(
        compilation_cache_location=str(tmp_path / "run_cache"),
        distributed={"coordinatorAddress": "127.0.0.1:1",
                     "numProcesses": 2, "processId": 0})
    with pytest.raises(RuntimeError, match="coordinator unreachable"):
        runner.run(RunType.TRAIN, params)
    after = (_compile_cache.chosen_build_dir(), _compile_cache.build_dir())
    assert after == before
