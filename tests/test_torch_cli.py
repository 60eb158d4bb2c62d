"""The port's CLI: ``gen`` writes a project of the port, ``--device``
reaches the generated app and the serving modes, the module entry point
runs without JAX; then the JAX package's ``tests/test_cli.py`` case for
case on the port."""
import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from torch_mirror import (load_mirror, mirror_cases, mirror_fixtures,
                          port_on_cpu, run_mirror_case)  # noqa: F401

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TITANIC = os.path.join(_REPO, "examples", "data", "titanic.csv")


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            roots |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module)
    return roots


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_gen_writes_a_project_of_the_port(tmp_path, sparse):
    from transmogrifai_tpu_torch.cli import main
    out = str(tmp_path / "proj")
    args = ["gen", "--input", TITANIC, "--response", "survived",
            "--id", "id", "--output-dir", out]
    assert main(args + (["--sparse"] if sparse else [])) == 0
    for f in ("features.py", "app.py"):
        mods = _imported_roots(os.path.join(out, f))
        ours = {m for m in mods if m.startswith("transmogrifai_tpu")}
        assert ours and all(m.split(".")[0] == "transmogrifai_tpu_torch"
                            for m in ours), (f, sorted(ours))
        assert "jax" not in {m.split(".")[0] for m in mods}
    params = open(os.path.join(out, "params.yaml")).read()
    # the kernels' build cache, a directory of the project
    assert f"compilationCacheLocation: {out}/kernel_cache" in params


def test_run_hands_device_to_the_generated_app(tmp_path, monkeypatch):
    """``run --device cpu`` trains on the host with no other help: the
    CLI hands the device to the app, the app to its runner."""
    from transmogrifai_tpu_torch.cli import main
    out = str(tmp_path / "proj")
    assert main(["gen", "--input", TITANIC, "--response", "survived",
                 "--id", "id", "--output-dir", out]) == 0
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["run", "--params", os.path.join(out, "params.yaml"),
                 "--run-type", "train", "--device", "cpu"]) == 0
    assert os.path.exists(os.path.join(out, "model", "workflow.json"))
    # the run made the build cache gen named, and handed it back after
    assert os.path.isdir(os.path.join(out, "kernel_cache"))
    from transmogrifai_tpu_torch import _compile_cache
    assert _compile_cache.chosen_build_dir() != os.path.join(
        out, "kernel_cache")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["run", "--params", os.path.join(out, "params.yaml"),
              "--run-type", "train"])


def test_serve_engine_on_the_cpu_matches_bulk_scoring(tmp_path, monkeypatch):
    """``serve --engine --replicas 2 --device cpu`` on a saved model:
    every response row equals the model's own scores."""
    from transmogrifai_tpu_torch.cli import main
    from transmogrifai_tpu_torch.workflow import WorkflowModel
    from torch_mirror import cpu_default
    util = load_mirror("serving_util.py")
    with pytest.MonkeyPatch.context() as mp:     # train on the host
        cpu_default(mp)
        model, ds, name = util.train_small_serving_model(7)
    path = str(tmp_path / "model")
    model.save(path)
    rng = np.random.default_rng(0)
    reqs, cols = [], {k: np.asarray(ds.column(k)) for k in ds.column_names}
    with open(tmp_path / "r.jsonl", "w") as f:
        for _ in range(10):
            lo = int(rng.integers(0, 280))
            req = {k: [None if np.isnan(x) else float(x)
                       for x in v[lo:lo + 5]]
                   for k, v in cols.items() if k != "label"}
            reqs.append((lo, lo + 5))
            f.write(json.dumps({"columns": req}) + "\n")
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["serve", "--engine", "--model", path,
                 "--input", str(tmp_path / "r.jsonl"),
                 "--output", str(tmp_path / "o.jsonl"), "--clients", "4",
                 "--replicas", "2", "--device", "cpu"]) == 0
    out = [json.loads(x) for x in open(tmp_path / "o.jsonl")]
    assert [o["id"] for o in out] == list(range(10))
    want = WorkflowModel.load(path, device="cpu").compile_scoring(
        buckets=True).score_arrays(ds)[name]
    for o, (lo, hi) in zip(out, reqs):
        np.testing.assert_allclose(np.asarray(o["results"][name]),
                                   want[lo:hi], rtol=0, atol=1e-6)


def test_module_entry_point_imports_no_jax():
    code = ("import runpy, sys\n"
            "sys.argv = ['transmogrifai_tpu_torch', '--help']\n"
            "try:\n"
            "    runpy.run_module('transmogrifai_tpu_torch',"
            " run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'transmogrifai_tpu')]\n"
            "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "serve" in res.stdout and "--device" not in res.stdout


MIRROR = load_mirror("test_cli.py")

# the JAX module's own fixtures
globals().update(mirror_fixtures(MIRROR))


@pytest.mark.parametrize("name,kwargs", mirror_cases(MIRROR))
def test_cli_case_on_the_port(name, kwargs, request, port_on_cpu):
    run_mirror_case(MIRROR, name, kwargs, request)
