"""The PyTorch/CUDA port stands alone: ``transmogrifai_tpu_torch``,
``chip_smoke.py``, ``gbt_parity_probe.py`` and ``fused_pass_probe.py``
import neither JAX nor
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
           for f in ("chip_smoke.py", "gbt_parity_probe.py",
                     "fused_pass_probe.py")]
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
        "import chip_smoke, gbt_parity_probe, fused_pass_probe\n"
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
    from transmogrifai_tpu_torch import parallel
    for call in (lambda: portable.from_portable(manifest, {}),
                 lambda: ModelRegistry().register("v", path),
                 lambda: ModelRegistry().register_lazy("v", path),
                 lambda: build_registry(path),
                 lambda: ServingEngine(path),
                 lambda: parallel.data_mesh(),
                 lambda: parallel.get_mesh(),
                 lambda: parallel.default_mesh(),
                 lambda: parallel.get_mesh_2d(),
                 lambda: parallel.hybrid_mesh(),
                 lambda: parallel.grid_map(lambda s: s, np.zeros(4)),
                 lambda: parallel.sharded_statistics(
                     np.zeros((4, 2), np.float32), np.zeros(4)),
                 lambda: parallel.sharded_histograms(
                     np.zeros((4, 2), np.int32), np.zeros((1, 4, 3)),
                     np.zeros((1, 4), np.int32), 1, 2)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_training_entry_points_default_to_cuda(monkeypatch):
    """The selector with its default candidate list (trees and linear
    families), each Op* linear stage and the evaluators resolve to CUDA
    with no device argument, so without a card they raise."""
    from transmogrifai_tpu_torch import models as TM
    from transmogrifai_tpu_torch.dataset import Dataset
    from transmogrifai_tpu_torch.evaluators import Evaluators
    from transmogrifai_tpu_torch.features import FeatureBuilder
    from transmogrifai_tpu_torch.features import types as ft
    from transmogrifai_tpu_torch.models.base import prediction_column
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(40, 3)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float64)
    ds = Dataset({"y": y, "x": X}, {"y": ft.RealNN, "x": ft.OPVector})
    lbl = FeatureBuilder.of(ft.RealNN, "y").from_column().as_response()
    vec = FeatureBuilder.OPVector("x").from_column().as_predictor()
    calls = [lambda: TM.BinaryClassificationModelSelector
             .with_cross_validation().set_input(lbl, vec).fit(ds)]
    for stage in ("OpLogisticRegression", "OpLinearSVC", "OpNaiveBayes",
                  "OpLinearRegression", "OpGeneralizedLinearRegression"):
        calls.append(lambda s=stage: getattr(TM, s)().set_input(
            lbl, vec).fit(ds))
    pds = Dataset({"y": y, "p": prediction_column(
        np.full((40, 2), 0.5), "binary")}, {"y": ft.RealNN,
                                            "p": ft.Prediction})
    for make in ("binary_classification", "multi_classification",
                 "regression"):
        calls.append(lambda m=make: getattr(Evaluators, m)().evaluate(
            pds, "y", "p"))
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_linear_modules_are_in_the_import_probe():
    """The linear families, their stages, the sweep and the evaluators
    are among the modules the probe above imports."""
    import pkgutil
    import transmogrifai_tpu_torch as P
    mods = {m.name for m in pkgutil.walk_packages(P.__path__,
                                                  P.__name__ + ".")}
    assert {"transmogrifai_tpu_torch.models.linear",
            "transmogrifai_tpu_torch.models.stages",
            "transmogrifai_tpu_torch.models.tuning",
            "transmogrifai_tpu_torch.models.selector",
            "transmogrifai_tpu_torch.evaluators",
            "transmogrifai_tpu_torch.profiling"} <= mods
    for rel in (("models", "linear.py"), ("models", "stages.py"),
                ("evaluators", "__init__.py")):
        assert os.path.join(_PKG, *rel) in _port_sources()


def test_kernel_wrapper_never_falls_back_off_cpu():
    """Only a CPU tensor takes the plain version; any other device must
    launch the kernel or raise."""
    from transmogrifai_tpu_torch.models import serving_kernels as sk
    X = torch.empty((4, 3), device="meta")
    W = torch.empty((2, 4, 1), device="meta")
    mid = torch.empty((4,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sk.fused_linear_scores(X, W, mid)


def test_parallel_modules_are_in_the_import_probe():
    """The data-parallel layer is among the modules the probe above
    imports (it walks the package), and the ring's sources are found."""
    import pkgutil
    import transmogrifai_tpu_torch as P
    mods = {m.name for m in pkgutil.walk_packages(P.__path__,
                                                  P.__name__ + ".")}
    assert {"transmogrifai_tpu_torch.parallel",
            "transmogrifai_tpu_torch.parallel.mesh",
            "transmogrifai_tpu_torch.parallel.data_parallel"} <= mods
    assert os.path.join(_PKG, "parallel", "data_parallel.py") in (
        _port_sources())


def test_ring_wrapper_takes_no_other_device():
    """A mesh of one kind only: the ring never quietly moves a part to
    the CPU, and TM_MESH_RDMA_RING=0 is the only route to the plain sum
    on a card (a choice resolved on the host)."""
    from transmogrifai_tpu_torch import parallel
    from transmogrifai_tpu_torch.models import kernels as tk
    mesh = parallel.data_mesh(["cpu"] * 2)
    with pytest.raises(ValueError, match="its rank is on"):
        tk.ring_allreduce([torch.zeros(3), torch.zeros(3, device="meta")],
                          mesh)


def test_failed_kernel_build_raises(monkeypatch, tmp_path):
    from transmogrifai_tpu_torch import _cuda_build
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no card here' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setenv("TM_COMPILE_CACHE_DIR", str(tmp_path / "b"))
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
                                          "ring_allreduce",
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


def test_workflow_modules_are_in_the_import_probe():
    """The front door's modules (readers, native, stages, vectorizers,
    transmogrify, checker, lint, resilience, executor, workflow,
    insights, runner, local, export) are among the modules the probe
    above imports, so none of them reaches JAX."""
    import pkgutil
    import transmogrifai_tpu_torch as P
    mods = {m.name for m in pkgutil.walk_packages(P.__path__,
                                                  P.__name__ + ".")}
    want = {"readers", "readers.core", "readers.formats", "native",
            "features.manifest", "features.aggregators",
            "stages.persistence", "ops.hashing", "ops.text",
            "ops.sensitive", "ops.vectorizers", "ops.transmogrifier",
            "ops.sanity_checker", "resilience.policy",
            "resilience.checkpoint", "lint", "lint.analyzer",
            "lint.ast_checks", "lint.diagnostics", "lint.graph",
            "executor", "workflow", "insights", "runner", "local",
            "portable_export"}
    assert {f"transmogrifai_tpu_torch.{m}" for m in want} <= mods


def _tiny_workflow(FB, ft, M, transmogrify, SanityChecker, Workflow):
    y = FB.of(ft.RealNN, "y").from_column().as_response()
    xs = [FB.of(ft.Real, "a").from_column().as_predictor(),
          FB.of(ft.PickList, "c").from_column().as_predictor()]
    checked = SanityChecker().set_input(y, transmogrify(xs)).output
    pred = M.BinaryClassificationModelSelector.with_cross_validation(
        n_folds=2, candidates=[["LogisticRegression", {"regParam": [0.1]}]]
    ).set_input(y, checked).output
    return Workflow([pred])


def _tiny_rows(n=60):
    rng = np.random.default_rng(0)
    return [{"y": float(i % 2), "a": float(rng.normal()) + (i % 2),
             "c": "xy"[int(rng.integers(0, 2))]} for i in range(n)]


def test_loading_a_jax_saved_workflow_imports_no_jax(tmp_path):
    from transmogrifai_tpu import FeatureBuilder, models as M
    from transmogrifai_tpu.features import types as ft
    from transmogrifai_tpu.ops.sanity_checker import SanityChecker
    from transmogrifai_tpu.ops.transmogrifier import transmogrify
    from transmogrifai_tpu.workflow import Workflow
    path = str(tmp_path / "jax_model")
    _tiny_workflow(FeatureBuilder, ft, M, transmogrify, SanityChecker,
                   Workflow).train(_tiny_rows()).save(path)
    code = (
        "import sys\n"
        "from transmogrifai_tpu_torch.workflow import WorkflowModel\n"
        f"m = WorkflowModel.load({path!r}, device='cpu')\n"
        f"rows = {_tiny_rows(5)!r}\n"
        "assert m.score(rows).n_rows == 5\n"
        "assert m.compile_scoring().score_arrays(rows)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'transmogrifai_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_workflow_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """Workflow.train, WorkflowModel.load(...).score, WorkflowRunner.run
    and LocalScorer resolve to CUDA with no device argument, so without
    a card each raises; nothing trains or scores on the CPU unasked."""
    from transmogrifai_tpu_torch import models as M
    from transmogrifai_tpu_torch.features import FeatureBuilder
    from transmogrifai_tpu_torch.features import types as ft
    from transmogrifai_tpu_torch.local import LocalScorer, load_model_local
    from transmogrifai_tpu_torch.ops.sanity_checker import (
        SanityChecker, compute_statistics)
    from transmogrifai_tpu_torch.ops.transmogrifier import transmogrify
    from transmogrifai_tpu_torch.readers import DataReaders
    from transmogrifai_tpu_torch.runner import (OpParams, RunType,
                                                WorkflowRunner)
    from transmogrifai_tpu_torch.workflow import Workflow, WorkflowModel
    wf = _tiny_workflow(FeatureBuilder, ft, M, transmogrify, SanityChecker,
                        Workflow)
    rows = _tiny_rows()
    path = str(tmp_path / "m")
    wf.train(rows, device="cpu").save(path)
    cpu_model = WorkflowModel.load(path, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    reader = DataReaders.simple(rows)
    calls = [
        lambda: wf.train(rows),
        lambda: WorkflowModel.load(path).score(rows),
        lambda: WorkflowRunner(wf, train_reader=reader).run(
            RunType.TRAIN, OpParams()),
        lambda: WorkflowRunner(wf, score_reader=reader).run(
            RunType.SCORE, OpParams(model_location=path)),
        lambda: LocalScorer(cpu_model),
        lambda: load_model_local(path),
        lambda: cpu_model.compile_scoring(device="cuda"),
        lambda: compute_statistics(np.zeros((4, 2)), np.zeros(4)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_serving_tier_modules_are_in_the_import_probe():
    """The serving tier (health, router, fleet, worker, autoscaler,
    shadow, the transports, metrics, continuum) and the CLI are among
    the modules the probe above imports, so none of them reaches JAX;
    importing the package's ``__main__`` runs nothing."""
    import pkgutil
    import transmogrifai_tpu_torch as P
    mods = {m.name for m in pkgutil.walk_packages(P.__path__,
                                                  P.__name__ + ".")}
    want = {"serving.health", "serving.router", "serving.fleet",
            "serving.worker", "serving.autoscaler", "serving.shadow",
            "serving.transport", "serving.transport.base",
            "serving.transport.inproc", "serving.transport.wire",
            "serving.transport.tcp", "serving.transport.netchaos",
            "telemetry.metrics", "continuum", "continuum.monitor",
            "continuum.controller", "cli", "__main__"}
    assert {f"transmogrifai_tpu_torch.{m}" for m in want} <= mods


def test_serving_tier_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """ServingFleet (either transport), build_registry, the CLI's
    serving modes and a worker's main resolve to CUDA with no device,
    so without a card each raises; nothing serves on the CPU unasked."""
    from transmogrifai_tpu_torch import models as M
    from transmogrifai_tpu_torch.cli import main as cli_main
    from transmogrifai_tpu_torch.features import FeatureBuilder
    from transmogrifai_tpu_torch.features import types as ft
    from transmogrifai_tpu_torch.ops.sanity_checker import SanityChecker
    from transmogrifai_tpu_torch.ops.transmogrifier import transmogrify
    from transmogrifai_tpu_torch.serving import ServingFleet, build_registry
    from transmogrifai_tpu_torch.serving.worker import main as worker_main
    from transmogrifai_tpu_torch.workflow import Workflow
    path = str(tmp_path / "m")
    _tiny_workflow(FeatureBuilder, ft, M, transmogrify, SanityChecker,
                   Workflow).train(_tiny_rows(), device="cpu").save(path)
    (tmp_path / "r.jsonl").write_text('{"a": 1.0, "c": "x"}\n')
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: ServingFleet(path, replicas=2),
        lambda: ServingFleet(path, replicas=1, transport="socket"),
        lambda: build_registry(path),
        lambda: cli_main(["serve", "--engine", "--model", path, "--input",
                          str(tmp_path / "r.jsonl"), "--output",
                          str(tmp_path / "o.jsonl")]),
        lambda: worker_main(["--model", path]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
