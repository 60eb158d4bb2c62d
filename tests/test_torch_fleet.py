"""The port's fleet tier against the JAX package: a model the JAX
package trained and saved, served by the port's fleet on the CPU (both
transports) against the JAX fleet serving the same directory; the
registry's saved-workflow layout and its load retries; and the JAX
package's ``tests/test_serving_fleet.py`` case for case on the port."""
import numpy as np
import pytest

from torch_mirror import (load_mirror, mirror_cases, mirror_fixtures,
                          port_on_cpu, run_mirror_case)  # noqa: F401

#: served scores, port against JAX on the same saved model (the
#: tolerance of tests/test_torch_serving_engine.py)
SERVE_ATOL = 1e-5
PKGS = ("transmogrifai_tpu", "transmogrifai_tpu_torch")


@pytest.fixture(scope="module")
def jax_saved(tmp_path_factory):
    """(saved-model dir, prediction name, raw columns) of the serving
    suites' small LR workflow, trained and saved by the JAX package."""
    from serving_util import train_small_serving_model
    model, ds, name = train_small_serving_model(5)
    path = str(tmp_path_factory.mktemp("jax_served") / "model")
    model.save(path)
    cols = {k: np.asarray(ds.column(k)) for k in ds.column_names}
    return path, name, cols


def _requests(cols, n_req=12, seed=0):
    rng = np.random.default_rng(seed)
    n = len(cols["x0"])
    out = []
    for _ in range(n_req):
        lo = int(rng.integers(0, n - 16))
        hi = lo + int(rng.integers(1, 16))
        out.append({k: v[lo:hi] for k, v in cols.items() if k != "label"})
    return out


def _dataset(pkg, cols):
    import importlib
    root = importlib.import_module(pkg)
    ft = root.features.types
    n = len(cols["x0"])
    data = dict(cols, label=np.zeros(n))
    return root.Dataset(data, {k: ft.RealNN if k == "label" else ft.Real
                               for k in data})


def _fleet_scores(pkg, path, reqs, name, **kw):
    import importlib
    serving = importlib.import_module(f"{pkg}.serving")
    cfg = serving.FleetConfig(replicas=2, supervise_s=0.05)
    with serving.ServingFleet(path, replicas=2, buckets=(16, 64),
                              config=cfg, **kw) as fleet:
        return [np.asarray(fleet.score(_dataset(pkg, r), timeout=120)[name])
                for r in reqs]


def _check_against_jax(jax_saved, transport):
    path, name, cols = jax_saved
    reqs = _requests(cols)
    want = _fleet_scores("transmogrifai_tpu", path, reqs, name)
    got = _fleet_scores("transmogrifai_tpu_torch", path, reqs, name,
                        transport=transport, device="cpu")
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=SERVE_ATOL)


def test_jax_saved_model_through_the_port_inproc_fleet(jax_saved):
    _check_against_jax(jax_saved, "inproc")


@pytest.mark.slow
def test_jax_saved_model_through_the_port_socket_fleet(jax_saved):
    _check_against_jax(jax_saved, "socket")


def test_registry_loads_a_saved_workflow_and_retries_a_transient_fault(
        jax_saved):
    from transmogrifai_tpu_torch.resilience import faults
    from transmogrifai_tpu_torch.serving import ModelRegistry
    from transmogrifai_tpu_torch.serving.registry import LOAD_STATS
    from transmogrifai_tpu_torch.workflow import WorkflowModel
    path, name, cols = jax_saved
    before = LOAD_STATS.as_dict()
    reg = ModelRegistry()
    with faults.active("serving.registry.load:raise-transient:1"):
        reg.register("v1", path, buckets=(16,), device="cpu")
    after = LOAD_STATS.as_dict()
    assert after["retries"] - before["retries"] == 1
    assert after["loaded"] - before["loaded"] == 1
    assert reg.get("v1").backend.kind == "workflow"
    assert str(reg.get("v1").backend.scorer.device) == "cpu"
    req = _requests(cols, n_req=1)[0]
    with reg.acquire("v1") as (_v, backend):
        n, vals = backend.prepare(_dataset("transmogrifai_tpu_torch", req))
        got = backend.finalize(backend.launch(n, vals))[name]
    model = WorkflowModel.load(path, device="cpu")
    want = model.compile_scoring().score_arrays(
        _dataset("transmogrifai_tpu_torch", req))[name]
    np.testing.assert_array_equal(got, want)
    # a deterministic failure (no artifact layout) is not retried
    with pytest.raises(ValueError, match="neither a saved WorkflowModel"):
        ModelRegistry().register("bad", str(path) + "_missing_parent/..",
                                 device="cpu")


def test_registry_refuses_a_skewed_portable_manifest(tmp_path, jax_saved):
    """The pre-publish lint gate: a portable export whose manifest
    names another result than its backend produces never serves."""
    import json
    from transmogrifai_tpu_torch.lint import LintError
    from transmogrifai_tpu_torch.serving import ModelRegistry
    from transmogrifai_tpu_torch.workflow import WorkflowModel
    path, _name, _cols = jax_saved
    out = str(tmp_path / "export")
    WorkflowModel.load(path, device="cpu").export_portable(out)
    man = json.load(open(f"{out}/manifest.json"))
    man["resultNames"] = ["not_the_prediction"]
    json.dump(man, open(f"{out}/manifest.json", "w"))
    with pytest.raises(LintError):
        ModelRegistry().register("v1", out, device="cpu")


MIRROR = load_mirror("test_serving_fleet.py")

# the JAX module's own fixtures (its trained models)
globals().update(mirror_fixtures(MIRROR))


@pytest.mark.parametrize("name,kwargs", mirror_cases(MIRROR))
def test_fleet_case_on_the_port(name, kwargs, request, port_on_cpu):
    run_mirror_case(MIRROR, name, kwargs, request)
