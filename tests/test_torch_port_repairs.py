"""JAX-package cases the port used to fail, run on the port.

Each case is the JAX test's own text through ``tests/torch_mirror.py``
or, where the JAX case leans on a design the port keeps different, its
equivalent with the JAX case's assertions:

* a ``score_columns`` model registers on the host backend of kind
  ``"portable"`` (``tests/test_request_overhead.py``'s ``_AffineModel``
  storms; ``tests/test_serving_engine.py``'s portable cases);
* ``WorkflowModel.compile_scoring(donate=True)`` scores the same bits
  (``tests/test_serving_stream.py``);
* the metrics of ``evaluators.functional`` take numpy arrays
  (``tests/test_models.py``).
"""
import numpy as np
import pytest

from torch_mirror import (cpu_default, load_mirror, mirror_cases,  # noqa
                          mirror_fixtures, port_on_cpu, run_mirror_case)

RO = load_mirror("test_request_overhead.py")
ST = load_mirror("test_serving_stream.py")
MO = load_mirror("test_models.py")
globals().update(mirror_fixtures(ST))       # served


@pytest.fixture(scope="module", autouse=True)
def module_on_cpu():
    """The module's fixtures (``served`` trains) resolve to the CPU."""
    with pytest.MonkeyPatch.context() as mp:
        cpu_default(mp)
        yield


def _port_engine(plane, impl, **cfg_kw):
    """The JAX module's ``_engine`` on the port's one request plane: the
    ``legacy`` plane and the ``dict`` queue are the JAX benches' baseline
    arms, which the port's strict config parse rejects."""
    from transmogrifai_tpu_torch.serving import (EngineConfig, ModelRegistry,
                                                 ServingEngine)
    reg = ModelRegistry()
    reg.register("m", RO._AffineModel(),
                 warm_sample={"x": np.zeros(1, np.float32)})
    cfg = EngineConfig(max_wait_ms=1.0, max_batch_rows=64,
                       tenant_weights=dict(RO._WEIGHTS), **cfg_kw)
    return ServingEngine(registry=reg, config=cfg)


RO._engine = _port_engine
RO._CONFIGS = (("fast", "array"),)

#: the _AffineModel cases that do not compare the two request planes
RO_CASES = ("test_sixteen_thread_storm_bitwise_and_balanced_ledgers",
            "test_overhead_clock_monotone_segments_sum_to_total")


@pytest.mark.parametrize("name,kwargs", [
    p for p in mirror_cases(RO) if p.id.split("[")[0] in RO_CASES])
def test_score_columns_duck_serves_through_the_engine(name, kwargs, request,
                                                      port_on_cpu):
    run_mirror_case(RO, name, kwargs, request)


def test_duck_registers_on_the_portable_backend(port_on_cpu):
    from transmogrifai_tpu_torch.serving import ModelRegistry
    reg = ModelRegistry()
    reg.register("m", RO._AffineModel())
    backend = reg.get().backend
    assert backend.kind == "portable"
    x = np.arange(3, dtype=np.float32)
    n, vals = backend.prepare({"x": x})
    assert np.array_equal(backend.run(n, vals)["score"], x * 2.0 + 1.0)
    with pytest.raises(TypeError, match="cannot register"):
        reg.register("bad", object())


def _numpy_artifact(model, path, buckets):
    """The JAX package's ``portable.load(art)``: the numpy interpreter.
    In the port ``portable.load`` is the device chain, which an artifact
    path serves fused; its ``score_columns`` and the artifact's own
    ``portable_runtime`` are the numpy one."""
    from transmogrifai_tpu_torch import portable, portable_runtime
    model.export_portable(path, buckets=buckets)
    host = portable_runtime.load(path)
    return host, portable.load(path, device="cpu")


def test_portable_backend_through_engine(served, tmp_path, port_on_cpu):
    from transmogrifai_tpu_torch.serving import ModelRegistry, ServingEngine
    model, ds, _ = served
    host, chain = _numpy_artifact(model, str(tmp_path / "artifact"),
                                  (32, 64))
    cols = {f"x{i}": np.asarray(ds.column(f"x{i}")[:15], np.float64)
            for i in range(5)}
    ref = host.score_columns(cols)
    # the device chain's numpy scorer is the artifact's runtime
    for k, v in chain.score_columns(cols).items():
        assert np.array_equal(ref[k], v)
    reg = ModelRegistry()
    reg.register("v", host)
    with ServingEngine(registry=reg) as eng:
        assert eng.registry.get().backend.kind == "portable"
        got = eng.score(dict(cols), timeout=60)
    for k in ref:
        assert np.array_equal(ref[k], got[k])


def test_mixed_dtype_requests_never_promote_each_other(served, tmp_path,
                                                       port_on_cpu):
    from transmogrifai_tpu_torch.serving import (EngineConfig, ModelRegistry,
                                                 ServingEngine)
    model, ds, _ = served
    host, _ = _numpy_artifact(model, str(tmp_path / "artifact"), (32,))
    cols_f = {f"x{i}": np.asarray(ds.column(f"x{i}")[:4], np.float64)
              for i in range(5)}
    cols_i = {f"x{i}": np.arange(1, 5, dtype=np.int64) for i in range(5)}
    ref_f = host.score_columns(cols_f)
    ref_i = host.score_columns(cols_i)
    reg = ModelRegistry()
    reg.register("v", host)
    eng = ServingEngine(registry=reg,
                        config=EngineConfig(max_wait_ms=100.0))
    eng._accepting = True            # queue both before dispatch
    f1 = eng.submit(dict(cols_f))
    f2 = eng.submit(dict(cols_i))
    eng.start()
    got_f, got_i = f1.result(30), f2.result(30)
    for k in ref_f:
        assert np.array_equal(ref_f[k], got_f[k])
        assert np.array_equal(ref_i[k], got_i[k])
    # two groups dispatched, not one promoted batch
    assert eng.stats.as_dict()["batches"] == 2
    eng.stop()


@pytest.mark.parametrize("name,kwargs", [
    p for p in mirror_cases(ST) if p.id == "test_donated_buffers_still_exact"])
def test_donated_compile_scoring_case(name, kwargs, request, port_on_cpu):
    run_mirror_case(ST, name, kwargs, request)


@pytest.mark.parametrize("name,kwargs", [
    p for p in mirror_cases(MO)
    if p.id == "test_multiclass_topk_threshold_metrics"])
def test_topk_metrics_on_numpy_case(name, kwargs, request, port_on_cpu):
    run_mirror_case(MO, name, kwargs, request)


@pytest.mark.parametrize("fn", ["auroc", "aupr", "binary_metrics",
                                "threshold_curves", "multiclass_metrics",
                                "multiclass_topk_threshold_metrics",
                                "regression_metrics"])
def test_functional_metrics_take_numpy_like_jax(fn):
    """Every metric on numpy (weights positional and by keyword) equals
    the JAX package's on the same arrays, within f32 summation order."""
    import jax.numpy as jnp
    import torch
    from transmogrifai_tpu.evaluators import functional as JF
    from transmogrifai_tpu_torch.evaluators import functional as TF
    rng = np.random.default_rng(5)
    n = 64
    w = rng.random(n).astype(np.float32)
    if fn.startswith("multiclass"):
        a = rng.dirichlet(np.ones(3), n).astype(np.float32)
        b = rng.integers(0, 3, n)
    elif fn == "regression_metrics":
        a = rng.normal(size=n).astype(np.float32)
        b = rng.normal(size=n)              # float64: taken as f32
    else:
        a = rng.random(n).astype(np.float32)
        b = (rng.random(n) < 0.5).astype(np.float32)
    def as_dict(out):
        return out if isinstance(out, dict) else {"v": out}
    ref = as_dict(getattr(JF, fn)(jnp.asarray(a), jnp.asarray(b),
                                  jnp.asarray(w)))
    for got in (getattr(TF, fn)(a, b, w), getattr(TF, fn)(a, b, weights=w),
                getattr(TF, fn)(torch.as_tensor(a), b, list(w))):
        got = as_dict(got)
        for k, r in ref.items():
            g = got[k]
            assert isinstance(g, torch.Tensor), k
            np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
