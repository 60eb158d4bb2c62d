"""The fused serving plane over fitted workflows, against the JAX package.

Five workflows are trained in both packages on the same rows: Boston
LinearRegression, Titanic LogisticRegression (four one-hot pivots on
the host, so vector boundary columns), Iris softmax LogisticRegression,
Titanic with a user stage (defined once on each package's
``UnaryTransformer``, with its own ``make_device_fn``) between the
SanityChecker and the head, and Titanic with a GBT head. The port's
``stack_spec_of`` must accept exactly the backends the JAX package's
accepts: the first three on the table form (the prefix tables in the
kernel), the user stage on the generic form (each member's own prefix,
then the kernel's identity table), the GBT head on neither.

Scores: two JAX-saved models of each fusable workflow (two regParams,
the same rows, so one pivot vocabulary) loaded in the port, the port's
``FusedGroupScorer`` against the JAX package's on the same boundary
values, 1e-5 (f32 arithmetic in another order, as the engine parity
test states); under ``TM_KERNEL_EXACT=1`` bitwise each member's own
tail. Engine: members whose pivot vocabularies differ never share a
launch, and no request fails; the JAX package pools them and fails the
launch (a reference-side fault, ROADMAP §3).
"""
import importlib
import os

import numpy as np
import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DATA = os.path.join(_REPO, "examples", "data")
JAX, PORT = "transmogrifai_tpu", "transmogrifai_tpu_torch"
BUCKETS = (16, 64)
REG_PARAMS = (0.01, 0.1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _user_stage(pkg):
    """A user's own device stage, the same class on either package's
    base: its class key (module and qualified name) is the same in
    both, so a model the JAX package saves with it loads in the port."""
    ft = _m(pkg, "features.types")
    base = _m(pkg, "stages.base")
    xp = torch if pkg == PORT else importlib.import_module("jax.numpy")

    class HalfShift(base.UnaryTransformer):
        """x -> 0.5 x + 0.25 over a feature vector."""
        in_type = ft.OPVector
        out_type = ft.OPVector
        operation_name = "halfShift"

        def _transform_columns(self, ds):
            arr = np.asarray(ds.column(self.input_names[0]), np.float32)
            return (arr * np.float32(0.5) + np.float32(0.25), ft.OPVector,
                    ds.manifest(self.input_names[0]))

        def make_device_fn(self):
            def fn(v):
                v = v.to(torch.float32) if pkg == PORT \
                    else v.astype(xp.float32)
                return v * 0.5 + 0.25
            return fn

    return HalfShift


USER_STAGE = {JAX: _user_stage(JAX), PORT: _user_stage(PORT)}

TITANIC = {"id": "ID", "pclass": "PickList", "sex": "PickList",
           "age": "Real", "sibSp": "Integral", "parCh": "Integral",
           "fare": "Real", "cabin": "PickList", "embarked": "PickList",
           "survived": "RealNN"}
BOSTON = {"crim": "Real", "zn": "Real", "indus": "Real", "chas": "Binary",
          "nox": "Real", "rm": "Real", "age": "Real", "dis": "Real",
          "rad": "Integral", "tax": "Real", "ptratio": "Real",
          "lstat": "Real", "medv": "RealNN"}
IRIS = {"sepalLength": "Real", "sepalWidth": "Real", "petalLength": "Real",
        "petalWidth": "Real", "irisClass": "RealNN"}

#: case -> (form the port serves it on, or None for no spec)
CASES = {"boston": "table", "titanic": "table", "iris": "table",
         "user_stage": "generic", "gbt": None}


def _records(pkg, case):
    """The case's rows as records (the same rows in both packages)."""
    ft = _m(pkg, "features.types")
    readers = _m(pkg, "readers")
    if case == "boston":
        schema, path, key = BOSTON, "boston.csv", None
    elif case == "iris":
        schema, path, key = dict(IRIS, irisClass="PickList"), "iris.csv", None
    else:
        schema, path, key = TITANIC, "titanic.csv", "id"
    types = {k: getattr(ft, v) for k, v in schema.items()}
    recs = readers.DataReaders.csv(os.path.join(_DATA, path), types,
                                   key=key).read()
    if case == "iris":
        labels = sorted({r["irisClass"] for r in recs})
        for r in recs:
            r["irisClass"] = float(labels.index(r["irisClass"]))
    return recs


def _workflow(pkg, case, reg_param):
    """The case's workflow from ``pkg``'s classes."""
    ft = _m(pkg, "features.types")
    feat = _m(pkg, "features.feature")
    M = _m(pkg, "models")
    transmogrify = _m(pkg, "ops.transmogrifier").transmogrify
    SanityChecker = _m(pkg, "ops.sanity_checker").SanityChecker
    FB = feat.FeatureBuilder
    feat.reset_uids()
    schema = {"boston": BOSTON, "iris": IRIS}.get(case, TITANIC)
    label = {"boston": "medv", "iris": "irisClass"}.get(case, "survived")
    resp = FB.of(getattr(ft, schema[label]), label).from_column() \
        .as_response()
    preds = [FB.of(getattr(ft, t), n).from_column().as_predictor()
             for n, t in schema.items() if n not in ("id", label)]
    vec = transmogrify(preds)
    lr = [["LinearRegression" if case == "boston" else "LogisticRegression",
           {"regParam": [reg_param]}]]
    if case == "boston":
        sel = M.RegressionModelSelector.with_train_validation_split(
            candidates=lr)
    elif case == "iris":
        sel = M.MultiClassificationModelSelector.with_cross_validation(
            n_folds=3, candidates=lr)
    else:
        vec = SanityChecker().set_input(resp, vec).output
        if case == "user_stage":
            vec = USER_STAGE[pkg]().set_input(vec).output
        cands = ([["GBTClassifier", {"maxIter": [3], "maxDepth": [2]}]]
                 if case == "gbt" else lr)
        sel = M.BinaryClassificationModelSelector.with_cross_validation(
            n_folds=3, candidates=cands)
    pred = sel.set_input(resp, vec).output
    return _m(pkg, "workflow").Workflow([pred])


def _train(pkg, case, reg_param):
    kw = {"device": "cpu"} if pkg == PORT else {}
    return _workflow(pkg, case, reg_param).train(_records(pkg, case), **kw)


def _backend(pkg, model):
    """A registry's serving backend over ``model``'s own scorer."""
    kw = {"device": "cpu"} if pkg == PORT else {}
    return _m(pkg, "serving.registry")._FusedBackend(
        model.compile_scoring(buckets=BUCKETS, **kw))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """case -> {"jax": [model per REG_PARAMS], "port": the port's model
    trained at REG_PARAMS[0], "loaded": the JAX models saved and loaded
    in the port}; the GBT case trains one model in each package."""
    out = {}
    for case in CASES:
        params = REG_PARAMS[:1] if case == "gbt" else REG_PARAMS
        jax_models = [_train(JAX, case, r) for r in params]
        loaded = []
        for k, jm in enumerate(jax_models):
            path = str(tmp_path_factory.mktemp(f"{case}{k}") / "model")
            jm.save(path)
            loaded.append(_m(PORT, "workflow").WorkflowModel.load(
                path, device="cpu"))
        out[case] = {"jax": jax_models, "loaded": loaded,
                     "port": _train(PORT, case, REG_PARAMS[0])}
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_stack_spec_parity_with_jax(case, trained):
    """The port's stack_spec_of is non-None exactly where the JAX
    package's is, on models trained in each package on the same rows;
    the spec names the form that serves it, and both packages read the
    same head."""
    from transmogrifai_tpu.serving.fusion import stack_spec_of as jax_spec_of
    from transmogrifai_tpu_torch.serving.fusion import stack_spec_of
    jspec = jax_spec_of(_backend(JAX, trained[case]["jax"][0]))
    for model in (trained[case]["port"], trained[case]["loaded"][0]):
        spec = stack_spec_of(_backend(PORT, model))
        assert (spec is None) == (jspec is None)
        if spec is None:
            continue
        assert spec.form == CASES[case]
        assert (spec.act, spec.p, spec.L, spec.n_out) == (
            jspec.act, jspec.p, jspec.L, jspec.n_out)
        assert spec.boundary == jspec.boundary
    if jspec is not None:
        loaded = stack_spec_of(_backend(PORT, trained[case]["loaded"][0]))
        np.testing.assert_array_equal(loaded.W.numpy(), jspec.W)
    assert (jspec is None) == (CASES[case] is None)


def _members(pkg, models):
    spec_of = _m(pkg, "serving.fusion").stack_spec_of
    return [(b, spec_of(b)) for b in (_backend(pkg, m) for m in models)]


def _slice_inputs(case, members, n=150, seed=0):
    """Boundary values of ``n`` of the case's rows (three bucket
    slices) through the port's host prefix, and random model ids."""
    recs = _records(PORT, case)
    rng = np.random.default_rng(seed)
    rows = [recs[i] for i in rng.integers(0, len(recs), n)]
    _n, vals = members[0][0].prepare(rows)
    mid = rng.integers(0, len(members), n).astype(np.int32)
    return vals, mid


@pytest.mark.parametrize("case", ["boston", "iris", "titanic", "user_stage"])
def test_fused_group_scorer_matches_jax_on_both_forms(case, trained,
                                                      monkeypatch):
    """The port's stacked pass (the table form's prefix tables, or the
    generic form's own prefixes and identity table) over the JAX-saved
    models loaded in the port, against the JAX package's jitted pass
    over the JAX models, on the same boundary values: 1e-5. Titanic's
    boundary holds the pivots' vectors (C = 41 slots)."""
    from transmogrifai_tpu.serving.fusion import (
        FusedGroupScorer as JaxGroupScorer)
    from transmogrifai_tpu_torch.serving.fusion import FusedGroupScorer
    monkeypatch.delenv("TM_KERNEL_EXACT", raising=False)
    port_members = _members(PORT, trained[case]["loaded"])
    jax_members = _members(JAX, trained[case]["jax"])
    port = FusedGroupScorer(port_members)
    jax_ = JaxGroupScorer(jax_members, pallas_mode="0")
    assert port._tails is None and port.form == CASES[case]
    vals, mid = _slice_inputs(case, port_members)
    if case in ("titanic", "user_stage"):
        assert sum(np.prod(v.shape[1:], dtype=int) for v in vals) == 41
    n = len(mid)
    got = port.finalize(port.launch(n, vals, mid))
    want = jax_.finalize(jax_.launch(n, vals, mid))
    assert got.shape == want.shape == (n, port.n_out)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", ["boston", "iris", "titanic", "user_stage"])
def test_exact_mode_is_bitwise_each_members_own_tail(case, trained,
                                                     monkeypatch):
    """TM_KERNEL_EXACT=1 on the CPU: every row bit for bit its own
    member's tail over the same padded slices."""
    from transmogrifai_tpu_torch.serving.fusion import FusedGroupScorer
    monkeypatch.setenv("TM_KERNEL_EXACT", "1")
    members = _members(PORT, trained[case]["loaded"])
    scorer = FusedGroupScorer(members)
    assert scorer.exact and scorer._tails is not None
    vals, mid = _slice_inputs(case, members, seed=1)
    got = scorer.finalize(scorer.launch(len(mid), vals, mid))
    for k, (backend, spec) in enumerate(members):
        own = backend.finalize(backend.launch(len(mid), vals))
        np.testing.assert_array_equal(
            got[mid == k].view(np.uint32),
            own[spec.result_name][mid == k].view(np.uint32))


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("case", ["titanic", "user_stage"])
def test_engine_serves_both_forms_on_the_fused_plane(case, exact, trained,
                                                     monkeypatch):
    """The two JAX-saved models behind one engine with the fused plane
    on, requests of both submitted together: fused, no fallback, no
    failure; each request within 1e-5 of its own model, and under
    TM_KERNEL_EXACT=1 bit for bit its own model's scores."""
    from transmogrifai_tpu_torch import serving
    if exact:
        monkeypatch.setenv("TM_KERNEL_EXACT", "1")
    else:
        monkeypatch.delenv("TM_KERNEL_EXACT", raising=False)
    models = trained[case]["loaded"]
    reg = serving.ModelRegistry()
    recs = _records(PORT, case)
    for k, model in enumerate(models):
        reg.register(f"m{k}", model, buckets=BUCKETS, warm_sample=recs[:1])
    eng = serving.ServingEngine(registry=reg, config=serving.EngineConfig(
        fused_kernel=True, max_wait_ms=100.0, max_batch_rows=64)).start()
    try:
        futs = [(k, recs[7 * j:7 * j + 7],
                 eng.submit(recs[7 * j:7 * j + 7], model=f"m{k}"))
                for j in range(6) for k in range(2)]
        out = [(k, rows, f.result(60)) for k, rows, f in futs]
    finally:
        eng.stop()
    st = eng.stats.as_dict()
    assert st["fused_batches"] > 0 and st["fused_fallbacks"] == 0
    assert st["failed"] == 0
    for k, rows, res in out:
        name = models[k].result_features[0].name
        own = models[k].compile_scoring(buckets=BUCKETS, device="cpu") \
            .score_arrays(rows)[name]
        if exact:
            np.testing.assert_array_equal(res[name].view(np.uint32),
                                          own.view(np.uint32))
        else:
            np.testing.assert_allclose(res[name], own, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# members whose pivot vocabularies differ
# ---------------------------------------------------------------------------

def _width_records(levels_a, levels_b, n=240, seed=0):
    """Two PickLists of ``levels_a`` / ``levels_b`` levels (no nulls),
    one Real column and a label that depends on all three."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, levels_a, n)
    b = rng.integers(0, levels_b, n)
    x = rng.normal(size=n)
    y = ((a == 0) ^ (b == 1) ^ (x > 0.3)).astype(float)
    return [{"a": f"a{a[i]}", "b": f"b{b[i]}", "x": float(x[i]),
             "y": float(y[i])} for i in range(n)]


def _width_model(pkg, records, reg_param):
    """transmogrify over (a, b, x) and an LR head, no SanityChecker: the
    pivots' widths are levels + other + null, so (3, 2) and (2, 3)
    levels give one head width p = 5 + 4 + 2 = 4 + 5 + 2."""
    ft = _m(pkg, "features.types")
    feat = _m(pkg, "features.feature")
    M = _m(pkg, "models")
    FB = feat.FeatureBuilder
    feat.reset_uids()
    y = FB.of(ft.RealNN, "y").from_column().as_response()
    preds = [FB.of(ft.PickList, "a").from_column().as_predictor(),
             FB.of(ft.PickList, "b").from_column().as_predictor(),
             FB.of(ft.Real, "x").from_column().as_predictor()]
    pred = M.BinaryClassificationModelSelector.with_train_validation_split(
        candidates=[["LogisticRegression", {"regParam": [reg_param]}]]
    ).set_input(y, _m(pkg, "ops.transmogrifier").transmogrify(preds)).output
    kw = {"device": "cpu"} if pkg == PORT else {}
    return _m(pkg, "workflow").Workflow([pred]).train(records, **kw)


def _serve_widths(pkg, monkeypatch):
    """Three members (m0 and m2 on (3, 2) levels, m1 on (2, 3)) behind
    one engine with the fused plane on; four requests each, submitted
    together. Returns (engine stats, [(model, rows, result or error)],
    the models)."""
    monkeypatch.delenv("TM_KERNEL_EXACT", raising=False)
    serving = _m(pkg, "serving")
    data = {0: _width_records(3, 2), 1: _width_records(2, 3, seed=1),
            2: _width_records(3, 2)}
    models = {f"m{k}": _width_model(pkg, data[k], REG_PARAMS[k % 2])
              for k in range(3)}
    reg = serving.ModelRegistry()
    for name, model in models.items():
        reg.register(name, model, buckets=BUCKETS,
                     warm_sample=data[int(name[1])][:1])
    eng = serving.ServingEngine(registry=reg, config=serving.EngineConfig(
        fused_kernel=True, max_wait_ms=100.0, max_batch_rows=64)).start()
    subs = []
    try:
        for j in range(4):
            for name in models:
                rows = data[int(name[1])][j * 3:j * 3 + 3]
                subs.append((name, rows, eng.submit(rows, model=name)))
        out = []
        for name, rows, fut in subs:
            try:
                out.append((name, rows, fut.result(60)))
            except Exception as e:      # noqa: BLE001 — recorded
                out.append((name, rows, e))
    finally:
        eng.stop()
    return eng.stats.as_dict(), out, models


def test_members_of_two_widths_never_share_a_launch(monkeypatch):
    """The port: the two m0 / m2 requests of a drain pass ride one fused
    launch, m1's (other pivot widths, the same head width) score apart,
    no fallback and no failure; every row within 1e-5 of its own model
    (the fused plane's f32 on the CPU)."""
    from transmogrifai_tpu_torch.serving.fusion import stack_spec_of
    stats, out, models = _serve_widths(PORT, monkeypatch)
    specs = {n: stack_spec_of(_backend(PORT, m)) for n, m in models.items()}
    assert len({s.fuse_key() for s in specs.values()}) == 1
    assert stats["failed"] == 0 and stats["fused_fallbacks"] == 0
    assert stats["fused_batches"] > 0
    assert stats["fused_requests"] <= 8     # m1 never rides a fused pass
    for name, rows, res in out:
        assert not isinstance(res, Exception), res
        sc = models[name].compile_scoring(buckets=BUCKETS, device="cpu")
        want = sc.score_arrays(rows)[specs[name].result_name]
        np.testing.assert_allclose(res[specs[name].result_name], want,
                                   rtol=0, atol=1e-5)


def test_jax_package_pools_two_widths_and_fails_the_launch(monkeypatch):
    """The reference: its fuse key carries names only and its request
    signature dtypes only, so m1 pools with m0 and m2, and the gathered
    boundary columns cannot be concatenated
    (``transmogrifai_tpu/serving/engine.py:1487``): requests fail."""
    stats, out, _models = _serve_widths(JAX, monkeypatch)
    errors = [res for _n, _r, res in out if isinstance(res, Exception)]
    assert stats["failed"] == len(errors) > 0
    assert all(isinstance(e, ValueError) for e in errors)
