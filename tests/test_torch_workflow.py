"""The port's workflow front door against the JAX package.

The Titanic helloworld (``examples/op_titanic_simple.py``) rebuilt from
each package's classes — CSV reader -> transmogrify -> SanityChecker ->
BinaryClassificationModelSelector (3 folds, LR {regParam: [0.01, 0.1],
elasticNetParam: [0.0, 0.5]} plus DT, to stay CPU-fast) — trains in
both packages on the same file; the port runs with ``device="cpu"``.
Tolerances: every CV metric within 1e-4 and the same winner; scores
within 1e-5 (LR's Newton/FISTA sums in another order); a model saved by
one package scores in the other within 1e-6 of the saving package.
Also mirrors ``tests/test_workflow.py`` and ``tests/test_runner.py``:
DAG layering, fused scoring against the stage walk, local scoring,
serial vs parallel executors, checkpoint resume and every runner type.
"""
import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: the suite runs several
    workers at once, and torch's intra-op threads on these small tensors
    only add contention for the other workers' timing-sensitive tests."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TITANIC = os.path.join(_REPO, "examples", "data", "titanic.csv")
LR_GRID = {"regParam": [0.01, 0.1], "elasticNetParam": [0.0, 0.5]}


class Pkg:
    """One package's front-door classes, by module path."""

    def __init__(self, name: str):
        m = importlib.import_module
        self.name = name
        self.ft = m(name + ".features.types")
        feat = m(name + ".features.feature")
        self.FeatureBuilder = feat.FeatureBuilder
        self.reset_uids = feat.reset_uids
        self.M = m(name + ".models")
        self.SanityChecker = m(name + ".ops.sanity_checker").SanityChecker
        self.transmogrify = m(name + ".ops.transmogrifier").transmogrify
        self.DataReaders = m(name + ".readers").DataReaders
        self.wf = m(name + ".workflow")
        self.Evaluators = m(name + ".evaluators").Evaluators
        self.runner = m(name + ".runner")
        self.local = m(name + ".local")
        self.port = name == "transmogrifai_tpu_torch"

    def kw(self):
        """The device argument of the port's entry points."""
        return {"device": "cpu"} if self.port else {}

    def schema(self):
        ft = self.ft
        return {"id": ft.ID, "pclass": ft.PickList, "sex": ft.PickList,
                "age": ft.Real, "sibSp": ft.Integral, "parCh": ft.Integral,
                "fare": ft.Real, "cabin": ft.PickList,
                "embarked": ft.PickList, "survived": ft.RealNN}

    def reader(self, path=TITANIC):
        return self.DataReaders.csv(path, self.schema(), key="id")

    def titanic(self, candidates=None, folds=3):
        """(Workflow, prediction feature) of the Titanic helloworld."""
        ft, FB = self.ft, self.FeatureBuilder
        self.reset_uids()
        survived = FB.of(ft.RealNN, "survived").from_column().as_response()
        preds = [FB.of(t, n).from_column().as_predictor()
                 for n, t in self.schema().items()
                 if n not in ("id", "survived")]
        checked = self.SanityChecker().set_input(
            survived, self.transmogrify(preds)).output
        cands = candidates or [["LogisticRegression", LR_GRID],
                               ["DecisionTreeClassifier", None]]
        pred = self.M.BinaryClassificationModelSelector.with_cross_validation(
            n_folds=folds, candidates=cands).set_input(
                survived, checked).output
        return self.wf.Workflow([pred]), pred

    def train(self, workflow, data=None, **kw):
        return workflow.train(data if data is not None else self.reader(),
                              **kw, **self.kw())

    def load(self, path):
        return self.wf.WorkflowModel.load(path, **self.kw())


JAX = Pkg("transmogrifai_tpu")
PORT = Pkg("transmogrifai_tpu_torch")


def _probs(model, ds):
    name = model.result_features[0].name
    return np.asarray([[r["probability_0"], r["probability_1"]]
                       for r in ds.column(name)], np.float64)


def _strip(v):
    """Drop the host wall clocks (the executor's ``stageTimings``);
    everything else is a fitted result."""
    if isinstance(v, dict):
        return {k: _strip(x) for k, x in v.items() if k != "stageTimings"}
    if isinstance(v, list):
        return [_strip(x) for x in v]
    return v


def _fingerprint(model):
    from transmogrifai_tpu_torch.stages.persistence import stage_to_json
    from transmogrifai_tpu_torch.workflow import _json_default
    return json.dumps(_strip([stage_to_json(st) for st in model.stages]),
                      default=_json_default, sort_keys=True)


def _summaries(model):
    from transmogrifai_tpu_torch.workflow import _json_default
    return json.dumps(_strip(model.train_summaries), default=_json_default,
                      sort_keys=True)


@pytest.fixture(scope="module")
def titanic():
    out = {}
    for pkg in (JAX, PORT):
        wf, pred = pkg.titanic()
        model = pkg.train(wf)
        out[pkg.name] = (model, pred)
    return out


def _selector_summary(model):
    return model.selected_model().summary


def _checker(model):
    return next(st for st in model.stages
                if st.operation_name == "sanityChecked")


def test_titanic_winner_and_cv_metrics_match_jax(titanic):
    j = _selector_summary(titanic["transmogrifai_tpu"][0])
    t = _selector_summary(titanic["transmogrifai_tpu_torch"][0])
    assert t["bestModel"]["family"] == j["bestModel"]["family"]
    assert t["bestModel"]["hyper"] == j["bestModel"]["hyper"]
    assert t["bestModel"]["family"] == "LogisticRegression"
    assert t["bestModel"]["hyper"] == {"regParam": 0.01,
                                       "elasticNetParam": 0.5}
    assert len(t["validationResults"]) == len(j["validationResults"]) == 2
    for rj, rt in zip(j["validationResults"], t["validationResults"]):
        assert rt["family"] == rj["family"]
        assert rt["grid"] == rj["grid"]
        np.testing.assert_allclose(rt["gridMetrics"], rj["gridMetrics"],
                                   rtol=0, atol=1e-4)
    assert t["dataCounts"] == j["dataCounts"]
    assert t["splitterSummary"] == j["splitterSummary"]


def test_titanic_kept_slots_and_reasons_match_jax(titanic):
    j = _checker(titanic["transmogrifai_tpu"][0])
    t = _checker(titanic["transmogrifai_tpu_torch"][0])
    assert t.params["keep_indices"] == j.params["keep_indices"]
    for key in ("names", "dropped", "droppedParents", "keepIndices",
                "featuresIn", "featuresOut", "cramersV",
                "pointwiseMutualInformation"):
        assert t.summary[key] == j.summary[key], key
    assert t.manifest.to_json() == j.manifest.to_json()


def test_titanic_scores_and_train_metrics_match_jax(titanic):
    jm, _ = titanic["transmogrifai_tpu"]
    tm, _ = titanic["transmogrifai_tpu_torch"]
    pj = _probs(jm, jm.score(JAX.reader()))
    pt = _probs(tm, tm.score(PORT.reader()))
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-5)
    mj = jm.evaluate(JAX.reader(), JAX.Evaluators.binary_classification())
    mt = tm.evaluate(PORT.reader(), PORT.Evaluators.binary_classification())
    assert abs(mt["AuROC"] - 0.8017) < 0.01
    assert abs(mt["AuROC"] - mj["AuROC"]) < 1e-4


@pytest.mark.parametrize("family,atol", [
    ("DecisionTreeClassifier", 0.0), ("LogisticRegression", 1e-5)])
def test_exact_mode_scores_match_jax(family, atol, monkeypatch):
    """Under TM_KERNEL_EXACT=1 a DT workflow scores bitwise like the
    JAX package's, and an LR one within 1e-5."""
    monkeypatch.setenv("TM_KERNEL_EXACT", "1")
    grid = {"regParam": [0.01], "elasticNetParam": [0.5]} \
        if family == "LogisticRegression" else {"maxDepth": [4]}
    got = []
    for pkg in (JAX, PORT):
        wf, _ = pkg.titanic(candidates=[[family, grid]], folds=2)
        model = pkg.train(wf)
        got.append(_probs(model, model.score(pkg.reader())))
    if atol == 0.0:
        assert np.array_equal(got[1], got[0])
    else:
        np.testing.assert_allclose(got[1], got[0], rtol=0, atol=atol)


def test_serial_and_parallel_executors_identical():
    models = []
    for mode in ("serial", "parallel"):
        wf, _ = PORT.titanic(folds=2)
        models.append(PORT.train(wf, executor=mode))
    assert _fingerprint(models[0]) == _fingerprint(models[1])
    assert _summaries(models[0]) == _summaries(models[1])
    timings = models[1].train_summaries["stageTimings"]
    assert timings["executor"] == "parallel"
    # the impute vectorizers ran as the layer's fused device block
    assert {"fused", "skipped"} <= {s["transform"]
                                    for s in timings["stages"]}


@pytest.mark.parametrize("nth", [9, 11])
def test_checkpoint_resume_identical(tmp_path, nth):
    """Die at the nth stage fit (layer 0 holds the eight vectorizers, so
    9 is the combiner and 11 the selector), resume with the same
    arguments: the model equals an uninterrupted train's, and the
    checkpoint goes."""
    from transmogrifai_tpu_torch.resilience import faults
    cands = [["LogisticRegression", {"regParam": [0.01]}]]
    wf, _ = PORT.titanic(candidates=cands, folds=2)
    baseline = PORT.train(wf)
    ckpt = str(tmp_path / "ckpt")
    with faults.active(f"executor.stage_fit:raise-fatal:{nth}"):
        with pytest.raises(faults.FaultError):
            wf, _ = PORT.titanic(candidates=cands, folds=2)
            PORT.train(wf, checkpoint_dir=ckpt)
    assert os.path.isdir(ckpt)
    wf, _ = PORT.titanic(candidates=cands, folds=2)
    resumed = PORT.train(wf, checkpoint_dir=ckpt, resume=True)
    assert _fingerprint(baseline) == _fingerprint(resumed)
    assert _summaries(baseline) == _summaries(resumed)
    assert resumed.train_summaries["stageTimings"]["resumedLayers"] >= 1
    assert np.array_equal(_probs(baseline, baseline.score(PORT.reader())),
                          _probs(resumed, resumed.score(PORT.reader())))
    assert not os.path.exists(ckpt)


def test_port_saved_model_scores_alike_in_jax(titanic, tmp_path):
    tm, _ = titanic["transmogrifai_tpu_torch"]
    path = str(tmp_path / "port_model")
    tm.save(path)
    doc = json.load(open(os.path.join(path, "workflow.json")))
    # class keys name the JAX package's modules
    assert all(s["className"].startswith("transmogrifai_tpu.")
               for s in doc["stages"])
    pt = _probs(tm, tm.score(PORT.reader()))
    jm = JAX.load(path)
    pj = _probs(jm, jm.score(JAX.reader()))
    np.testing.assert_allclose(pj, pt, rtol=0, atol=1e-6)


def test_jax_saved_model_scores_alike_in_port(titanic, tmp_path):
    jm, _ = titanic["transmogrifai_tpu"]
    path = str(tmp_path / "jax_model")
    jm.save(path)
    pj = _probs(jm, jm.score(JAX.reader()))
    tm = PORT.load(path)
    assert type(tm.selected_model()).__module__.startswith(
        "transmogrifai_tpu_torch.")
    pt = _probs(tm, tm.score(PORT.reader()))
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-6)
    # and the port's fused scorer on the loaded model agrees
    sc = tm.compile_scoring(device="cpu")
    assert [type(s).__name__ for s in sc.host_stages] == ["OneHotModel"] * 4
    arr = sc.score_arrays(PORT.reader())[tm.result_features[0].name]
    np.testing.assert_allclose(arr, pj, rtol=0, atol=1e-6)


def test_port_loads_jax_model_without_importing_jax(titanic, tmp_path):
    jm, _ = titanic["transmogrifai_tpu"]
    path = str(tmp_path / "jax_model")
    jm.save(path)
    code = (
        "import sys, numpy as np\n"
        "from transmogrifai_tpu_torch.workflow import WorkflowModel\n"
        "from transmogrifai_tpu_torch.readers import DataReaders\n"
        "from transmogrifai_tpu_torch.features import types as ft\n"
        f"m = WorkflowModel.load({path!r}, device='cpu')\n"
        "schema = {'id': ft.ID, 'pclass': ft.PickList, 'sex': ft.PickList,"
        " 'age': ft.Real, 'sibSp': ft.Integral, 'parCh': ft.Integral,"
        " 'fare': ft.Real, 'cabin': ft.PickList, 'embarked': ft.PickList,"
        " 'survived': ft.RealNN}\n"
        f"ds = m.score(DataReaders.csv({TITANIC!r}, schema, key='id'))\n"
        "assert ds.n_rows == 891\n"
        "print([k for k in sys.modules"
        " if k.split('.')[0] in ('jax', 'jaxlib', 'transmogrifai_tpu')])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=_REPO,
                         env={**os.environ, "PYTHONPATH": _REPO})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_unported_class_key_raises_naming_the_item():
    from transmogrifai_tpu_torch.stages.base import resolve_stage_class
    # the Criteo path's classes (item 6) are ported and resolve
    cls = resolve_stage_class(
        "transmogrifai_tpu.models.sparse.SparseSelectedModel")
    assert cls.__module__ == "transmogrifai_tpu_torch.models.sparse"
    # the feature layer (item 2) and LDA are ported and resolve
    for key in ("transmogrifai_tpu.ops.lda.LDAModel",
                "transmogrifai_tpu.ops.parsers.StringIndexer"):
        cls = resolve_stage_class(key)
        assert cls.__module__ == "transmogrifai_tpu_torch." + key.split(
            ".", 1)[1].rsplit(".", 1)[0]
    # the FT-Transformer (a later slice) resolves too; a key no module
    # of either package defines raises
    cls = resolve_stage_class(
        "transmogrifai_tpu.models.ft_transformer.OpFTTransformerClassifier")
    assert cls.__module__ == "transmogrifai_tpu_torch.models.ft_transformer"
    with pytest.raises(ValueError, match="unknown stage class"):
        resolve_stage_class("transmogrifai_tpu.models.nothing.OpNothing")
    cls = resolve_stage_class("transmogrifai_tpu.ops.vectorizers.OneHotModel")
    assert cls.__module__ == "transmogrifai_tpu_torch.ops.vectorizers"


def test_local_scorer_matches_batch_scores(titanic):
    tm, _ = titanic["transmogrifai_tpu_torch"]
    rows = PORT.reader().read()[:40]
    batch = _probs(tm, tm.score(rows))
    scorer = PORT.local.LocalScorer(tm, device="cpu")
    name = tm.result_features[0].name
    for i, rec in enumerate(rows):
        rec = {k: v for k, v in rec.items() if k != "survived"}
        got = scorer(rec)[name]
        np.testing.assert_allclose(
            [got["probability_0"], got["probability_1"]], batch[i],
            rtol=0, atol=1e-6)
    many = scorer.score_batch(rows)
    np.testing.assert_allclose(
        [[r[name]["probability_0"], r[name]["probability_1"]]
         for r in many], batch, rtol=0, atol=1e-6)


def test_compute_dag_layers():
    wf, pred = PORT.titanic()
    raw, layers = PORT.wf.compute_dag([pred])
    assert {f.name for f in raw} >= {"survived", "age", "sex"}
    assert len(layers) == 4
    assert [st.operation_name for st in layers[-1]] == ["modelSelected"]
    jwf, jpred = JAX.titanic()
    jraw, jlayers = JAX.wf.compute_dag([jpred])
    assert [[st.uid for st in lay] for lay in layers] == \
        [[st.uid for st in lay] for lay in jlayers]


def test_fused_scoring_matches_stage_walk_and_survives_persistence(
        titanic, tmp_path):
    tm, _ = titanic["transmogrifai_tpu_torch"]
    name = tm.result_features[0].name
    walk = _probs(tm, tm.score(PORT.reader()))
    sc = tm.compile_scoring(buckets=(64, 512), device="cpu")
    got = sc.score_arrays(PORT.reader())[name]
    np.testing.assert_allclose(got, walk, rtol=0, atol=1e-6)
    fused_ds = sc.score(PORT.reader())
    np.testing.assert_allclose(_probs(tm, fused_ds), walk, rtol=0,
                               atol=1e-6)
    # 891 rows -> one 512 slice + a 379-row remainder padded to 512,
    # for each of the two calls
    assert sc.stats.as_dict()["per_bucket"]["512"]["batches"] == 4
    assert sc.stats.as_dict()["total_rows"] == 2 * 891
    tm.save(str(tmp_path / "m"))
    loaded = PORT.load(str(tmp_path / "m"))
    got2 = loaded.compile_scoring().score_arrays(PORT.reader())[name]
    np.testing.assert_allclose(got2, got, rtol=0, atol=1e-6)


def test_runner_train_score_evaluate_features(tmp_path):
    wf, _ = PORT.titanic(
        candidates=[["LogisticRegression", {"regParam": [0.01]}]], folds=2)
    runner = PORT.runner.WorkflowRunner(
        wf, train_reader=PORT.reader(), score_reader=PORT.reader(),
        evaluator=PORT.Evaluators.binary_classification(), device="cpu")
    params = PORT.runner.OpParams(
        model_location=str(tmp_path / "model"),
        metrics_location=str(tmp_path / "metrics"),
        score_location=str(tmp_path / "scores"))
    RT = PORT.runner.RunType
    res = runner.run(RT.TRAIN, params)
    assert res["bestModel"]["family"] == "LogisticRegression"
    assert res["trainMetrics"]["AuROC"] > 0.75
    assert os.path.exists(tmp_path / "model" / "workflow.json")
    insights = json.load(open(tmp_path / "metrics" / "model_insights.json"))
    assert insights["trainingParams"]["modelFamily"] == "LogisticRegression"
    res = runner.run(RT.SCORE, params)
    assert res["nRows"] == 891 and "metrics" in res
    assert os.path.exists(tmp_path / "scores" / "scores.csv")
    res = runner.run("evaluate", params)
    assert res["metrics"]["AuROC"] > 0.75
    res = runner.run(RT.FEATURES, params)
    assert res["nRows"] == 891
    assert os.path.exists(tmp_path / "scores" / "features.csv")
    for rt in ("train", "score", "evaluate", "features"):
        assert os.path.exists(tmp_path / "metrics" / f"{rt}_result.json")
    # a fresh runner scores from the saved model alone
    fresh = PORT.runner.WorkflowRunner(
        wf, score_reader=PORT.reader(), device="cpu")
    assert fresh.run(RT.SCORE, params)["nRows"] == 891


def test_runner_streaming_score_matches_batch(tmp_path):
    wf, _ = PORT.titanic(
        candidates=[["LogisticRegression", {"regParam": [0.01]}]], folds=2)
    runner = PORT.runner.WorkflowRunner(
        wf, train_reader=PORT.reader(), score_reader=PORT.reader(),
        device="cpu")
    RT = PORT.runner.RunType
    batch = tmp_path / "batch"
    stream = tmp_path / "stream"
    runner.run(RT.TRAIN, PORT.runner.OpParams(
        model_location=str(tmp_path / "m")))
    runner.run(RT.SCORE, PORT.runner.OpParams(
        model_location=str(tmp_path / "m"), score_location=str(batch)))
    res = runner.run(RT.STREAMING_SCORE, PORT.runner.OpParams(
        model_location=str(tmp_path / "m"), score_location=str(stream),
        custom_params={"chunkRows": 200}))
    assert res["nRows"] == 891 and res["nChunks"] == 5
    b = np.genfromtxt(batch / "scores.csv", delimiter=",", names=True,
                      dtype=None, encoding="utf-8")
    s = np.genfromtxt(stream / "scores.csv", delimiter=",", names=True,
                      dtype=None, encoding="utf-8")
    col = [n for n in b.dtype.names if n.endswith("probability_1")][0]
    np.testing.assert_allclose(s[col], b[col], rtol=0, atol=1e-6)


@pytest.mark.parametrize("field,value,item", [
    ("compilation_cache_location", "cache", "item 9"),
    ("debug_nans", True, "item 9"),
    ("distributed", {"numProcesses": 2}, "item 10")])
def test_runner_unported_params_raise(field, value, item):
    wf, _ = PORT.titanic()
    runner = PORT.runner.WorkflowRunner(wf, train_reader=PORT.reader(),
                                        device="cpu")
    params = PORT.runner.OpParams(**{field: value})
    with pytest.raises(NotImplementedError, match=item):
        runner.run("train", params)


def test_runner_params_from_json_and_stage_overrides(tmp_path):
    p = tmp_path / "params.json"
    p.write_text(json.dumps({"modelLocation": "m", "stageParams": {
        "SanityChecker": {"max_correlation": 0.5}}}))
    params = PORT.runner.OpParams.from_file(str(p))
    assert params.model_location == "m"
    wf, _ = PORT.titanic()
    PORT.runner.apply_stage_params(wf, params.stage_params)
    _, layers = PORT.wf.compute_dag(wf.result_features)
    checker = next(st for lay in layers for st in lay
                   if type(st).__name__ == "SanityChecker")
    assert checker.params["max_correlation"] == 0.5
    with pytest.raises(ValueError, match="unknown OpParams key"):
        PORT.runner.OpParams.from_dict({"bogus": 1})


def test_profile_location_writes_a_chrome_trace(tmp_path):
    wf, _ = PORT.titanic(
        candidates=[["LogisticRegression", {"regParam": [0.01]}]], folds=2)
    runner = PORT.runner.WorkflowRunner(wf, train_reader=PORT.reader(),
                                        device="cpu")
    res = runner.run("train", PORT.runner.OpParams(
        profile_location=str(tmp_path / "prof")))
    assert res["profileLocation"] == str(tmp_path / "prof")
    trace = json.load(open(tmp_path / "prof" / "trace.json"))
    assert trace["traceEvents"]


def test_unported_workflow_paths_raise(titanic):
    wf, _ = PORT.titanic()
    # the raw feature filter is ported (filters/)
    assert wf.with_raw_feature_filter(min_fill_rate=0.1) is wf
    assert type(wf.raw_feature_filter).__module__ == \
        "transmogrifai_tpu_torch.filters"
    assert wf.raw_feature_filter.min_fill_rate == 0.1
    # score_stream is ported (io/stream.py): one result a chunk, equal
    # to the batch scorer's
    tm, _ = titanic["transmogrifai_tpu_torch"]
    sc = tm.compile_scoring(device="cpu")
    rows = PORT.reader().read()[:9]
    got = list(sc.score_stream([rows[:5], rows[5:]]))
    want = sc.score_arrays(rows)
    for name in want:
        np.testing.assert_array_equal(
            np.concatenate([g[name] for g in got]), want[name])


def test_duplicate_output_names_raise_at_construction():
    ft, FB = PORT.ft, PORT.FeatureBuilder
    PORT.reset_uids()
    a = FB.of(ft.Real, "x").from_column().as_predictor()
    b = FB.of(ft.Real, "x").from_column().as_predictor()
    with pytest.raises(ValueError, match="TM-LINT-004"):
        PORT.wf.Workflow([PORT.transmogrify([a, b])])


def _boston(pkg, tmp_path=None):
    """examples/op_boston.py's schema with the LinearRegression
    candidate: an all-numeric workflow (its export has no host
    prefix)."""
    ft, FB = pkg.ft, pkg.FeatureBuilder
    pkg.reset_uids()
    schema = {"crim": ft.Real, "zn": ft.Real, "indus": ft.Real,
              "chas": ft.Binary, "nox": ft.Real, "rm": ft.Real,
              "age": ft.Real, "dis": ft.Real, "rad": ft.Integral,
              "tax": ft.Real, "ptratio": ft.Real, "lstat": ft.Real,
              "medv": ft.RealNN}
    medv = FB.of(ft.RealNN, "medv").from_column().as_response()
    preds = [FB.of(t, n).from_column().as_predictor()
             for n, t in schema.items() if n != "medv"]
    pred = pkg.M.RegressionModelSelector.with_train_validation_split(
        candidates=[["LinearRegression", {"regParam": [0.01]}]]).set_input(
            medv, pkg.transmogrify(preds)).output
    reader = pkg.DataReaders.csv(
        os.path.join(_REPO, "examples", "data", "boston.csv"), schema)
    return pkg.wf.Workflow([pred]), reader


def test_all_numeric_export_loads_in_both_packages(tmp_path):
    """A port-fitted all-numeric workflow exports the JAX package's
    portable format: the port's engine chain and the JAX package's
    loader score it like the WorkflowModel."""
    from transmogrifai_tpu import portable as jportable
    from transmogrifai_tpu_torch import portable as tportable
    wf, reader = _boston(PORT)
    model = PORT.train(wf, reader)
    path = str(tmp_path / "boston")
    files = model.export_portable(path, buckets=(16, 64))
    assert sorted(files) == ["manifest.json", "params.npz"]
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    assert manifest["hostPrefix"] == []
    assert [st["op"] for st in manifest["stages"]][-2:] == ["concat",
                                                            "predict"]
    ds = model.score(reader)
    name = model.result_features[0].name
    want = np.asarray([r["prediction"] for r in ds.column(name)])
    recs = reader.read()
    cols = {c: np.asarray([np.nan if r[c] is None else float(r[c])
                           for r in recs]) for c in manifest["boundary"]
            if c != "medv"}
    pm = tportable.load(path, device="cpu")
    assert pm.score_buckets == (16, 64)
    got = pm.compile_scoring().score_arrays(cols)[name][:, 0]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    jgot = jportable.load(path).score_columns(cols)[name][:, 0]
    np.testing.assert_allclose(jgot, want, rtol=1e-6, atol=1e-5)


def test_host_prefix_export_records_the_prefix_and_the_port_refuses(
        titanic, tmp_path):
    """(The name predates the repair: the port used to refuse every
    artifact with a host prefix.) The Titanic export records its four
    OneHotModel pivots as ``hostPrefix``, and the port now scores it as
    the JAX package's numpy runtime does, from the boundary columns
    (the pivots' outputs and the numeric columns): every row within
    1e-6 of the runtime (``transmogrifai_tpu.portable``, the module the
    JAX exporter copies in as ``portable_runtime.py``). Behind a
    ServingEngine with the fused plane on, the member is served on the
    classic plane: its prefix holds the one-hot vector boundary columns,
    which the prefix compiler does not take (no stack spec; beside
    another model in a drain pass it counts as a fused fallback)."""
    from transmogrifai_tpu import portable as jportable
    from transmogrifai_tpu_torch import portable as tportable
    from transmogrifai_tpu_torch.serving import (EngineConfig, ModelRegistry,
                                                 ServingEngine)
    tm, _ = titanic["transmogrifai_tpu_torch"]
    path = str(tmp_path / "titanic")
    tm.export_portable(path)
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    assert manifest["hostPrefix"] == ["OneHotModel"] * 4
    sc = tm.compile_scoring(device="cpu")
    ds = sc._host_ds(PORT.reader())
    cols = {c: np.asarray(ds.column(c)) for c in manifest["boundary"]
            if c in ds}
    name = manifest["resultNames"][0]
    want = jportable.load(path).score_columns(cols)[name]
    pm = tportable.load(path, device="cpu")
    got = pm.compile_scoring().score_arrays(cols)[name]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    reg = ModelRegistry()
    reg.register("titanic", pm, buckets=(16, 64),
                 warm_sample={c: v[:1] for c, v in cols.items()})
    eng = ServingEngine(registry=reg, config=EngineConfig(
        max_batch_rows=64, fused_kernel=True)).start()
    try:
        served = eng.submit({c: v[:40] for c, v in cols.items()}).result(
            timeout=30)[name]
    finally:
        eng.stop()
    np.testing.assert_allclose(served, got[:40], rtol=0, atol=1e-6)
    assert eng.stats.as_dict()["fused_batches"] == 0
    from transmogrifai_tpu_torch.serving.fusion import stack_spec_of
    from transmogrifai_tpu_torch.serving.registry import _FusedBackend
    assert stack_spec_of(_FusedBackend(pm.compile_scoring())) is None


def test_prefix_compiler_reads_a_fitted_workflow_scorer():
    """A port-fitted WorkflowModel's own scorer (not an export) behind a
    serving backend: the prefix compiler takes the Real vectorizers'
    imputes, the Binary vectorizer's (the same portable op) and the
    concat, so the model can ride the fused plane; the tables hold each
    column's filled value and null indicator."""
    from transmogrifai_tpu_torch.serving.fusion import stack_spec_of
    from transmogrifai_tpu_torch.serving.registry import _FusedBackend
    wf, reader = _boston(PORT)
    model = PORT.train(wf, reader)
    sc = model.compile_scoring(buckets=(16, 64), device="cpu")
    kinds = {type(st).__name__ for st in sc.device_stage_by_output.values()}
    assert {"RealVectorizerModel", "BinaryVectorizer",
            "VectorsCombiner", "SelectedModel"} <= kinds
    spec = stack_spec_of(_FusedBackend(sc))
    assert spec is not None and spec.act == "identity"
    # 10 Real + 1 Integral + 1 Binary columns, each value and null track
    assert len(spec.src) == 2 * 12
    assert sorted(set(np.asarray(spec.src).tolist())) == list(range(12))
