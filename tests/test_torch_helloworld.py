"""The helloworld apps rebuilt from the port's classes, end to end.

The Titanic, Iris and Boston workflows of ``examples/`` (their schemas
and candidate lists; the examples themselves are JAX-package files)
run through the port's runner on the CPU and must meet the reference's
floors (``tests/test_helloworld.py``): AuROC > 0.75, Error < 0.15,
R2 > 0.6. Titanic is also held to the JAX package's own run of the same
workflow: every LR grid point's CV metric within 1e-4, the winner
``LogisticRegression {regParam: 0.01, elasticNetParam: 0.5}`` and the
train AuROC within 0.01 of 0.8017. RF's draws differ from JAX's by
design (ROADMAP queue 3), so RF's grid is held to quality only.
Marked ``slow`` like the reference's ``test_helloworld.py``: each app
trains RF and GBT on the full example data.
"""
import os

import numpy as np
import pytest

from test_torch_workflow import JAX, PORT

pytestmark = pytest.mark.slow

_DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "data")

TITANIC_CANDIDATES = [
    ["LogisticRegression", {"regParam": [0.001, 0.01, 0.1],
                            "elasticNetParam": [0.0, 0.5]}],
    ["RandomForestClassifier", None],
    ["GBTClassifier", None],
]


def _run_train(pkg, wf, reader, evaluator, tmp_path):
    kw = {"device": "cpu"} if pkg.port else {}
    runner = pkg.runner.WorkflowRunner(wf, train_reader=reader,
                                       score_reader=reader,
                                       evaluator=evaluator, **kw)
    params = pkg.runner.OpParams(
        model_location=str(tmp_path / "model"),
        metrics_location=str(tmp_path / "metrics"),
        score_location=str(tmp_path / "scores"))
    return runner, params, runner.run(pkg.runner.RunType.TRAIN, params)


def test_titanic_end_to_end_matches_jax(tmp_path):
    results = {}
    for pkg in (JAX, PORT):
        wf, _ = pkg.titanic(candidates=TITANIC_CANDIDATES)
        runner, params, res = _run_train(
            pkg, wf, pkg.reader(), pkg.Evaluators.binary_classification(),
            tmp_path / pkg.name)
        results[pkg.name] = (runner, params, res)
    runner, params, res = results[PORT.name]
    jres = results[JAX.name][2]
    assert res["trainMetrics"]["AuROC"] > 0.75
    assert abs(res["trainMetrics"]["AuROC"] - 0.8017) < 0.01
    assert res["bestModel"] == {"family": "LogisticRegression",
                                "hyper": {"regParam": 0.01,
                                          "elasticNetParam": 0.5}}
    assert res["bestModel"] == jres["bestModel"]
    summ = runner._model.selected_model().summary["validationResults"]
    jsumm = results[JAX.name][0]._model.selected_model().summary[
        "validationResults"]
    by_fam = {r["family"]: r for r in summ}
    jby_fam = {r["family"]: r for r in jsumm}
    np.testing.assert_allclose(by_fam["LogisticRegression"]["gridMetrics"],
                               jby_fam["LogisticRegression"]["gridMetrics"],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(by_fam["GBTClassifier"]["gridMetrics"],
                               jby_fam["GBTClassifier"]["gridMetrics"],
                               rtol=0, atol=0.02)
    np.testing.assert_allclose(
        by_fam["RandomForestClassifier"]["gridMetrics"],
        jby_fam["RandomForestClassifier"]["gridMetrics"], rtol=0, atol=0.02)
    root = tmp_path / PORT.name
    assert os.path.exists(root / "model" / "workflow.json")
    assert os.path.exists(root / "metrics" / "model_insights.json")
    score = runner.run(PORT.runner.RunType.SCORE, params)
    assert score["nRows"] == 891
    assert os.path.exists(root / "scores" / "scores.csv")
    scorer = PORT.local.load_model_local(str(root / "model"), device="cpu")
    out = scorer({"pclass": "1", "sex": "female", "age": 28.0, "sibSp": 0,
                  "parCh": 0, "fare": 80.0, "cabin": "B20",
                  "embarked": "C"})
    prob = next(v for v in out.values() if isinstance(v, dict))
    assert prob["probability_1"] > 0.5


def _iris_reader(pkg):
    ft = pkg.ft
    schema = {"sepalLength": ft.Real, "sepalWidth": ft.Real,
              "petalLength": ft.Real, "petalWidth": ft.Real,
              "irisClass": ft.PickList}
    records = pkg.DataReaders.csv(os.path.join(_DATA, "iris.csv"),
                                  schema).read()
    labels = sorted({r["irisClass"] for r in records})
    for r in records:
        r["irisClass"] = float(labels.index(r["irisClass"]))
    return pkg.DataReaders.simple(records)


def test_iris_end_to_end(tmp_path):
    ft, FB = PORT.ft, PORT.FeatureBuilder
    PORT.reset_uids()
    label = FB.of(ft.RealNN, "irisClass").from_column().as_response()
    preds = [FB.of(ft.Real, n).from_column().as_predictor()
             for n in ("sepalLength", "sepalWidth", "petalLength",
                       "petalWidth")]
    pred = PORT.M.MultiClassificationModelSelector.with_cross_validation(
        n_folds=3, candidates=[
            ["LogisticRegression", {"regParam": [0.01, 0.1]}],
            ["RandomForestClassifier", None]]).set_input(
        label, PORT.transmogrify(preds)).output
    _, _, res = _run_train(PORT, PORT.wf.Workflow([pred]), _iris_reader(PORT),
                           PORT.Evaluators.multi_classification(), tmp_path)
    assert res["trainMetrics"]["Error"] < 0.15
    assert res["bestModel"]["family"] in ("LogisticRegression",
                                          "RandomForestClassifier")


def test_boston_end_to_end(tmp_path):
    ft, FB = PORT.ft, PORT.FeatureBuilder
    PORT.reset_uids()
    schema = {"crim": ft.Real, "zn": ft.Real, "indus": ft.Real,
              "chas": ft.Binary, "nox": ft.Real, "rm": ft.Real,
              "age": ft.Real, "dis": ft.Real, "rad": ft.Integral,
              "tax": ft.Real, "ptratio": ft.Real, "lstat": ft.Real,
              "medv": ft.RealNN}
    medv = FB.of(ft.RealNN, "medv").from_column().as_response()
    preds = [FB.of(t, n).from_column().as_predictor()
             for n, t in schema.items() if n != "medv"]
    pred = PORT.M.RegressionModelSelector.with_train_validation_split(
        train_ratio=0.75, candidates=[
            ["LinearRegression", {"regParam": [0.001, 0.01, 0.1]}],
            ["RandomForestRegressor", None],
            ["GBTRegressor", None]]).set_input(
        medv, PORT.transmogrify(preds)).output
    reader = PORT.DataReaders.csv(os.path.join(_DATA, "boston.csv"), schema)
    _, _, res = _run_train(PORT, PORT.wf.Workflow([pred]), reader,
                           PORT.Evaluators.regression(), tmp_path)
    assert res["trainMetrics"]["R2"] > 0.6
    assert res["bestModel"]["family"] in (
        "LinearRegression", "RandomForestRegressor", "GBTRegressor")
