"""The port's ``ops/numeric.py`` against the JAX package.

Each bucketizer, scaler, descaler, calibrator and ``FillMissingWithMean``
is fitted in both packages on the same values (numpy seed): the stage
JSON (fitted splits, edges, means, PAVA blocks), the output column and
every row of ``transform_value`` must be BITWISE equal. The decision-tree
bucketizers fit on the host in numpy in both packages, so their splits
are the same floats. The scaler/descaler chain (and the prediction
descaler of ``examples/op_house_log.py``) is held the same way.
"""
import numpy as np
import pytest

from torch_parity import (assert_same_column, assert_same_stage, build,
                          fit_both, reset_uids, stage_doc)

N = 211


def _reals(rng, missing=0.1):
    return [None if rng.random() < missing else float(x)
            for x in rng.normal(2.0, 3.0, N)]


def _positive(rng):
    return [None if rng.random() < 0.1 else float(x)
            for x in rng.lognormal(1.0, 0.8, N)]


def _labelled(rng):
    x = rng.normal(size=N)
    y = (x + 0.3 * rng.normal(size=N) > 0.2).astype(float)
    xs = [None if rng.random() < 0.08 else float(v) for v in x]
    return {"y": ("RealNN", [float(v) for v in y]), "x": ("Real", xs)}


def _labelled_map(rng):
    y = rng.integers(0, 2, N).astype(float)
    maps = []
    for i in range(N):
        m = {}
        for k in ("a", "b", "c"):
            if rng.random() < 0.8:
                m[k] = float(rng.normal() + (1.5 * y[i] if k != "c" else 0))
        if rng.random() < 0.05:
            m["b"] = float("nan")
        maps.append(m)
    return {"y": ("RealNN", [float(v) for v in y]), "m": ("RealMap", maps)}


UNARY = [
    ("NumericBucketizer", {"splits": [-1.0, 0.0, 2.5, 6.0]}, _reals),
    ("NumericBucketizer", {"splits": [0.0, 1.0], "track_nulls": False,
                           "track_invalid": True}, _reals),
    ("QuantileDiscretizer", {"num_buckets": 4}, _reals),
    ("QuantileDiscretizer", {"num_buckets": 7, "track_nulls": False},
     _reals),
    ("ScalarStandardScaler", {}, _reals),
    ("FillMissingWithMean", {}, _reals),
    ("FillMissingWithMean", {"default": -1.0},
     lambda rng: [None] * N),
    ("PercentileCalibrator", {}, _reals),
    ("PercentileCalibrator", {"buckets": 10}, _reals),
    ("ScalerTransformer", {"scaling_type": "linear", "slope": 2.5,
                           "intercept": -1.0}, _reals),
    ("ScalerTransformer", {"scaling_type": "log"}, _reals),
]


@pytest.mark.parametrize("cls,kw,make", UNARY,
                         ids=[f"{c}-{i}" for i, (c, *_r) in enumerate(UNARY)])
def test_unary_numeric_stage_bitwise_parity_with_jax(cls, kw, make):
    values = make(np.random.default_rng(17))
    j, t = fit_both("ops.numeric", cls, kw, ["x"], {"x": ("Real", values)})
    assert_same_stage(j, t)


BINARY = [
    ("DecisionTreeNumericBucketizer", {}, _labelled, ["y", "x"]),
    ("DecisionTreeNumericBucketizer", {"max_depth": 3, "min_samples": 4,
                                       "track_nulls": False},
     _labelled, ["y", "x"]),
    ("IsotonicRegressionCalibrator", {}, _labelled, ["y", "x"]),
    ("DecisionTreeNumericMapBucketizer", {}, _labelled_map, ["y", "m"]),
    ("DecisionTreeNumericMapBucketizer", {"max_depth": 1},
     _labelled_map, ["y", "m"]),
]


@pytest.mark.parametrize("cls,kw,make,inputs", BINARY,
                         ids=[f"{c}-{i}" for i, (c, *_r)
                              in enumerate(BINARY)])
def test_supervised_numeric_stage_bitwise_parity_with_jax(cls, kw, make,
                                                          inputs):
    cols = make(np.random.default_rng(23))
    j, t = fit_both("ops.numeric", cls, kw, inputs, cols, response="y")
    assert_same_stage(j, t)


def _descaler_chain(pkg, scaling):
    import importlib
    num = importlib.import_module(f"{pkg}.ops.numeric")
    rng = np.random.default_rng(31)
    vals = _positive(rng)
    other = _positive(rng)
    reset_uids()
    ds, feats = build(pkg, {"x": ("Real", vals), "v": ("Real", other)})
    scaler = num.ScalerTransformer(**scaling).set_input(feats["x"])
    scaled = scaler.output
    ds = scaler.transform(ds)
    desc = num.DescalerTransformer().set_input(feats["v"], scaled)
    out = desc.transform(ds)
    return scaler, desc, out, ds


@pytest.mark.parametrize("scaling", [
    {"scaling_type": "linear", "slope": 3.0, "intercept": 0.5},
    {"scaling_type": "log"}])
def test_scaler_descaler_chain_parity(scaling):
    js, jd, jout, jds = _descaler_chain("transmogrifai_tpu", scaling)
    ts, td, tout, tds = _descaler_chain("transmogrifai_tpu_torch", scaling)
    assert stage_doc(ts) == stage_doc(js)
    assert stage_doc(td) == stage_doc(jd)
    assert_same_column(jout, tout, jd.output.name)
    for i in range(jds.n_rows):
        a = jd.transform_value(jds.typed_value("v", i),
                               jds.typed_value(js.output.name, i)).value
        b = td.transform_value(tds.typed_value("v", i),
                               tds.typed_value(ts.output.name, i)).value
        assert (a == b) or (a is None and b is None) or (
            np.isnan(a) and np.isnan(b))


def _prediction_descaler(pkg):
    import importlib
    num = importlib.import_module(f"{pkg}.ops.numeric")
    rng = np.random.default_rng(37)
    y = _positive(rng)
    preds = [{"prediction": float(v)} for v in rng.normal(1.0, 0.5, N)]
    reset_uids()
    ds, feats = build(pkg, {"y": ("Real", y), "p": ("Prediction", preds)})
    scaler = num.ScalerTransformer(scaling_type="log").set_input(feats["y"])
    ds = scaler.transform(ds)
    desc = num.PredictionDescaler().set_input(feats["p"], scaler.output)
    return desc, desc.transform(ds)


def test_prediction_descaler_parity():
    jd, jout = _prediction_descaler("transmogrifai_tpu")
    td, tout = _prediction_descaler("transmogrifai_tpu_torch")
    assert stage_doc(td) == stage_doc(jd)
    assert_same_column(jout, tout, jd.output.name)
