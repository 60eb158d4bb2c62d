"""The port's readers and aggregators against the JAX package.

``DataReaders.csv`` must give the JAX package's Dataset exactly — the
same columns in the same order, the same values (NaN where the
reference has NaN), dtypes and feature types — on
``examples/data/titanic.csv`` and on a CSV generated from a numpy seed
with missing values and quoted commas, through both the native
(``csrc/libtmnative.so``) and the pure-Python CSV paths. The rest
mirrors ``tests/test_readers.py`` on the port's classes.
"""
import csv
import os

import numpy as np
import pytest

from transmogrifai_tpu import FeatureBuilder as JFB
from transmogrifai_tpu import native as jnative
from transmogrifai_tpu.features import types as jft
from transmogrifai_tpu.readers import DataReaders as JDR
from transmogrifai_tpu_torch import native as tnative
from transmogrifai_tpu_torch.features import aggregators as agg
from transmogrifai_tpu_torch.features import types as ft
from transmogrifai_tpu_torch.features.feature import FeatureBuilder
from transmogrifai_tpu_torch.readers import (AggregateDataReader,
                                             ConditionalDataReader,
                                             CSVAutoReader, CSVProductReader,
                                             DataReader, DataReaders,
                                             JoinedDataReader,
                                             infer_csv_schema)


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
TITANIC_SCHEMA = {"id": "ID", "pclass": "PickList", "sex": "PickList",
                  "age": "Real", "sibSp": "Integral", "parCh": "Integral",
                  "fare": "Real", "cabin": "PickList", "embarked": "PickList",
                  "survived": "RealNN"}


def _schema(types_mod, names):
    return {k: getattr(types_mod, v) for k, v in names.items()}


def assert_same_dataset(tds, jds):
    """Column names/order, values, dtypes and ftype names identical."""
    assert tds.column_names == jds.column_names
    assert tds.n_rows == jds.n_rows
    for name in jds.column_names:
        a, b = tds.column(name), jds.column(name)
        assert a.dtype == b.dtype, name
        assert a.shape == b.shape, name
        if a.dtype.kind == "f":
            assert np.array_equal(a, b, equal_nan=True), name
        else:
            assert list(a) == list(b), name
        assert tds.ftype(name).__name__ == jds.ftype(name).__name__, name
        assert (tds.manifest(name) is None) == (jds.manifest(name) is None)


def _read_both(path, names, key="id"):
    tds = DataReaders.csv(path, _schema(ft, names), key=key) \
        .generate_dataset([FeatureBuilder.of(getattr(ft, t), n)
                           .from_column().as_predictor()
                           for n, t in names.items()])
    jds = JDR.csv(path, _schema(jft, names), key=key) \
        .generate_dataset([JFB.of(getattr(jft, t), n)
                           .from_column().as_predictor()
                           for n, t in names.items()])
    return tds, jds


@pytest.fixture(params=["native", "python"])
def csv_path_kind(request, monkeypatch):
    """Run a case through the native CSV parser and through the
    pure-Python fallback, in both packages alike."""
    if request.param == "python":
        monkeypatch.setattr(tnative, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    return request.param


def test_titanic_csv_identical_to_jax(csv_path_kind):
    tds, jds = _read_both(TITANIC, TITANIC_SCHEMA)
    assert tds.n_rows == 891
    assert_same_dataset(tds, jds)


def _generated_csv(path, n=300, seed=7):
    rng = np.random.default_rng(seed)
    cities = ["Paris", "New York, NY", 'Say "hi", friend', "Oslo", ""]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["id", "x", "k", "city", "note", "flag", "y"])
        for i in range(n):
            x = "" if rng.random() < 0.15 else repr(float(rng.normal()))
            k = "" if rng.random() < 0.1 else str(int(rng.integers(-5, 50)))
            city = cities[int(rng.integers(0, len(cities)))]
            note = ("" if rng.random() < 0.2 else
                    f"a, b {int(rng.integers(0, 9))}, c")
            flag = ["true", "false", ""][int(rng.integers(0, 3))]
            w.writerow([f"r{i}", x, k, city, note, flag,
                        str(int(rng.integers(0, 2)))])


GEN_SCHEMA = {"id": "ID", "x": "Real", "k": "Integral", "city": "PickList",
              "note": "Text", "flag": "Binary", "y": "RealNN"}


def test_generated_csv_with_missing_and_quoted_commas(tmp_path,
                                                      csv_path_kind):
    path = str(tmp_path / "gen.csv")
    _generated_csv(path)
    tds, jds = _read_both(path, GEN_SCHEMA)
    assert tds.n_rows == 300
    assert np.isnan(tds.column("x")).any()
    assert "New York, NY" in set(tds.column("city"))
    assert_same_dataset(tds, jds)


def test_native_library_is_the_shared_build():
    # both packages resolve the same repo-root csrc/ build
    assert os.path.abspath(tnative._LIB_PATH) == \
        os.path.abspath(jnative._LIB_PATH)


# -- mirrors of tests/test_readers.py ---------------------------------------

MONOID_CASES = [
    ("sum", [1, None, 2.5], 3.5), ("mean", [2, None, 4], 3.0),
    ("min", [3, 1, 2], 1), ("max", [3, 1, 2], 3),
    ("first", ["a", "b"], "a"), ("last", ["a", "b"], "b"),
    ("or", [False, None, True], True), ("and", [True, False], False),
    ("concat", ["a", None, "b"], "a b"),
    ("union", [{"a"}, {"b", "a"}], frozenset({"a", "b"})),
    ("concat_list", [(1,), None, (2, 3)], (1, 2, 3)),
    ("collect", [5, None, 7], (5, 7)), ("mode", ["x", "y", "x"], "x"),
    ("sum", [], None)]


@pytest.mark.parametrize("name,values,want", MONOID_CASES)
def test_monoid_aggregators_match_jax(name, values, want):
    from transmogrifai_tpu.features import aggregators as jagg
    got = agg.by_name(name)(values)
    assert got == want
    assert got == jagg.by_name(name)(values)


def test_merge_map_and_midpoint():
    m = agg.default_for(ft.MultiPickListMap)
    out = m([{"a": ["x"]}, {"a": ["y"], "b": ["z"]}])
    assert out == {"a": frozenset({"x", "y"}), "b": frozenset({"z"})}
    mm = agg.MergeMapAggregator(agg.MeanAggregator())
    assert mm([{"a": 2.0}, {"a": 4.0}]) == {"a": 3.0}
    mid = agg.by_name("midpoint")([(0.0, 0.0, 1.0), (0.0, 90.0, 3.0)])
    assert mid[0] == pytest.approx(0.0, abs=1e-6)
    assert mid[1] == pytest.approx(45.0, abs=1e-6)
    assert mid[2] == pytest.approx(2.0)


def test_default_aggregators_by_type():
    assert isinstance(agg.default_for(ft.Real), agg.SumAggregator)
    assert isinstance(agg.default_for(ft.Binary), agg.OrAggregator)
    assert isinstance(agg.default_for(ft.Date), agg.MaxAggregator)
    assert isinstance(agg.default_for(ft.PickList), agg.ModeAggregator)
    assert isinstance(agg.default_for(ft.Text), agg.ConcatTextAggregator)
    assert isinstance(agg.default_for(ft.MultiPickList),
                      agg.UnionSetAggregator)
    assert isinstance(agg.default_for(ft.Geolocation),
                      agg.GeoMidpointAggregator)
    inner = agg.default_for(ft.RealMap)
    assert isinstance(inner, agg.MergeMapAggregator)
    assert isinstance(inner.inner, agg.SumAggregator)
    with pytest.raises(ValueError):
        agg.by_name("nope")


CSV_TEXT = """id,age,fare,sex,survived,alone
a,22,7.25,male,0,true
b,38,71.28,female,1,false
c,,8.05,female,1,
d,35,53.1,male,0,false
"""


@pytest.fixture
def csv_path(tmp_path):
    p = tmp_path / "toy.csv"
    p.write_text(CSV_TEXT)
    return str(p)


def test_infer_handles_zero_and_inf_tokens(tmp_path):
    p = tmp_path / "z.csv"
    p.write_text("a,b\n0.0,inf\n1.5,x\n")
    schema = infer_csv_schema(str(p))
    assert schema["a"] is ft.Real
    assert issubclass(schema["b"], ft.Text)


def test_datelist_csv_cell_parses_to_ints(tmp_path):
    p = tmp_path / "d.csv"
    p.write_text("d\n100|200\n")
    reader = CSVProductReader(str(p), {"d": ft.DateList})
    f = FeatureBuilder.of(ft.DateList, "d").from_column().as_predictor()
    ds = reader.generate_dataset([f])
    assert ds.raw_value("d", 0) == (100, 200)


def test_csv_product_reader(csv_path):
    schema = {"id": ft.ID, "age": ft.Integral, "fare": ft.Real,
              "sex": ft.PickList, "survived": ft.RealNN, "alone": ft.Binary}
    recs = CSVProductReader(csv_path, schema, key="id").read()
    assert len(recs) == 4
    assert recs[0] == {"id": "a", "age": 22, "fare": 7.25, "sex": "male",
                       "survived": 0.0, "alone": True}
    assert recs[2]["age"] is None and recs[2]["alone"] is None


def test_csv_schema_inference_matches_jax(csv_path):
    from transmogrifai_tpu.readers import infer_csv_schema as j_infer
    schema = infer_csv_schema(csv_path)
    assert schema["age"] is ft.Integral
    assert schema["fare"] is ft.Real
    assert schema["alone"] is ft.Binary
    assert schema["sex"] is ft.PickList
    assert issubclass(schema["id"], ft.Text)
    assert {k: v.__name__ for k, v in schema.items()} == \
        {k: v.__name__ for k, v in j_infer(csv_path).items()}


def test_csv_auto_reader_generates_dataset(csv_path):
    reader = CSVAutoReader(csv_path, key="id", response="survived")
    resp, preds = FeatureBuilder.from_schema(reader.schema, "survived")
    ds = reader.generate_dataset([resp] + preds)
    assert ds.n_rows == 4
    assert ds.ftype("survived") is ft.RealNN
    assert ds.raw_value("fare", 1) == pytest.approx(71.28)


EVENTS = [
    {"user": "u1", "t": 1.0, "amount": 10.0, "label": 0.0, "tag": "a"},
    {"user": "u1", "t": 2.0, "amount": 5.0, "label": 0.0, "tag": "b"},
    {"user": "u1", "t": 9.0, "amount": 99.0, "label": 1.0, "tag": "z"},
    {"user": "u2", "t": 1.5, "amount": 3.0, "label": 0.0, "tag": "a"},
    {"user": "u2", "t": 8.0, "amount": 50.0, "label": 0.0, "tag": "c"},
]


def _agg_features():
    label = FeatureBuilder.of(ft.RealNN, "label").from_column().as_response()
    amount = FeatureBuilder.of(ft.Real, "amount").from_column().as_predictor()
    tags = (FeatureBuilder.of(ft.Text, "tag").from_column()
            .aggregate("concat").as_predictor())
    return label, amount, tags


def test_aggregate_reader_cutoff():
    label, amount, tags = _agg_features()
    reader = DataReaders.aggregate(EVENTS, key="user", time="t",
                                   cutoff=agg.CutOffTime.at(5.0))
    assert isinstance(reader, AggregateDataReader)
    ds = reader.generate_dataset([label, amount, tags])
    assert ds.n_rows == 2
    assert ds.raw_value("amount", 0) == pytest.approx(15.0)
    assert ds.raw_value("tag", 0) == "a b"
    assert ds.raw_value("label", 0) == pytest.approx(1.0)
    assert ds.raw_value("amount", 1) == pytest.approx(3.0)
    assert ds.raw_value("label", 1) == pytest.approx(0.0)
    assert ds.to_pylist("key") == ["u1", "u2"]


def test_aggregate_reader_no_cutoff_folds_everything():
    label, amount, _ = _agg_features()
    ds = DataReaders.aggregate(EVENTS, key="user", time="t").generate_dataset(
        [label, amount])
    assert ds.raw_value("amount", 0) == pytest.approx(114.0)
    assert ds.raw_value("label", 0) == pytest.approx(1.0)


def test_conditional_reader_and_unmatched_keys():
    label, amount, _ = _agg_features()
    reader = DataReaders.conditional(
        EVENTS, key="user", time="t",
        target_condition=lambda r: r["amount"] >= 50.0)
    assert isinstance(reader, ConditionalDataReader)
    ds = reader.generate_dataset([label, amount])
    assert ds.n_rows == 2
    assert ds.raw_value("amount", 0) == pytest.approx(15.0)
    assert ds.raw_value("label", 0) == pytest.approx(1.0)
    assert ds.raw_value("amount", 1) == pytest.approx(3.0)
    ds = DataReaders.conditional(
        EVENTS, key="user", time="t",
        target_condition=lambda r: r["tag"] == "z").generate_dataset(
            [label, amount])
    assert ds.n_rows == 1


def test_joined_readers():
    left = DataReader([{"id": "a", "x": 1.0}, {"id": "b", "x": 2.0}],
                      key="id")
    right = DataReader([{"id": "a", "y": 10.0}], key="id")
    assert JoinedDataReader(left, right).read() == \
        [{"id": "a", "x": 1.0, "y": 10.0}, {"id": "b", "x": 2.0}]
    right = DataReader([{"id": "a", "y": 10.0}, {"id": "c", "y": 30.0}],
                       key="id")
    inner = JoinedDataReader(left, right, join_type="inner").read()
    assert [r["id"] for r in inner] == ["a"]
    outer = JoinedDataReader(left, right, join_type="outer").read()
    assert sorted(r["id"] for r in outer) == ["a", "b", "c"]
    with pytest.raises(ValueError):
        JoinedDataReader(left, right, join_type="cross")


def test_workflow_trains_from_reader(csv_path):
    from transmogrifai_tpu_torch import models as M
    from transmogrifai_tpu_torch.ops.transmogrifier import transmogrify
    from transmogrifai_tpu_torch.workflow import Workflow

    schema = {"id": ft.ID, "age": ft.Real, "fare": ft.Real,
              "sex": ft.PickList, "survived": ft.RealNN, "alone": ft.Binary}
    reader = DataReaders.csv(csv_path, schema, key="id")
    resp, preds = FeatureBuilder.from_schema(
        {k: v for k, v in schema.items() if k != "id"}, "survived")
    pred = M.BinaryClassificationModelSelector.with_train_validation_split(
        candidates=[["LogisticRegression", {"regParam": [0.1]}]]
    ).set_input(resp, transmogrify(preds)).output
    model = Workflow([pred]).train(data=reader, device="cpu")
    scored = model.score(reader)
    assert scored.n_rows == 4
    assert all(0.0 <= r["probability_1"] <= 1.0
               for r in scored.to_pylist(pred.name))
