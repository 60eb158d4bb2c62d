"""The port's vectorizers and transmogrify against the JAX package.

Each vectorizer class is fitted in both packages on the same data (made
from a numpy seed): the fitted params, the manifests and the
transformed columns must be BITWISE equal, and so must the row path.
The executor's fused device block (the Real/Binary impute stages of one
layer) must equal the JAX package's ``_fused_transform`` bitwise in
f32, and both must equal the host transform. ``transmogrify`` on the
Titanic schema yields the same slots in the same order, and every other
feature type takes the JAX package's encoder chain. The rest mirrors
``tests/test_vectorizers.py`` on the port's classes.
"""
import numpy as np
import pytest
import torch

import transmogrifai_tpu.ops as jops
from transmogrifai_tpu import Dataset as JDataset
from transmogrifai_tpu import FeatureBuilder as JFB
from transmogrifai_tpu.features import types as jft
from transmogrifai_tpu_torch import ops
from transmogrifai_tpu_torch.dataset import Dataset
from transmogrifai_tpu_torch.features import types as ft
from transmogrifai_tpu_torch.features.feature import FeatureBuilder
from transmogrifai_tpu_torch.features.manifest import (NULL_INDICATOR,
                                                       OTHER_INDICATOR)
from transmogrifai_tpu_torch.stages import stage_from_json, stage_to_json


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


def feat(name, t):
    return FeatureBuilder.of(t, name).from_column().as_predictor()


def _column(kind, rng, n=257):
    if kind == "Real":
        v = rng.normal(3.0, 2.0, n)
        return [None if rng.random() < 0.15 else float(x) for x in v]
    if kind == "Integral":
        return [None if rng.random() < 0.1 else int(x)
                for x in rng.integers(-20, 20, n)]
    if kind == "Binary":
        return [None if rng.random() < 0.2 else bool(rng.random() < 0.4)
                for _ in range(n)]
    if kind == "PickList":
        return [None if rng.random() < 0.1 else f"v{int(rng.integers(0, 30))}"
                for _ in range(n)]
    if kind == "MultiPickList":
        return [frozenset(f"t{int(t)}" for t in
                          rng.integers(0, 12, int(rng.integers(0, 4))))
                for _ in range(n)]
    if kind == "Text":
        words = ["alpha", "beta", "gamma", "delta", "eps", "zeta", "eta"]
        return [None if rng.random() < 0.1 else " ".join(
            rng.choice(words, int(rng.integers(1, 6))))
            + f" w{int(rng.integers(0, 200))}" for _ in range(n)]
    if kind == "Date":
        return [None if rng.random() < 0.1 else int(x)
                for x in rng.integers(0, 10 ** 12, n)]
    if kind == "Geolocation":
        return [None if rng.random() < 0.1 else
                (float(rng.uniform(-80, 80)), float(rng.uniform(-170, 170)),
                 float(rng.integers(1, 6))) for _ in range(n)]
    raise KeyError(kind)


# (class, input type, kwargs)
CASES = [
    ("RealVectorizer", "Real", {}),
    ("RealVectorizer", "Integral", {"fill_with": "median"}),
    ("RealVectorizer", "Real", {"fill_with": "constant", "fill_value": 2.5,
                                "track_nulls": False}),
    ("BinaryVectorizer", "Binary", {}),
    ("OneHotVectorizer", "PickList", {"top_k": 7}),
    ("OneHotVectorizer", "PickList", {"min_support": 12,
                                      "other_track": False}),
    ("MultiPickListVectorizer", "MultiPickList", {"top_k": 5}),
    ("TextHashingVectorizer", "Text", {"num_bins": 16}),
    ("SmartTextVectorizer", "Text", {"max_cardinality": 300}),
    ("SmartTextVectorizer", "Text", {"max_cardinality": 5, "num_bins": 8}),
    ("DateToUnitCircle", "Date", {"time_period": "DayOfWeek"}),
    ("GeolocationVectorizer", "Geolocation", {}),
]


def _reset_uids():
    from transmogrifai_tpu.features.feature import reset_uids as j_reset
    from transmogrifai_tpu_torch.features.feature import reset_uids
    j_reset()
    reset_uids()


def _fit(pkg_ops, FB, Ds, types, cls, kind, kw, values):
    _reset_uids()
    f = FB.of(getattr(types, kind), "x").from_column().as_predictor()
    ds = Ds.from_dict({"x": values}, {"x": getattr(types, kind)})
    est = getattr(pkg_ops, cls)(**kw).set_input(f)
    model = est.fit(ds) if hasattr(est, "fit") else est
    out = model.transform(ds)
    return model, out


@pytest.mark.parametrize("cls,kind,kw", CASES,
                         ids=[f"{c}-{k}-{i}" for i, (c, k, _)
                              in enumerate(CASES)])
def test_vectorizer_bitwise_parity_with_jax(cls, kind, kw):
    values = _column(kind, np.random.default_rng(11))
    jm, jout = _fit(jops, JFB, JDataset, jft, cls, kind, kw, values)
    tm, tout = _fit(ops, FeatureBuilder, Dataset, ft, cls, kind, kw,
                    values)
    assert type(tm).__name__ == type(jm).__name__
    assert tm.stage_params_json() == jm.stage_params_json()
    name = tm.output.name
    assert name == jm.output.name
    a, b = tout.column(name), jout.column(name)
    assert a.dtype == b.dtype == np.float32
    assert np.array_equal(a, b)
    assert tout.manifest(name).to_json() == jout.manifest(name).to_json()
    # the row path agrees with the batch path, in both packages
    tv = ft.FeatureTypeFactory.by_name(kind)
    jv = jft.FeatureTypeFactory.by_name(kind)
    for i in (0, 1, 5, 17):
        row = tm.transform_value(tv(values[i])).value
        assert row == jm.transform_value(jv(values[i])).value
        assert np.array_equal(np.asarray(row, np.float32), a[i])


def test_vectors_combiner_parity_and_manifest_state():
    rng = np.random.default_rng(3)
    cols = {"a": _column("Real", rng), "b": _column("PickList", rng)}
    got = []
    for pkg_ops, FB, Ds, types in ((jops, JFB, JDataset, jft),
                                   (ops, FeatureBuilder, Dataset, ft)):
        fa = FB.of(types.Real, "a").from_column().as_predictor()
        fb = FB.of(types.PickList, "b").from_column().as_predictor()
        ds = Ds.from_dict(cols, {"a": types.Real, "b": types.PickList})
        ma, ds = pkg_ops.RealVectorizer().set_input(fa).fit_transform(ds)
        mb, ds = pkg_ops.OneHotVectorizer().set_input(fb).fit_transform(ds)
        comb = pkg_ops.VectorsCombiner().set_input(ma.output, mb.output)
        out = comb.transform(ds)
        got.append((comb, out.column(comb.output.name),
                    out.manifest(comb.output.name)))
    (jc, ja, jman), (tc, ta, tman) = got
    assert np.array_equal(ta, ja)
    assert tman.to_json() == jman.to_json()
    # the combiner caches its manifest for persistence, as in JAX
    assert tc.manifest.to_json() == jc.manifest.to_json()
    assert stage_from_json(stage_to_json(tc)).manifest.to_json() == \
        tman.to_json()
    # the device concat equals the host concat bitwise
    blocks = [torch.from_numpy(ds_col) for ds_col in (
        ta[:, :2], ta[:, 2:])]
    assert torch.equal(tc.make_device_fn()(*blocks), torch.from_numpy(ta))


def test_fused_device_block_matches_jax_fused_transform():
    """The executor's fused layer block (Real + Binary impute stages)
    is bitwise the JAX package's jitted block and the host path."""
    from transmogrifai_tpu.executor import _fused_transform as j_fused
    from transmogrifai_tpu_torch.executor import _fused_transform, _fusable
    rng = np.random.default_rng(5)
    data = {"r": _column("Real", rng), "i": _column("Integral", rng),
            "b": _column("Binary", rng)}
    kinds = {"r": "Real", "i": "Integral", "b": "Binary"}
    outs = []
    for pkg_ops, FB, Ds, types in ((jops, JFB, JDataset, jft),
                                   (ops, FeatureBuilder, Dataset, ft)):
        ds = Ds.from_dict(data, {k: getattr(types, v)
                                 for k, v in kinds.items()})
        models = []
        for k, v in kinds.items():
            f = FB.of(getattr(types, v), k).from_column().as_predictor()
            if v == "Binary":
                models.append(pkg_ops.BinaryVectorizer().set_input(f))
            else:
                models.append(pkg_ops.RealVectorizer().set_input(f).fit(ds))
        outs.append((models, ds))
    (jms, jds), (tms, tds) = outs
    assert all(_fusable(m, tds) for m in tms)
    jout = j_fused(jms, jds)
    tout = _fused_transform(tms, tds, torch.device("cpu"))
    for jm, tm in zip(jms, tms):
        name = tm.output.name
        assert tout[name].dtype == np.float32
        assert np.array_equal(tout[name], np.asarray(jout[jm.output.name]))
        host = tm.transform(tds).column(name)
        assert np.array_equal(tout[name], host)


def _titanic_vector(pkg):
    import importlib
    m = importlib.import_module
    types = m(pkg + ".features.types")
    feature = m(pkg + ".features.feature")
    feature.reset_uids()
    schema = {"pclass": "PickList", "sex": "PickList", "age": "Real",
              "sibSp": "Integral", "parCh": "Integral", "fare": "Real",
              "cabin": "PickList", "embarked": "PickList"}
    preds = [feature.FeatureBuilder.of(getattr(types, t), n)
             .from_column().as_predictor() for n, t in schema.items()]
    fv = m(pkg + ".ops.transmogrifier").transmogrify(preds)
    import os
    reader = m(pkg + ".readers").DataReaders.csv(
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "examples", "data", "titanic.csv"),
        {"id": types.ID, **{k: getattr(types, v) for k, v in schema.items()},
         "survived": types.RealNN}, key="id")
    wf = m(pkg + ".workflow").Workflow([fv])
    kw = {"device": "cpu"} if pkg.endswith("torch") else {}
    model = wf.train(reader, **kw)
    ds = model.transform(reader)
    return fv, ds.column(fv.name), ds.manifest(fv.name)


def test_transmogrify_titanic_same_slots_in_same_order():
    jfv, ja, jman = _titanic_vector("transmogrifai_tpu")
    tfv, ta, tman = _titanic_vector("transmogrifai_tpu_torch")
    assert tfv.name == jfv.name
    assert tman.column_names() == jman.column_names()
    assert tman.to_json() == jman.to_json()
    assert np.array_equal(ta, ja)
    assert ta.shape == (891, len(tman))


@pytest.mark.parametrize("kind,module", [
    ("Email", "ops.parsers"), ("URL", "ops.parsers"),
    ("Phone", "ops.parsers"), ("DateList", "ops.parsers"),
    ("TextArea", "ops.lda"), ("TextList", "ops.text_advanced"),
    ("RealMap", "ops.maps"), ("PickListMap", "ops.maps")])
def test_later_slice_types_take_the_jax_encoder_chain(kind, module):
    # the types a later slice brought now dispatch to the JAX package's
    # encoder chain, reaching ``module``: the same stage classes in the
    # same order as the JAX package's transmogrify
    _reset_uids()
    f = feat("x", getattr(ft, kind))
    out = ops.transmogrify([f])
    _reset_uids()
    jf = JFB.of(getattr(jft, kind), "x").from_column().as_predictor()
    jout = jops.transmogrify([jf])

    def chain(v):
        stages, todo = [], [v]
        while todo:
            g = todo.pop()
            if g.origin_stage is not None:
                stages.append(g.origin_stage)
                todo += list(g.parents)
        return stages

    got, want = chain(out), chain(jout)
    assert [type(s).__name__ for s in got] == [type(s).__name__
                                               for s in want]
    assert [s.params for s in got] == [s.params for s in want]
    assert any(type(s).__module__ == f"transmogrifai_tpu_torch.{module}"
               for s in got)


def test_other_entry_points_are_ported():
    # transmogrify_sparse is ported (ops/sparse.py): the hashed indices
    # and the dense vector
    hashed, dense = ops.transmogrify_sparse([feat("x", ft.PickList),
                                             feat("y", ft.Real)])
    assert issubclass(hashed.wtype, ft.SparseIndices)
    assert issubclass(dense.wtype, ft.OPVector)
    # tokenizing with a language (ops.analyzers) and with detection
    # (ops.text_advanced) is ported: the JAX package's tokens
    for lang in ("en", "auto"):
        assert ops.tokenize("The quick foxes", language=lang, stem=True) \
            == jops.tokenize("The quick foxes", language=lang, stem=True)
    # the bare regex split is ported
    assert ops.tokenize("Hello, World!") == ["hello", "world"]
    # sensitive-name detection (ops.ner_data's lexicons) is ported
    m = ops.SmartTextVectorizer(sensitive_feature_mode="detect_only") \
        .set_input(feat("t", ft.Text)).fit(Dataset.from_dict(
            {"t": ["Ann Lee", "Bob Ray"]}, {"t": ft.Text}))
    assert m is not None
    # smart text routes TextArea with textarea='smart'
    st = ops.default_vectorizer(feat("d", ft.TextArea), textarea="smart")
    assert type(st).__name__ == "SmartTextVectorizer"


# -- mirrors of tests/test_vectorizers.py -----------------------------------

def test_real_vectorizer_mean_impute_and_null_track():
    f = feat("x", ft.Real)
    ds = Dataset.from_dict({"x": [1.0, None, 3.0]}, {"x": ft.Real})
    model, out = ops.RealVectorizer(fill_with="mean").set_input(f) \
        .fit_transform(ds)
    np.testing.assert_allclose(out.column(model.output.name),
                               [[1, 0], [2, 1], [3, 0]])
    assert out.manifest(model.output.name).column_names() == \
        ["x_value", f"x_{NULL_INDICATOR}"]
    assert model.transform_value(ft.Real(None)).value == (2.0, 1.0)


def test_binary_vectorizer():
    f = feat("b", ft.Binary)
    ds = Dataset.from_dict({"b": [True, None, False]}, {"b": ft.Binary})
    t = ops.BinaryVectorizer().set_input(f)
    np.testing.assert_allclose(t.transform(ds).column(t.output.name),
                               [[1, 0], [0, 1], [0, 0]])


def test_onehot_topk_other_null():
    f = feat("c", ft.PickList)
    vals = ["a"] * 5 + ["b"] * 3 + ["c"] * 1 + [None]
    ds = Dataset.from_dict({"c": vals}, {"c": ft.PickList})
    model, out = ops.OneHotVectorizer(top_k=2).set_input(f).fit_transform(ds)
    assert out.manifest(model.output.name).column_names() == [
        "c_a", "c_b", f"c_{OTHER_INDICATOR}", f"c_{NULL_INDICATOR}"]
    arr = out.column(model.output.name)
    assert arr[0].tolist() == [1, 0, 0, 0]
    assert arr[8].tolist() == [0, 0, 1, 0]
    assert arr[9].tolist() == [0, 0, 0, 1]
    assert stage_from_json(stage_to_json(model)).params["labels"] == \
        ["a", "b"]


def test_text_hashing_deterministic():
    f = feat("t", ft.Text)
    ds = Dataset.from_dict({"t": ["hello world hello", None]},
                           {"t": ft.Text})
    t = ops.TextHashingVectorizer(num_bins=8).set_input(f)
    arr = t.transform(ds).column(t.output.name)
    assert arr[0].sum() == 3.0
    assert arr[1][8] == 1.0
    t2 = ops.TextHashingVectorizer(num_bins=8).set_input(f)
    np.testing.assert_array_equal(arr,
                                  t2.transform(ds).column(t2.output.name))


def test_smart_text_switches_mode_and_persists():
    f = feat("t", ft.Text)
    low = Dataset.from_dict({"t": ["a", "b", "a", None]}, {"t": ft.Text})
    assert ops.SmartTextVectorizer(max_cardinality=5).set_input(f) \
        .fit(low).params["mode"] == "pivot"
    high = Dataset.from_dict({"t": [f"word{i} filler" for i in range(50)]},
                             {"t": ft.Text})
    m2 = ops.SmartTextVectorizer(max_cardinality=5, num_bins=16) \
        .set_input(f).fit(high)
    assert m2.params["mode"] == "hash"
    assert m2.transform(high).column(m2.output.name).shape[1] == 17
    loaded = stage_from_json(stage_to_json(m2))
    np.testing.assert_array_equal(
        loaded.transform(high).column(loaded.output.name),
        m2.transform(high).column(m2.output.name))


def test_date_unit_circle_and_geolocation():
    day_ms = 24 * 3600_000
    ds = Dataset.from_dict({"d": [0, day_ms // 4, None]}, {"d": ft.Date})
    t = ops.DateToUnitCircle(time_period="HourOfDay") \
        .set_input(feat("d", ft.Date))
    arr = t.transform(ds).column(t.output.name)
    np.testing.assert_allclose(arr[0], [0.0, 1.0, 0.0], atol=1e-12)
    np.testing.assert_allclose(arr[1], [1.0, 0.0, 0.0], atol=1e-7)
    assert arr[2].tolist() == [0.0, 0.0, 1.0]
    ds = Dataset.from_dict({"g": [(0.0, 0.0, 1.0), None]},
                           {"g": ft.Geolocation})
    model, out = ops.GeolocationVectorizer() \
        .set_input(feat("g", ft.Geolocation)).fit_transform(ds)
    arr = out.column(model.output.name)
    np.testing.assert_allclose(arr[0], [1, 0, 0, 0], atol=1e-7)
    np.testing.assert_allclose(arr[1], [1, 0, 0, 1], atol=1e-7)


def test_feature_dsl_vectorize_and_transmogrify():
    out = feat("x", ft.Real).vectorize(track_nulls=False)
    assert out.wtype is ft.OPVector
    assert out.origin_stage.params["track_nulls"] is False
    with pytest.raises(TypeError):
        feat("x", ft.Real).vectorize(bogus_param=1)
    resp = FeatureBuilder.RealNN("y").from_column().as_response()
    with pytest.raises(ValueError):
        ops.transmogrify([resp])
    fv = feat("a", ft.Real).transmogrify(feat("b", ft.PickList))
    assert type(fv.origin_stage).__name__ == "VectorsCombiner"


def _pivot_col(rng, n=600):
    vals = []
    for _ in range(n):
        r = rng.random()
        vals.append(None if r < 0.08 else "" if r < 0.12
                    else f"c{int(rng.integers(0, 40))}")
    return np.array(vals, dtype=object)


def test_onehot_and_multipicklist_vectorized_bitwise_parity():
    rng = np.random.default_rng(0)
    col = _pivot_col(rng)
    for labels in ([f"c{j}" for j in range(25)], []):
        for tn in (True, False):
            for ot in (True, False):
                m = ops.OneHotModel(labels=labels, track_nulls=tn,
                                    other_track=ot)
                assert np.array_equal(m._vectorize(col),
                                      m._vectorize_rows(col))
    tags = [f"t{j}" for j in range(30)]
    col = np.array(
        [None if rng.random() < 0.1 else frozenset(
            str(t) for t in rng.choice(tags, rng.integers(0, 5),
                                       replace=False))
         for _ in range(500)], dtype=object)
    for labels in ([f"t{j}" for j in range(15)], []):
        m = ops.MultiPickListModel(labels=labels)
        assert np.array_equal(m._vectorize(col), m._vectorize_rows(col))


def test_tm_vectorize_env_restores_seed_loops(monkeypatch):
    col = _pivot_col(np.random.default_rng(1), n=120)
    ds = Dataset({"c": col}, {"c": ft.PickList})
    f = feat("c", ft.PickList)
    monkeypatch.setenv("TM_VECTORIZE", "0")
    m0, out0 = ops.OneHotVectorizer().set_input(f).fit_transform(ds)
    monkeypatch.setenv("TM_VECTORIZE", "1")
    m1, out1 = ops.OneHotVectorizer().set_input(f).fit_transform(ds)
    assert m0.params["labels"] == m1.params["labels"]
    assert np.array_equal(out0.column(m0.output.name),
                          out1.column(m1.output.name))


def test_portable_constructors_still_build_the_merged_classes():
    """A portable artifact's stages are the fitted classes themselves,
    wired to column names."""
    m = ops.RealVectorizerModel(fill_value=1.5, track_nulls=True) \
        .wire(["x"], "x_vec")
    assert m.input_names == ["x"] and m.output_name == "x_vec"
    out = m.make_device_fn()(torch.tensor([1.0, float("nan")]))
    assert out.tolist() == [[1.0, 0.0], [1.5, 1.0]]
    c = ops.VectorsCombiner().wire(["a", "b"], "ab")
    assert c.input_names == ["a", "b"]
