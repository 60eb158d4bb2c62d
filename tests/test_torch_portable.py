"""Weights carried across: models trained by the JAX package, exported
as portable artifacts, loaded by the port on the CPU and scored by its
FusedScorer — against the JAX FusedScorer and the JAX package's numpy
portable runtime (atol 1e-5: f32 arithmetic in another order). The
bucket slicing and padding helpers must be identical to the JAX ones.
"""
import json
import os

import numpy as np
import pytest
import torch

from tests.serving_util import train_small_serving_model
from transmogrifai_tpu import portable as jportable
from transmogrifai_tpu import workflow as jworkflow
from transmogrifai_tpu.portable_export import export_portable
from transmogrifai_tpu_torch import portable as tportable
from transmogrifai_tpu_torch import workflow as tworkflow
from transmogrifai_tpu_torch.resilience.atomic import IncompleteArtifactError

BUCKETS = (8, 32)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Two trained models (the fused-serving suite's seeds), each with
    its JAX scorer, its portable export dir and its training data."""
    out = []
    for seed in (11, 23):
        model, ds, pred = train_small_serving_model(seed)
        path = str(tmp_path_factory.mktemp(f"art{seed}"))
        export_portable(model, path, buckets=BUCKETS)
        out.append((model, ds, pred, path))
    return out


def _columns(ds, lo, hi, with_label=False):
    return {k: ds.column(k)[lo:hi] for k in ds.column_names
            if with_label or k != "label"}


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("lo,hi", [(0, 1), (0, 8), (3, 40), (0, 300)])
def test_port_scores_match_jax(artifacts, which, lo, hi):
    model, ds, pred, path = artifacts[which]
    cols = _columns(ds, lo, hi)
    port = tportable.load(path, device="cpu").compile_scoring(
        buckets=BUCKETS)
    got = port.score_arrays(cols)[pred]
    jax_sc = model.compile_scoring(buckets=BUCKETS)
    from transmogrifai_tpu.dataset import Dataset
    ref = jax_sc.score_arrays(Dataset(
        {k: ds.column(k)[lo:hi] for k in ds.column_names},
        {k: ds.ftype(k) for k in ds.column_names}))[pred]
    numpy_rt = jportable.load(path).score_columns(cols)[pred]
    assert got.shape == ref.shape == (hi - lo, 2)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(got, numpy_rt, atol=1e-5)
    # the label column is a response: present or absent, same scores
    with_label = port.score_arrays(_columns(ds, lo, hi, True))[pred]
    np.testing.assert_array_equal(with_label, got)
    assert port.stats.total_rows == 2 * (hi - lo)


def test_scorer_exposes_what_fusion_reads(artifacts):
    model, _ds, pred, path = artifacts[0]
    port = tportable.load(path, device="cpu").compile_scoring(
        buckets=BUCKETS)
    jax_sc = model.compile_scoring(buckets=BUCKETS)
    assert port.boundary == jax_sc.boundary
    assert port._response_boundary == jax_sc._response_boundary
    assert port.result_names == jax_sc.result_names == [pred]
    assert port.buckets == jax_sc.buckets == BUCKETS
    assert [o for _, _, o in port.device_infos] == \
        [o for _, _, o in jax_sc.device_infos]
    assert type(port.device_stage_by_output[pred]).__name__ == \
        "PredictionModel"
    assert port.device == torch.device("cpu")


@pytest.mark.parametrize("ladder", [(8, 32), (64,), (1, 2, 4), None, True,
                                    (16, 64), (3, 5, 1000)])
def test_bucket_slices_identical_to_jax(ladder):
    class _Stub:
        pass

    for n in list(range(0, 70)) + [127, 128, 129, 1000, 32768, 70001]:
        t, j = _Stub(), _Stub()
        t.buckets = tworkflow._normalize_buckets(ladder)
        j.buckets = jworkflow._normalize_buckets(ladder)
        assert t.buckets == j.buckets
        assert list(tworkflow.FusedScorer._bucket_slices(t, n)) == \
            list(jworkflow.FusedScorer._bucket_slices(j, n))


@pytest.mark.parametrize("shape,dtype", [((0,), np.float32),
                                         ((1,), np.float32),
                                         ((5,), np.int32),
                                         ((7, 3), np.float64),
                                         ((16,), np.int64)])
def test_pad_rows_identical_to_jax(shape, dtype):
    rng = np.random.default_rng(0)
    col = (rng.normal(size=shape) * 100).astype(dtype)
    for rows in (shape[0], shape[0] + 1, 16, 64):
        if rows < shape[0]:
            continue
        a = tworkflow._pad_rows(col, rows)
        b = jworkflow._pad_rows(col, rows)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_normalize_buckets_errors_match_jax():
    assert tworkflow.DEFAULT_SCORE_BUCKETS == jworkflow.DEFAULT_SCORE_BUCKETS
    for bad in ((), (0, 4), (-1,)):
        with pytest.raises(ValueError):
            tworkflow._normalize_buckets(bad)
        with pytest.raises(ValueError):
            jworkflow._normalize_buckets(bad)


def test_flatten_tree_matches_jax():
    tree = {"b": [np.arange(3), {"c": np.float32(2.0)}], "a": np.eye(2)}
    flat = tportable.flatten_tree(tree)
    assert flat.keys() == jportable.flatten_tree(tree).keys()
    back = tportable.unflatten_tree(flat)
    np.testing.assert_array_equal(back["b"][0], np.arange(3))
    np.testing.assert_array_equal(back["a"], np.eye(2))


def test_boundary_preparation_rules(artifacts):
    """Floats -> f32, integers -> int32, an absent response -> zeros,
    an absent predictor or a ragged request -> a loud error."""
    _model, ds, _pred, path = artifacts[0]
    port = tportable.load(path, device="cpu").compile_scoring(
        buckets=BUCKETS)
    cols = _columns(ds, 0, 4)
    cols["x1"] = np.array([1, 2, 3, 4], np.int64)
    n, vals = port._boundary_host(cols)
    by = dict(zip(port.boundary, vals))
    assert n == 4 and by["x0"].dtype == np.float32
    assert by["x1"].dtype == np.int32
    np.testing.assert_array_equal(by["label"], np.zeros(4, np.float32))
    with pytest.raises(ValueError, match="'x2' missing"):
        port._boundary_host({k: v for k, v in cols.items() if k != "x2"})
    cols["x3"] = cols["x3"][:2]
    with pytest.raises(ValueError, match="'x3' has 2 rows"):
        port._boundary_host(cols)
    with pytest.raises(TypeError):
        port._boundary_host([1, 2, 3])


def test_from_portable_rejects_what_the_slice_lacks(artifacts):
    _model, _ds, _pred, path = artifacts[0]
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    arrays = tportable.load(path, device="cpu").arrays
    # a host prefix is metadata, as in the JAX runtime: the chain loads
    host = dict(manifest, hostPrefix=["SmartTextVectorizerModel"])
    assert tportable.from_portable(host, arrays, "cpu").boundary == \
        manifest["boundary"]
    stages = [dict(s) for s in manifest["stages"]]
    stages[-1]["family"] = "FTTransformerClassifier"
    with pytest.raises(ValueError, match="'FTTransformerClassifier' is not "
                                         "ported"):
        tportable.from_portable(dict(manifest, stages=stages), arrays, "cpu")
    stages[-1] = {"out": "o", "inputs": ["a", "b"], "op": "lda_topics"}
    with pytest.raises(ValueError, match="op 'lda_topics' is not"):
        tportable.from_portable(dict(manifest, stages=stages), arrays, "cpu")
    with pytest.raises(ValueError, match="unsupported portable format"):
        tportable.from_portable(dict(manifest, format=2), arrays, "cpu")


def test_load_requires_the_success_sentinel(artifacts, tmp_path):
    _model, _ds, _pred, path = artifacts[0]
    for f in ("manifest.json", "params.npz"):
        (tmp_path / f).write_bytes(open(os.path.join(path, f), "rb").read())
    with pytest.raises(IncompleteArtifactError, match="_SUCCESS"):
        tportable.load(str(tmp_path), device="cpu")
    (tmp_path / "_SUCCESS").write_text("")
    assert tportable.load(str(tmp_path), device="cpu").result_names


def test_model_to_rebuilds_on_another_device(artifacts):
    _model, _ds, _pred, path = artifacts[0]
    pm = tportable.load(path, device="cpu")
    assert pm.to("cpu") is pm
    # keep_cols persists its indices as a list (the JAX package's
    # param); its device function gathers on the device of its input
    keep = pm.stages[-2].params["keep_indices"]
    assert keep and all(type(i) is int for i in keep)
    vec = torch.arange(2.0 * (max(keep) + 1)).reshape(2, -1)
    out = pm.stages[-2].make_device_fn()(None, vec)
    assert out.device.type == "cpu" and out.dtype == torch.float32
    assert out[0].tolist() == [float(i) for i in keep]
    beta = pm.stages[-1].model_params["beta"]
    assert beta.dtype == torch.float32 and beta.device.type == "cpu"


def test_jax_exported_gbt_artifact_scores_alike(tmp_path, monkeypatch):
    """A tree family's predict loads through the port's registry: a
    GBT workflow trained and exported by the JAX package scores the same
    in both packages (atol 1e-5: f32 sums in another order)."""
    from transmogrifai_tpu import Dataset, FeatureBuilder
    from transmogrifai_tpu import models as M
    from transmogrifai_tpu.features import types as ft
    from transmogrifai_tpu.ops.transmogrifier import transmogrify
    from transmogrifai_tpu.workflow import Workflow
    fam = M.MODEL_FAMILIES["GBTClassifier"]
    for attr, small in (("n_bins", 16), ("max_depth_cap", 3),
                        ("n_rounds_cap", 6)):
        monkeypatch.setattr(fam, attr, small)
    rng = np.random.default_rng(3)
    n = 240
    cols = {f"x{i}": np.where(rng.random(n) < 0.05, np.nan,
                              rng.normal(size=n)) for i in range(4)}
    cols["label"] = ((np.nan_to_num(cols["x0"]) > 0)
                     ^ (np.nan_to_num(cols["x1"]) > 0)).astype(np.float64)
    schema = {f"x{i}": ft.Real for i in range(4)}
    schema["label"] = ft.RealNN
    ds = Dataset({k: np.asarray(v, np.float64) for k, v in cols.items()},
                 schema)
    label = FeatureBuilder.of(ft.RealNN, "label").from_column().as_response()
    preds = [FeatureBuilder.of(ft.Real, f"x{i}").from_column().as_predictor()
             for i in range(4)]
    pred = M.BinaryClassificationModelSelector.with_cross_validation(
        n_folds=2, candidates=[["GBTClassifier", {"maxDepth": [3.0],
                                                  "stepSize": [0.3]}]]
    ).set_input(label, transmogrify(preds)).output
    model = Workflow([pred]).train(ds)
    export_portable(model, str(tmp_path), buckets=BUCKETS)
    port = tportable.load(str(tmp_path), device="cpu")
    assert port.stages[-1].params["family"] == "GBTClassifier"
    assert port.stages[-1].model_params["feat"].dtype == torch.int64
    data = {k: v for k, v in cols.items() if k != "label"}
    got = port.compile_scoring(buckets=BUCKETS).score_arrays(data)[pred.name]
    ref = jportable.load(str(tmp_path)).score_columns(data)[pred.name]
    jax_sc = model.compile_scoring(buckets=BUCKETS).score_arrays(ds)[pred.name]
    assert got.shape == (n, 2)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(got, jax_sc, atol=1e-5)


@pytest.mark.parametrize("family,problem,grid", [
    ("NaiveBayes", "binary", None),
    ("GeneralizedLinearRegression", "regression", {"familyLink": [1.0]}),
    ("GeneralizedLinearRegression", "regression", {"familyLink": [0.0]})])
def test_jax_exported_linear_head_artifact_scores_alike(tmp_path, family,
                                                        problem, grid):
    """A NaiveBayes or GLM head loads through the port's registry: a
    workflow trained and exported by the JAX package scores the same in
    both packages (atol 1e-5: f32 sums in another order)."""
    from transmogrifai_tpu import Dataset, FeatureBuilder
    from transmogrifai_tpu import models as M
    from transmogrifai_tpu.features import types as ft
    from transmogrifai_tpu.ops.transmogrifier import transmogrify
    from transmogrifai_tpu.workflow import Workflow
    rng = np.random.default_rng(4)
    n = 240
    cols = {f"x{i}": np.where(rng.random(n) < 0.05, np.nan,
                              rng.normal(size=n)) for i in range(4)}
    x0 = np.nan_to_num(cols["x0"])
    cols["label"] = ((x0 > 0).astype(np.float64) if problem == "binary"
                     else np.exp(0.4 * x0 + 0.2 * rng.normal(size=n)))
    schema = {f"x{i}": ft.Real for i in range(4)}
    schema["label"] = ft.RealNN
    ds = Dataset({k: np.asarray(v, np.float64) for k, v in cols.items()},
                 schema)
    label = FeatureBuilder.of(ft.RealNN, "label").from_column().as_response()
    preds = [FeatureBuilder.of(ft.Real, f"x{i}").from_column().as_predictor()
             for i in range(4)]
    factory = (M.BinaryClassificationModelSelector if problem == "binary"
               else M.RegressionModelSelector)
    pred = factory.with_cross_validation(
        n_folds=2, candidates=[[family, grid]]
    ).set_input(label, transmogrify(preds)).output
    model = Workflow([pred]).train(ds)
    export_portable(model, str(tmp_path), buckets=BUCKETS)
    port = tportable.load(str(tmp_path), device="cpu")
    assert port.stages[-1].params["family"] == family
    data = {k: v for k, v in cols.items() if k != "label"}
    got = port.compile_scoring(buckets=BUCKETS).score_arrays(data)[pred.name]
    ref = jportable.load(str(tmp_path)).score_columns(data)[pred.name]
    jax_sc = model.compile_scoring(buckets=BUCKETS).score_arrays(ds)[pred.name]
    assert got.shape == ref.shape == (n, 2 if problem == "binary" else 1)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, jax_sc, atol=1e-5, rtol=1e-5)
