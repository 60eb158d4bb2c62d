"""The port's ``filters/`` (``RawFeatureFilter``, ``FeatureDistribution``)
and its wiring into ``Workflow`` against the JAX package, and the JAX
package's ``tests/test_filters.py`` case for case on the port.

The filter is host code: on the same raw rows both packages must keep
the same features and return the same summary JSON (fill rates, JS
divergences, null-label correlations, exclusion reasons, train
distributions), and a workflow trained with ``with_raw_feature_filter``
must record that summary under ``rawFeatureFilter``, prune the same
features and raise when a result feature is removed.
"""
import json

import numpy as np
import pytest

from torch_mirror import (load_mirror, mirror_cases, port_on_cpu,  # noqa
                          run_mirror_case)
from torch_parity import build, reset_uids

PKGS = ("transmogrifai_tpu", "transmogrifai_tpu_torch")


def _cols(n=240, seed=0):
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < 0.5).astype(float)
    return {
        "label": ("RealNN", [float(v) for v in y]),
        "good": ("Real", [float(v) for v in rng.normal(size=n)]),
        "sparse": ("Real", [float(v) if rng.random() < 0.02 else None
                            for v in rng.normal(size=n)]),
        "leaky": ("Real", [None if v > 0.5 else 1.0 for v in y]),
        "cat": ("PickList", [str(rng.choice(["a", "b", "c"]))
                             for _ in range(n)]),
        "txt": ("Text", [None if rng.random() < 0.3 else
                         " ".join(rng.choice(["x", "y", "zz"], 3))
                         for _ in range(n)]),
        "m": ("RealMap", [{"k": float(v)} if rng.random() < 0.5 else {}
                          for v in rng.normal(size=n)]),
    }


def _filter(pkg, kw, cols, score_cols=None):
    import importlib
    filt = importlib.import_module(f"{pkg}.filters")
    reset_uids()
    ds, feats = build(pkg, cols, response="label")
    if score_cols is not None:
        kw = dict(kw, score_data=build(pkg, score_cols, "label")[0])
    kept, summary = filt.RawFeatureFilter(**kw).filter_features(
        list(feats.values()), ds)
    return [f.name for f in kept], summary


@pytest.mark.parametrize("kw", [
    {"min_fill_rate": 0.1},
    {"min_fill_rate": 0.001, "max_correlation": 0.9},
    {"min_fill_rate": 0.05, "max_js_divergence": 0.3, "scored": True},
    {"min_fill_rate": 0.05, "protected_features": ["sparse"]},
], ids=["fill", "correlation", "drift", "protected"])
def test_raw_feature_filter_matches_jax(kw):
    kw = dict(kw)
    score = None
    if kw.pop("scored", False):
        score = _cols(seed=5)
        score["good"] = ("Real", [v + 3.0 for v in score["good"][1]])
    out = [_filter(pkg, kw, _cols(), score) for pkg in PKGS]
    assert out[1][0] == out[0][0]
    assert json.dumps(out[1][1], sort_keys=True) == json.dumps(
        out[0][1], sort_keys=True)


def test_feature_distribution_matches_jax():
    import transmogrifai_tpu.filters as J
    import transmogrifai_tpu_torch.filters as P
    from transmogrifai_tpu.features import types as jft
    from transmogrifai_tpu_torch.features import types as ft
    rng = np.random.default_rng(3)
    a = rng.normal(0, 1, 500)
    a[::7] = np.nan
    b = rng.normal(0.4, 1.2, 500)
    ja = J.FeatureDistribution.compute("x", a, jft.Real, bins=20)
    ta = P.FeatureDistribution.compute("x", a, ft.Real, bins=20)
    assert ta.to_json() == ja.to_json()
    edges = ja.shared_edges(20)
    assert np.array_equal(ta.shared_edges(20), edges)
    jb = J.FeatureDistribution.compute("x", b, jft.Real, bins=20,
                                       edges=edges)
    tb = P.FeatureDistribution.compute("x", b, ft.Real, bins=20,
                                       edges=edges)
    assert ta.js_divergence(tb) == ja.js_divergence(jb)
    assert ta.merge(tb).to_json() == ja.merge(jb).to_json()
    assert P.FeatureDistribution.from_json(ja.to_json()).to_json() \
        == ja.to_json()


def _workflow(pkg, device_kw):
    import importlib
    M = importlib.import_module(f"{pkg}.models")
    ops = importlib.import_module(f"{pkg}.ops")
    W = importlib.import_module(f"{pkg}.workflow")
    reset_uids()
    ds, feats = build(pkg, _cols(), response="label")
    fv = ops.transmogrify([feats[n] for n in ("good", "sparse", "leaky",
                                              "cat", "txt", "m")])
    pred = M.BinaryClassificationModelSelector.with_train_validation_split(
        candidates=[["LogisticRegression", {"regParam": [0.1]}]]
    ).set_input(feats["label"], fv).output
    wf = W.Workflow([pred]).with_raw_feature_filter(min_fill_rate=0.05,
                                                    max_correlation=0.9)
    model = wf.train(data=ds, **device_kw)
    return model, model.score(ds).column(pred.name), pred


def test_workflow_filter_summary_and_scores_match_jax():
    jm, jscores, _ = _workflow(PKGS[0], {})
    tm, tscores, _ = _workflow(PKGS[1], {"device": "cpu"})
    js, ts = (m.train_summaries["rawFeatureFilter"] for m in (jm, tm))
    assert json.dumps(ts, sort_keys=True) == json.dumps(js, sort_keys=True)
    assert set(ts["exclusionReasons"]) == {"sparse", "leaky"}
    assert [f.name for f in tm.raw_features] == [f.name
                                                 for f in jm.raw_features]
    jp = np.array([r["probability_1"] for r in jscores])
    tp = np.array([r["probability_1"] for r in tscores])
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-6)


def test_filter_removing_a_result_feature_raises():
    from transmogrifai_tpu_torch.workflow import Workflow
    reset_uids()
    ds, feats = build(PKGS[1], _cols(), response="label")
    wf = Workflow([feats["sparse"]]).with_raw_feature_filter(
        min_fill_rate=0.5)
    with pytest.raises(ValueError, match="result features depend"):
        wf.train(data=ds, device="cpu")


MIRROR = load_mirror("test_filters.py")


@pytest.mark.parametrize("name,kwargs", mirror_cases(MIRROR))
def test_filters_case_on_the_port(name, kwargs, request, port_on_cpu):
    run_mirror_case(MIRROR, name, kwargs, request)
