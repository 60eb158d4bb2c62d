"""The port's ModelInsights and RecordInsightsLOCO against the JAX
package.

``model_insights`` of the same fitted model (a Titanic workflow trained
and saved by the JAX package, loaded by each) must give the same report:
the same keys, features, contributions and checker statistics. LOCO's
per-record deltas for an LR and a GBT model (the JAX package's fitted
parameters in both) must agree within 1e-5 (each package sums its
predict in its own order), with the same top groups. Also mirrors the
insights and LOCO cases of ``tests/test_workflow.py``.
"""
import json

import numpy as np
import pytest

from test_torch_workflow import JAX, PORT


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


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A JAX-trained Titanic workflow (LR + GBT candidates), saved."""
    out = {}
    for fam, grid in (("LogisticRegression", {"regParam": [0.01]}),
                      ("GBTClassifier", {"maxIter": [4], "maxDepth": [3]})):
        wf, _ = JAX.titanic(candidates=[[fam, grid]], folds=2)
        model = JAX.train(wf)
        path = str(tmp_path_factory.mktemp(fam) / "model")
        model.save(path)
        out[fam] = path
    return out


def _norm(doc):
    return json.loads(json.dumps(doc, sort_keys=True, default=str))


@pytest.mark.parametrize("family", ["LogisticRegression", "GBTClassifier"])
def test_model_insights_equal_jax(saved, family):
    jm = JAX.load(saved[family])
    tm = PORT.load(saved[family])
    j = _norm(jm.model_insights())
    t = _norm(tm.model_insights())
    assert sorted(t) == sorted(j)
    assert t["features"] == j["features"]
    assert t["sanityCheckerSummary"] == j["sanityCheckerSummary"]
    assert t["trainingParams"] == j["trainingParams"]
    assert t["label"] == j["label"]
    assert t["selectedModelInfo"] == j["selectedModelInfo"]
    assert sorted(t["stageInfo"]) == sorted(j["stageInfo"])
    for uid, info in j["stageInfo"].items():
        assert t["stageInfo"][uid]["operation"] == info["operation"]
        assert t["stageInfo"][uid]["output"] == info["output"]
    contrib = [d["contribution"] for f in t["features"]
               for d in f["derivedFeatures"] if not d.get("excluded")]
    assert any(any(c) for c in contrib)


def _loco_both(path, top_k=4):
    from transmogrifai_tpu.insights import RecordInsightsLOCO as JLOCO
    from transmogrifai_tpu_torch.insights import RecordInsightsLOCO as TLOCO
    out = []
    for pkg, cls in ((JAX, JLOCO), (PORT, TLOCO)):
        m = pkg.load(path)
        sel = m.selected_model()
        vec_name = sel.input_names[1]
        vec = next(st.output for st in m.stages
                   if st.output.name == vec_name)
        loco = cls(sel, top_k=top_k).set_input(vec)
        ds = m.transform(pkg.reader())
        X = ds.column(vec_name).astype(np.float32)
        keys, masks = loco._group_masks(ds, X.shape[1])
        out.append((loco, ds, X, keys, masks))
    return out


@pytest.mark.parametrize("family", ["LogisticRegression", "GBTClassifier"])
def test_loco_deltas_match_jax(saved, family):
    import jax
    import jax.numpy as jnp
    (jl, jds, jX, jkeys, jmasks), (tl, tds, tX, tkeys, tmasks) = \
        _loco_both(saved[family])
    assert tkeys == jkeys
    assert np.array_equal(tmasks, jmasks)
    assert np.array_equal(tX, jX)
    # the JAX package's deltas, as its transform computes them
    fam = jl.model.family
    params = jax.tree.map(jnp.asarray, jl.model.model_params)
    n_classes = jl.model.params["n_classes"]
    base = fam.predict_kernel(params, jnp.asarray(jX), n_classes)
    ref = np.stack([np.asarray(base - fam.predict_kernel(
        params, jnp.asarray(jX * (1.0 - m)[None, :]), n_classes))
        for m in jmasks])
    got = tl._deltas(tX, tmasks)
    assert got.shape == ref.shape == (len(tkeys), len(tX), 2)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    # the records' top groups agree wherever the ranking is not a tie
    jcol = jl.transform(jds).column(jl.output.name)
    tcol = tl.transform(tds).column(tl.output.name)
    score = np.abs(ref).max(axis=2).T                     # (n, G)
    for i in range(len(tcol)):
        s = np.sort(score[i])[::-1]
        if np.all(np.diff(s[:5]) < -1e-4):
            assert list(tcol[i]) == list(jcol[i])
            for k in tcol[i]:
                np.testing.assert_allclose(json.loads(tcol[i][k]),
                                           json.loads(jcol[i][k]),
                                           rtol=0, atol=2e-5)


def test_loco_chunks_groups_without_changing_results(saved, monkeypatch):
    from transmogrifai_tpu_torch import insights
    _, (tl, tds, tX, tkeys, tmasks) = _loco_both(saved["GBTClassifier"])
    whole = tl._deltas(tX, tmasks)
    monkeypatch.setattr(insights, "LOCO_CHUNK_ELEMENTS", tX.size * 3)
    # three groups a call instead of all: torch's CPU kernels round a
    # row by the batch around it, so only the last bits may move
    np.testing.assert_allclose(tl._deltas(tX, tmasks), whole, rtol=0,
                               atol=1e-6)


def test_loco_persists_with_its_model(saved, tmp_path):
    from transmogrifai_tpu_torch.stages import stage_from_json, stage_to_json
    _, (tl, tds, tX, tkeys, tmasks) = _loco_both(saved["LogisticRegression"])
    loaded = stage_from_json(json.loads(json.dumps(
        stage_to_json(tl), default=float)))
    assert np.array_equal(loaded._deltas(tX, tmasks), tl._deltas(tX, tmasks))
    assert loaded.to("cpu") is loaded


def test_sparse_loco_is_not_ported():
    from transmogrifai_tpu_torch.insights import SparseRecordInsightsLOCO
    with pytest.raises(NotImplementedError, match="models.sparse"):
        SparseRecordInsightsLOCO()


# -- mirrors of tests/test_workflow.py's insights cases ---------------------

def test_model_insights_report():
    wf, pred = PORT.titanic(
        candidates=[["LogisticRegression", {"regParam": [0.01]}]], folds=2)
    ins = PORT.train(wf).model_insights()
    names = {f["featureName"] for f in ins["features"]}
    assert {"age", "fare", "sex", "pclass"} <= names
    sex = next(f for f in ins["features"] if f["featureName"] == "sex")
    assert any(d["contribution"] for d in sex["derivedFeatures"])
    assert ins["selectedModelInfo"]["bestModel"]["family"] == \
        "LogisticRegression"
    assert ins["label"]["labelName"] == "survived"


def test_loco_record_insights():
    from transmogrifai_tpu_torch.insights import RecordInsightsLOCO
    wf, pred = PORT.titanic(
        candidates=[["LogisticRegression", {"regParam": [0.01]}]], folds=2)
    model = PORT.train(wf)
    sel = model.selected_model()
    checked = next(st.output for st in model.stages
                   if st.output.name == sel.input_names[1])
    loco = RecordInsightsLOCO(sel, top_k=3).set_input(checked)
    col = loco.transform(model.transform(PORT.reader())).column(
        loco.output.name)
    assert len(col) == 891
    assert 0 < len(col[0]) <= 3
    hits = sum(1 for r in col if any(k.startswith("sex") for k in r))
    assert hits > len(col) * 0.5
