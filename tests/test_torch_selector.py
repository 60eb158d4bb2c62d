"""The port's evaluators, validator and ModelSelector against the JAX
package's on the CPU.

Tolerances, and why: the metric kernels agree within 1e-6 (f32 sums and
scans in another order), ties included; splitters and fold masks are
numpy copies and agree exactly; the selector on the XOR data picks the
same winner, and its per-grid-point validation metrics agree within
1e-6 for the decision tree (integer-valued stats, bitwise growth under
``TM_KERNEL_EXACT=1``), within 0.01 for the boosted families (near-tied
splits may flip after the first round, see test_torch_trees.py) and
within 0.05 for the forest (each package draws its own bootstrap; 32
trees keep that spread small).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transmogrifai_tpu import models as JM
from transmogrifai_tpu.evaluators import functional as JF
from transmogrifai_tpu.models import tuning as JTU
from transmogrifai_tpu_torch import models as TM
from transmogrifai_tpu_torch.evaluators import functional as TF
from transmogrifai_tpu_torch.models import tuning as TTU

TREES = ["DecisionTreeClassifier", "RandomForestClassifier",
         "GBTClassifier", "XGBoostClassifier"]
FAMILIES = ("DecisionTreeClassifier", "RandomForestClassifier",
            "GBTClassifier", "XGBoostClassifier")


@pytest.fixture(autouse=True)
def small_caps():
    saved = []
    for reg in (JM.MODEL_FAMILIES, TM.MODEL_FAMILIES):
        for name in FAMILIES:
            fam = reg[name]
            saved.append((fam, fam.n_bins, fam.max_depth_cap,
                          getattr(fam, "n_trees_cap", None),
                          getattr(fam, "n_rounds_cap", None)))
            fam.n_bins, fam.max_depth_cap = 16, 4
            if hasattr(fam, "n_trees_cap"):
                fam.n_trees_cap = 8
            if hasattr(fam, "n_rounds_cap"):
                fam.n_rounds_cap = 10
    yield
    for fam, b, d, t, r in saved:
        fam.n_bins, fam.max_depth_cap = b, d
        if t is not None:
            fam.n_trees_cap = t
        if r is not None:
            fam.n_rounds_cap = r


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# Evaluators
# ---------------------------------------------------------------------------

def _binary_case(seed, ties):
    rng = np.random.default_rng(seed)
    n = 500
    y = (rng.random(n) < 0.4).astype(np.float32)
    s = np.clip(0.3 * y + 0.7 * rng.random(n), 0, 1).astype(np.float32)
    if ties:
        s = np.round(s * 8) / 8           # leaves score alike: many ties
    w = rng.integers(0, 3, size=n).astype(np.float32)
    return s, y, w


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_binary_metrics_match_jax(ties, weighted):
    s, y, w = _binary_case(int(ties) + 2 * int(weighted), ties)
    jw = jnp.asarray(w) if weighted else None
    tw = _t(w) if weighted else None
    ref = {k: float(v) for k, v in JF.binary_metrics(
        jnp.asarray(s), jnp.asarray(y), jw).items()}
    got = {k: float(v) for k, v in TF.binary_metrics(_t(s), _t(y),
                                                     tw).items()}
    assert set(got) == set(ref)
    for k in ref:     # LogLoss is NaN in both at a score of exactly 1
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    assert float(TF.auroc(_t(s), _t(y), tw)) == pytest.approx(
        float(JF.auroc(jnp.asarray(s), jnp.asarray(y), jw)), abs=1e-6)
    assert float(TF.aupr(_t(s), _t(y), tw)) == pytest.approx(
        float(JF.aupr(jnp.asarray(s), jnp.asarray(y), jw)), abs=1e-6)


def test_multiclass_and_regression_metrics_match_jax():
    rng = np.random.default_rng(4)
    p = rng.random((300, 4)).astype(np.float32)
    p /= p.sum(1, keepdims=True)
    y = rng.integers(0, 4, size=300)
    w = rng.random(300).astype(np.float32)
    ref = JF.multiclass_metrics(jnp.asarray(p), jnp.asarray(y),
                                jnp.asarray(w))
    got = TF.multiclass_metrics(_t(p), _t(y), _t(w))
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    pred = rng.normal(size=300).astype(np.float32)
    tgt = (pred + rng.normal(size=300)).astype(np.float32)
    ref = JF.regression_metrics(jnp.asarray(pred), jnp.asarray(tgt),
                                jnp.asarray(w))
    got = TF.regression_metrics(_t(pred), _t(tgt), _t(w))
    for k in ref:
        assert float(got[k]) == pytest.approx(float(ref[k]), rel=1e-5), k


@pytest.mark.parametrize("metric", sorted(TTU._METRIC_FNS))
def test_validation_metric_fns_match_jax(metric):
    rng = np.random.default_rng(len(metric))
    k = 2 if metric in ("auroc", "aupr", "brier", "rmse", "r2") else 3
    p = rng.random((200, k)).astype(np.float32)
    p /= p.sum(1, keepdims=True)
    y = rng.integers(0, k, size=200).astype(np.float32)
    if metric in ("rmse", "r2"):
        y = rng.normal(size=200).astype(np.float32)
    w = (rng.random(200) < 0.5).astype(np.float32)
    ref = float(JTU._METRIC_FNS[metric][0](jnp.asarray(p), jnp.asarray(y),
                                           jnp.asarray(w)))
    got = float(TTU._METRIC_FNS[metric][0](_t(p), _t(y), _t(w)))
    assert got == pytest.approx(ref, rel=1e-6, abs=1e-6)
    assert TTU._METRIC_FNS[metric][1] == JTU._METRIC_FNS[metric][1]


# ---------------------------------------------------------------------------
# Splitters and the fold x grid batch
# ---------------------------------------------------------------------------

def test_splitters_and_fold_batch_match_jax():
    rng = np.random.default_rng(0)
    y = (rng.random(1000) < 0.05).astype(np.float32)
    for spec in ({}, {"type": "balancer", "mode": "resample"},
                 {"type": "cutter"}, {"type": "splitter"}):
        js = JTU.make_splitter(spec, 7, default_kind="balancer")
        ts = TTU.make_splitter(spec, 7, default_kind="balancer")
        for a, b in zip(js.split(1000), ts.split(1000)):
            np.testing.assert_array_equal(a, b)
        (jw, jsum), (tw, tsum) = js.prepare(y), ts.prepare(y)
        np.testing.assert_array_equal(jw, tw)
        assert jsum.to_json() == tsum.to_json()
    for a, b in zip(JTU.make_fold_masks(500, 3, 9),
                    TTU.make_fold_masks(500, 3, 9)):
        np.testing.assert_array_equal(a, b)
    grid = JM.MODEL_FAMILIES["GBTClassifier"].make_grid()
    assert grid == TM.MODEL_FAMILIES["GBTClassifier"].make_grid()
    tm, vm = TTU.make_fold_masks(100, 3)
    for a, b in zip(JTU.build_fold_grid_batch(grid, tm, vm)[:2],
                    TTU.build_fold_grid_batch(grid, tm, vm)[:2]):
        np.testing.assert_array_equal(a, b)
    jh = JTU.build_fold_grid_batch(grid, tm, vm)[2]
    th = TTU.build_fold_grid_batch(grid, tm, vm)[2]
    assert sorted(jh) == sorted(th)
    for k in jh:
        np.testing.assert_array_equal(np.asarray(jh[k]), th[k])


# ---------------------------------------------------------------------------
# The selector
# ---------------------------------------------------------------------------

def _xor_ds(pkg, seed=0, n=200):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4)).astype(np.float32)
    y = ((X[:, 0] > 0) ^ (X[:, 1] > 0)).astype(np.float32)
    if pkg == "jax":
        from transmogrifai_tpu import Dataset, FeatureBuilder
        from transmogrifai_tpu.features import types as ft
    else:
        from transmogrifai_tpu_torch.dataset import Dataset
        from transmogrifai_tpu_torch.features import FeatureBuilder
        from transmogrifai_tpu_torch.features import types as ft
    lbl = FeatureBuilder.of(ft.RealNN, "y").from_column().as_response()
    vec = FeatureBuilder.OPVector("x").from_column().as_predictor()
    ds = Dataset({"y": y.astype(np.float64), "x": X},
                 {"y": ft.RealNN, "x": ft.OPVector})
    return ds, lbl, vec


def test_selector_matches_jax_on_xor(monkeypatch):
    monkeypatch.setenv("TM_KERNEL_EXACT", "1")
    for reg in (JM.MODEL_FAMILIES, TM.MODEL_FAMILIES):
        reg["RandomForestClassifier"].n_trees_cap = 32
    ds, lbl, vec = _xor_ds("jax")
    jsel = JM.BinaryClassificationModelSelector.with_cross_validation(
        n_folds=3, candidates=TREES).set_input(lbl, vec)
    jmodel, _ = jsel.fit_transform(ds)
    ds, lbl, vec = _xor_ds("torch")
    tsel = TM.BinaryClassificationModelSelector.with_cross_validation(
        n_folds=3, candidates=TREES, device="cpu").set_input(lbl, vec)
    tmodel, out = tsel.fit_transform(ds)
    js, ts = jmodel.summary, tmodel.summary
    assert ts["bestModel"]["family"] == js["bestModel"]["family"]
    assert ts["bestModel"]["hyper"] == js["bestModel"]["hyper"]
    tol = {"DecisionTreeClassifier": 1e-6, "GBTClassifier": 0.01,
           "XGBoostClassifier": 0.01, "RandomForestClassifier": 0.05}
    for jr, tr in zip(js["validationResults"], ts["validationResults"]):
        assert tr["family"] == jr["family"] and tr["grid"] == jr["grid"]
        np.testing.assert_allclose(tr["gridMetrics"], jr["gridMetrics"],
                                   atol=tol[jr["family"]],
                                   err_msg=jr["family"])
    for k in ("splitterSummary", "dataCounts", "validationType"):
        assert ts[k] == js[k]
    assert ts["holdoutEvaluation"]["AuROC"] == pytest.approx(
        js["holdoutEvaluation"]["AuROC"], abs=0.02)
    assert set(ts["wallSeconds"]["families"]) == set(TREES)
    col = out.column(tmodel.output.name)
    assert len(col) == 200 and 0.0 <= col[0]["probability_1"] <= 1.0


def test_stacked_candidates_match_their_own_validation(monkeypatch):
    """Candidates of one family stack into one folded batch; each gets
    the metrics it gets when validated alone (an instance's fit does
    not depend on its batch)."""
    monkeypatch.setenv("TM_KERNEL_EXACT", "1")
    ds, lbl, vec = _xor_ds("torch", seed=1)
    cands = [["DecisionTreeClassifier", {"maxDepth": [2.0]}],
             ["DecisionTreeClassifier", {"maxDepth": [4.0]}]]

    def metrics(candidates):
        model = TM.BinaryClassificationModelSelector.with_cross_validation(
            candidates=candidates, device="cpu").set_input(lbl, vec).fit(ds)
        return [r["gridMetrics"] for r in model.summary["validationResults"]]

    assert metrics(cands) == metrics(cands[:1]) + metrics(cands[1:])


def test_unported_families_and_knobs_raise(monkeypatch):
    """The linear families are ported: LR and NaiveBayes candidates, and
    the default list, construct; LR and NaiveBayes fit beside a tree.
    The unknown family and the per-instance tree path still raise."""
    ds, lbl, vec = _xor_ds("torch")
    sel = TM.BinaryClassificationModelSelector.with_cross_validation(
        candidates=["LogisticRegression", "NaiveBayes",
                    "DecisionTreeClassifier"], device="cpu")
    model = sel.set_input(lbl, vec).fit(ds)
    assert [r["family"] for r in model.summary["validationResults"]] == [
        "LogisticRegression", "NaiveBayes", "DecisionTreeClassifier"]
    default = TM.BinaryClassificationModelSelector.with_cross_validation()
    assert [c for c, _ in default.params["candidates"]] == [
        c for c, _ in JM.BinaryClassificationModelSelector
        .with_cross_validation().params["candidates"]]
    with pytest.raises(ValueError, match="unknown model family"):
        TM.BinaryClassificationModelSelector.with_cross_validation(
            candidates=["FTTransformerClassifier"])
    monkeypatch.setenv("TM_TREE_GRID_FOLD", "0")
    with pytest.raises(NotImplementedError, match="TM_TREE_GRID_FOLD=0"):
        TM.BinaryClassificationModelSelector.with_cross_validation(
            candidates=["GBTClassifier"])
    TM.BinaryClassificationModelSelector.with_cross_validation(
        candidates=["LogisticRegression"])


def test_selector_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds, lbl, vec = _xor_ds("torch")
    sel = TM.BinaryClassificationModelSelector.with_cross_validation(
        candidates=["DecisionTreeClassifier"]).set_input(lbl, vec)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sel.fit(ds)


def test_out_of_memory_retries_in_halved_chunks(monkeypatch):
    """A CUDA out-of-memory on the whole batch re-runs it in 2, 4, then 8
    sequential chunks; the chunks' metrics equal the whole batch's (an
    instance's fit does not depend on its batch)."""
    monkeypatch.setenv("TM_KERNEL_EXACT", "1")
    fam = TM.MODEL_FAMILIES["DecisionTreeClassifier"]
    rng = np.random.default_rng(2)
    X = rng.normal(size=(150, 3)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    grid = fam.make_grid({"maxDepth": [2.0, 3.0, 4.0]})
    v = TTU.OpCrossValidation(n_folds=3)
    ref = v.validate(fam, grid, X, y, np.ones(150, np.float32), 2, "cpu")
    real = type(fam).fit_eval_grid
    sizes = []

    def flaky(self, X, y, w, tr, va, hy, n_classes, metric_fn):
        sizes.append(tr.shape[0])
        if tr.shape[0] > 3:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
        return real(self, X, y, w, tr, va, hy, n_classes, metric_fn)

    monkeypatch.setattr(type(fam), "fit_eval_grid", flaky)
    got = v.validate(fam, grid, X, y, np.ones(150, np.float32), 2, "cpu")
    assert sizes[:2] == [9, 5] and max(sizes[2:]) <= 3
    np.testing.assert_array_equal(got.grid_metrics, ref.grid_metrics)
    assert got.best_index == ref.best_index

    def broken(self, *a, **k):
        raise ValueError("host-side bug mentioning OOM")

    monkeypatch.setattr(type(fam), "fit_eval_grid", broken)
    with pytest.raises(ValueError, match="host-side"):
        v.validate(fam, grid, X, y, np.ones(150, np.float32), 2, "cpu")
