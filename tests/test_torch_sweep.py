"""The port's validation sweep (``models/tuning.py``) and the selector
around it, against the JAX package's on the CPU and against itself.

Mirrors ``tests/test_sweep_fusion.py``: fused-exact bitwise against the
serial validator, the default (specialized, fold-sliced) sweep against
serial, ragged key sets, batch-length and batch-content invariance
(bitwise: what the selector's resume relies on), ``split_static_hyper``
and ``fold_slice_batch`` equal to the JAX package's, sliced against
masked, the GLM's static link against its traced one, and the selector
fused against serial. Then the three default selectors against the JAX
package's, LR alone on Titanic's numeric columns, the selector's
candidate-level resume and the out-of-memory halving of a sweep batch.

Tolerances, and why: the fused default deviates from serial only by
what static specialization and fold slicing move (the order of
summation, a FISTA tail run as a no-op): grid metrics within 1e-4
relative / 1e-6 absolute, as the JAX package states for itself. Against
the JAX package the linear families' grid metrics agree within 1e-5
(the same f32 fits in another order of summation, measured up to
6e-8). The tree families keep the tolerances of test_torch_selector.py
on the binary AUROC: the decision tree within 1e-6 (exact mode), the
boosted families within 0.01 (near-tied splits may go either way after
the first round) and the forest within 0.05 (each package draws its
own bootstrap). On the multiclass error (~100 validation rows a fold,
so a row that changes class moves it by ~0.01) the boosted families
within 0.03 and the forest within 0.06 (measured 0.017 and 0.035); on
the regression RMSE, relative, the boosted families within 0.02 and
the forest within 0.06 (measured 0.010 and 0.052).
"""
import csv
import json
import os

import numpy as np
import pytest
import torch

from transmogrifai_tpu import models as JM
from transmogrifai_tpu.models import tuning as JTU
from transmogrifai_tpu_torch import models as TM
from transmogrifai_tpu_torch import parallel as TP
from transmogrifai_tpu_torch.models import tuning as TTU
from transmogrifai_tpu_torch.parallel import get_mesh
from transmogrifai_tpu_torch.resilience import faults

LINEAR_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: the suite runs several
    workers at once, and torch's intra-op threads on these small tensors
    only add contention (half the CPU time of the default threads here)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
#: per problem: (decision tree, boosted, forest); regression relative
TREE_TOL = {"binary": (1e-6, 0.01, 0.05), "multiclass": (1e-6, 0.03, 0.06),
            "regression": (1e-6, 0.02, 0.06)}


def _tolerance(problem, family):
    """(atol, rtol) of a family's grid metrics against the JAX package."""
    dt, boosted, forest = TREE_TOL[problem]
    tol = (dt if family.startswith("DecisionTree") else
           boosted if family.startswith(("GBT", "XGBoost")) else
           forest if family.startswith("RandomForest") else None)
    if tol is None:
        return LINEAR_TOL, 0.0
    return (0.0, tol) if problem == "regression" and tol > 1e-6 else (tol,
                                                                       0.0)


@pytest.fixture(autouse=True)
def clean_knobs(monkeypatch):
    for k in ("TM_SWEEP_FUSION", "TM_SWEEP_EXACT", "TM_SWEEP_FOLD_SLICE",
              "TM_TREE_GRID_FOLD", "TM_MESH_AXIS"):
        monkeypatch.delenv(k, raising=False)
    yield monkeypatch
    faults.reset()


@pytest.fixture()
def lr_data():
    rng = np.random.default_rng(0)
    n, d = 320, 10
    X = rng.normal(size=(n, d)).astype(np.float32)
    beta = rng.normal(size=d).astype(np.float32)
    y = (X @ beta + rng.normal(size=n) > 0).astype(np.float32)
    return X, y, np.ones(n, np.float32)


def _entries(F=TM.MODEL_FAMILIES):
    lr, nb = F["LogisticRegression"], F["NaiveBayes"]
    return [
        ("0:LR", lr, lr.make_grid({"regParam": [0.01, 0.1],
                                   "elasticNetParam": [0.0]})),
        ("1:LR", lr, lr.make_grid({"regParam": [1.0],
                                   "elasticNetParam": [0.0]})),
        ("2:NB", nb, nb.make_grid(None)),
    ]


def _fused(cv, entries, X, y, w, k=2):
    return {key: cv.collect(p) for key, p in
            cv.dispatch_many(entries, X, y, w, k, device="cpu").items()}


def test_resolve_sweep_mode_and_knobs(clean_knobs):
    """The sweep knobs read as in the JAX package."""
    assert TTU.resolve_sweep_mode() == "fused"
    for v, want in (("0", "serial"), ("serial", "serial"), ("1", "fused"),
                    ("on", "fused")):
        clean_knobs.setenv("TM_SWEEP_FUSION", v)
        assert TTU.resolve_sweep_mode() == want == JTU.resolve_sweep_mode()
    clean_knobs.setenv("TM_SWEEP_FUSION", "bogus")
    with pytest.raises(ValueError, match="unknown sweep mode"):
        TTU.resolve_sweep_mode()
    for knobs in ({}, {"TM_SWEEP_FOLD_SLICE": "0"}, {"TM_SWEEP_EXACT": "1"},
                  {"TM_SWEEP_EXACT": "0", "TM_SWEEP_FOLD_SLICE": "1"}):
        for k in ("TM_SWEEP_FOLD_SLICE", "TM_SWEEP_EXACT"):
            clean_knobs.delenv(k, raising=False)
        for k, v in knobs.items():
            clean_knobs.setenv(k, v)
        assert TTU.fold_sliced() == JTU.fold_sliced()
        assert TTU.sweep_exact() == JTU.sweep_exact()


def test_fused_exact_bitwise_vs_serial_validator(lr_data, clean_knobs):
    """TM_SWEEP_EXACT=1: the fused cross-candidate batch slices into
    per-candidate metrics bitwise-equal to one dispatch per candidate."""
    clean_knobs.setenv("TM_SWEEP_EXACT", "1")
    X, y, w = lr_data
    cv = TTU.OpCrossValidation(n_folds=3, metric="auroc")
    legacy = {key: cv.validate(fam, grid, X, y, w, 2, device="cpu")
              for key, fam, grid in _entries()}
    fused = _fused(cv, _entries(), X, y, w)
    for key in legacy:
        assert np.array_equal(legacy[key].grid_metrics,
                              fused[key].grid_metrics), key
        assert legacy[key].best_index == fused[key].best_index


def test_fused_default_equivalent_and_specialized(lr_data):
    X, y, w = lr_data
    cv = TTU.OpCrossValidation(n_folds=3, metric="auroc")
    legacy = {key: cv.validate(fam, grid, X, y, w, 2, device="cpu")
              for key, fam, grid in _entries()}
    fused = _fused(cv, _entries(), X, y, w)
    for key in legacy:
        np.testing.assert_allclose(legacy[key].grid_metrics,
                                   fused[key].grid_metrics, rtol=1e-4,
                                   atol=1e-6)
        assert legacy[key].best_index == fused[key].best_index
    from transmogrifai_tpu_torch.profiling import SWEEP_STATS
    labels = set(SWEEP_STATS.snapshot())
    assert ("sweep/LogisticRegression/auroc/k2/static"
            "{'elasticNetParam': 0.0}/sliced") in labels
    assert "serial/LogisticRegression/auroc/k2" in labels


def test_ragged_hyper_key_sets_split_groups(lr_data, clean_knobs):
    """Same-family candidates whose grids carry different key sets do
    not share a batch; each still matches the serial validator."""
    clean_knobs.setenv("TM_SWEEP_EXACT", "1")
    X, y, w = lr_data
    lr = TM.MODEL_FAMILIES["LogisticRegression"]
    entries = [
        ("0:LR+extra", lr, lr.make_grid({"regParam": [0.01],
                                         "elasticNetParam": [0.0],
                                         "customKey": [0.5, 1.0]})),
        ("1:LR", lr, lr.make_grid({"regParam": [0.01, 0.1],
                                   "elasticNetParam": [0.0]})),
    ]
    cv = TTU.OpCrossValidation(n_folds=3, metric="auroc")
    legacy = {key: cv.validate(fam, grid, X, y, w, 2, device="cpu")
              for key, fam, grid in entries}
    for order in (entries, entries[::-1]):
        fused = _fused(cv, order, X, y, w)
        for key in legacy:
            assert np.array_equal(legacy[key].grid_metrics,
                                  fused[key].grid_metrics), key


@pytest.mark.parametrize("metric", ["auroc", "logloss"])
def test_batch_length_invariance(lr_data, metric):
    """A candidate's metrics do not depend on which siblings shared its
    batch (a resumed selector re-dispatches a smaller one)."""
    X, y, w = lr_data
    cv = TTU.OpCrossValidation(n_folds=2, metric=metric)
    full = _fused(cv, _entries(), X, y, w)["1:LR"]
    solo = _fused(cv, _entries()[1:2], X, y, w)["1:LR"]
    assert np.array_equal(full.grid_metrics, solo.grid_metrics)


def test_split_static_hyper_matches_jax(clean_knobs):
    for F, fn in ((JM.MODEL_FAMILIES, JTU.split_static_hyper),
                  (TM.MODEL_FAMILIES, TTU.split_static_hyper)):
        lr, nb = F["LogisticRegression"], F["NaiveBayes"]
        traced, static = fn(lr, {"regParam": np.asarray([0.01, 0.1]),
                                 "elasticNetParam": np.zeros(2)})
        assert static == (("elasticNetParam", 0.0),)
        assert set(traced) == {"regParam"}
        traced, static = fn(lr, {"regParam": np.asarray([0.01, 0.1]),
                                 "elasticNetParam": np.asarray([0.0, 0.5])})
        assert static == () and set(traced) == {"regParam",
                                                 "elasticNetParam"}
        traced, static = fn(nb, {"smoothing": np.ones(3)})
        assert static == () and set(traced) == {"smoothing"}
        glm = F["GeneralizedLinearRegression"]
        traced, static = fn(glm, {"familyLink": np.ones(2),
                                  "variancePower": np.ones(2)})
        assert len(traced) == 1 and len(static) == 1     # one stays traced
    clean_knobs.setenv("TM_SWEEP_EXACT", "1")
    traced, static = TTU.split_static_hyper(
        TM.MODEL_FAMILIES["LogisticRegression"],
        {"regParam": np.ones(2), "elasticNetParam": np.zeros(2)})
    assert static == ()


@pytest.mark.parametrize("n,folds,g", [(11, 2, 3), (40, 3, 1), (7, 3, 2)])
def test_fold_slice_batch_matches_jax(n, folds, g):
    train_m, val_m = TTU.make_fold_masks(n, folds, seed=0)
    got = TTU.fold_slice_batch(train_m, val_m, g)
    want = JTU.fold_slice_batch(train_m, val_m, g)
    for a, b in zip(got, want):
        for x, z in zip(a, b):
            assert x.dtype == z.dtype
            np.testing.assert_array_equal(x, z)


def test_fold_slice_batch_layout():
    train_m, val_m = TTU.make_fold_masks(11, 2, seed=0)
    (tr_i, tr_ok), (va_i, va_ok) = TTU.fold_slice_batch(train_m, val_m, 3)
    assert tr_i.shape == tr_ok.shape and tr_i.shape[0] == 6
    for f in range(2):
        rows = np.flatnonzero(train_m[f])
        for j in range(3):
            item = f * 3 + j
            assert np.array_equal(tr_i[item, :len(rows)], rows)
            assert tr_ok[item, :len(rows)].all()
            assert not tr_ok[item, len(rows):].any()
    counts = np.zeros(11)
    for f in range(2):
        counts[va_i[f * 3][va_ok[f * 3] > 0]] += 1
    assert (counts == 1).all()


def test_candidate_static_sig_matches_jax():
    for F, fn in ((JM.MODEL_FAMILIES, JTU.candidate_static_sig),
                  (TM.MODEL_FAMILIES, TTU.candidate_static_sig)):
        lr = F["LogisticRegression"]
        assert fn(lr, lr.make_grid({"regParam": [0.01],
                                    "elasticNetParam": [0.0]})) == (
            ("elasticNetParam", 0.0),)
        assert fn(lr, lr.make_grid({"elasticNetParam": [0.0, 0.5]})) == ()
        glm = F["GeneralizedLinearRegression"]
        assert fn(glm, glm.make_grid()) == (("familyLink", 0.0),
                                            ("variancePower", 1.5))


def test_fold_sliced_sweep_matches_masked(lr_data, clean_knobs):
    X, y, w = lr_data
    cv = TTU.OpCrossValidation(n_folds=3, metric="auroc")
    clean_knobs.setenv("TM_SWEEP_FOLD_SLICE", "0")
    masked = _fused(cv, _entries(), X, y, w)
    clean_knobs.delenv("TM_SWEEP_FOLD_SLICE")
    sliced = _fused(cv, _entries(), X, y, w)
    for key in masked:
        np.testing.assert_allclose(masked[key].grid_metrics,
                                   sliced[key].grid_metrics, rtol=1e-4,
                                   atol=1e-6)
        assert masked[key].best_index == sliced[key].best_index


def test_static_specialization_batch_content_invariance(lr_data):
    """A candidate's specialization derives from its own grid: alone or
    beside a candidate that keeps the hyper traced, bitwise alike."""
    X, y, w = lr_data
    lr = TM.MODEL_FAMILIES["LogisticRegression"]
    mixed = ("0:LR", lr, lr.make_grid({"regParam": [0.01],
                                       "elasticNetParam": [0.5]}))
    const = ("1:LR", lr, lr.make_grid({"regParam": [0.01],
                                       "elasticNetParam": [0.0]}))
    cv = TTU.OpCrossValidation(n_folds=2, metric="logloss")
    both = _fused(cv, [mixed, const], X, y, w)["1:LR"]
    solo = _fused(cv, [const], X, y, w)["1:LR"]
    assert np.array_equal(both.grid_metrics, solo.grid_metrics)


def test_glm_static_link_matches_traced(clean_knobs):
    rng = np.random.default_rng(1)
    n, d = 250, 6
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = np.exp(0.3 * X[:, 0] + 0.1 * X[:, 1]
               + 0.1 * rng.normal(size=n)).astype(np.float32)
    w = np.ones(n, np.float32)
    glm = TM.MODEL_FAMILIES["GeneralizedLinearRegression"]
    grid = glm.make_grid({"regParam": [0.01, 0.1], "familyLink": [1.0]})
    cv = TTU.OpCrossValidation(n_folds=2, metric="rmse")
    clean_knobs.setenv("TM_SWEEP_EXACT", "1")
    exact = _fused(cv, [("g", glm, grid)], X, y, w, 1)["g"]
    clean_knobs.delenv("TM_SWEEP_EXACT")
    spec = _fused(cv, [("g", glm, grid)], X, y, w, 1)["g"]
    np.testing.assert_allclose(exact.grid_metrics, spec.grid_metrics,
                               rtol=1e-4)
    assert exact.best_index == spec.best_index


def test_sweep_matches_jax(lr_data):
    """The fused default sweep against the JAX package's, per grid point."""
    X, y, w = lr_data
    jcv = JTU.OpCrossValidation(n_folds=3, metric="logloss")
    tcv = TTU.OpCrossValidation(n_folds=3, metric="logloss")
    jp = jcv.dispatch_many(_entries(JM.MODEL_FAMILIES), X, y, w, 2)
    tp = _fused(tcv, _entries(), X, y, w)
    for key, p in jp.items():
        jr = jcv.collect(p)
        np.testing.assert_allclose(tp[key].grid_metrics, jr.grid_metrics,
                                   atol=LINEAR_TOL)
        assert tp[key].best_index == jr.best_index


def test_validation_result_json_round_trip(lr_data):
    """from_json inverts to_json, and reads a document as the JAX
    package's from_json does."""
    X, y, w = lr_data
    cv = TTU.OpCrossValidation(n_folds=2, metric="logloss")
    for r in _fused(cv, _entries(), X, y, w).values():
        doc = json.loads(json.dumps(r.to_json()))
        back = TTU.ValidationResult.from_json(doc, cv.larger_is_better)
        assert back.to_json() == r.to_json()
        assert JTU.ValidationResult.from_json(
            doc, cv.larger_is_better).to_json() == back.to_json()
        assert np.array_equal(back.grid_metrics.astype(np.float32),
                              r.grid_metrics.astype(np.float32))


def test_sweep_out_of_memory_halves_the_chunk(lr_data, clean_knobs):
    """A CUDA out-of-memory in a sweep batch re-runs it in chunks of a
    half, a quarter and an eighth of the items; the last, one item a
    chunk, equals a sweep that ran one item a chunk from the start. A
    host-side error mentioning memory surfaces."""
    X, y, w = lr_data
    fam = TM.MODEL_FAMILIES["LogisticRegression"]
    grid = fam.make_grid()
    cv = TTU.OpCrossValidation(n_folds=3, metric="logloss")
    ref = _fused(cv, [("a", fam, grid)], X, y, w)["a"]
    clean_knobs.setitem(TTU.SWEEP_CHUNK, "cpu", 8)
    real = type(fam).fit_batch
    sizes = []

    def flaky(self, X, y, w, hyper, n_classes):
        sizes.append(X.shape[0])
        if X.shape[0] > 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
        return real(self, X, y, w, hyper, n_classes)

    clean_knobs.setattr(type(fam), "fit_batch", flaky)
    got = _fused(cv, [("a", fam, grid)], X, y, w)["a"]
    assert sizes[:3] == [8, 4, 2] and set(sizes[3:]) == {1}
    np.testing.assert_array_equal(got.grid_metrics, ref.grid_metrics)

    def broken(self, *a, **k):
        raise ValueError("host-side bug mentioning OOM")

    clean_knobs.setattr(type(fam), "fit_batch", broken)
    with pytest.raises(ValueError, match="host-side"):
        _fused(cv, [("a", fam, grid)], X, y, w)


def test_unported_sweep_knobs_raise(lr_data, clean_knobs):
    X, y, w = lr_data
    cv = TTU.OpCrossValidation(n_folds=2)
    clean_knobs.setenv("TM_TREE_GRID_FOLD", "0")
    # a linear family takes the sweep whatever the tree knob says
    _fused(cv, _entries()[2:], X, y, w)
    with pytest.raises(NotImplementedError, match="TM_TREE_GRID_FOLD=0"):
        cv.dispatch_many([("t", TM.MODEL_FAMILIES["GBTClassifier"],
                           [TM.MODEL_FAMILIES["GBTClassifier"]
                            .default_hyper])], X, y, w, 2, device="cpu")
    clean_knobs.delenv("TM_TREE_GRID_FOLD")
    clean_knobs.setenv("TM_MESH_AXIS", "grid,data")
    # the 2-D sweep is ported: the knob no longer refuses a dispatch on
    # one device, and a 2 x 2 grid x data mesh gives the same winner
    on_one = _fused(cv, _entries()[2:], X, y, w)
    grid_data = {key: cv.collect(p) for key, p in cv.dispatch_many(
        _entries()[2:], X, y, w, 2, TP.get_mesh_2d(["cpu"] * 4)).items()}
    for key, res in on_one.items():
        assert grid_data[key].best_index == res.best_index
        np.testing.assert_allclose(grid_data[key].grid_metrics,
                                   res.grid_metrics, rtol=1e-4, atol=1e-6)
    clean_knobs.delenv("TM_MESH_AXIS")
    # the JAX signatures: mesh=None positional or keyword, the device a
    # keyword resolved as every entry point's (None: CUDA, or raise); a
    # grid mesh shards the batch and leaves its metrics bitwise
    key, fam, grid = _entries()[2]
    one = cv.validate(fam, grid, X, y, w, 2, None, device="cpu")
    two = cv.validate(fam, grid, X, y, w, 2,
                      mesh=get_mesh(["cpu"] * 2))
    assert np.array_equal(one.grid_metrics, two.grid_metrics)
    with pytest.raises(TypeError, match="mesh"):
        cv.validate(fam, grid, X, y, w, 2, mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cv.dispatch_many([(key, fam, grid)], X, y, w, 2)


# ---------------------------------------------------------------------------
# The selector
# ---------------------------------------------------------------------------

def _ds(pkg, X, y):
    if pkg == "jax":
        from transmogrifai_tpu import Dataset, FeatureBuilder
        from transmogrifai_tpu.features import types as ft
    else:
        from transmogrifai_tpu_torch.dataset import Dataset
        from transmogrifai_tpu_torch.features import FeatureBuilder
        from transmogrifai_tpu_torch.features import types as ft
    lbl = FeatureBuilder.of(ft.RealNN, "y").from_column().as_response()
    vec = FeatureBuilder.OPVector("x").from_column().as_predictor()
    ds = Dataset({"y": y.astype(np.float64), "x": X.astype(np.float32)},
                 {"y": ft.RealNN, "x": ft.OPVector})
    return ds, lbl, vec


def _selector(pkg, problem, ds_lbl_vec, **kw):
    ds, lbl, vec = ds_lbl_vec
    mods = JM if pkg == "jax" else TM
    if pkg != "jax":
        kw.setdefault("device", "cpu")
    sel = mods.ModelSelector(problem=problem, **kw).set_input(lbl, vec)
    return sel, ds


def test_selector_fused_vs_serial_equivalent(clean_knobs):
    rng = np.random.default_rng(2)
    n = 260
    X = rng.normal(size=(n, 6)).astype(np.float32)
    y = ((X @ rng.normal(size=6)) + rng.normal(size=n) > 0).astype(np.float32)
    cands = [["LogisticRegression", {"regParam": [0.01, 0.1],
                                     "elasticNetParam": [0.0]}],
             ["NaiveBayes", None]]

    def fit(env):
        for k, v in env.items():
            if v is None:
                clean_knobs.delenv(k, raising=False)
            else:
                clean_knobs.setenv(k, v)
        sel, ds = _selector("torch", "binary", _ds("torch", X, y),
                            candidates=cands,
                            validation={"type": "crossValidation",
                                        "folds": 2, "metric": "auroc"})
        return sel.fit(ds)

    serial = fit({"TM_SWEEP_FUSION": "0"})
    fused = fit({"TM_SWEEP_FUSION": None})
    s0, s1 = serial.summary, fused.summary
    assert s0["bestModel"]["family"] == s1["bestModel"]["family"]
    assert s0["bestModel"]["hyper"] == s1["bestModel"]["hyper"]
    assert len(s1["validationResults"]) == len(cands)
    for a, b in zip(s0["validationResults"], s1["validationResults"]):
        np.testing.assert_allclose(a["gridMetrics"], b["gridMetrics"],
                                   rtol=1e-4, atol=1e-6)
    for k in serial.model_params:
        np.testing.assert_allclose(serial.model_params[k].numpy(),
                                   fused.model_params[k].numpy(),
                                   rtol=1e-3, atol=1e-5)
    exact = fit({"TM_SWEEP_EXACT": "1"})
    for k in serial.model_params:
        assert torch.equal(serial.model_params[k], exact.model_params[k]), k
    assert s0["validationResults"] == exact.summary["validationResults"]


@pytest.fixture()
def small_trees():
    saved = []
    for reg in (JM.MODEL_FAMILIES, TM.MODEL_FAMILIES):
        for fam in reg.values():
            if not hasattr(fam, "max_depth_cap"):
                continue
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


def _problem_data(problem, n=300, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4)).astype(np.float32)
    z = X[:, 0] * X[:, 1] + 0.8 * X[:, 2] + 0.3 * rng.normal(size=n)
    if problem == "binary":
        return X, (z > 0).astype(np.float32)
    if problem == "multiclass":
        return X, np.digitize(z, np.quantile(z, [1 / 3, 2 / 3])
                              ).astype(np.float32)
    return X, z.astype(np.float32)


@pytest.mark.parametrize("problem", ["binary", "multiclass", "regression"])
def test_default_selectors_match_jax(problem, small_trees, clean_knobs):
    """Each default candidate list (the JAX package's) constructs and
    fits on the port: the same winner and hyper as the JAX package, and
    every family's grid metrics within its tolerance."""
    clean_knobs.setenv("TM_KERNEL_EXACT", "1")
    assert (TM.ModelSelector.default_candidates(problem)
            == JM.ModelSelector.default_candidates(problem))
    X, y = _problem_data(problem)
    models = []
    for pkg in ("jax", "torch"):
        sel, ds = _selector(pkg, problem, _ds(pkg, X, y))
        models.append(sel.fit(ds))
    js, ts = (m.summary for m in models)
    assert ts["bestModel"]["family"] == js["bestModel"]["family"]
    assert ts["bestModel"]["hyper"] == js["bestModel"]["hyper"]
    for jr, tr in zip(js["validationResults"], ts["validationResults"]):
        assert tr["family"] == jr["family"] and tr["grid"] == jr["grid"]
        atol, rtol = _tolerance(problem, jr["family"])
        np.testing.assert_allclose(tr["gridMetrics"], jr["gridMetrics"],
                                   atol=atol, rtol=rtol,
                                   err_msg=jr["family"])
    assert set(models[1].wall_seconds["families"]) == {
        r["family"] for r in ts["validationResults"]}
    assert set(ts) == set(js)


def _titanic():
    """Titanic's numeric columns (pclass, sex, age with its mean filled,
    sibSp, parCh, fare) and the survived label, read with csv."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "data", "titanic.csv")
    with open(path) as f:
        rows = list(csv.DictReader(f))
    age = np.array([float(r["age"]) if r["age"] else np.nan for r in rows])
    age = np.where(np.isnan(age), np.nanmean(age), age)
    X = np.stack([[float(r["pclass"]) for r in rows],
                  [1.0 if r["sex"] == "female" else 0.0 for r in rows],
                  age, [float(r["sibSp"]) for r in rows],
                  [float(r["parCh"]) for r in rows],
                  [float(r["fare"]) for r in rows]], 1).astype(np.float32)
    y = np.array([float(r["survived"]) for r in rows], np.float32)
    return X, y


def test_titanic_lr_grid_picks_the_jax_winner():
    X, y = _titanic()
    out = []
    for pkg in ("jax", "torch"):
        sel, ds = _selector(pkg, "binary", _ds(pkg, X, y),
                            candidates=["LogisticRegression"])
        out.append(sel.fit(ds).summary)
    js, ts = out
    assert ts["bestModel"]["family"] == js["bestModel"]["family"]
    assert ts["bestModel"]["hyper"] == js["bestModel"]["hyper"]
    np.testing.assert_allclose(ts["validationResults"][0]["gridMetrics"],
                               js["validationResults"][0]["gridMetrics"],
                               atol=LINEAR_TOL)


def _resume_selector(ckpt=None):
    from transmogrifai_tpu_torch.features.feature import reset_uids
    reset_uids()
    X, y = _problem_data("binary", n=240, seed=4)
    cands = [["LogisticRegression", {"regParam": [0.01, 0.1]}],
             ["LogisticRegression", {"regParam": [1.0]}],
             ["NaiveBayes", None]]
    sel, ds = _selector("torch", "binary", _ds("torch", X, y),
                        candidates=cands, uid="ModelSelector_resume")
    sel.fit_checkpoint_dir = ckpt
    return sel, ds


def test_selector_family_level_resume(tmp_path):
    """A fit stopped by a fault after the first candidate resumes after
    it: only the unvalidated candidates re-run (as a smaller fused
    batch), and the summary, the refit and its scores are bitwise the
    uninterrupted fit's (the host-clock walls stay on the fitted
    objects, out of the summary)."""
    sel, ds = _resume_selector()
    baseline = sel.fit(ds)
    ckpt = str(tmp_path / "ckpt")
    os.makedirs(ckpt)
    with faults.active("models.selector.validate:raise-fatal:1"):
        sel, ds = _resume_selector(ckpt)
        with pytest.raises(faults.FaultError):
            sel.fit(ds)
    progress = json.load(open(os.path.join(ckpt, "selector_progress.json")))
    assert list(progress["families"]) == ["0:LogisticRegression"]
    faults.configure("models.selector.validate:raise-fatal:9999")
    sel, ds = _resume_selector(ckpt)
    resumed = sel.fit(ds)
    assert faults.stats_dict()["arrivals"]["models.selector.validate"] == 2
    assert (json.dumps(baseline.summary, sort_keys=True)
            == json.dumps(resumed.summary, sort_keys=True))
    assert set(resumed.wall_seconds) == {"families", "refit"}
    for k in baseline.model_params:
        assert torch.equal(baseline.model_params[k], resumed.model_params[k])
    X = ds.column("x")
    assert np.array_equal(baseline.predict_probs(X), resumed.predict_probs(X))


def test_drifted_checkpoint_rejected_loudly(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    os.makedirs(ckpt)
    with faults.active("models.selector.validate:raise-fatal:1"):
        sel, ds = _resume_selector(ckpt)
        with pytest.raises(faults.FaultError):
            sel.fit(ds)
    # other data: a different token
    sel, ds = _resume_selector(ckpt)
    X = ds.column("x").copy()
    X[:, 0] += 1.0
    ds2, _, _ = _ds("torch", X, ds.column("y"))
    with pytest.raises(ValueError, match="different selector configuration"):
        sel.fit(ds2)
    # another configuration: a different token
    sel, ds = _resume_selector(ckpt)
    sel.params["seed"] = 7
    with pytest.raises(ValueError, match="different selector configuration"):
        sel.fit(ds)
    # a torn progress file
    path = os.path.join(ckpt, "selector_progress.json")
    text = open(path).read()
    with open(path, "w") as f:
        f.write(text[:len(text) // 2])
    sel, ds = _resume_selector(ckpt)
    with pytest.raises(ValueError, match="unreadable"):
        sel.fit(ds)
    # the original configuration still resumes once the file is whole
    with open(path, "w") as f:
        f.write(text)
    sel, ds = _resume_selector(ckpt)
    resumed = sel.fit(ds)
    sel, ds = _resume_selector()
    assert (json.dumps(resumed.summary, sort_keys=True)
            == json.dumps(sel.fit(ds).summary, sort_keys=True))


def test_sweep_stats_attribute_items_to_the_device(lr_data):
    from transmogrifai_tpu_torch.profiling import SWEEP_STATS, SweepStats
    X, y, w = lr_data
    before = SWEEP_STATS.snapshot()
    cv = TTU.OpCrossValidation(n_folds=3, metric="auroc")
    _fused(cv, _entries(), X, y, w)
    d = SweepStats.delta(before, SWEEP_STATS.snapshot())
    # two batches: the LR group (3 grid points x 3 folds) and NB's (3)
    assert d["dispatches"] == 2
    assert d["devices"] == {"cpu": {"dispatches": 2, "items": 12}}
    assert "compiles" not in d
