"""The port's tree engine (``transmogrifai_tpu_torch.models.trees``)
against the JAX package's (``transmogrifai_tpu.models.trees``) on the
CPU, at shrunk caps on both packages' family singletons.

Tolerances, and why:
* binning: edges and bins bitwise (unit weights: the cumulative weights
  are exact integers; the quantile levels reproduce XLA's f32
  arithmetic); the unweighted nanquantile path within 1e-6 relative;
* DT and RF growers under ``TM_KERNEL_EXACT=1`` on integer-valued stats:
  ``feat``/``thr`` bitwise and leaves within 1e-6 (RF given JAX's own
  bootstrap counts and per-node draws — the port's generator cannot
  give JAX's bits; with its own draws RF is held to quality, AUROC
  within 0.02);
* boosting: the first round's tree bitwise when its stats are exact
  (balanced labels: p0 = 0.5, g = +-0.5, h = 0.25); later rounds take
  gradients from sigmoid/softmax, which XLA and torch round differently
  in the last bit, so near-tied splits may flip: training AUROC within
  0.005 and mean |dp| within 0.01, R2 within 0.01 for regression;
* prediction from the same params (JAX-fitted, carried across with
  ``params_from_numpy``): within 1e-6.
"""
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transmogrifai_tpu import models as JM
from transmogrifai_tpu.models import trees as JT
from transmogrifai_tpu_torch import models as TM
from transmogrifai_tpu_torch.evaluators import functional as TF
from transmogrifai_tpu_torch.models import trees as TT

FAMILIES = ("DecisionTreeClassifier", "DecisionTreeRegressor",
            "RandomForestClassifier", "RandomForestRegressor",
            "GBTClassifier", "GBTRegressor",
            "XGBoostClassifier", "XGBoostRegressor")


@pytest.fixture(autouse=True)
def small_caps():
    """Shrink both packages' static caps (n_bins 16, depth 4, 8 trees,
    10 rounds), restored after."""
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


@pytest.fixture
def exact(monkeypatch):
    monkeypatch.setenv("TM_KERNEL_EXACT", "1")


def _xor(seed, n=300, d=5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = ((X[:, 0] > 0) ^ (X[:, 1] > 0)).astype(np.float32)
    return X, y


def _balanced(seed, n=300, d=5):
    """Exactly half positive, so the first boosting round's stats are
    exact (p0 = 0.5)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = np.zeros(n, np.float32)
    y[rng.permutation(n)[: n // 2]] = 1.0
    X[:, 0] += 1.5 * (y - 0.5)
    X[:, 1] *= 1.0 + y
    return X, y


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _jit(fn, **static):
    """The JAX reference as one jitted program (eager JAX compiles every
    primitive on its own, which costs this file most of its time)."""
    return jax.jit(partial(fn, **static))


# ---------------------------------------------------------------------------
# Binning
# ---------------------------------------------------------------------------

def test_quantile_levels_match_jnp_linspace_bitwise():
    for nb in (2, 3, 6, 7, 10, 16, 20, 31, 32, 33, 64):
        np.testing.assert_array_equal(
            TT._quantile_levels(nb, "cpu").numpy(),
            np.asarray(jnp.linspace(0.0, 1.0, nb + 1)[1:-1]))


@pytest.mark.parametrize("n_bins", [16, 32, 10])
def test_weighted_edges_and_bins_bitwise(n_bins):
    rng = np.random.default_rng(n_bins)
    X = rng.normal(size=(500, 6)).astype(np.float32)
    X[rng.random(X.shape) < 0.05] = np.nan
    X[:, 3] = np.round(X[:, 3])                  # heavy ties
    w = np.ones(500, np.float32)
    w[rng.random(500) < 0.3] = 0.0               # held-out rows
    je = np.asarray(JT.quantile_bin_edges(_j(X), n_bins, _j(w)))
    te = TT.quantile_bin_edges(_t(X), n_bins, _t(w)).numpy()
    np.testing.assert_array_equal(te, je)
    np.testing.assert_array_equal(
        TT.bin_data(_t(X), _t(te)).numpy(),
        np.asarray(JT.bin_data(_j(X), _j(je))))


def test_unweighted_edges_match_nanquantile():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(400, 5)).astype(np.float32)
    X[rng.random(X.shape) < 0.05] = np.nan
    je = np.asarray(JT.quantile_bin_edges(_j(X), 16))
    te = TT.quantile_bin_edges(_t(X), 16).numpy()
    np.testing.assert_allclose(te, je, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Growers
# ---------------------------------------------------------------------------

def _grower_inputs(seed, Gb=3, n=240, d=5, C=2, B=16):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    edges = np.asarray(JT.quantile_bin_edges(_j(X), B, _j(np.ones(n))))
    bins = np.asarray(JT.bin_data(_j(X), _j(edges)))
    y = rng.integers(0, C, size=n)
    w = rng.integers(0, 3, size=(Gb, n)).astype(np.float32)
    gw = (np.eye(C, dtype=np.float32)[y][None] * w[..., None])
    hw = np.broadcast_to(w[..., None], gw.shape).copy()
    hyper = (np.ones((Gb, d), np.float32), np.full(Gb, 1e-6, np.float32),
             np.zeros(Gb, np.float32), np.array([1, 2, 1][:Gb], np.float32),
             np.array([4, 3, 2][:Gb], np.float32))
    return bins, gw, hw, w, edges, hyper


def _jax_subset_draws(keys, Gb, d, depth):
    return [np.asarray(jax.vmap(lambda k: jax.random.uniform(
        jax.random.fold_in(k, lv), (1 << lv, d)))(keys))
        for lv in range(depth)]


@pytest.mark.parametrize("subset", [False, True])
def test_grow_tree_grid_bitwise_exact(exact, subset):
    bins, gw, hw, w, edges, hyper = _grower_inputs(4)
    Gb, d = gw.shape[0], bins.shape[1]
    kw, tkw = {}, {}
    if subset:
        keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(Gb))
        rate = np.array([0.5, 0.3, 1.0], np.float32)
        kw = dict(subset_keys=keys, subset_rate=_j(rate))
        tkw = dict(subset_draws=[_t(a) for a in
                                 _jax_subset_draws(keys, Gb, d, 4)],
                   subset_rate=_t(rate))
    jf, jt, jl, jg, jp = _jit(JT.grow_tree_grid, max_depth=4)(
        _j(bins), _j(gw), _j(hw), _j(w), _j(edges),
        *[_j(h) for h in hyper], **kw)
    tf, tt, tl, tg, tp = TT.grow_tree_grid(
        _t(bins), _t(gw), _t(hw), _t(w), _t(edges),
        *[_t(h) for h in hyper], max_depth=4, **tkw)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6)


def test_single_grower_is_the_grid_grower_of_one(exact):
    """The JAX package's single-instance ``grow_tree`` equals the port's
    grid grower at Gb = 1."""
    bins, gw, hw, w, edges, hyper = _grower_inputs(8, Gb=1)
    jf, jt, jl, _jg, _jp = _jit(JT.grow_tree, max_depth=4)(
        _j(bins), _j(gw[0]), _j(hw[0]), _j(w[0]), _j(edges),
        _j(hyper[0][0]), _j(hyper[1][0]), _j(hyper[2][0]), _j(hyper[3][0]),
        _j(hyper[4][0]))
    tf, tt, tl, _tg, _tp = TT.grow_tree_grid(
        _t(bins), _t(gw), _t(hw), _t(w), _t(edges),
        *[_t(h) for h in hyper], max_depth=4)
    np.testing.assert_array_equal(tf[0].numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tt[0].numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl[0].numpy(), np.asarray(jl), atol=1e-6)


# ---------------------------------------------------------------------------
# Fitters
# ---------------------------------------------------------------------------

def _fold_batch(seed, n, Gb=4):
    rng = np.random.default_rng(seed)
    return (rng.random((Gb, n)) < 0.7).astype(np.float32)


def test_single_tree_grid_fit_bitwise_exact(exact):
    X, y = _xor(0)
    tr = _fold_batch(0, len(y))
    hyper = {"maxDepth": np.array([3, 4, 3, 4], np.float32),
             "minInstancesPerNode": np.array([1, 1, 5, 5], np.float32)}
    kw = dict(max_depth=4, n_bins=16, classification=True)
    j = _np(_jit(JT.fit_single_tree_grid, n_classes=2, **kw)(
        _j(X), _j(y), _j(np.ones(len(y))), _j(tr),
        {k: _j(v) for k, v in hyper.items()}))
    t = TM.params_to_numpy(TT.fit_single_tree_grid(
        _t(X), _t(y), _t(np.ones(len(y), np.float32)), _t(tr),
        {k: _t(v) for k, v in hyper.items()}, 2, **kw))
    assert set(t) == set(j)
    for k in ("feat", "thr"):
        np.testing.assert_array_equal(t[k], j[k])
    for k in ("leaf", "tree_w", "feature_importance"):
        np.testing.assert_allclose(t[k], j[k], atol=1e-6)


def _auroc(p, y):
    return float(TF.auroc(_t(p), _t(y)))


def _jax_forest_draws(seed, T, n, d, depth):
    keys = jax.random.split(jax.random.PRNGKey(seed), T)
    kk = jax.vmap(jax.random.split)(keys)
    kb, kf = kk[:, 0], kk[:, 1]
    boot = np.asarray(jax.vmap(lambda k: jax.random.poisson(
        k, 1.0, (n,)))(kb)).astype(np.float32)
    return boot, _jax_subset_draws(kf, T, d, depth)


def test_forest_grid_fit_bitwise_given_jax_draws(exact):
    X, y = _xor(1)
    n, d = X.shape
    tr = _fold_batch(1, n, Gb=2)
    T = 8
    hyper = {"maxDepth": np.array([3, 4], np.float32),
             "featureSubsetRate": np.array([0.6, 0.6], np.float32),
             "numTrees": np.array([6, 8], np.float32),
             "seed": np.zeros(2, np.float32)}
    kw = dict(max_depth=4, n_bins=16, n_trees=T, classification=True)
    j = _np(_jit(JT.fit_forest_grid, n_classes=2, **kw)(
        _j(X), _j(y), _j(np.ones(n)), _j(tr),
        {k: _j(v) for k, v in hyper.items()}))
    boot, draws = _jax_forest_draws(0, T, n, d, 4)
    t = TM.params_to_numpy(TT.fit_forest_grid(
        _t(X), _t(y), _t(np.ones(n, np.float32)), _t(tr),
        {k: _t(v) for k, v in hyper.items()}, 2,
        boot=_t(np.stack([boot, boot])),
        subset_draws=[_t(np.concatenate([a, a])) for a in draws], **kw))
    for k in ("feat", "thr"):
        np.testing.assert_array_equal(t[k], j[k])
    for k in ("leaf", "tree_w", "feature_importance"):
        np.testing.assert_allclose(t[k], j[k], atol=1e-6)


def test_forest_with_its_own_draws_matches_jax_quality():
    """Each package's own RNG: mean held-out AUROC over four seeds of a
    32-tree forest within 0.02 (one small forest's AUROC spreads by
    more than that from seed to seed)."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(600, 5)).astype(np.float32)
    y = ((X[:, 0] > 0) ^ (X[:, 1] > 0)).astype(np.float32)
    Xv = rng.normal(size=(2000, 5)).astype(np.float32)
    yv = ((Xv[:, 0] > 0) ^ (Xv[:, 1] > 0)).astype(np.float32)
    fam_j = JM.MODEL_FAMILIES["RandomForestClassifier"]
    fam_t = TM.MODEL_FAMILIES["RandomForestClassifier"]
    fam_j.n_trees_cap = fam_t.n_trees_cap = 32
    fit = jax.jit(lambda X, y, w, h: fam_j.fit_kernel(X, y, w, h, 2))
    pred = jax.jit(lambda p, X: fam_j.predict_kernel(p, X, 2))
    aj, at = [], []
    for seed in range(4):
        hyper = dict(fam_j.default_hyper, seed=float(seed))
        pj = fit(_j(X), _j(y), _j(np.ones(len(y))),
                 {k: _j(np.float32(v)) for k, v in hyper.items()})
        aj.append(_auroc(np.asarray(pred(pj, _j(Xv)))[:, 1], yv))
        pt = fam_t.fit_kernel(_t(X), _t(y), torch.ones(len(y)),
                              {k: torch.tensor(v) for k, v in hyper.items()},
                              2)
        at.append(_auroc(fam_t.predict_kernel(pt, _t(Xv), 2).numpy()[:, 1],
                         yv))
    assert abs(np.mean(at) - np.mean(aj)) <= 0.02
    assert np.mean(at) > 0.95


BOOSTED = [
    ("GBTClassifier", "logistic",
     {"stepSize": [0.1, 0.3, 0.1, 0.3], "regLambda": [0, 0, 1, 1]}),
    ("XGBoostClassifier", "logistic",
     {"stepSize": [0.3, 0.1, 0.3, 0.1], "regLambda": [1, 1, 1, 1],
      "maxDepth": [4, 4, 3, 3]}),
]


@pytest.mark.parametrize("family,objective,grid", BOOSTED)
def test_boosted_grid_fit_within_tolerance(exact, family, objective, grid):
    X, y = _balanced(5)
    n = len(y)
    tr = np.ones((4, n), np.float32)
    hyper = {k: np.asarray(v, np.float32) for k, v in grid.items()}
    kw = dict(max_depth=4, n_bins=16, n_rounds=10, objective=objective)
    j = _np(_jit(JT.fit_boosted_grid, n_classes=2, **kw)(
        _j(X), _j(y), _j(np.ones(n)), _j(tr),
        {k: _j(v) for k, v in hyper.items()}))
    t = TT.fit_boosted_grid(_t(X), _t(y), _t(np.ones(n, np.float32)),
                            _t(tr), {k: _t(v) for k, v in hyper.items()},
                            2, **kw)
    tn = TM.params_to_numpy(t)
    np.testing.assert_array_equal(tn["feat"][:, 0], j["feat"][:, 0])
    np.testing.assert_array_equal(tn["thr"][:, 0], j["thr"][:, 0])
    np.testing.assert_allclose(tn["leaf"][:, 0], j["leaf"][:, 0], atol=1e-6)
    np.testing.assert_array_equal(tn["base"], j["base"])
    fam_j = JM.MODEL_FAMILIES[family]
    fam_t = TM.MODEL_FAMILIES[family]
    pj = np.asarray(jax.jit(jax.vmap(
        lambda p: fam_j.predict_kernel(p, _j(X), 2)))(
            {k: _j(v) for k, v in j.items()}))
    pt = fam_t.predict_kernel(t, _t(X), 2).numpy()
    assert np.abs(pt - pj).mean() <= 0.01
    for g in range(4):
        assert abs(_auroc(pt[g, :, 1], y) - _auroc(pj[g, :, 1], y)) <= 0.005


def test_boosted_draws_handed_in_drive_subsampling(exact):
    """With subsample / colsample below 1 the port, handed JAX's own
    per-round draws, grows JAX's first tree."""
    X, y = _balanced(6)
    n, d = X.shape
    hyper = {"subsample": np.array([0.8], np.float32),
             "colsampleByTree": np.array([0.6], np.float32),
             "colsampleByNode": np.array([0.7], np.float32),
             "seed": np.array([3.0], np.float32)}
    kw = dict(max_depth=4, n_bins=16, n_rounds=3, objective="logistic")
    j = _np(_jit(JT.fit_boosted_grid, n_classes=2, **kw)(
        _j(X), _j(y), _j(np.ones(n)), _j(np.ones((1, n))),
        {k: _j(v) for k, v in hyper.items()}))
    k0 = jax.random.PRNGKey(3)
    rows, cols, nodes = [], [], [[] for _ in range(4)]
    for r in range(3):
        key = jax.random.fold_in(k0, r)
        ks, kf = jax.random.split(key)
        kn = jax.random.fold_in(key, 7919)
        rows.append(np.asarray(jax.random.uniform(ks, (n,)))[None])
        cols.append(np.asarray(jax.random.uniform(kf, (d,)))[None])
        for lv in range(4):
            nodes[lv].append(np.asarray(jax.random.uniform(
                jax.random.fold_in(kn, lv), (1 << lv, d)))[None])
    draws = {"row": _t(np.stack(rows)), "col": _t(np.stack(cols)),
             "node": [_t(np.stack(nd)) for nd in nodes]}
    t = TM.params_to_numpy(TT.fit_boosted_grid(
        _t(X), _t(y), _t(np.ones(n, np.float32)),
        _t(np.ones((1, n), np.float32)),
        {k: _t(v) for k, v in hyper.items()}, 2, draws=draws, **kw))
    np.testing.assert_array_equal(t["feat"][:, 0], j["feat"][:, 0])
    np.testing.assert_array_equal(t["thr"][:, 0], j["thr"][:, 0])


def test_boosted_regression_within_tolerance(exact):
    X, _ = _balanced(7)
    y = (X[:, 0] * 2 - X[:, 1] ** 2).astype(np.float32)
    n = len(y)
    kw = dict(max_depth=4, n_bins=16, n_rounds=10, objective="squared")
    hyper = {"stepSize": np.array([0.3], np.float32)}
    j = _jit(JT.fit_boosted_grid, n_classes=1, **kw)(
        _j(X), _j(y), _j(np.ones(n)), _j(np.ones((1, n))),
        {k: _j(v) for k, v in hyper.items()})
    t = TT.fit_boosted_grid(_t(X), _t(y), _t(np.ones(n, np.float32)),
                            _t(np.ones((1, n), np.float32)),
                            {k: _t(v) for k, v in hyper.items()}, 1, **kw)

    def r2(p):
        return 1 - np.mean((p - y) ** 2) / np.var(y)

    pj = np.asarray(JT.ensemble_raw({k: v[0] for k, v in j.items()},
                                    _j(X)))[:, 0]
    pt = TT.ensemble_raw({k: v[0] for k, v in t.items()}, _t(X)).numpy()[:, 0]
    assert abs(r2(pt) - r2(pj)) <= 0.01 and r2(pt) > 0.5


def test_importance_and_multiclass_fit_shapes():
    rng = np.random.default_rng(9)
    X = rng.normal(size=(200, 4)).astype(np.float32)
    y = (np.digitize(X[:, 0], [-0.5, 0.5])).astype(np.float32)   # 3 classes
    for name in ("DecisionTreeClassifier", "RandomForestClassifier",
                 "XGBoostClassifier"):
        fam = TM.MODEL_FAMILIES[name]
        hyper = {k: torch.tensor(v) for k, v in fam.default_hyper.items()}
        p = fam.fit_kernel(_t(X), _t(y), torch.ones(200), hyper, 3)
        probs = fam.predict_kernel(p, _t(X), 3).numpy()
        assert probs.shape == (200, 3)
        np.testing.assert_allclose(probs.sum(1), 1.0, atol=1e-5)
        assert (probs.argmax(1) == y).mean() > 0.8
        imp = p["feature_importance"].numpy()
        assert imp.shape == (4,) and abs(imp.sum() - 1) < 1e-5
        assert imp.argmax() == 0


# ---------------------------------------------------------------------------
# Prediction and carrying params across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["DecisionTreeClassifier",
                                    "RandomForestClassifier",
                                    "GBTClassifier", "XGBoostClassifier",
                                    "GBTRegressor", "RandomForestRegressor"])
def test_params_from_jax_predict_what_jax_predicts(family):
    X, y = _xor(10)
    if "Regressor" in family:
        y = (X[:, 0] - X[:, 2]).astype(np.float32)
    n_classes = 1 if "Regressor" in family else 2
    fam_j = JM.MODEL_FAMILIES[family]
    hyper = {k: _j(np.float32(v)) for k, v in fam_j.default_hyper.items()}
    pj_params = _np(jax.jit(lambda X, y, w, h: fam_j.fit_kernel(
        X, y, w, h, n_classes))(_j(X), _j(y), _j(np.ones(len(y))), hyper))
    ref = np.asarray(jax.jit(lambda p, X: fam_j.predict_kernel(
        p, X, n_classes))({k: _j(v) for k, v in pj_params.items()}, _j(X)))
    params = TM.params_from_numpy(pj_params, "cpu")
    assert params["feat"].dtype == torch.int64
    got = TM.MODEL_FAMILIES[family].predict_kernel(params, _t(X),
                                                   n_classes).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    back = TM.params_to_numpy(params)
    for k, v in pj_params.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)


def test_op_stage_fits_on_the_cpu():
    from transmogrifai_tpu_torch.dataset import Dataset
    from transmogrifai_tpu_torch.features import FeatureBuilder, types as ft
    X, y = _xor(11, n=200)
    ds = Dataset({"y": y.astype(np.float64), "x": X},
                 {"y": ft.RealNN, "x": ft.OPVector})
    lbl = FeatureBuilder.of(ft.RealNN, "y").from_column().as_response()
    vec = FeatureBuilder.OPVector("x").from_column().as_predictor()
    est = TT.OpGBTClassifier(device="cpu").set_input(lbl, vec)
    model, out = est.fit_transform(ds)
    col = out.column(model.output.name)
    assert 0.0 <= col[0]["probability_1"] <= 1.0
    assert model.device == torch.device("cpu")
    acc = np.mean([r["prediction"] for r in col] == y)
    assert acc > 0.9
