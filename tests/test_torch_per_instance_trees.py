"""The per-instance tree path (``TM_TREE_GRID_FOLD=0``) and bf16
histogram accumulation (``TM_HIST_ACCUM_BF16=1``) against the JAX
package, on the CPU.

Under ``TM_TREE_GRID_FOLD=0`` the JAX package validates a tree family
through its vmapped sweep: each (fold, grid point) item bins on its own
weighted sketch (``trees._prep(X, n_bins, w)``) and grows through
``grow_tree``. The port runs the same items through
``_TreeFamily.fit_batch``: a batched sketch and one histogram launch a
level over per-item bins. Held here:

* the batched sketch is bitwise a loop of single sketches (items with
  their own rows, and one shared matrix under per-item weights);
* the per-item-bins histogram is bitwise a loop of shared-bins calls,
  and bitwise the vmapped ``histogram_xla`` on integer stats;
* DecisionTree CV metrics bitwise the JAX package's in exact mode
  (integer stats); GBT and XGBoost within 1e-2 (f32 gradients from
  another sigmoid and other summation orders move splits at near ties,
  the port's kept f32 drift); RandomForest bitwise trees given JAX's
  draws, and within 0.02 mean AUROC with its own draws;
* the 1-D and 2-D mesh runs on eight CPU ranks;
* bf16 accumulation within the reference's bound of the f32 histogram
  (rtol 2e-2, atol 2.0, ``tests/test_pallas_kernels.py``) and of the JAX
  BlockSpec interpret path; exact mode wins and is bitwise f32.
"""
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transmogrifai_tpu import models as JM
from transmogrifai_tpu.models import kernels as jk
from transmogrifai_tpu.models import trees as JT
from transmogrifai_tpu.models.tuning import OpCrossValidation as JCV
from transmogrifai_tpu_torch import models as TM
from transmogrifai_tpu_torch.models import kernels as tk
from transmogrifai_tpu_torch.models import trees as TT
from transmogrifai_tpu_torch.models.tuning import OpCrossValidation as TCV
from test_torch_trees import _jax_forest_draws

FAMILIES = ("DecisionTreeClassifier", "RandomForestClassifier",
            "GBTClassifier", "XGBoostClassifier")


@pytest.fixture(autouse=True)
def small_caps(monkeypatch):
    """Both packages' caps shrunk (n_bins 16, depth 4, 8 trees, 6
    rounds) and the numerics knobs cleared, restored after."""
    for k in ("TM_KERNEL_EXACT", "TM_HIST_BF16", "TM_HIST_ACCUM_BF16",
              "TM_TREE_GRID_FOLD", "TM_SWEEP_FOLD_SLICE", "TM_SWEEP_EXACT",
              "TM_SWEEP_FUSION", "TM_MESH_AXIS", "TM_MESH_DEVICES"):
        monkeypatch.delenv(k, raising=False)
    for reg in (JM.MODEL_FAMILIES, TM.MODEL_FAMILIES):
        for name in FAMILIES:
            fam = reg[name]
            monkeypatch.setattr(fam, "n_bins", 16)
            monkeypatch.setattr(fam, "max_depth_cap", 4)
            if hasattr(fam, "n_trees_cap"):
                monkeypatch.setattr(fam, "n_trees_cap", 8)
            if hasattr(fam, "n_rounds_cap"):
                monkeypatch.setattr(fam, "n_rounds_cap", 6)
    yield monkeypatch


def _data(seed=0, n=300, d=5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    logit = np.sin(X[:, 0] * 2) * 2 + X[:, 1] * X[:, 2]
    y = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    return X, y, np.ones(n, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the batched sketch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shared", [False, True], ids=["sliced", "masked"])
def test_item_sketch_is_a_loop_of_single_sketches(shared):
    rng = np.random.default_rng(3)
    b, n, d, B = 4, 257, 6, 16
    X = rng.normal(size=(n if shared else b, n, d)).astype(np.float32)
    X = X[0] if shared else X
    X[..., 5, 2] = np.nan                       # NaNs carry no weight
    w = rng.integers(0, 3, size=(b, n)).astype(np.float32)
    w[1, : n // 2] = 0.0                        # a fold mask
    got = TT.quantile_bin_edges_items(_t(X), B, _t(w))
    assert got.shape == (b, d, B - 1)
    for j in range(b):
        Xj = X if shared else X[j]
        one = TT.quantile_bin_edges(_t(Xj), B, _t(w[j]))
        assert torch.equal(got[j], one)
        ref = np.asarray(JT.quantile_bin_edges(jnp.asarray(Xj), B,
                                               jnp.asarray(w[j])))
        np.testing.assert_array_equal(got[j].numpy(), ref)


# ---------------------------------------------------------------------------
# the per-item-bins histogram
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gbins", [1, 2, 6], ids=["shared", "G/T", "G"])
def test_item_bins_histogram_is_a_loop_of_shared_calls(gbins, small_caps):
    small_caps.setenv("TM_KERNEL_EXACT", "1")
    rng = np.random.default_rng(gbins)
    G, n, d, S, m, B = 6, 301, 5, 5, 4, 16
    bins = rng.integers(0, B, size=(gbins, n, d)).astype(np.int32)
    stats = rng.integers(-3, 4, size=(G, n, S)).astype(np.float32)
    pos = rng.integers(0, m, size=(G, n)).astype(np.int32)
    got = tk.histogram_grid(_t(bins), _t(stats), _t(pos), m, B)
    per = G // gbins
    for s in range(gbins):
        sl = slice(s * per, (s + 1) * per)
        one = tk.histogram_torch(_t(bins[s]), _t(stats[sl]), _t(pos[sl]),
                                 m, B)
        assert torch.equal(got[sl], one)
        ref = np.asarray(jax.vmap(lambda st, p: jk.histogram_xla(
            jnp.asarray(bins[s]), st, p, m, B))(jnp.asarray(stats[sl]),
                                                jnp.asarray(pos[sl])))
        np.testing.assert_array_equal(got[sl].numpy(), ref)
    with pytest.raises(ValueError, match="do not divide"):
        tk.histogram_grid(_t(bins[:1].repeat(4, 0)), _t(stats), _t(pos),
                          m, B)


def test_launch_plan_cost_and_autotune_key_carry_gbins():
    from transmogrifai_tpu_torch.autotune import costmodel as acm
    one = tk.launch_plan(16, 1000, 28, 5, 8, 32)
    many = tk.launch_plan(16, 1000, 28, 5, 8, 32, Gbins=16)
    assert many["packed_bytes"] == 16 * one["packed_bytes"]
    assert many["workspace_words"] > one["workspace_words"]
    c1 = tk.histogram_cost(16, 1000, 28, 5, 8, 32)
    c16 = tk.histogram_cost(16, 1000, 28, 5, 8, 32, Gbins=16)
    assert c16["bytes"] - c1["bytes"] == 4.0 * 15 * 1000 * 28
    shape = dict(G=16, n=1000, d=28, B=32, S=5, m=8)
    assert acm.shape_key(shape) == (16, 1000, 28, 32, 5, 8)
    assert acm.shape_key(dict(shape, Gbins=1)) == acm.shape_key(shape)
    assert acm.shape_key(dict(shape, Gbins=16)) != acm.shape_key(shape)
    assert not np.array_equal(acm.featurize(dict(shape, Gbins=16), {}),
                              acm.featurize(shape, {}))


# ---------------------------------------------------------------------------
# CV metrics under TM_TREE_GRID_FOLD=0, against the JAX package
# ---------------------------------------------------------------------------

def _cv(M, CV, name, X, y, w, fused, **kw):
    fam = M.MODEL_FAMILIES[name]
    grid = [dict(fam.default_hyper, maxDepth=md) for md in (2.0, 4.0)]
    cv = CV(n_folds=3, metric="auroc")
    if fused:
        p = cv.dispatch_many([("a", fam, grid)], X, y, w, 2, **kw)["a"]
    else:
        p = cv.dispatch(fam, grid, X, y, w, 2, **kw)
    return cv.collect(p).grid_metrics


@pytest.mark.parametrize("fused", [True, False], ids=["sliced", "masked"])
@pytest.mark.parametrize("name,exact,tol", [
    ("DecisionTreeClassifier", True, 0.0),
    ("GBTClassifier", False, 1e-2),
    ("XGBoostClassifier", False, 1e-2)])
def test_cv_metrics_match_jax_per_instance(name, exact, tol, fused,
                                           small_caps):
    """DT bitwise in exact mode (its stats are integer-valued); GBT and
    XGBoost within ``tol`` (f32 gradients, other summation orders)."""
    small_caps.setenv("TM_TREE_GRID_FOLD", "0")
    if exact:
        small_caps.setenv("TM_KERNEL_EXACT", "1")
    X, y, w = _data()
    j = _cv(JM, JCV, name, X, y, w, fused)
    t = _cv(TM, TCV, name, X, y, w, fused, device="cpu")
    if tol == 0.0:
        np.testing.assert_array_equal(t, j)
    else:
        np.testing.assert_allclose(t, j, atol=tol)


def test_per_instance_path_differs_from_the_folded_sketch(small_caps):
    """The two paths bin differently (one shared sketch against one per
    fold), as in the JAX package; the port's gap is the JAX one."""
    small_caps.setenv("TM_KERNEL_EXACT", "1")
    X, y, w = _data(1)
    name = "DecisionTreeClassifier"
    folded = (_cv(TM, TCV, name, X, y, w, True, device="cpu"),
              _cv(JM, JCV, name, X, y, w, True))
    small_caps.setenv("TM_TREE_GRID_FOLD", "0")
    per_item = (_cv(TM, TCV, name, X, y, w, True, device="cpu"),
                _cv(JM, JCV, name, X, y, w, True))
    np.testing.assert_array_equal(folded[0], folded[1])
    np.testing.assert_array_equal(per_item[0], per_item[1])
    assert not np.array_equal(folded[0], per_item[0])


def test_forest_item_fit_bitwise_given_jax_draws(small_caps):
    """One sweep item (a fold's gathered rows, zero-weight padding) as
    the JAX package's vmapped ``fit_forest`` fits it: with JAX's draws
    the trees are bitwise, leaves within 1e-6."""
    small_caps.setenv("TM_KERNEL_EXACT", "1")
    X, y, _ = _data(2)
    n, d = X.shape
    w = np.ones(n, np.float32)
    w[-40:] = 0.0                               # the item's padding
    T, depth = 8, 4
    hyper = {"maxDepth": 3.0, "featureSubsetRate": 0.6, "numTrees": 6.0,
             "minInstancesPerNode": 1.0, "minInfoGain": 0.0, "seed": 0.0}
    j = jax.jit(partial(JT.fit_forest, n_classes=2, max_depth=depth,
                        n_bins=16, n_trees=T, classification=True))(
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(w),
        {k: jnp.float32(v) for k, v in hyper.items()})
    boot, subset = _jax_forest_draws(0, T, n, d, depth)
    bins, edges = TT._prep_items(_t(X)[None], 16, _t(w)[None])
    t = TT.fit_forest_binned(
        bins, edges, _t(y)[None], _t(w)[None],
        {k: torch.tensor([v]) for k, v in hyper.items()}, 2,
        max_depth=depth, n_trees=T, classification=True,
        boot=_t(boot)[None], subset_draws=[_t(a) for a in subset])
    for k in ("feat", "thr"):
        np.testing.assert_array_equal(t[k][0].numpy(), np.asarray(j[k]))
    for k in ("leaf", "tree_w", "feature_importance"):
        np.testing.assert_allclose(t[k][0].numpy(), np.asarray(j[k]),
                                   atol=1e-6)


def test_forest_own_draws_within_quality_of_jax(small_caps):
    """Each package's own draws, 32 trees: the grid's mean CV AUROC
    within 0.02 of the JAX package's."""
    small_caps.setenv("TM_TREE_GRID_FOLD", "0")
    for reg in (JM.MODEL_FAMILIES, TM.MODEL_FAMILIES):
        small_caps.setattr(reg["RandomForestClassifier"], "n_trees_cap", 32)
    X, y, w = _data(4, n=600)
    j = _cv(JM, JCV, "RandomForestClassifier", X, y, w, True)
    t = _cv(TM, TCV, "RandomForestClassifier", X, y, w, True, device="cpu")
    assert abs(float(np.mean(t)) - float(np.mean(j))) < 0.02, (t, j)


def test_fit_batch_shared_rows_equal_gathered_rows(small_caps):
    """An expanded X (the masked sweep: one matrix, per-item weights) and
    the same rows materialized per item give the same params bitwise."""
    small_caps.setenv("TM_KERNEL_EXACT", "1")
    X, y, _ = _data(5, n=160)
    rng = np.random.default_rng(5)
    w = (rng.random((3, 160)) < 0.7).astype(np.float32)
    fam = TM.MODEL_FAMILIES["DecisionTreeClassifier"]
    hyper = {"maxDepth": torch.tensor([2.0, 3.0, 4.0]),
             "minInstancesPerNode": 1.0, "minInfoGain": 0.0}
    Xt, yt = _t(X), _t(y)
    shared = fam.fit_batch(Xt.expand(3, -1, -1), yt.expand(3, -1), _t(w),
                           hyper, 2)
    own = fam.fit_batch(Xt.repeat(3, 1, 1), yt.repeat(3, 1), _t(w),
                        hyper, 2)
    for k in shared:
        assert torch.equal(shared[k], own[k]), k


# ---------------------------------------------------------------------------
# meshes, eight CPU ranks
# ---------------------------------------------------------------------------

@pytest.fixture
def eight_cpu_ranks(small_caps):
    from transmogrifai_tpu_torch.parallel import mesh
    small_caps.setattr(mesh, "visible_devices",
                       lambda: [torch.device("cpu")] * 8)
    return small_caps


def test_per_instance_on_grid_and_grid_by_data_meshes(eight_cpu_ranks):
    """Items are independent: a 1-D grid mesh of eight ranks gives the
    one-device metrics bitwise; on a 2 x 4 grid x data mesh (masked, the
    JAX package's 2-D layout) the row sums move with the sharding, and
    DecisionTree's integer stats keep them exact."""
    from transmogrifai_tpu_torch.parallel import get_mesh, get_mesh_2d
    eight_cpu_ranks.setenv("TM_TREE_GRID_FOLD", "0")
    eight_cpu_ranks.setenv("TM_KERNEL_EXACT", "1")
    X, y, w = _data(6, n=322)
    for name in ("DecisionTreeClassifier", "GBTClassifier"):
        one = _cv(TM, TCV, name, X, y, w, True, device="cpu")
        grid = _cv(TM, TCV, name, X, y, w, True, mesh=get_mesh())
        np.testing.assert_array_equal(grid, one)
        masked = _cv(TM, TCV, name, X, y, w, False, device="cpu")
        mesh2d = get_mesh_2d()
        assert mesh2d.shape["data"] > 1
        two = _cv(TM, TCV, name, X, y, w, True, mesh=mesh2d)
        tol = 1e-6 if name == "DecisionTreeClassifier" else 1e-2
        np.testing.assert_allclose(two, masked, atol=tol)


# ---------------------------------------------------------------------------
# TM_HIST_ACCUM_BF16=1
# ---------------------------------------------------------------------------

def _hist_case(seed, G=3, n=5000, d=5, S=3, m=4, B=8, integer=False):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, size=(n, d)).astype(np.int32)
    stats = (rng.integers(-3, 4, size=(G, n, S)) if integer
             else rng.normal(size=(G, n, S))).astype(np.float32)
    pos = rng.integers(0, m, size=(G, n)).astype(np.int32)
    return bins, stats, pos, m, B


@pytest.mark.parametrize("integer", [True, False])
def test_bf16_accumulation_within_the_reference_bound(integer, small_caps):
    bins, stats, pos, m, B = _hist_case(7, integer=integer)
    f32 = tk.histogram_torch(_t(bins), _t(stats), _t(pos), m, B)
    small_caps.setenv("TM_HIST_ACCUM_BF16", "1")
    got = tk.histogram_grid(_t(bins), _t(stats), _t(pos), m, B)
    assert got.dtype == torch.float32
    # every value a bf16 number, within the JAX package's own bound
    assert torch.equal(got, got.to(torch.bfloat16).to(torch.float32))
    np.testing.assert_allclose(got.numpy(), f32.numpy(), rtol=2e-2,
                               atol=2.0)
    if not integer:                     # real stats do round
        assert not torch.equal(got, f32)
    # the JAX BlockSpec interpret path under the same knob
    ref = np.asarray(jk.histogram_pallas_grid(
        jnp.asarray(bins), jnp.asarray(stats), jnp.asarray(pos), m, B,
        block_n=512, double_buffer=False, interpret=True))
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-2, atol=2.0)
    # exact mode wins: bitwise the f32 histogram (and the JAX one on
    # integer stats)
    small_caps.setenv("TM_KERNEL_EXACT", "1")
    exact = tk.histogram_grid(_t(bins), _t(stats), _t(pos), m, B)
    assert torch.equal(exact, f32)
    if integer:
        np.testing.assert_array_equal(exact.numpy(), np.asarray(
            jax.vmap(lambda s, p: jk.histogram_xla(
                jnp.asarray(bins), s, p, m, B))(jnp.asarray(stats),
                                                jnp.asarray(pos))))


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def test_bf16_accumulation_sums_each_nodes_runs(small_caps):
    """The plain version's rounding points are the kernel's: each
    node's rows in row order, cut every run_rows_of(n) rows, each run's
    partial rounded to bf16 and added into a bf16 sum. On integer stats
    whose run partials pass 256 (exact in f32, not in bf16) it equals a
    loop over the runs bitwise, and differs from the f32 histogram and
    from rounding at fixed blocks of rows (the JAX package's points)."""
    G, n, d, S, m, B = 2, 9000, 2, 2, 2, 4
    rng = np.random.default_rng(8)
    bins = rng.integers(0, B, size=(n, d)).astype(np.int32)
    stats = rng.integers(0, 8, size=(G, n, S)).astype(np.float32)
    pos = rng.integers(0, m, size=(G, n)).astype(np.int32)
    pos[1, :5] = m                              # rows outside [0, m)
    small_caps.setenv("TM_HIST_ACCUM_BF16", "1")
    got = tk.histogram_torch(_t(bins), _t(stats), _t(pos), m, B).numpy()
    R = tk.run_rows_of(n)
    want = np.zeros((G, m, S, d, B), np.float32)
    for g in range(G):
        for k in range(m):
            rows = np.nonzero(pos[g] == k)[0]
            assert len(rows) > R                # every node has two runs
            for r0 in range(0, len(rows), R):
                rr = rows[r0:r0 + R]
                part = np.zeros((S, d, B), np.float64)
                for j in range(d):
                    for s in range(S):
                        part[s, j] = np.bincount(
                            bins[rr, j], weights=stats[g, rr, s],
                            minlength=B)
                assert part.max() > 256         # not exact in bf16
                want[g, k] = _bf16(want[g, k] + _bf16(part))
    np.testing.assert_array_equal(got, want.reshape(G, m * S, d * B))
    small_caps.delenv("TM_HIST_ACCUM_BF16")
    f32 = tk.histogram_torch(_t(bins), _t(stats), _t(pos), m, B)
    assert not np.array_equal(got, f32.numpy())
    fixed = np.zeros_like(got)
    for r0 in range(0, n, R):
        part = tk.histogram_torch(_t(bins[r0:r0 + R]),
                                  _t(stats[:, r0:r0 + R]),
                                  _t(pos[:, r0:r0 + R]), m, B).numpy()
        fixed = _bf16(fixed + _bf16(part))
    assert not np.array_equal(got, fixed)


def test_node_runs_cut_each_nodes_rows():
    pos = torch.tensor([[0, 1, 0, 0, 5, 1, 0, 1, 0]], dtype=torch.int32)
    np.testing.assert_array_equal(tk.node_runs(pos, 2, 2).numpy(),
                                  [[0, 0, 0, 1, 0, 0, 1, 1, 2]])


def test_both_knobs_through_the_selector(small_caps):
    """TM_TREE_GRID_FOLD=0 with TM_HIST_ACCUM_BF16=1 end to end through
    BinaryClassificationModelSelector on the CPU: every tree family
    validates, the winner refits; the metrics stay within 0.05 of the
    f32 run's."""
    from transmogrifai_tpu_torch.dataset import Dataset
    from transmogrifai_tpu_torch.features import FeatureBuilder
    from transmogrifai_tpu_torch.features import types as ft
    X, y, _ = _data(9)
    ds = Dataset({"y": y.astype(np.float64), "x": X},
                 {"y": ft.RealNN, "x": ft.OPVector})
    lbl = FeatureBuilder.of(ft.RealNN, "y").from_column().as_response()
    vec = FeatureBuilder.OPVector("x").from_column().as_predictor()
    small_caps.setenv("TM_TREE_GRID_FOLD", "0")

    def fit():
        sel = TM.BinaryClassificationModelSelector.with_cross_validation(
            candidates=list(FAMILIES), device="cpu").set_input(lbl, vec)
        model = sel.fit(ds)
        return {r["family"]: np.asarray(r["gridMetrics"])
                for r in model.summary["validationResults"]}
    f32 = fit()
    small_caps.setenv("TM_HIST_ACCUM_BF16", "1")
    bf16 = fit()
    assert set(bf16) == set(FAMILIES)
    for name in FAMILIES:
        assert np.isfinite(bf16[name]).all()
        np.testing.assert_allclose(bf16[name], f32[name], atol=0.05)
