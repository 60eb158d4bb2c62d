"""The port's 2-D (grid x data) sweep on meshes of CPU ranks, against the
JAX package's 2-D mesh runs on the 8 forced host devices of
``tests/conftest.py`` and against the port's own one-device and 1-D
results: ``get_mesh_2d``, ``pad_grid_by_data``, ``grid_map``'s 2-D
branch, the lockstep rank threads of ``parallel.spmd``, the folded tree
runner and the linear sweep with their row contractions summed over the
data ranks, ``TM_MESH_AXIS=grid,data`` routing and attribution
(mirroring ``test_sweep_scaling.py``'s 2-D case).

On CPU tensors the ring's wrappers run their plain version, the
origin-order sum the CUDA kernel is held to on the card.

Tolerances, and why:
* linear CV metrics: the JAX tests' rtol 1e-4, atol 1e-6 (row sharding
  moves the f32 row sums, as JAX's 2-D against its 1-D), the same
  best grid point;
* the quantile sketch: bitwise (the edges come from the gathered rows);
* FT-Transformer: its fit at learning rate 1e-3 within 1e-5 on the
  parameters and the probabilities, its CV AUROC within 2e-3 (AdamW
  amplifies the row sums' order at larger rates: a row permutation
  alone on one device moves the fit as far);
* trees: bitwise where the stats are integer-valued (one-hot classes at
  unit weights: DT, RF, the histogram level); boosted trees end to end
  within atol 1e-2, the JAX test's own (``test_data_parallel.py``), with
  the same winner.
"""
import threading

import numpy as np
import pytest
import torch

import jax

from transmogrifai_tpu.models import tuning as JTU
from transmogrifai_tpu.parallel import mesh as JMESH
from transmogrifai_tpu_torch import models as TM
from transmogrifai_tpu_torch import parallel as TP
from transmogrifai_tpu_torch.models import trees as TT
from transmogrifai_tpu_torch.models import tuning as TTU
from transmogrifai_tpu_torch.parallel import mesh as TMESH
from transmogrifai_tpu_torch.parallel import spmd
from transmogrifai_tpu_torch.profiling import SWEEP_STATS, SweepStats

CPU = "cpu"
LINEAR_TOL = dict(rtol=1e-4, atol=1e-6)
TREE_ATOL = 1e-2
#: FT-Transformer with its rows sharded against one device: the fit at
#: learning rate 1e-3, and the CV's AUROC (see the FT tests)
FT_PARAM_ATOL = 1e-5
FT_PROB_ATOL = 1e-5
FT_AUROC_ATOL = 2e-3


@pytest.fixture(autouse=True)
def eight_cpu_ranks(monkeypatch):
    """Default meshes draw from eight CPU ranks; the mesh knobs unset."""
    for k in ("TM_MESH_DEVICES", "TM_MESH_AXIS", "TM_MESH_RDMA_RING",
              "TM_SWEEP_EXACT",
              "TM_SWEEP_FUSION", "TM_TREE_GRID_FOLD"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(TMESH, "visible_devices",
                        lambda: [torch.device(CPU)] * 8)
    yield monkeypatch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lr_data():
    rng = np.random.default_rng(0)
    n, d = 203, 5
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.7 * rng.normal(size=n) > 0
         ).astype(np.float32)
    return X, y, np.ones(n, np.float32)


@pytest.fixture
def small_boost():
    fams = [TM.MODEL_FAMILIES[f] for f in ("GBTClassifier",
                                           "XGBoostClassifier")]
    old = [f.n_rounds_cap for f in fams]
    for f in fams:
        f.n_rounds_cap = 3
    yield
    for f, o in zip(fams, old):
        f.n_rounds_cap = o


def _collect(cv, entries, X, y, w, mesh, **kw):
    return {k: cv.collect(p) for k, p in
            cv.dispatch_many(entries, X, y, w, 2, mesh, **kw).items()}


# ---------------------------------------------------------------------------
# The 2-D mesh helpers against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", range(1, 9))
def test_get_mesh_2d_shape_matches_jax(n):
    t = TP.get_mesh_2d([CPU] * n)
    j = JMESH.get_mesh_2d(jax.devices()[:n])
    assert t.axis_names == tuple(j.axis_names) == ("grid", "data")
    assert t.shape == dict(j.shape)
    assert t.size == n and len(t.rows) == t.shape["grid"]
    assert all(r.size == t.shape["data"] for r in t.rows)
    assert t.labels() == [f"cpu:{i}" for i in range(n)]


def test_get_mesh_2d_grid_size_override_and_refusals():
    m = TP.get_mesh_2d([CPU] * 8, grid_size=4)
    assert m.shape == {"grid": 4, "data": 2} == dict(
        JMESH.get_mesh_2d(jax.devices()[:8], grid_size=4).shape)
    for bad in (3, 0):
        with pytest.raises(ValueError, match="not divisible"):
            TP.get_mesh_2d([CPU] * 8, grid_size=bad)
    with pytest.raises(ValueError, match="uneven mesh rows"):
        TP.Mesh2D([[CPU, CPU], [CPU]])
    with pytest.raises(ValueError, match="2-D mesh axes"):
        TP.Mesh2D([[CPU]], ("rows", "data"))


def test_one_card_holds_a_2d_mesh_through_its_device_pool(eight_cpu_ranks):
    """No knob puts several ranks on a card: the default meshes draw from
    ``visible_devices()``, and a pool that repeats one device gives a
    2 x 2 mesh of ranks sharing it (``cpu:r`` here, ``cuda:N#r`` on a
    card); an unknown TM_MESH_ name raises."""
    eight_cpu_ranks.setattr(TMESH, "visible_devices",
                            lambda: [torch.device(CPU)] * 4)
    eight_cpu_ranks.setenv("TM_MESH_AXIS", "grid,data")
    mesh = TP.default_mesh()
    assert mesh.shape == {"grid": 2, "data": 2}
    assert TMESH.device_labels([torch.device("cuda", 0)] * 2) == [
        "cuda:0#0", "cuda:0#1"]
    eight_cpu_ranks.setenv("TM_MESH_RANKS_PER_DEVICE", "4")
    with pytest.raises(ValueError, match="TM_MESH_RANKS_PER_DEVICE"):
        TP.default_mesh()


@pytest.mark.parametrize("b,n,g,k", [(7, 10, 2, 4), (6, 8, 3, 2),
                                     (1, 5, 4, 3), (8, 12, 2, 4)])
def test_pad_grid_by_data_matches_jax(b, n, g, k):
    a = (np.arange(b * n, dtype=np.float32).reshape(b, n) + 1) % 3
    want = np.asarray(JMESH.pad_grid_by_data(a, g, k))
    assert np.array_equal(TP.pad_grid_by_data(a, g, k), want)
    got_t = TP.pad_grid_by_data(torch.from_numpy(a), g, k)
    assert np.array_equal(got_t.numpy(), want)


def test_grid_map_2d_rows_and_items_in_lockstep():
    """Items shard over the grid rows (edge-padded), the replicated rows
    and the fold-mask rows over each row's ranks (zero-padded in
    lockstep): a weighted row sum through ``spmd.row_sum`` sees every
    row exactly once, and the results come back in item order."""
    rng = np.random.default_rng(1)
    n = 11
    v = rng.integers(1, 9, size=n).astype(np.float32)
    masks = (rng.random((5, n)) > 0.4).astype(np.float32)
    scale = np.arange(5, dtype=np.float32) + 1

    def fn(items, x):
        m, s = items
        part = (torch.as_tensor(m) * x[None, :]).sum(1)
        total, = spmd.row_sum(part)
        return total * torch.as_tensor(s)

    want = (masks * v[None, :]).sum(1) * scale
    for mesh in (TP.get_mesh_2d([CPU] * 8), TP.get_mesh_2d([CPU] * 6),
                 TP.hybrid_mesh([CPU] * 8, per_host=4)):
        got = TP.grid_map(fn, (masks, scale), (torch.from_numpy(v),), mesh)
        assert np.array_equal(got.numpy(), want), mesh


def test_rank_error_breaks_the_barrier_and_surfaces():
    """A rank that raises stops its peers at their next collective and
    the caller gets the rank's own error, not a hang."""
    mesh = TP.data_mesh([CPU] * 3)

    def fn(r):
        if r == 1:
            raise KeyError("planted on rank 1")
        spmd.row_sum(torch.ones(2))
        return r

    with pytest.raises(KeyError, match="planted on rank 1"):
        spmd.run_ranks(mesh, fn, 9)
    assert spmd.current() is None
    assert spmd.row_sum(torch.ones(1))[0].item() == 1.0  # no group: as is


def test_rank_threads_inherit_grad_and_inference_modes():
    mesh = TP.data_mesh([CPU] * 2)
    with torch.inference_mode():
        seen = spmd.run_ranks(
            mesh, lambda r: torch.is_inference_mode_enabled(), 4)
    assert seen == [True, True]
    with torch.no_grad():
        seen = spmd.run_ranks(mesh, lambda r: torch.is_grad_enabled(), 4)
    assert seen == [False, False]
    names = spmd.run_ranks(mesh, lambda r: threading.current_thread().name,
                           4)
    assert names == ["tm-rank-0", "tm-rank-1"]


# ---------------------------------------------------------------------------
# The sketch and the folded trees over data ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ranks", [2, 3, 4])
@pytest.mark.parametrize("weighted", [True, False])
def test_sharded_sketch_is_bitwise_unsharded(ranks, weighted):
    rng = np.random.default_rng(ranks)
    n = 301
    X = rng.normal(size=(n, 6)).astype(np.float32)
    X[::9, 2] = np.nan
    X[:, 4] = np.round(X[:, 4])                  # ties
    w = ((np.arange(n) % 4) != 0).astype(np.float32) if weighted else None
    one = TT.quantile_bin_edges(torch.from_numpy(X), 32,
                                None if w is None else torch.from_numpy(w))
    mesh = TP.data_mesh([CPU] * ranks)
    xs = TP.shard_rows(X, mesh)
    ws = None if w is None else TP.shard_rows(w, mesh)
    got = spmd.run_ranks(mesh, lambda r: TT.quantile_bin_edges(
        xs[r], 32, None if ws is None else ws[r]), n)
    for e in got:
        assert torch.equal(e, one)


def test_grow_at_histogram_level_over_data_ranks_is_bitwise():
    """grow_tree_grid inside the rank threads (each level's histograms
    and the leaf sums summed over the ranks) with integer-valued stats:
    every rank's tree bitwise the one-device grow's, and each rank's
    row positions its own rows'."""
    rng = np.random.default_rng(3)
    n, d, B, Gb, D = 157, 5, 8, 3, 3
    bins = rng.integers(0, B, size=(n, d)).astype(np.int32)
    gw = rng.integers(-3, 4, size=(Gb, n, 1)).astype(np.float32)
    hw = rng.integers(1, 3, size=(Gb, n, 1)).astype(np.float32)
    w = rng.integers(0, 2, size=(Gb, n)).astype(np.float32)
    edges = torch.arange(B - 1, dtype=torch.float32)[None].repeat(d, 1)
    rep = dict(feat_mask=torch.ones(Gb, d), lam=torch.ones(Gb),
               gamma=torch.zeros(Gb), min_instances=torch.ones(Gb),
               depth_limit=torch.full((Gb,), float(D)))
    one = TT.grow_tree_grid(torch.from_numpy(bins), torch.from_numpy(gw),
                            torch.from_numpy(hw), torch.from_numpy(w),
                            edges, *rep.values(), max_depth=D)
    mesh = TP.data_mesh([CPU] * 4)
    sh = [TP.shard_rows(a, mesh, axis=ax) for a, ax in
          ((bins, 0), (gw, 1), (hw, 1), (w, 1))]
    got = spmd.run_ranks(mesh, lambda r: TT.grow_tree_grid(
        sh[0][r], sh[1][r], sh[2][r], sh[3][r], edges, *rep.values(),
        max_depth=D), n)
    s = -(-n // 4)
    for r, res in enumerate(got):
        for a, b in zip(res[:4], one[:4]):
            assert torch.equal(a, b)
        lo = r * s
        real = max(0, min(n, lo + s) - lo)
        assert torch.equal(res[4][:, :real], one[4][:, lo:lo + real])


def test_folded_trees_over_grid_data_match_one_device(lr_data):
    """The folded runner over a 2 x 2 grid x data mesh against one
    device: DT and RF bitwise (one-hot stats at unit weights, every draw
    made over all rows and cut to the rank's), the same best grid
    point."""
    X, y, w = lr_data
    cv = TTU.OpCrossValidation(n_folds=3)
    names = ("DecisionTreeClassifier", "RandomForestClassifier")
    entries = [(nm, TM.MODEL_FAMILIES[nm], TM.MODEL_FAMILIES[nm].make_grid())
               for nm in names]
    one = _collect(cv, entries, X, y, w, None, device=CPU)
    two = _collect(cv, entries, X, y, w, TP.get_mesh_2d([CPU] * 4))
    for nm in names:
        assert np.array_equal(two[nm].grid_metrics, one[nm].grid_metrics), nm
        assert two[nm].best_index == one[nm].best_index, nm


def _jax_test_data(n=322, d=5):
    """``test_data_parallel.py``'s ``_cv_metrics`` data (seed 7)."""
    rng = np.random.default_rng(7)
    X = rng.normal(size=(n, d)).astype(np.float32)
    beta = np.linspace(-1, 1, d).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-(X @ beta)))).astype(np.float32)
    return X, y, np.ones(n, np.float32)


@pytest.mark.parametrize("family", ["GBTClassifier", "XGBoostClassifier"])
def test_boosted_trees_over_grid_data_match_1d(family):
    """Boosted trees on the JAX 2-D-vs-1-D test's data (n = 322, d = 5,
    its full caps): the 2 x 4 grid x data mesh against the 1-D grid mesh
    of the same 8 ranks within that test's atol 1e-2 (the gradient sums'
    order moves with the sharding, and a near-tie split may part), with
    the same best grid point."""
    X, y, w = _jax_test_data()
    fam = TM.MODEL_FAMILIES[family]
    cv = TTU.OpCrossValidation(n_folds=3, metric="auroc")
    one = cv.validate(fam, fam.make_grid(), X, y, w, 2,
                      mesh=TP.get_mesh([CPU] * 8))
    two = cv.validate(fam, fam.make_grid(), X, y, w, 2,
                      mesh=TP.get_mesh_2d([CPU] * 8))
    np.testing.assert_allclose(two.grid_metrics, one.grid_metrics, rtol=0,
                               atol=TREE_ATOL)
    assert two.best_index == one.best_index


# ---------------------------------------------------------------------------
# The linear sweep over grid x data against the JAX package's 2-D mesh
# ---------------------------------------------------------------------------

def _lr_entries(F):
    fam = F["LogisticRegression"]
    return [("lr", fam, fam.make_grid({"regParam": [0.01, 0.1],
                                       "elasticNetParam": [0.0, 0.5]}))]


def test_lr_cv_over_2x4_ranks_matches_jax_2d(lr_data):
    """LR's CV over 2 x 4 CPU ranks (the elastic-net items run Newton,
    the power iteration and FISTA, every row contraction summed over
    the 4 data ranks) against JAX's get_mesh_2d() on its 8 devices and
    against the port's one-device run."""
    X, y, w = lr_data
    t = _collect(TTU.OpCrossValidation(n_folds=3), _lr_entries(
        TM.MODEL_FAMILIES), X, y, w, TP.get_mesh_2d([CPU] * 8,
                                                    grid_size=2))["lr"]
    jcv = JTU.OpCrossValidation(n_folds=3)
    j = jcv.collect(jcv.dispatch_many(
        _lr_entries(__import__("transmogrifai_tpu.models",
                               fromlist=["x"]).MODEL_FAMILIES),
        X, y, w, 2, JMESH.get_mesh_2d())["lr"])
    np.testing.assert_allclose(t.grid_metrics, j.grid_metrics, **LINEAR_TOL)
    assert t.best_index == j.best_index
    one = _collect(TTU.OpCrossValidation(n_folds=3), _lr_entries(
        TM.MODEL_FAMILIES), X, y, w, None, device=CPU)["lr"]
    np.testing.assert_allclose(t.grid_metrics, one.grid_metrics,
                               **LINEAR_TOL)
    assert t.best_index == one.best_index


@pytest.mark.parametrize("family", ["LinearSVC", "NaiveBayes",
                                    "LinearRegression",
                                    "GeneralizedLinearRegression"])
def test_other_linear_families_over_grid_data_match_one_device(lr_data,
                                                               family):
    """The closed forms (ridge, naive Bayes: one packed exchange), IRLS
    (each step's gradient and Hessian packed into one exchange) and
    Nesterov over a 2 x 2 mesh against one device."""
    X, y, w = lr_data
    fam = TM.MODEL_FAMILIES[family]
    regression = "regression" in fam.problem_types
    yy = (X[:, 0] * 0.5 + 2.0 + 0.1 * y) if regression else y
    if family == "GeneralizedLinearRegression":
        yy = np.exp(0.3 * X[:, 0])
    metric = "rmse" if regression else "auroc"
    k = 1 if regression else 2
    grid = fam.make_grid({"familyLink": [0.0, 1.0], "regParam": [0.1]}
                         if family == "GeneralizedLinearRegression" else None)
    cv = TTU.OpCrossValidation(n_folds=3, metric=metric)
    ent = [("f", fam, grid)]
    yy = np.asarray(yy, np.float32)
    one = {key: cv.collect(p) for key, p in cv.dispatch_many(
        ent, X, yy, w, k, device=CPU).items()}["f"]
    two = {key: cv.collect(p) for key, p in cv.dispatch_many(
        ent, X, yy, w, k, TP.get_mesh_2d([CPU] * 4)).items()}["f"]
    np.testing.assert_allclose(two.grid_metrics, one.grid_metrics,
                               **LINEAR_TOL)
    assert two.best_index == one.best_index


@pytest.fixture
def small_ft(monkeypatch):
    fam = TM.MODEL_FAMILIES["FTTransformerClassifier"]
    for k, v in {"d_model": 16, "d_ff": 32, "n_steps": 20}.items():
        monkeypatch.setattr(fam, k, v)
    return fam


@pytest.mark.parametrize("ranks", [2, 4])
def test_ft_transformer_fit_over_data_ranks_matches_one_device(lr_data,
                                                               small_ft,
                                                               ranks):
    """FT-Transformer's fit with its rows sharded over ``ranks`` data
    ranks against one device, on a fold's 0/1 weights: the
    standardisation's weighted sums and every AdamW step's gradient are
    summed over the ranks, so every rank holds the full-batch fit. Only
    the row sums' order moves. At learning rate 1e-3 the 20 steps keep
    that at the order's own size: read 7.7e-7 on the parameters and
    3.9e-7 on the probabilities (a row permutation alone on one device:
    1.1e-6 and 4.8e-7). A rank that summed its own rows alone misses by
    more than 0.09 and 0.8. (Larger rates amplify the order: at 1e-2 a
    permutation alone moves the probabilities by 6e-3.)"""
    X, y, w = lr_data
    w = (np.random.default_rng(5).random(len(w)) > 0.33).astype(np.float32)
    fam, G = small_ft, 2
    hy = {"learningRate": torch.tensor([1e-3, 1e-3]),
          "weightDecay": torch.tensor([0.0, 1e-4])}

    def fit(Xr, yr, wr):
        return fam.fit_batch(torch.as_tensor(Xr).expand(G, -1, -1),
                             torch.as_tensor(yr).expand(G, -1),
                             torch.as_tensor(wr).expand(G, -1), hy, 2)

    def flat(p):
        return torch.cat([t.reshape(G, -1) for t in
                          TM.base.tree_leaves(p)], 1)

    one = fit(X, y, w)
    mesh = TP.data_mesh([CPU] * ranks)
    xs, ys, ws = (TP.shard_rows(a, mesh) for a in (X, y, w))
    res = spmd.run_ranks(mesh, lambda r: fit(xs[r], ys[r], ws[r]), len(y))
    for r, p in enumerate(res):
        torch.testing.assert_close(flat(p), flat(one), rtol=0,
                                   atol=FT_PARAM_ATOL,
                                   msg=lambda m: f"rank {r}: {m}")
    for g in range(G):
        def probs(p):
            return fam.predict_kernel(TM.base.tree_map(lambda v: v[g], p),
                                      torch.as_tensor(X), 2)
        torch.testing.assert_close(probs(res[0]), probs(one), rtol=0,
                                   atol=FT_PROB_ATOL)


def test_ft_transformer_cv_over_grid_data_matches_one_device(lr_data,
                                                            small_ft):
    """FT-Transformer's CV over a 2 x 2 mesh against one device: AUROC
    within FT_AUROC_ATOL (at these rates the sharded fits' probabilities
    move by up to ~1e-3 with the row sums' order, as a permutation
    alone moves them, and a validation pair whose order flips moves a
    fold's AUROC by 1 / (positives x negatives), ~1e-3 here), the same
    best grid point."""
    X, y, w = lr_data
    fam = small_ft
    cv = TTU.OpCrossValidation(n_folds=3)
    ent = [("ft", fam, fam.make_grid({"learningRate": [3e-3, 1e-2],
                                      "weightDecay": [1e-4]}))]
    one = _collect(cv, ent, X, y, w, None, device=CPU)["ft"]
    two = _collect(cv, ent, X, y, w, TP.get_mesh_2d([CPU] * 4))["ft"]
    np.testing.assert_allclose(two.grid_metrics, one.grid_metrics, rtol=0,
                               atol=FT_AUROC_ATOL)
    assert two.best_index == one.best_index


def test_a_family_fitting_shards_alone_is_refused_on_grid_data(lr_data):
    """A family whose fit does not make its row reductions through
    parallel.spmd is refused on a grid x data mesh (each rank would fit
    its shard alone), and still runs on a 1-D grid mesh."""
    X, y, w = lr_data
    base = TM.MODEL_FAMILIES["LogisticRegression"]

    class ShardBlind(type(base)):
        name = ""                       # unnamed: not registered
        rows_sharded = False

    fam = ShardBlind()
    fam.name = "ShardBlindLR"
    cv = TTU.OpCrossValidation(n_folds=2)
    ent = [("x", fam, fam.make_grid({"regParam": [0.1]}))]
    with pytest.raises(NotImplementedError, match="ShardBlindLR"):
        cv.dispatch_many(ent, X, y, w, 2, TP.get_mesh_2d([CPU] * 4))
    flat = _collect(cv, ent, X, y, w, TP.get_mesh([CPU] * 2))["x"]
    assert np.isfinite(flat.grid_metrics).all()


def test_tm_mesh_axis_2d_routes_the_selector(eight_cpu_ranks, lr_data):
    """TM_MESH_AXIS=grid,data routes the fused sweep through the 2-D
    runners (the sweep's labels end in /2d, the folded one's start with
    folded2d/), every rank of every grid row is attributed with its
    row's real items, and the metrics equal the 1-D mesh's within the
    tolerance (mirrors test_sweep_scaling.py's 2-D case)."""
    X, y, w = lr_data
    cv = TTU.OpCrossValidation(n_folds=2, metric="auroc")
    fams = TM.MODEL_FAMILIES
    entries = _lr_entries(fams) + [
        ("dt", fams["DecisionTreeClassifier"],
         fams["DecisionTreeClassifier"].make_grid())]
    flat = _collect(cv, entries, X, y, w, TP.get_mesh())
    eight_cpu_ranks.setenv("TM_MESH_AXIS", "grid,data")
    mesh = TP.default_mesh()
    assert mesh.shape == {"grid": 2, "data": 4}
    before = SWEEP_STATS.snapshot()
    two_d = _collect(cv, entries, X, y, w, mesh)
    delta = SweepStats.delta(before, SWEEP_STATS.snapshot())
    assert set(delta["devices"]) == set(mesh.labels())
    progs = set(delta["programs"])
    assert any(p.endswith("/2d") and "LogisticRegression" in p
               for p in progs)
    assert "folded2d/DecisionTreeClassifier/k2" in progs
    # each grid row's ranks share its items: 4 x the real items in all
    real = sum(2 * len(g) for _, _, g in entries)
    assert sum(c["items"] for c in delta["devices"].values()) == 4 * real
    for key, _, _ in entries:
        np.testing.assert_allclose(flat[key].grid_metrics,
                                   two_d[key].grid_metrics, **LINEAR_TOL,
                                   err_msg=key)


def test_grid_data_items_do_not_depend_on_their_grid_row(lr_data):
    """An item's metric is the same whichever grid row fits it: the same
    grid on 1 x 4 and 2 x 4 meshes (different row assignment, the same
    data split) bitwise, and a retried 2-D batch (chunks, each booking
    its attribution) bitwise too."""
    X, y, w = lr_data
    ent = _lr_entries(TM.MODEL_FAMILIES)
    cv = TTU.OpCrossValidation(n_folds=3)
    a = _collect(cv, ent, X, y, w, TP.Mesh2D([[CPU] * 4]))["lr"]
    b = _collect(cv, ent, X, y, w, TP.get_mesh_2d([CPU] * 8,
                                                  grid_size=2))["lr"]
    assert np.array_equal(a.grid_metrics, b.grid_metrics)
    pend = cv.dispatch_many(ent, X, y, w, 2, TP.get_mesh_2d([CPU] * 4))
    batch = pend["lr"].batch
    whole = batch.materialize()
    before = SWEEP_STATS.snapshot()
    retried = batch._retry_fn(3)
    delta = SweepStats.delta(before, SWEEP_STATS.snapshot())
    # 3 chunks, each booked on all 4 ranks
    assert sum(c["dispatches"] for c in delta["devices"].values()) == 3 * 4
    assert np.array_equal(np.asarray(retried), whole)
