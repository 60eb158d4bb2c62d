"""The port's multi-device paths on meshes of CPU ranks, against the JAX
package's mesh runs on the 8 forced host devices of ``tests/conftest.py``
and against the port's own one-device results: the row-sharded
SanityChecker statistics, the sharded sparse fits, and the selector's
1-D grid sharding (``get_mesh``, ``default_mesh``, ``grid_map``,
``TM_MESH_DEVICES`` steering, per-rank attribution and the
``models.sweep.chip_dispatch`` fault point).

On CPU tensors the ring's wrappers run their plain version, the
origin-order sum the CUDA kernel is held to on the card; the pool a
default mesh draws from (``parallel.mesh.visible_devices``) is eight CPU
ranks here, as the JAX side forces eight host devices.

Tolerances, and why:
* statistics: the JAX tests' own (rtol 1e-4, atol 1e-5; Spearman on
  uneven rows rtol 1e-3, atol 1e-4): f32 sums of the same terms per
  shard, then across shards. On integer-valued inputs every sum of the
  first pass is an exact f32 integer, so mean, std, variance, min, max,
  y_mean and y_std equal the one-rank result bitwise; corr_label,
  corr_ff and spearman sum non-integer products and keep the tolerance;
* sparse fits: the JAX tests' rtol 1e-4, atol 1e-6 (the sharded step
  divides the reduced raw gradient by the global Σw, the one-device
  step each row's share before its scatter);
* grid sharding: bitwise. Items are independent, so no mesh size, and
  no thread dispatching beside another, may move a bit; against the
  JAX package's mesh runs the sweep's own LINEAR_TOL (1e-5).
"""
import threading

import numpy as np
import pytest
import torch

import jax

from transmogrifai_tpu import models as JM
from transmogrifai_tpu.models import sparse as JS
from transmogrifai_tpu.models.tuning import OpCrossValidation as JCV
from transmogrifai_tpu.ops import sanity_checker as JSC
from transmogrifai_tpu.parallel import data_parallel as JDP
from transmogrifai_tpu.parallel import mesh as JMESH
from transmogrifai_tpu_torch import models as TM
from transmogrifai_tpu_torch import parallel as TP
from transmogrifai_tpu_torch.models import sparse as TS
from transmogrifai_tpu_torch.models import tuning as TTU
from transmogrifai_tpu_torch.ops import sanity_checker as TSC
from transmogrifai_tpu_torch.parallel import mesh as TMESH
from transmogrifai_tpu_torch.profiling import SWEEP_STATS, SweepStats
from transmogrifai_tpu_torch.resilience import faults

CPU = "cpu"
STAT_KEYS = ("mean", "std", "variance", "min", "max", "corr_label",
             "spearman", "corr_ff", "y_mean", "y_std")
#: keys whose formulas are first-pass sums only (bitwise on integers)
SUM_KEYS = ("mean", "std", "variance", "min", "max", "y_mean", "y_std")
LINEAR_TOL = 1e-5


@pytest.fixture(autouse=True)
def eight_cpu_ranks(monkeypatch):
    """Default meshes draw from eight CPU ranks; the mesh knobs unset."""
    for k in ("TM_MESH_DEVICES", "TM_MESH_AXIS", "TM_MESH_RDMA_RING",
              "TM_SWEEP_EXACT", "TM_SWEEP_FUSION"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(TMESH, "visible_devices",
                        lambda: [torch.device(CPU)] * 8)
    faults.reset()
    yield monkeypatch
    faults.reset()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_mesh(k, axis="grid"):
    return TP.get_mesh([CPU] * k, axis=axis)


# ---------------------------------------------------------------------------
# The mesh: labels, default mesh, grid_map
# ---------------------------------------------------------------------------

def test_default_mesh_spans_the_configured_pool(eight_cpu_ranks):
    m = TP.default_mesh()
    assert m.size == 8 and m.axis_names == ("grid",)
    assert m.shape == {"grid": 8}
    assert m.labels() == [f"cpu:{i}" for i in range(8)]
    eight_cpu_ranks.setenv("TM_MESH_DEVICES", "2")
    assert TP.default_mesh().size == 2
    assert JMESH.default_mesh().devices.size == 2
    eight_cpu_ranks.setenv("TM_MESH_DEVICES", "3")
    with pytest.raises(ValueError, match="does not divide"):
        TP.default_mesh()
    eight_cpu_ranks.delenv("TM_MESH_DEVICES")
    assert TP.data_mesh().axis_names == ("data",)
    eight_cpu_ranks.setenv("TM_MESH_AXIS", "grid,data")
    m2, j2 = TP.default_mesh(), JMESH.default_mesh()
    assert m2.axis_names == tuple(j2.axis_names) == ("grid", "data")
    assert m2.shape == dict(j2.shape) == {"grid": 2, "data": 4}
    assert [s.labels() for s in m2.rows] == [
        [f"cpu:{i}" for i in range(4)], [f"cpu:{i}" for i in range(4, 8)]]
    with pytest.raises(ValueError, match="unknown mesh axis"):
        TP.Mesh([CPU], axis="rows")


def test_grid_map_rejects_none_leaves():
    with pytest.raises(ValueError, match="None leaves"):
        TP.grid_map(lambda item: item[0], (np.ones((8, 4)), None),
                    mesh=_cpu_mesh(2))
    with pytest.raises(ValueError, match="None leaves"):
        JMESH.grid_map(lambda item: item[0],
                       (jax.numpy.ones((8, 4)), None))


@pytest.mark.parametrize("k", [1, 3, 8])
def test_grid_map_shards_in_order_and_slices_the_padding(k):
    """Rank r gets the contiguous shard r of the edge-padded batch, with
    the replicated tensors on its device; results come back in order."""
    a = np.arange(10, dtype=np.float32)
    seen = []

    def fn(shard, scale):
        x, hy = shard
        seen.append(len(x))
        return {"v": torch.from_numpy(x) * scale + hy["h"]}

    out = TP.grid_map(fn, (a, {"h": torch.from_numpy(a[::-1].copy())}),
                      (torch.tensor(2.0),), mesh=_cpu_mesh(k))
    assert np.array_equal(out["v"].numpy(), a * 2 + a[::-1])
    assert seen == [-(-10 // k)] * k


# ---------------------------------------------------------------------------
# sharded_statistics and SanityChecker(mesh=)
# ---------------------------------------------------------------------------

def _stats_case(case):
    """The JAX tests' inputs (test_data_parallel.py)."""
    if case == "constant_column":
        rng = np.random.default_rng(0)
        X = rng.normal(size=(1000, 12)).astype(np.float32)
        X[:, 3] = 0.0
        y = (rng.random(1000) > 0.5).astype(np.float32)
    else:
        rng = np.random.default_rng(1)
        X = rng.normal(size=(1003, 5)).astype(np.float32)
        y = rng.normal(size=1003).astype(np.float32)
    return X, y


@pytest.mark.parametrize("case", ["constant_column", "uneven_rows"])
def test_sharded_statistics_match_jax_and_one_rank(case):
    X, y = _stats_case(case)
    got = TP.sharded_statistics(X, y, TP.data_mesh([CPU] * 8))
    one = TSC.compute_statistics(X, y, CPU)
    jax_sh = JDP.sharded_statistics(X, y, JDP.data_mesh())
    assert set(got) == set(STAT_KEYS) == set(jax_sh)
    for ref in (one, jax_sh):
        for k in STAT_KEYS:
            tol = (dict(rtol=1e-3, atol=1e-4) if k == "spearman"
                   and case == "uneven_rows" else dict(rtol=1e-4,
                                                       atol=1e-5))
            np.testing.assert_allclose(got[k], np.asarray(ref[k]),
                                       err_msg=k, equal_nan=True, **tol)


@pytest.mark.parametrize("ndev", [2, 3, 8])
def test_sharded_statistics_integer_inputs_bitwise(eight_cpu_ranks, ndev):
    """Integer-valued inputs: the first-pass keys equal the one-rank
    result bitwise, and the ring (forced on) equals the plain version."""
    rng = np.random.default_rng(5)
    X = rng.integers(-6, 7, size=(1001, 6)).astype(np.float32)
    X[:, 2] = 3.0
    y = rng.integers(0, 2, 1001).astype(np.float32)
    one = TSC.compute_statistics(X, y, CPU)
    mesh = TP.data_mesh([CPU] * ndev)
    eight_cpu_ranks.setenv("TM_MESH_RDMA_RING", "1")
    ring = TP.sharded_statistics(X, y, mesh)
    eight_cpu_ranks.setenv("TM_MESH_RDMA_RING", "0")
    plain = TP.sharded_statistics(X, y, mesh)
    for k in STAT_KEYS:
        assert np.array_equal(ring[k], plain[k], equal_nan=True), k
        if k in SUM_KEYS:
            assert np.array_equal(ring[k], one[k], equal_nan=True), k
        else:
            np.testing.assert_allclose(ring[k], one[k], rtol=1e-4,
                                       atol=1e-5, equal_nan=True,
                                       err_msg=k)


def test_sharded_spearman_average_ranks_match_scipy_on_ties():
    """The columns of the JAX test, ranked across 8 shards: the average
    ranks of the full columns, as scipy.stats.spearmanr."""
    from scipy.stats import spearmanr
    rng = np.random.default_rng(7)
    n = 500
    X = np.stack([
        (rng.random(n) > 0.8).astype(np.float32),
        rng.integers(0, 3, n).astype(np.float32),
        rng.normal(size=n).astype(np.float32),
        np.round(rng.normal(size=n), 1).astype(np.float32),
        np.zeros(n, np.float32),
    ], axis=1)
    y = (X[:, 0] + rng.normal(0, 0.5, n) > 0.5).astype(np.float32)
    got = TP.sharded_statistics(X, y, TP.data_mesh([CPU] * 8))["spearman"]
    for j in range(4):
        np.testing.assert_allclose(got[j], spearmanr(X[:, j], y).statistic,
                                   atol=1e-6, err_msg=f"column {j}")
    assert got[4] == 0.0                   # the constant column's guard


def test_sharded_statistics_refuse_rows_past_the_f32_rank_limit():
    n = TP.data_parallel.MAX_STATISTICS_ROWS + 1
    with pytest.raises(ValueError, match="2\\*\\*23"):
        TP.sharded_statistics(np.zeros((n, 1), np.float32),
                              np.zeros(n, np.float32),
                              TP.data_mesh([CPU] * 2))


def _checker_ds(pkg, n, seed):
    """The JAX checker test's columns (fine, constant, leaky, fine) at n
    rows, plus a planted near-copy of the label."""
    if pkg == "jax":
        from transmogrifai_tpu.features import types as ft
        from transmogrifai_tpu.testkit import TestFeatureBuilder
    else:
        from transmogrifai_tpu_torch.features import types as ft
        from transmogrifai_tpu_torch.testkit import TestFeatureBuilder
    rng = np.random.default_rng(seed)
    y = (rng.random(n) > 0.5).astype(float)
    vecs = np.stack([rng.normal(size=n), np.zeros(n),
                     y * 2 - 1 + rng.normal(0, 1e-4, n),
                     rng.normal(size=n),
                     y + rng.normal(0, 0.05, n)], axis=1)
    return TestFeatureBuilder.of(
        {"label": (ft.RealNN, y.tolist()),
         "vec": (ft.OPVector, [tuple(r) for r in vecs])}, response="label")


@pytest.mark.parametrize("n,seed", [(400, 4), (2000, 9)])
def test_sanity_checker_mesh_equals_local_and_jax(n, seed):
    ds, feats = _checker_ds("torch", n, seed)
    local = TSC.SanityChecker(device=CPU).set_input(
        feats["label"], feats["vec"]).fit(ds)
    mesh = TP.data_mesh([CPU] * 8)
    checker = TSC.SanityChecker(mesh=mesh)
    dist = checker.set_input(feats["label"], feats["vec"]).fit(ds)
    jds, jfeats = _checker_ds("jax", n, seed)
    jdist = JSC.SanityChecker(mesh=JDP.data_mesh()).set_input(
        jfeats["label"], jfeats["vec"]).fit(jds)
    assert dist.summary["dropped"] == local.summary["dropped"] \
        == jdist.summary["dropped"]
    assert dist.params["keep_indices"] == local.params["keep_indices"] \
        == jdist.params["keep_indices"] == [0, 3]
    # the mesh is transient: neither a param nor in the saved stage
    from transmogrifai_tpu_torch.stages import stage_to_json
    assert "mesh" not in checker.params
    assert "mesh" not in str(stage_to_json(dist))


def test_grid_data_axis_routes_the_checker_through_sharded_statistics(
        eight_cpu_ranks):
    ds, feats = _checker_ds("torch", 600, 2)
    calls = []
    real = TP.data_parallel.sharded_statistics

    def spy(X, y, mesh=None):
        calls.append(mesh.size)
        return real(X, y, mesh)

    eight_cpu_ranks.setattr(TP.data_parallel, "sharded_statistics", spy)
    local = TSC.SanityChecker(device=CPU).set_input(
        feats["label"], feats["vec"]).fit(ds)
    assert calls == []
    eight_cpu_ranks.setenv("TM_MESH_AXIS", "grid,data")
    sharded = TSC.SanityChecker(device=CPU).set_input(
        feats["label"], feats["vec"]).fit(ds)
    assert calls == [8]
    assert sharded.summary["dropped"] == local.summary["dropped"]
    assert sharded.params["keep_indices"] == local.params["keep_indices"]


# ---------------------------------------------------------------------------
# The sharded sparse fits
# ---------------------------------------------------------------------------

def _ctr_data(n, seed=42):
    """``test_sparse.py``'s synthetic CTR rows (its ``_ctr_data``)."""
    from transmogrifai_tpu_torch.ops.sparse import hash_tokens
    rng = np.random.default_rng(seed)
    cats = {f"c{j}": rng.integers(0, 50, n) for j in range(6)}
    nums = rng.normal(size=(n, 4)).astype(np.float32)
    logits = ((cats["c0"] % 7 < 3).astype(np.float32) * 1.5
              - (cats["c1"] % 5 < 2).astype(np.float32) * 1.2
              + nums[:, 0] * 0.8)
    y = (rng.random(n) < 1 / (1 + np.exp(-logits))).astype(np.float32)
    idx = np.zeros((n, 6), np.int32)
    for j, (name, col) in enumerate(sorted(cats.items())):
        idx[:, j] = hash_tokens([f"{name}|{v}" for v in col], 1 << 12, 42)
    return idx, nums, y


def _close(got, want, what):
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=f"{what} {k}")


def test_sparse_lr_sharded_matches_single_device_and_jax():
    idx, nums, y = _ctr_data(2000)
    w = np.ones_like(y)
    kw = dict(lr=0.1, l2=1e-6, epochs=2, batch_size=256)
    single = TS.fit_sparse_lr(idx, nums, y, w, 1 << 12, device=CPU, **kw)
    sharded = TS.fit_sparse_lr_sharded(idx, nums, y, w, 1 << 12,
                                       mesh=TP.data_mesh([CPU] * 8), **kw)
    jsh = JS.fit_sparse_lr_sharded(idx, nums, y, w, 1 << 12,
                                   mesh=JDP.data_mesh(), **kw)
    _close(sharded, single, "port single")
    _close(sharded, jsh, "jax sharded")


def _fm_softmax_data():
    n, K, D, B = 1024, 4, 3, 1 << 10
    rng = np.random.default_rng(31)
    idx = rng.integers(0, B, size=(n, K)).astype(np.int32)
    X = rng.normal(size=(n, D)).astype(np.float32)
    return idx, X, np.ones(n, np.float32), B, rng


def test_sparse_fm_and_softmax_sharded_match_single_device_and_jax():
    idx, X, w, B, rng = _fm_softmax_data()
    mesh = TP.data_mesh([CPU] * 8)
    yb = (rng.random(len(w)) < 0.5).astype(np.float32)
    emb = np.asarray(JS.init_sparse_fm(B, X.shape[1], 4, 3)["emb"])
    kw = dict(k=4, lr=0.1, epochs=1, batch_size=256)
    a = TS.fit_sparse_fm(idx, X, yb, w, B, seed=3, emb=emb, device=CPU,
                         **kw)
    b = TS.fit_sparse_fm_sharded(idx, X, yb, w, B, mesh=mesh, seed=3,
                                 emb=emb, **kw)
    jb = JS.fit_sparse_fm_sharded(idx, X, yb, w, B, mesh=JDP.data_mesh(),
                                  seed=3, **kw)
    _close(b, a, "port fm single")
    _close(b, jb, "jax fm sharded")
    # without emb both draw it from the seed's CPU generator
    _close(TS.fit_sparse_fm_sharded(idx, X, yb, w, B, mesh=mesh, seed=3,
                                    **kw),
           TS.fit_sparse_fm(idx, X, yb, w, B, seed=3, device=CPU, **kw),
           "port fm own draw")
    ym = rng.integers(0, 3, len(w)).astype(np.float32)
    c = TS.fit_sparse_softmax(idx, X, ym, w, B, 3, lr=0.2, epochs=1,
                              batch_size=256, device=CPU)
    d = TS.fit_sparse_softmax_sharded(idx, X, ym, w, B, 3, mesh=mesh,
                                      lr=0.2, epochs=1, batch_size=256)
    jd = JS.fit_sparse_softmax_sharded(idx, X, ym, w, B, 3,
                                       mesh=JDP.data_mesh(), lr=0.2,
                                       epochs=1, batch_size=256)
    _close(d, c, "port softmax single")
    _close(d, jd, "jax softmax sharded")
    with pytest.raises(ValueError, match="label ids"):
        TS.fit_sparse_softmax_sharded(idx, X, ym + 5, w, B, 3, mesh=mesh)


@pytest.mark.parametrize("family", ["lr", "fm", "softmax"])
@pytest.mark.parametrize("ndev", [3, 4])
def test_sharded_uneven_batches_and_lazy_l2(family, ndev):
    """1000 rows at batch 256 (a padded last batch), shards of unequal
    size (256 rows over 3 ranks), uneven weights and l2 > 0: the touched
    mask is the union over ranks and Σw the global batch's."""
    idx, X, w, B, rng = _fm_softmax_data()
    idx, X = idx[:1000], X[:1000]
    w = rng.uniform(0.2, 2.0, 1000).astype(np.float32)
    w[rng.random(1000) < 0.2] = 0.0
    mesh = TP.data_mesh([CPU] * ndev)
    kw = dict(lr=0.1, l2=0.05, epochs=2, batch_size=256)
    if family == "softmax":
        y = rng.integers(0, 3, 1000).astype(np.float32)
        single = TS.fit_sparse_softmax(idx, X, y, w, B, 3, device=CPU, **kw)
        sharded = TS.fit_sparse_softmax_sharded(idx, X, y, w, B, 3,
                                                mesh=mesh, **kw)
    else:
        y = (rng.random(1000) < 0.4).astype(np.float32)
        one = TS.fit_sparse_lr if family == "lr" else TS.fit_sparse_fm
        sh = (TS.fit_sparse_lr_sharded if family == "lr"
              else TS.fit_sparse_fm_sharded)
        single = one(idx, X, y, w, B, device=CPU, **kw)
        sharded = sh(idx, X, y, w, B, mesh=mesh, **kw)
    _close(sharded, single, family)


def test_local_sum_of_weights_fault_breaks_the_sharded_fit(eight_cpu_ranks):
    """A planted fault: each rank normalises its gradient by its own Σw
    (and the reduced Σw is the mesh size's share of one). The fit must
    then leave the single-device fit's tolerance."""
    idx, X, w, B, rng = _fm_softmax_data()
    w = rng.uniform(0.2, 2.0, len(w)).astype(np.float32)
    y = (rng.random(len(w)) < 0.4).astype(np.float32)
    mesh = TP.data_mesh([CPU] * 4)
    kw = dict(lr=0.1, l2=0.01, epochs=1, batch_size=256)
    single = TS.fit_sparse_lr(idx, X, y, w, B, device=CPU, **kw)
    _close(TS.fit_sparse_lr_sharded(idx, X, y, w, B, mesh=mesh, **kw),
           single, "sound")
    real = TS._rank_parts

    def local_mean(grad_fn, *a, **k):
        def grads(*ga, mean=False):
            return grad_fn(*ga, mean=True)
        buf = real(grads, *a, **k)
        buf[0] = 1.0 / mesh.size
        return buf

    eight_cpu_ranks.setattr(TS, "_rank_parts", local_mean)
    faulty = TS.fit_sparse_lr_sharded(idx, X, y, w, B, mesh=mesh, **kw)
    with pytest.raises(AssertionError):
        _close(faulty, single, "faulty")


# ---------------------------------------------------------------------------
# Grid sharding of the validator and the selector
# ---------------------------------------------------------------------------

@pytest.fixture()
def lr_data():
    """``test_sweep_scaling.py``'s data (its rng fixture's seed)."""
    rng = np.random.default_rng(42)
    n, d = 240, 6
    X = rng.normal(size=(n, d)).astype(np.float32)
    beta = rng.normal(size=d).astype(np.float32)
    y = (X @ beta + 0.3 * rng.normal(size=n) > 0).astype(np.float32)
    return X, y, np.ones(n, np.float32)


def _entries(F=TM.MODEL_FAMILIES, grid_reg=(0.01, 0.1, 1.0)):
    """``test_sweep_scaling.py``'s ``_entries()`` (LR + NB)."""
    lr, nb = F["LogisticRegression"], F["NaiveBayes"]
    return [("0:LR", lr, lr.make_grid({"regParam": list(grid_reg),
                                       "elasticNetParam": [0.0]})),
            ("1:NB", nb, nb.make_grid(None))]


def _collect_all(cv, entries, X, y, w, mesh, **kw):
    pend = cv.dispatch_many(entries, X, y, w, 2, mesh, **kw)
    return {k: cv.collect(p).grid_metrics for k, p in pend.items()}


def test_mesh_size_bitwise_invariance_threaded(lr_data):
    """1, 2 and 8 CPU ranks dispatched from three threads at once: the
    same bits as the one-device sweep, and the JAX package's mesh runs
    within the sweep's tolerance."""
    X, y, w = lr_data
    cv = TTU.OpCrossValidation(n_folds=2, metric="auroc")
    single = _collect_all(cv, _entries(), X, y, w, None, device=CPU)
    results, errors = {}, []

    def run(nd):
        try:
            results[nd] = _collect_all(cv, _entries(), X, y, w,
                                       _cpu_mesh(nd))
        except BaseException as e:     # surfaced below, not swallowed
            errors.append((nd, e))

    threads = [threading.Thread(target=run, args=(nd,)) for nd in (1, 2, 8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    jcv = JCV(n_folds=2, metric="auroc")
    jres = _collect_all(jcv, _entries(JM.MODEL_FAMILIES), X, y, w,
                        JMESH.get_mesh(jax.devices()))
    for key, _, _ in _entries():
        for nd in (1, 2, 8):
            assert np.array_equal(single[key], results[nd][key]), (key, nd)
        np.testing.assert_allclose(single[key], jres[key], atol=LINEAR_TOL,
                                   err_msg=key)


def test_ragged_grid_exact_equals_the_serial_validator(eight_cpu_ranks,
                                                       lr_data):
    """3 grid points x 2 folds and NB's singleton x 2 folds over 8 ranks
    (edge-padded shards) under TM_SWEEP_EXACT=1: bitwise the serial
    validator per candidate on one device, as on the JAX meshes."""
    eight_cpu_ranks.setenv("TM_SWEEP_EXACT", "1")
    X, y, w = lr_data
    cv = TTU.OpCrossValidation(n_folds=2, metric="auroc")
    for _, _, grid in _entries():
        assert (2 * len(grid)) % 8
    serial = {key: cv.validate(fam, grid, X, y, w, 2, device=CPU)
              for key, fam, grid in _entries()}
    for nd in (2, 8):
        fused = _collect_all(cv, _entries(), X, y, w, _cpu_mesh(nd))
        for key, _, _ in _entries():
            assert np.array_equal(serial[key].grid_metrics, fused[key]), (
                key, nd)


def test_tm_mesh_devices_steers_the_default_mesh(eight_cpu_ranks, lr_data):
    """TM_MESH_DEVICES=2 shrinks the default mesh: the attribution names
    exactly the 2 ranks' labels, and every metric keeps its bits."""
    X, y, w = lr_data
    cv = TTU.OpCrossValidation(n_folds=2, metric="auroc")
    full = _collect_all(cv, _entries(), X, y, w, TP.default_mesh())
    eight_cpu_ranks.setenv("TM_MESH_DEVICES", "2")
    before = SWEEP_STATS.snapshot()
    small = _collect_all(cv, _entries(), X, y, w, TP.default_mesh())
    delta = SweepStats.delta(before, SWEEP_STATS.snapshot())
    assert set(delta["devices"]) == {"cpu:0", "cpu:1"}
    for key, _, _ in _entries():
        assert np.array_equal(full[key], small[key]), key


def test_per_rank_attribution_reconciles_and_reaches_statusz(lr_data):
    """Rank items sum to the real (fold x grid) items, padding excluded,
    in the delta, per program, and in /statusz ``sweepDevices`` and
    /metricsz; ranks that share a card are told apart."""
    from transmogrifai_tpu_torch.serving.health import status_snapshot
    from transmogrifai_tpu_torch.telemetry.metrics import prometheus_text
    X, y, w = lr_data
    cv = TTU.OpCrossValidation(n_folds=2, metric="auroc")
    before = SWEEP_STATS.snapshot()
    _collect_all(cv, _entries(), X, y, w, _cpu_mesh(8))
    delta = SweepStats.delta(before, SWEEP_STATS.snapshot())
    want = sum(2 * len(grid) for _, _, grid in _entries())
    assert sum(c["items"] for c in delta["devices"].values()) == want
    assert set(delta["devices"]) <= {f"cpu:{i}" for i in range(8)}
    per_prog = sum(c["items"] for p in delta["programs"].values()
                   for c in (p.get("devices") or {}).values())
    assert per_prog == want
    # LR's 6 items over 8 ranks: a share of one, ranks 6 and 7 idle
    lr_prog = [p for k, p in delta["programs"].items() if "Logistic" in k]
    assert sorted(c["items"] for c in lr_prog[0]["devices"].values()) == [
        0, 0, 1, 1, 1, 1, 1, 1]

    class _Eng:
        class registry:
            @staticmethod
            def versions():
                return []

            @staticmethod
            def get():
                raise KeyError("no default version")
            default_version = None
        stats = type("S", (), {"as_dict": staticmethod(lambda: {})})()

        class admission:
            max_queue_rows = 1
            max_queue_requests = 1

            class ema:
                @staticmethod
                def as_dict():
                    return {}
        started_at = 0.0

        @staticmethod
        def live():
            return True

        @staticmethod
        def ready():
            return True

    snap = status_snapshot(_Eng, process_globals=False)
    assert snap["sweepDevices"] == SWEEP_STATS.devices_dict()
    assert "cpu:7" in snap["sweepDevices"]
    text = prometheus_text({"live": True, "ready": True,
                            "engine": {"submitted": 1, "completed": 1},
                            "sweepDevices": {"cuda:0#2": {"dispatches": 4,
                                                          "items": 17}}})
    assert 'tm_sweep_device_items_total{device="cuda:0#2"} 17' in text


def test_chip_dispatch_fault_fires_per_shard(lr_data):
    """One arrival per mesh shard at materialize; a raise-fatal on the
    third fails the family's batch naming the shard's rank label."""
    X, y, w = lr_data
    cv = TTU.OpCrossValidation(n_folds=2, metric="auroc")
    entries = _entries(grid_reg=(0.01,))
    with faults.active("models.sweep.chip_dispatch:raise-fatal:3"):
        pend = cv.dispatch_many(entries, X, y, w, 2, _cpu_mesh(8))
        with pytest.raises(faults.FaultError,
                           match=r"chip_dispatch#3.*'device': 'cpu:2'"):
            cv.collect(pend["0:LR"])
        stats = faults.stats_dict()
    assert stats["injected"] == {
        "models.sweep.chip_dispatch:raise-fatal": 1}
    assert stats["arrivals"]["models.sweep.chip_dispatch"] == 3


def test_chip_dispatch_fires_once_per_batch_on_one_rank(lr_data):
    X, y, w = lr_data
    cv = TTU.OpCrossValidation(n_folds=2, metric="auroc")
    with faults.active("models.sweep.chip_dispatch:raise-fatal:99"):
        pend = cv.dispatch_many(_entries(), X, y, w, 2, device=CPU)
        for p in pend.values():
            cv.collect(p)
            cv.collect(p)                  # cached: no second arrival
        stats = faults.stats_dict()
    assert stats["arrivals"]["models.sweep.chip_dispatch"] == 2


def test_chip_dispatch_transient_is_retryable(lr_data):
    X, y, w = lr_data
    cv = TTU.OpCrossValidation(n_folds=2, metric="auroc")
    entries = _entries(grid_reg=(0.01,))
    with faults.active("models.sweep.chip_dispatch:raise-transient:1"):
        pend = cv.dispatch_many(entries, X, y, w, 2, _cpu_mesh(8))
        with pytest.raises(faults.TransientFaultError) as ei:
            cv.collect(pend["0:LR"])
    assert getattr(ei.value, "retryable", False)
    pend = cv.dispatch_many(entries, X, y, w, 2, _cpu_mesh(8))
    cv.collect(pend["0:LR"])


@pytest.fixture()
def small_gbt():
    fam = TM.MODEL_FAMILIES["GBTClassifier"]
    saved = (fam.n_bins, fam.max_depth_cap, fam.n_rounds_cap)
    fam.n_bins, fam.max_depth_cap, fam.n_rounds_cap = 16, 3, 4
    yield fam
    fam.n_bins, fam.max_depth_cap, fam.n_rounds_cap = saved


def test_folded_gbt_over_four_ranks_is_bitwise(small_gbt, lr_data):
    """The folded tree path on a shard: the shared sketch and bins come
    from (X, w) alone, so each grid point's trees, and its metric, are
    those of the whole batch."""
    X, y, w = lr_data
    cv = TTU.OpCrossValidation(n_folds=3, metric="auroc")
    grid = small_gbt.make_grid({"maxDepth": [2.0, 3.0],
                                "stepSize": [0.1, 0.3]})
    one = cv.validate(small_gbt, grid, X, y, w, 2, device=CPU)
    for nd in (1, 4):
        got = cv.validate(small_gbt, grid, X, y, w, 2, _cpu_mesh(nd))
        assert np.array_equal(one.grid_metrics, got.grid_metrics), nd


def _selector_ds():
    from transmogrifai_tpu_torch.dataset import Dataset
    from transmogrifai_tpu_torch.features import FeatureBuilder
    from transmogrifai_tpu_torch.features import types as ft
    rng = np.random.default_rng(2)
    n = 260
    X = rng.normal(size=(n, 6)).astype(np.float32)
    y = ((X @ rng.normal(size=6)) + rng.normal(size=n) > 0).astype(
        np.float32)
    lbl = FeatureBuilder.of(ft.RealNN, "y").from_column().as_response()
    vec = FeatureBuilder.OPVector("x").from_column().as_predictor()
    ds = Dataset({"y": y.astype(np.float64), "x": X},
                 {"y": ft.RealNN, "x": ft.OPVector})
    return ds, lbl, vec


@pytest.mark.parametrize("fusion", [None, "0"])
def test_selector_set_mesh_gives_the_same_model(eight_cpu_ranks, fusion):
    """``BinaryClassificationModelSelector.set_mesh`` over 4 CPU ranks
    (fused and serial sweeps): the same winner and train summaries as no
    mesh, and the mesh is neither a param nor saved."""
    from transmogrifai_tpu_torch.stages import stage_to_json
    if fusion is not None:
        eight_cpu_ranks.setenv("TM_SWEEP_FUSION", fusion)
    ds, lbl, vec = _selector_ds()
    cands = [["LogisticRegression", {"regParam": [0.01, 0.1],
                                     "elasticNetParam": [0.0]}],
             ["NaiveBayes", None]]
    models = []
    for mesh in (None, _cpu_mesh(4)):
        sel = TM.BinaryClassificationModelSelector.with_cross_validation(
            n_folds=2, candidates=cands, device=CPU).set_input(lbl, vec)
        if mesh is not None:
            assert sel.set_mesh(mesh) is sel
        models.append(sel.fit(ds))
    a, b = models
    assert a.summary == b.summary
    assert a.summary["bestModel"] == b.summary["bestModel"]
    for k in a.model_params:
        assert torch.equal(a.model_params[k], b.model_params[k]), k
    assert "mesh" not in sel.params
    ja, jb = stage_to_json(a), stage_to_json(b)
    assert "mesh" not in str(jb)
    assert ja["params"] == jb["params"]


def test_selector_resolves_no_mesh_on_the_cpu():
    sel = TM.BinaryClassificationModelSelector.with_cross_validation(
        device=CPU)
    assert sel._effective_mesh(torch.device(CPU)) is None
    m = _cpu_mesh(2)
    assert sel.set_mesh(m)._effective_mesh(torch.device(CPU)) is m
