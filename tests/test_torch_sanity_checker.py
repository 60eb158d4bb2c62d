"""The port's SanityChecker against the JAX package.

``compute_statistics`` on the same matrices (made from a numpy seed,
heavy ties included): host ranks EQUAL, moments and correlations within
1e-6 relative (atol 1e-6 for values near zero — f32 sums run in another
order than XLA's), the contingency rows, Cramér's V and PMI identical,
and the kept slots and removal reasons identical on Titanic and on a
dataset with a planted label leak. The device-rank function on the CPU
is bitwise equal to ``host_rank_columns``, ties included, and the two
rank switches (``TM_CHECKER_HOST_RANKS``) give bitwise-equal
statistics. Also mirrors the checker cases of ``test_feature_ops.py``
and ``test_sweep_fusion.py``.
"""
import numpy as np
import pytest
import torch

from transmogrifai_tpu import Dataset as JDataset
from transmogrifai_tpu import FeatureBuilder as JFB
from transmogrifai_tpu.features import types as jft
from transmogrifai_tpu.ops import sanity_checker as jsc
from transmogrifai_tpu_torch.dataset import Dataset
from transmogrifai_tpu_torch.features import types as ft
from transmogrifai_tpu_torch.features.feature import FeatureBuilder
from transmogrifai_tpu_torch.features.manifest import (ColumnManifest,
                                                       ColumnMeta)
from transmogrifai_tpu_torch.ops import sanity_checker as sc


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


STATS_RTOL = 1e-6


def _matrix(seed=0, n=400, d=30, tie_frac=0.5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[rng.random((n, d)) < tie_frac] = 1.25          # heavy ties
    X[:, 3] = 7.0                                    # a constant column
    X[:, 4] = (rng.random(n) < 0.3).astype(np.float32)   # an indicator
    y = (rng.random(n) < 0.4).astype(np.float32)
    return X, y


def test_device_ranks_bitwise_equal_host_ranks():
    X, y = _matrix()
    host = sc.host_rank_columns(X)
    dev = sc.rank_columns(torch.from_numpy(X)).numpy()
    assert dev.dtype == host.dtype == np.float32
    assert np.array_equal(dev, host)
    # and the JAX package's host ranks
    assert np.array_equal(host, jsc.host_rank_columns(X))
    from scipy.stats import rankdata
    np.testing.assert_array_equal(host[:, 0],
                                  rankdata(X[:, 0], method="average") - 1.0)
    # a label column of ties only
    ones = np.ones((50, 1), np.float32)
    assert np.array_equal(sc.rank_columns(torch.from_numpy(ones)).numpy(),
                          sc.host_rank_columns(ones))


@pytest.mark.parametrize("seed", [0, 1])
def test_compute_statistics_against_jax(seed, monkeypatch):
    X, y = _matrix(seed)
    monkeypatch.setenv("TM_CHECKER_HOST_RANKS", "1")
    ref = jsc.compute_statistics(X, y)
    got = sc.compute_statistics(X, y, device="cpu")
    assert set(got) == set(ref)
    for k in ref:
        a, b = np.asarray(got[k]), np.asarray(ref[k])
        assert a.shape == b.shape, k
        assert np.array_equal(np.isnan(a), np.isnan(b)), k
        np.testing.assert_allclose(a, b, rtol=STATS_RTOL, atol=1e-6,
                                   equal_nan=True, err_msg=k)
    # the moments of a constant column are exact in both
    assert got["variance"][3] == ref["variance"][3] == 0.0
    assert np.isnan(got["corr_label"][3]) and np.isnan(ref["corr_label"][3])


def test_rank_switch_gives_bitwise_equal_statistics(monkeypatch):
    X, y = _matrix(2)
    monkeypatch.setenv("TM_CHECKER_HOST_RANKS", "0")
    dev = sc.compute_statistics(X, y, device="cpu")
    monkeypatch.setenv("TM_CHECKER_HOST_RANKS", "1")
    host = sc.compute_statistics(X, y, device="cpu")
    for k in dev:
        assert np.array_equal(dev[k], host[k], equal_nan=True), k
    monkeypatch.delenv("TM_CHECKER_HOST_RANKS")
    assert sc.host_ranks_enabled("cpu")
    assert not sc.host_ranks_enabled("cuda")


def test_contingency_cramers_and_pmi_identical():
    X, y = _matrix(3)
    cols = X[:, [4]]
    cols = np.concatenate([cols, 1.0 - cols], axis=1)
    y_oh = np.stack([1.0 - y, y], axis=1).astype(np.float32)
    v_t, t_t = sc.cramers_v(cols, y_oh, device="cpu")
    v_j, t_j = jsc.cramers_v(cols, y_oh)
    assert np.array_equal(t_t, np.asarray(t_j))
    assert v_t == v_j
    assert sc._pmi_from_table(t_t) == jsc._pmi_from_table(np.asarray(t_j))


def _fit_both(y, X, manifest, **checker_kw):
    """The checker of each package fitted on the same (label, vec)."""
    from transmogrifai_tpu.features.manifest import ColumnManifest as JCM
    jds = JDataset({"label": y, "vec": X},
                   {"label": jft.RealNN, "vec": jft.OPVector},
                   manifests={"vec": JCM.from_json(manifest.to_json())})
    tds = Dataset({"label": y, "vec": X},
                  {"label": ft.RealNN, "vec": ft.OPVector},
                  manifests={"vec": manifest})
    j = jsc.SanityChecker(**checker_kw).set_input(
        JFB.of(jft.RealNN, "label").from_column().as_response(),
        JFB.of(jft.OPVector, "vec").from_column().as_predictor()).fit(jds)
    t = sc.SanityChecker(device="cpu", **checker_kw).set_input(
        FeatureBuilder.of(ft.RealNN, "label").from_column().as_response(),
        FeatureBuilder.of(ft.OPVector, "vec").from_column().as_predictor()
    ).fit(tds)
    return j, t


def test_planted_leak_dropped_identically():
    rng = np.random.default_rng(4)
    n = 600
    y = (rng.random(n) < 0.45).astype(np.float64)
    X = rng.normal(size=(n, 8)).astype(np.float32)
    X[:, 2] = y + rng.normal(scale=1e-3, size=n)        # label leak
    X[:, 5] = X[:, 1] * 2.0 + 1.0                       # duplicate column
    X[:, 4] = 3.0                                       # constant
    X[:, 6] = rng.random(n) < 0.5                       # indicator
    X[:, 7] = 1.0 - X[:, 6]                             # its complement
    man = ColumnManifest(
        [ColumnMeta("num", "Real", descriptor_value=f"c{i}")
         for i in range(6)]
        + [ColumnMeta("k", "PickList", grouping="k", indicator_value="a"),
           ColumnMeta("k", "PickList", grouping="k", indicator_value="b")])
    jm, tm = _fit_both(y, X.astype(np.float32), man)
    assert tm.params["keep_indices"] == jm.params["keep_indices"]
    assert tm.summary["dropped"] == jm.summary["dropped"]
    assert tm.summary["cramersV"] == jm.summary["cramersV"]
    assert tm.summary["pointwiseMutualInformation"] == \
        jm.summary["pointwiseMutualInformation"]
    dropped = tm.summary["dropped"]
    assert "label correlation too high" in dropped["num_c2"]
    assert "correlated with column 1" in dropped["num_c5"]
    assert dropped["num_c4"] == "low variance"
    assert 2 not in tm.params["keep_indices"]


def test_titanic_kept_slots_identical():
    from test_torch_vectorizers import _titanic_vector
    jfv, ja, jman = _titanic_vector("transmogrifai_tpu")
    tfv, ta, tman = _titanic_vector("transmogrifai_tpu_torch")
    rng = np.random.default_rng(0)
    y = (rng.random(len(ta)) < 0.4).astype(np.float64)
    y[ta[:, 1] > 0] = 1.0          # one slot predicts the label well
    j, t = _fit_both(y, ta, tman)
    assert t.params["keep_indices"] == j.params["keep_indices"]
    assert t.summary["dropped"] == j.summary["dropped"]
    assert t.summary["dropped"]


def test_keep_cols_device_fn_and_row_path():
    X, y = _matrix(5, n=20, d=6)
    m = sc.SanityCheckerModel(keep_indices=[0, 2, 5])
    out = m.make_device_fn()(None, torch.from_numpy(X))
    assert torch.equal(out, torch.from_numpy(X[:, [0, 2, 5]]))
    m.wire(["label", "vec"], "kept")
    assert m.transform_value(ft.RealNN(1.0),
                             ft.OPVector(tuple(X[0].tolist()))).value == \
        tuple(X[0, [0, 2, 5]].tolist())


def test_unported_mesh_paths_raise(monkeypatch):
    """A mesh of ranks takes the row-sharded statistics (the same drops
    as no mesh); under TM_MESH_AXIS=grid,data the checker fits, the
    default mesh is the 2-D one and the selector's families validate on
    it (the 2-D sweep is ported)."""
    from transmogrifai_tpu_torch import parallel
    from transmogrifai_tpu_torch.models import MODEL_FAMILIES
    from transmogrifai_tpu_torch.models.tuning import require_ported
    X, y = _matrix(6, n=30, d=6)
    ds = Dataset({"label": y.astype(np.float64), "vec": X},
                 {"label": ft.RealNN, "vec": ft.OPVector})

    def fit(**kw):
        return sc.SanityChecker(**kw).set_input(
            FeatureBuilder.of(ft.RealNN, "label").from_column()
            .as_response(),
            FeatureBuilder.of(ft.OPVector, "vec").from_column()
            .as_predictor()).fit(ds)
    local = fit(device="cpu")
    meshed = fit(mesh=parallel.data_mesh(["cpu"] * 4))
    assert meshed.params["keep_indices"] == local.params["keep_indices"]
    monkeypatch.setattr(parallel.mesh, "visible_devices",
                        lambda: [torch.device("cpu")] * 2)
    monkeypatch.setenv("TM_MESH_AXIS", "grid,data")
    assert fit(device="cpu").params["keep_indices"] == \
        local.params["keep_indices"]
    m2 = parallel.default_mesh()
    assert m2.axis_names == ("grid", "data")
    assert m2.shape == {"grid": 1, "data": 2}
    require_ported(MODEL_FAMILIES["LogisticRegression"])


# -- mirrors of test_feature_ops.py's checker cases -------------------------

def test_sanity_checker_pointwise_mutual_information():
    from transmogrifai_tpu_torch.ops.vectorizers import OneHotVectorizer
    rng = np.random.default_rng(0)
    n = 400
    cat = rng.choice(["a", "b"], n, p=[0.5, 0.5])
    y = np.where(cat == "a",
                 (rng.random(n) < 0.8), (rng.random(n) < 0.3)).astype(float)
    ds = Dataset.from_dict({"c": cat.tolist(), "label": y.tolist()},
                           {"c": ft.PickList, "label": ft.RealNN})
    c = FeatureBuilder.of(ft.PickList, "c").from_column().as_predictor()
    label = FeatureBuilder.of(ft.RealNN, "label").from_column().as_response()
    vec = OneHotVectorizer(top_k=5).set_input(c).fit(ds)
    model = sc.SanityChecker(max_cramers_v=0.999, device="cpu").set_input(
        label, vec.output).fit(vec.transform(ds))
    pmi = model.summary["pointwiseMutualInformation"]
    rows = pmi[next(iter(pmi))]["byIndicator"]
    p_a = float((cat == "a").mean())
    p_y1 = float(y.mean())
    p_ay1 = float(((cat == "a") & (y == 1)).mean())
    want = np.log2(p_ay1 / (p_a * p_y1))
    assert any(abs(r[1] - want) < 1e-4 for r in rows if r[1] is not None)


@pytest.mark.parametrize("exclusion", ["none", "hashed_text"])
def test_correlation_exclusion_hashed_text_matches_jax(exclusion):
    """Hashing-trick slots are exempt from the correlation drop rules
    under 'hashed_text' and not under 'none', in both packages alike."""
    rng = np.random.default_rng(0)
    n = 200
    base = rng.normal(size=n)
    X = np.stack([base, base * 1.0000001, rng.normal(size=n)],
                 axis=1).astype(np.float32)
    y = (rng.random(n) > 0.5).astype(np.float64)
    man = ColumnManifest([
        ColumnMeta("t", "Text", descriptor_value="hash_0"),
        ColumnMeta("t", "Text", descriptor_value="hash_1"),
        ColumnMeta("v", "Real", descriptor_value="raw")])
    j, t = _fit_both(y, X, man, max_feature_corr=0.99,
                     correlation_exclusion=exclusion)
    assert t.summary["dropped"] == j.summary["dropped"]
    correlated = any("correlated" in w for w in t.summary["dropped"].values())
    assert correlated == (exclusion == "none")
    with pytest.raises(ValueError, match="correlation_exclusion"):
        sc.SanityChecker(correlation_exclusion="bogus")
