"""The port's Criteo path against the JAX package on the CPU: hashing,
fold ids, each sparse family's fit (Adagrad-LR, FTRL, FM, softmax), the
streamed fits, the grid sweep, the selector, LOCO, the front door and a
CTR model crossing packages. Mirrors ``tests/test_sparse.py``.

Tolerances, and why: both packages run the same f32 update sequence
and differ only in the order of summation (XLA's scatter and dot
against torch's ``index_put_`` and product-and-sum) and in the last
bits of the logistic; each family's parameters agree within rtol 1e-5
(atol 1e-6; measured up to 1.2e-7 absolute on 2-epoch fits). Hashes
and fold ids are bit-identical (integers). Validation losses agree
within 1e-5 with the same best grid point (f32 sums of the same
losses). The FM starts from the JAX package's ``emb`` draws where
parity is asked for; from its own ``torch.Generator`` draws it is held
to quality: held-out AUROC within 0.01 of the JAX fit's. Probabilities
of a model carried across packages agree within 1e-6 (the port's
two-way softmax head against ``sigmoid``: at most 1.2e-7).
"""
import json
import os

import numpy as np
import pytest
import torch

import transmogrifai_tpu.models.sparse as JS
import transmogrifai_tpu.ops.sparse as JO
import transmogrifai_tpu_torch.models.sparse as TS
import transmogrifai_tpu_torch.ops.sparse as TO

RTOL, ATOL = 1e-5, 1e-6
LOSS_TOL = 1e-5
CROSS_TOL = 1e-6
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs (the suite runs several
    workers at once; these tensors are small)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ctr_data(seed, n, **kw):
    """tests/test_sparse.py's synthetic CTR rows (the label depends on
    two hashed fields and one numeric) from a seed."""
    from test_sparse import _ctr_data as reference_rows
    return reference_rows(np.random.default_rng(seed), n, **kw)


def _close(got, want, rtol=RTOL, atol=ATOL):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=rtol, atol=atol, err_msg=k)


def _chunks(idx, nums, y, w, sizes):
    def make():
        off = 0
        for s in sizes:
            sl = slice(off, off + s)
            off += s
            yield {"idx": idx[sl], "num": nums[sl], "y": y[sl], "w": w[sl]}
    return make


def _auroc(p, y):
    from transmogrifai_tpu_torch.evaluators.functional import auroc
    return float(auroc(torch.as_tensor(p), torch.as_tensor(y)))


# ---------------------------------------------------------------------------
# hashing and folds: bit-identical
# ---------------------------------------------------------------------------

def test_hash_tokens_bit_identical_to_jax():
    toks = [f"f|{i}" for i in range(500)] + ["f|__null__", "g|hello world",
                                             "h|ünïcode"]
    for B in (1 << 10, 1 << 20, 1 << 25):
        np.testing.assert_array_equal(TO.hash_tokens(toks, B, 42),
                                      JO.hash_tokens(toks, B, 42))


@pytest.mark.parametrize("native", [True, False])
def test_hash_column_bit_identical_to_jax(native, monkeypatch):
    """Strings with None/'' nulls, numeric codes with NaN nulls and
    out-of-int64 values, mixed object columns; with the native murmur3
    batch and with the pure-Python dedup branch."""
    import transmogrifai_tpu_torch.native as tn
    if not native:
        monkeypatch.setattr(tn, "available", lambda: False)
    rng = np.random.default_rng(1)
    strs = np.asarray([f"v{i % 7}" for i in range(500)], dtype=object)
    strs[3], strs[10] = None, ""
    nums = rng.integers(0, 50, 300).astype(np.float64)
    nums[[7, 8]] = np.nan
    nums[9] = 2.0 ** 63
    mixed = np.asarray([3.5, None, "x", 2], dtype=object)
    for col in (strs, nums, mixed):
        np.testing.assert_array_equal(
            TO._hash_column(col, "f", 1 << 12, 42),
            JO._hash_column(col, "f", 1 << 12, 42))


def test_hashing_vectorizer_stage_matches_jax():
    from transmogrifai_tpu import Dataset as JD
    from transmogrifai_tpu_torch.dataset import Dataset as TD
    from transmogrifai_tpu_torch.features import FeatureBuilder, types as ft
    from transmogrifai_tpu.features import types as jft
    n = 40
    data = {"a": [f"v{i % 5}" for i in range(n)],
            "b": [None if i % 7 == 0 else f"u{i % 3}" for i in range(n)],
            "k": list(range(n))}
    ds = TD.from_dict(data, {"a": ft.PickList, "b": ft.PickList,
                             "k": ft.Integral})
    fs = [FeatureBuilder.of(t, c).from_column().as_predictor()
          for c, t in (("a", ft.PickList), ("b", ft.PickList),
                       ("k", ft.Integral))]
    st = TO.SparseHashingVectorizer(num_buckets=1 << 10).set_input(*fs)
    col = st.transform(ds).column(st.output.name)
    assert col.shape == (n, 3) and col.dtype == np.int32
    jds = JD.from_dict(data, {"a": jft.PickList, "b": jft.PickList,
                              "k": jft.Integral})
    from transmogrifai_tpu import FeatureBuilder as JFB
    jfs = [JFB.of(t, c).from_column().as_predictor()
           for c, t in (("a", jft.PickList), ("b", jft.PickList),
                        ("k", jft.Integral))]
    jst = JO.SparseHashingVectorizer(num_buckets=1 << 10).set_input(*jfs)
    np.testing.assert_array_equal(col, jst.transform(jds).column(
        jst.output.name))
    row = st.transform_value(ft.PickList("v0"), ft.PickList(None),
                             ft.Integral(0))
    assert list(row.value) == col[0].tolist()


def test_hash_collision_stats_match_jax():
    toks = [f"f|{i}" for i in range(5000)]
    widths = (1 << 10, 1 << 14, 1 << 18)
    assert TO.hash_collision_stats(toks, widths) == \
        JO.hash_collision_stats(toks, widths)


def test_fold_ids_bit_identical_and_offset_stable():
    n, F = 50_000, 3
    for seed in (0, 42, 7):
        a = TS._fold_ids(0, n, F, seed)
        np.testing.assert_array_equal(a, JS._fold_ids(0, n, F, seed))
        np.testing.assert_array_equal(
            np.concatenate([TS._fold_ids(s, 1000, F, seed)
                            for s in range(0, n, 1000)]), a)
    counts = np.bincount(TS._fold_ids(0, n, F, 42), minlength=F) / n
    assert np.all(np.abs(counts - 1 / F) < 0.01), counts


# ---------------------------------------------------------------------------
# each family's fit against the JAX package's
# ---------------------------------------------------------------------------

def _fm_emb(B, d, k, seed):
    return np.asarray(JS.init_sparse_fm(B, d, k, seed)["emb"])


FAMILY_CASES = ["adagrad", "adagrad_l2", "ftrl", "ftrl_l1", "fm", "fm_l2",
                "softmax", "softmax_l2"]


def _fit_pair(case, idx, nums, y, w, B, batch_size=256, epochs=2):
    """(port params, JAX params) of one family fit on the same rows."""
    l2 = 1e-3 if case.endswith("_l2") else 0.0
    if case.startswith("adagrad"):
        kw = dict(lr=0.1, l2=l2, epochs=epochs, batch_size=batch_size)
        return (TS.fit_sparse_lr(idx, nums, y, w, B, device=CPU, **kw),
                JS.fit_sparse_lr(idx, nums, y, w, B, **kw))
    if case.startswith("ftrl"):
        kw = dict(alpha=0.2, l1=1e-3 if case == "ftrl_l1" else 0.0,
                  l2=0.01, epochs=epochs, batch_size=batch_size)
        return (TS.fit_sparse_ftrl(idx, nums, y, w, B, device=CPU, **kw),
                JS.fit_sparse_ftrl(idx, nums, y, w, B, **kw))
    if case.startswith("fm"):
        kw = dict(k=4, lr=0.1, l2=l2, epochs=epochs, batch_size=batch_size)
        emb = _fm_emb(B, nums.shape[1], 4, 7)
        return (TS.fit_sparse_fm(idx, nums, y, w, B, emb=emb, device=CPU,
                                 **kw),
                JS.fit_sparse_fm(idx, nums, y, w, B, seed=7, **kw))
    ym = (idx[:, 0] % 3).astype(np.float32)
    kw = dict(lr=0.2, l2=l2, epochs=epochs, batch_size=batch_size)
    return (TS.fit_sparse_softmax(idx, nums, ym, w, B, 3, device=CPU, **kw),
            JS.fit_sparse_softmax(idx, nums, ym, w, B, 3, **kw))


@pytest.mark.parametrize("case", FAMILY_CASES)
def test_family_fit_matches_jax(case):
    """Two epochs of each family (l2 > 0 where it has one: lazy L2 on
    the hashed tables, decoupled on dense), on a row count that is not
    a batch multiple (padded rows), rtol 1e-5."""
    idx, nums, y = _ctr_data(3, 2000, buckets=1 << 10)
    w = np.ones_like(y)
    got, want = _fit_pair(case, idx, nums, y, w, 1 << 10)
    _close(got, want)


@pytest.mark.parametrize("case", ["adagrad_l2", "ftrl", "fm_l2",
                                  "softmax"])
def test_family_epoch_matches_jax_from_a_trained_state(case):
    """One epoch of each family's epoch function from the same nonzero
    state (the JAX state carried over), with fractional weights: rtol
    1e-5."""
    import jax.numpy as jnp
    idx, nums, y = _ctr_data(5, 1024, buckets=1 << 10)
    w = np.random.default_rng(0).random(1024).astype(np.float32)
    B = 1 << 10
    if case.startswith("ftrl"):
        st = JS.init_sparse_ftrl(B, nums.shape[1])
        st = JS.ftrl_epoch(st, idx, nums, y, w, 0.2, 1.0, 0.0, 0.01, 256)
        tst = {g: {k: torch.tensor(np.asarray(v)) for k, v in st[g].items()}
               for g in st}
        want = JS.ftrl_epoch(st, idx, nums, y, w, 0.2, 1.0, 0.0, 0.01, 256)
        got = TS.ftrl_epoch(tst, idx, nums, y, w, 0.2, 1.0, 0.0, 0.01, 256)
        for g in ("z", "n"):
            _close({k: v.numpy() for k, v in got[g].items()},
                   {k: np.asarray(v) for k, v in want[g].items()})
        return
    if case.startswith("adagrad"):
        init, epoch, tepoch = (JS.init_sparse_lr(B, 4), JS.sparse_lr_epoch,
                               TS.sparse_lr_epoch)
    elif case.startswith("fm"):
        init, epoch, tepoch = JS.init_sparse_fm(B, 4, 4, 3), JS.fm_epoch, \
            TS.fm_epoch
    else:
        y = (idx[:, 0] % 3).astype(np.float32)
        init, epoch, tepoch = (JS.init_sparse_softmax(B, 4, 3),
                               JS.softmax_epoch, TS.softmax_epoch)
    l2 = 1e-3 if case.endswith("_l2") else 0.0
    acc = {k: jnp.full_like(v, 1e-6) for k, v in init.items()}
    p, a = epoch(init, acc, idx, nums, y, w, 0.1, l2, 256)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in p.items()}
    ta = {k: torch.tensor(np.asarray(v)) for k, v in a.items()}
    want_p, want_a = epoch(p, a, idx, nums, y, w, 0.1, l2, 256)
    got_p, got_a = tepoch(tp, ta, idx, nums, y, w, 0.1, l2, 256)
    _close({k: v.numpy() for k, v in got_p.items()},
           {k: np.asarray(v) for k, v in want_p.items()})
    _close({k: v.numpy() for k, v in got_a.items()},
           {k: np.asarray(v) for k, v in want_a.items()})


@pytest.mark.parametrize("case", ["adagrad", "ftrl", "fm", "softmax"])
def test_streaming_matches_in_memory_and_jax(case):
    """Four 512-row chunks at batch 256, two epochs: the streamed fit
    equals the port's in-memory fit (the same minibatches) and the JAX
    package's streamed fit, rtol 1e-5."""
    idx, nums, y = _ctr_data(7, 2048)
    B, w = 1 << 12, np.ones(2048, np.float32)
    if case == "softmax":
        y = (idx[:, 0] % 3).astype(np.float32)
    cf = _chunks(idx, nums, y, w, [512] * 4)
    d = nums.shape[1]
    if case == "adagrad":
        kw = dict(lr=0.1, l2=1e-6, epochs=2, batch_size=256)
        got = TS.fit_sparse_lr_streaming(cf, B, d, device=CPU, **kw)
        mem = TS.fit_sparse_lr(idx, nums, y, w, B, device=CPU, **kw)
        want = JS.fit_sparse_lr_streaming(cf, B, d, **kw)
    elif case == "ftrl":
        kw = dict(alpha=0.2, l1=1e-3, epochs=2, batch_size=256)
        got = TS.fit_sparse_ftrl_streaming(cf, B, d, device=CPU, **kw)
        mem = TS.fit_sparse_ftrl(idx, nums, y, w, B, device=CPU, **kw)
        want = JS.fit_sparse_ftrl_streaming(cf, B, d, **kw)
    elif case == "fm":
        kw = dict(k=4, lr=0.1, epochs=2, batch_size=256)
        emb = _fm_emb(B, d, 4, 7)
        got = TS.fit_sparse_fm_streaming(cf, B, d, emb=emb, device=CPU, **kw)
        mem = TS.fit_sparse_fm(idx, nums, y, w, B, emb=emb, device=CPU, **kw)
        want = JS.fit_sparse_fm_streaming(cf, B, d, seed=7, **kw)
    else:
        kw = dict(lr=0.2, epochs=2, batch_size=256)
        got = TS.fit_sparse_softmax_streaming(cf, B, d, 3, device=CPU, **kw)
        mem = TS.fit_sparse_softmax(idx, nums, y, w, B, 3, device=CPU, **kw)
        want = JS.fit_sparse_softmax_streaming(cf, B, d, 3, **kw)
    for k in got:
        np.testing.assert_array_equal(got[k], mem[k], err_msg=k)
    _close(got, want)


@pytest.mark.parametrize("family", ["adagrad", "fm"])
def test_ragged_tail_at_l2_steps_the_padded_batches_like_jax(family):
    """Chunks of 64, 64, 40, 24 rows at batch 32 with l2 > 0: the tail
    chunks pad to 64 rows, so the 24-row chunk adds a whole w = 0 batch
    whose decoupled L2 still decays ``dense``. The port cuts the same
    minibatches, padded ones included: rtol 1e-5 against the JAX
    package. Dropping the padded batch moves ``dense`` (checked, so the
    test would see a port that skipped it)."""
    rng = np.random.default_rng(7)
    n, K, d, B = 192, 4, 3, 64
    idx = rng.integers(0, B, (n, K)).astype(np.int32)
    num = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.random(n) > 0.5).astype(np.float32)
    w = np.ones(n, np.float32)
    ragged = _chunks(idx, num, y, w, [64, 64, 40, 24])
    kw = dict(lr=0.1, l2=0.05, epochs=2, batch_size=32)
    if family == "fm":
        emb = _fm_emb(B, d, 2, 0)
        got = TS.fit_sparse_fm_streaming(ragged, B, d, k=2, emb=emb,
                                         device=CPU, **kw)
        want = JS.fit_sparse_fm_streaming(ragged, B, d, k=2, **kw)
    else:
        got = TS.fit_sparse_lr_streaming(ragged, B, d, device=CPU, **kw)
        want = JS.fit_sparse_lr_streaming(ragged, B, d, **kw)
        no_pad = TS.fit_sparse_lr_streaming(
            _chunks(idx, num, y, w, [64, 64, 64]), B, d, device=CPU, **kw)
        assert not np.allclose(no_pad["dense"], got["dense"],
                               rtol=1e-4, atol=0)
    _close(got, want)
    assert list(TS._uniform_chunks(ragged())) and [
        len(c["y"]) for c in TS._uniform_chunks(
            TS._pad_chunk(c, 32) for c in ragged())] == [64, 64, 64, 64]


def test_fm_own_draws_learn_interactions_like_jax():
    """The port's FM from its own torch.Generator draws: held-out AUROC
    within 0.01 of the JAX FM's on cross-only (XOR) signal, which
    hashed LR cannot express (LR stays near chance)."""
    rng = np.random.default_rng(11)
    n, card, B = 8000, 8, 1 << 10
    c0, c1 = rng.integers(0, card, n), rng.integers(0, card, n)
    y = ((c0 % 2) ^ (c1 % 2)).astype(np.float32)
    y = np.where(rng.random(n) < 0.9, y, 1 - y).astype(np.float32)
    idx = np.stack([TO.hash_tokens([f"a|{v}" for v in c0], B, 42),
                    TO.hash_tokens([f"b|{v}" for v in c1], B, 42)], 1)
    X = np.zeros((n, 1), np.float32)
    w = np.ones(n, np.float32)
    tr, ho = slice(0, 6000), slice(6000, n)
    kw = dict(k=8, lr=0.1, epochs=3, batch_size=512)
    pt = TS.fit_sparse_fm(idx[tr], X[tr], y[tr], w[tr], B, seed=0,
                          device=CPU, **kw)
    pj = JS.fit_sparse_fm(idx[tr], X[tr], y[tr], w[tr], B, seed=0, **kw)
    a_t = _auroc(TS.predict_sparse_lr(pt, idx[ho], X[ho], device=CPU)[:, 1],
                 y[ho])
    a_j = _auroc(np.asarray(JS.predict_sparse_lr(pj, idx[ho], X[ho]))[:, 1],
                 y[ho])
    plr = TS.fit_sparse_lr(idx[tr], X[tr], y[tr], w[tr], B, lr=0.1,
                           epochs=3, batch_size=512, device=CPU)
    a_lr = _auroc(TS.predict_sparse_lr(plr, idx[ho], X[ho],
                                       device=CPU)[:, 1], y[ho])
    assert a_t > 0.8 and abs(a_t - a_j) <= 0.01, (a_t, a_j)
    assert a_lr < 0.62, a_lr


def test_predict_matches_jax_and_is_row_independent():
    """The port's predict on parameters the JAX package fitted: within
    1e-6 of the JAX predict (LR and FM); each row alone equals its row
    in the batch bit for bit."""
    idx, nums, y = _ctr_data(9, 600, buckets=1 << 10)
    w = np.ones_like(y)
    for params in (JS.fit_sparse_lr(idx, nums, y, w, 1 << 10, epochs=1,
                                    batch_size=128),
                   JS.fit_sparse_fm(idx, nums, y, w, 1 << 10, k=4,
                                    epochs=1, batch_size=128)):
        params = {k: np.asarray(v) for k, v in params.items()}
        got = TS.predict_sparse_lr(params, idx, nums, device=CPU)
        want = np.asarray(JS.predict_sparse_lr(params, idx, nums))
        np.testing.assert_allclose(got, want, rtol=0, atol=CROSS_TOL)
        for i in (0, 17, 599):
            one = TS.predict_sparse_lr(params, idx[i:i + 1],
                                       nums[i:i + 1], device=CPU)
            np.testing.assert_array_equal(one[0], got[i])
    ps = JS.fit_sparse_softmax(idx, nums, (idx[:, 0] % 3).astype(
        np.float32), w, 1 << 10, 3, epochs=1, batch_size=128)
    ps = {k: np.asarray(v) for k, v in ps.items()}
    np.testing.assert_allclose(
        TS.predict_sparse_softmax(ps, idx, nums, device=CPU),
        np.asarray(JS.predict_sparse_softmax(ps, idx, nums)),
        rtol=0, atol=CROSS_TOL)


def test_softmax_class_ids_are_checked():
    def chunks():
        yield {"idx": np.zeros((256, 2), np.int32),
               "num": np.zeros((256, 1), np.float32),
               "y": np.full(256, 3.0, np.float32),
               "w": np.ones(256, np.float32)}
    with pytest.raises(ValueError, match="label ids"):
        TS.fit_sparse_softmax_streaming(chunks, 64, 1, 3, batch_size=256,
                                        device=CPU)
    with pytest.raises(ValueError, match="integer-valued"):
        TS._check_class_ids(np.asarray([0.5, 1.0]), 3)


@pytest.mark.parametrize("fn", ["fit_sparse_lr_sharded",
                                "fit_sparse_fm_sharded",
                                "fit_sparse_softmax_sharded"])
def test_sharded_fits_raise_not_ported(fn, monkeypatch):
    """The sharded fits are ported: with no mesh they take the default
    data mesh, which raises without a card (never the CPU); over CPU
    ranks they match the one-device fit (rtol 1e-4, atol 1e-6)."""
    from transmogrifai_tpu_torch import parallel
    rng = np.random.default_rng(4)
    idx = rng.integers(0, 16, (40, 2)).astype(np.int32)
    X = rng.normal(size=(40, 1)).astype(np.float32)
    y = rng.integers(0, 2, 40).astype(np.float32)
    w = np.ones(40, np.float32)
    extra = (3,) if "softmax" in fn else ()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(TS, fn)(idx, X, y, w, 16, *extra)
    got = getattr(TS, fn)(idx, X, y, w, 16, *extra,
                          mesh=parallel.data_mesh(["cpu"] * 2),
                          batch_size=16)
    single = getattr(TS, fn[:-len("_sharded")])(
        idx, X, y, w, 16, *extra, batch_size=16, device=CPU)
    for k in single:
        np.testing.assert_allclose(got[k], single[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# the grid sweep
# ---------------------------------------------------------------------------

SWEEP_GRID = [{"lr": 0.1, "l2": 0.0}, {"lr": 0.05, "l2": 1e-6},
              {"lr": 1e-5, "l2": 0.0},
              {"family": "ftrl", "alpha": 0.1, "l1": 0.0},
              {"family": "ftrl", "alpha": 0.3, "l1": 1e-3, "l2": 0.01},
              {"family": "fm", "lr": 0.05}, {"family": "fm", "lr": 0.1,
                                              "l2": 1e-4}]


@pytest.mark.parametrize("max_rows", [None, 512, 700])
def test_validate_sparse_grid_matches_jax(max_rows):
    """Every grid point's validation loss within 1e-5 of the JAX
    package's, the same best index: in memory (one cached chunk) and
    streamed in 512- and 700-row chunks (a ragged tail); the FM from
    the JAX package's draws (``fm_emb``)."""
    idx, nums, y = _ctr_data(13, 2000)
    B = 1 << 12
    kw = dict(n_folds=2, epochs=2, batch_size=256, seed=5, fm_dim=4,
              max_device_rows=max_rows)
    want = JS.validate_sparse_grid(idx, nums, y, SWEEP_GRID, B, **kw)
    got = TS.validate_sparse_grid(idx, nums, y, SWEEP_GRID, B, device=CPU,
                                  fm_emb=_fm_emb(B, nums.shape[1], 4, 5),
                                  **kw)
    np.testing.assert_allclose(got["logloss"], want["logloss"], rtol=0,
                               atol=LOSS_TOL)
    assert got["best_index"] == want["best_index"]
    assert got["best_hyper"] == want["best_hyper"]
    assert sorted(got["wall_seconds"]) == ["adagrad", "fm", "ftrl"]


def test_softmax_sweep_matches_jax_and_guards():
    idx, nums, _ = _ctr_data(17, 1600, buckets=1 << 10)
    y = (idx[:, 0] % 3).astype(np.float32)
    grid = [{"family": "softmax", "lr": 0.2, "l2": 0.0},
            {"family": "softmax", "lr": 1e-5, "l2": 1e-3}]
    kw = dict(n_folds=3, epochs=2, batch_size=256, n_classes=3)
    want = JS.validate_sparse_grid(idx, nums, y, grid, 1 << 10, **kw)
    got = TS.validate_sparse_grid(idx, nums, y, grid, 1 << 10, device=CPU,
                                  **kw)
    np.testing.assert_allclose(got["logloss"], want["logloss"], rtol=0,
                               atol=LOSS_TOL)
    assert got["best_index"] == want["best_index"] == 0
    with pytest.raises(ValueError, match="n_classes"):
        TS.validate_sparse_grid(idx, nums, y, grid[:1], 1 << 10,
                                batch_size=256, device=CPU)
    with pytest.raises(ValueError, match="cannot be ranked"):
        TS.validate_sparse_grid(idx, nums, y, grid + [{"lr": 0.1}], 1 << 10,
                                n_classes=3, batch_size=256, device=CPU)
    with pytest.raises(ValueError, match="n_folds"):
        TS.validate_sparse_grid(idx, nums, y, grid, 1 << 10, n_folds=1,
                                n_classes=3, device=CPU)
    with pytest.raises(ValueError, match="unknown sparse family"):
        TS.validate_sparse_grid(idx, nums, y, [{"family": "svm"}], 1 << 10,
                                device=CPU)


def test_sweep_is_reproducible_and_instance_independent():
    """Two sweeps give bitwise the same losses; a grid point swept
    alone gives its loss in the full grid within 1e-6 (instances share
    only the batch's indices)."""
    idx, nums, y = _ctr_data(19, 1500)
    kw = dict(n_folds=2, epochs=1, batch_size=256, device=CPU, fm_dim=4)
    a = TS.validate_sparse_grid(idx, nums, y, SWEEP_GRID, 1 << 12, **kw)
    b = TS.validate_sparse_grid(idx, nums, y, SWEEP_GRID, 1 << 12, **kw)
    assert a["logloss"] == b["logloss"]
    one = TS.validate_sparse_grid(idx, nums, y, SWEEP_GRID[1:2], 1 << 12,
                                  **kw)
    assert abs(one["logloss"][0] - a["logloss"][1]) <= 1e-6


# ---------------------------------------------------------------------------
# the selector
# ---------------------------------------------------------------------------

def _selector_fit(pkg, idx, nums, y, **sel_kw):
    import importlib
    m = lambda x: importlib.import_module(pkg + x)
    ft = m(".features.types")
    FB = m(".features.feature").FeatureBuilder
    ds = m(".dataset").Dataset(
        {"y": y.astype(np.float64), "sx": idx, "nx": nums},
        {"y": ft.RealNN, "sx": ft.SparseIndices, "nx": ft.OPVector})
    fy = FB.of(ft.RealNN, "y").from_column().as_response()
    fs = FB.of(ft.SparseIndices, "sx").from_column().as_predictor()
    fn = FB.of(ft.OPVector, "nx").from_column().as_predictor()
    kw = {"device": CPU} if pkg.endswith("torch") else {}
    sel = m(".models.sparse").SparseModelSelector(**sel_kw, **kw)
    model, out = sel.set_input(fy, fs, fn).fit_transform(ds)
    return model, out, ds


def test_selector_summary_and_winner_match_jax():
    """Families compete over streamed 800-row chunks: the same summary
    keys and shape, every validation loss within 1e-5, the same winner
    and hyper, train and holdout metrics within 1e-5, the field
    contributions within rtol 1e-5 (from refit tables within 1e-5)."""
    _selector_matches_jax(chunk_rows=800)


def test_a_one_chunk_selector_matches_jax():
    """As above, with the training rows in one chunk, which the port
    prepares and copies once and holds for every pass of the fit."""
    _selector_matches_jax(chunk_rows=1 << 20)


def _selector_matches_jax(chunk_rows):
    idx, nums, y = _ctr_data(21, 2400)
    kw = dict(num_buckets=1 << 12, n_folds=2, epochs=2, refit_epochs=2,
              batch_size=256, chunk_rows=chunk_rows,
              grid=[{"family": "adagrad", "lr": 0.1, "l2": 0.0},
                    {"family": "adagrad", "lr": 0.02, "l2": 1e-6},
                    {"family": "ftrl", "alpha": 0.3, "l1": 0.0}])
    tm, tout, _ = _selector_fit("transmogrifai_tpu_torch", idx, nums, y,
                                **kw)
    jm, jout, _ = _selector_fit("transmogrifai_tpu", idx, nums, y, **kw)
    ts, js = tm.summary, jm.summary
    assert set(ts) == set(js)
    assert ts["bestModel"]["family"] == js["bestModel"]["family"]
    assert ts["bestModel"]["hyper"] == js["bestModel"]["hyper"]
    np.testing.assert_allclose([r["logloss"] for r in
                                ts["validationResults"]],
                               [r["logloss"] for r in
                                js["validationResults"]], atol=LOSS_TOL,
                               rtol=0)
    assert [(r["family"], r["hyper"]) for r in ts["validationResults"]] == \
        [(r["family"], r["hyper"]) for r in js["validationResults"]]
    for part in ("trainEvaluation", "holdoutEvaluation"):
        for k, v in js[part].items():
            assert abs(ts[part][k] - v) <= 1e-5, (part, k)
    np.testing.assert_allclose(ts["fieldContributions"],
                               js["fieldContributions"], rtol=RTOL)
    for k in ("splitterSummary", "dataCounts", "validationType",
              "problem"):
        assert ts[k] == js[k]
    assert set(tm.wall_seconds["families"]) == {"adagrad", "ftrl"}
    _close({k: v.numpy() for k, v in tm.model_params.items()},
           {k: np.asarray(v) for k, v in jm.model_params.items()})


def test_selector_fm_wins_on_interaction_data():
    """Three families compete on cross-only signal: the FM (own draws)
    wins, its refit works, and the fitted stage round-trips through
    stage JSON."""
    from transmogrifai_tpu_torch.stages import stage_from_json, stage_to_json
    rng = np.random.default_rng(23)
    n, B = 3000, 1 << 10
    c0, c1 = rng.integers(0, 8, n), rng.integers(0, 8, n)
    y = ((c0 % 2) ^ (c1 % 2)).astype(np.float32)
    y = np.where(rng.random(n) < 0.9, y, 1 - y).astype(np.float32)
    idx = np.stack([TO.hash_tokens([f"a|{v}" for v in c0], B, 42),
                    TO.hash_tokens([f"b|{v}" for v in c1], B, 42)], 1)
    X = np.zeros((n, 1), np.float32)
    model, _, ds = _selector_fit(
        "transmogrifai_tpu_torch", idx, X, y, num_buckets=B, n_folds=2,
        epochs=2, refit_epochs=3, batch_size=256, chunk_rows=1000,
        fm_dim=8, grid=[{"family": "adagrad", "lr": 0.1, "l2": 0.0},
                        {"family": "ftrl", "alpha": 0.3, "l1": 0.0},
                        {"family": "fm", "lr": 0.1, "l2": 0.0}])
    s = model.summary
    assert s["bestModel"]["family"] == "SparseFactorizationMachine"
    assert s["trainEvaluation"]["AuROC"] > 0.8
    loaded = stage_from_json(json.loads(json.dumps(stage_to_json(model))))
    a = model.transform(ds).column(model.output.name)
    b = loaded.transform(ds).column(loaded.output.name)
    assert all(x == z for x, z in zip(a, b))


def test_selector_guards_and_balancer():
    idx, nums, y = _ctr_data(25, 1200, buckets=1 << 10)
    with pytest.raises(ValueError, match="n_folds"):
        TS.SparseModelSelector(n_folds=1)
    with pytest.raises(ValueError, match="binary CTR front door"):
        _selector_fit("transmogrifai_tpu_torch", idx, nums, y,
                      num_buckets=1 << 10, grid=[{"family": "softmax"}])
    m, _, _ = _selector_fit(
        "transmogrifai_tpu_torch", idx, nums, y, num_buckets=1 << 10,
        batch_size=256, grid=[{"lr": 0.1, "l2": 0.0}],
        splitter={"type": "balancer", "sample_fraction": 0.6})
    assert m.summary["splitterSummary"]["name"] == "DataBalancer"


def test_selector_refit_checkpoint_resumes(tmp_path):
    """A selector fit killed during the winner's refit leaves its
    stream checkpoint; the re-fit resumes from it and matches the
    uninterrupted model's refit tables bitwise and holdout AUROC
    exactly; the checkpoint is gone after success."""
    from transmogrifai_tpu_torch.io import stream as iostream
    rng = np.random.default_rng(4)
    n, K, B = 4096, 3, 1 << 10
    idx = rng.integers(0, B, size=(n, K), dtype=np.int32)
    Xn = rng.normal(size=(n, 2)).astype(np.float32)
    y = (rng.random(n) < 0.4).astype(np.float32)
    kw = dict(num_buckets=B, n_folds=2, epochs=1, refit_epochs=2,
              batch_size=512, chunk_rows=1024,
              grid=[{"family": "adagrad", "lr": 0.05, "l2": 0.0}])
    want, _, _ = _selector_fit("transmogrifai_tpu_torch", idx, Xn, y, **kw)
    ck = str(tmp_path / "sel_ck")
    orig = iostream.fit_streaming

    def wrapped(step_fn, state, chunks, **fkw):
        n_steps = {"n": 0}

        def dying(s, c):
            n_steps["n"] += 1
            if n_steps["n"] > 5:
                raise KeyboardInterrupt("kill refit")
            return step_fn(s, c)
        return orig(dying, state, chunks, **dict(fkw, checkpoint_every=2))

    iostream.fit_streaming = wrapped
    try:
        with pytest.raises(KeyboardInterrupt):
            _selector_fit("transmogrifai_tpu_torch", idx, Xn, y,
                          checkpoint_dir=ck, **kw)
    finally:
        iostream.fit_streaming = orig
    path = os.path.join(ck, "refit_adagrad", "stream_fit.ckpt.npz")
    assert os.path.exists(path)
    got, _, _ = _selector_fit("transmogrifai_tpu_torch", idx, Xn, y,
                              checkpoint_dir=ck, **kw)
    for k in want.model_params:
        assert torch.equal(got.model_params[k], want.model_params[k]), k
    assert got.summary["holdoutEvaluation"]["AuROC"] == \
        want.summary["holdoutEvaluation"]["AuROC"]
    assert not os.path.exists(path)


HELD_KW = dict(num_buckets=1 << 10, n_folds=2, epochs=1, refit_epochs=2,
               batch_size=256, seed=7, fm_dim=4)


def _streamed_selector(idx, nums, y, grid, chunk_rows):
    """The selector's fit composed from the streamed sweep and the
    winner's streamed fit on host chunks of its training rows, each pass
    building its chunks anew: (the sweep's report, the refit's
    parameters)."""
    from transmogrifai_tpu_torch.models.tuning import make_splitter
    kw = HELD_KW
    splitter = make_splitter({"reserve_fraction": 0.1}, kw["seed"])
    train_i, _ = splitter.split(len(y))
    w, _ = splitter.prepare(y[train_i])
    chunks = _chunks(idx[train_i], nums[train_i], y[train_i], w,
                     [chunk_rows] * -(-len(train_i) // chunk_rows))
    B, d = kw["num_buckets"], nums.shape[1]
    report = TS.validate_sparse_grid_streaming(
        chunks, grid, B, d, n_folds=kw["n_folds"], epochs=kw["epochs"],
        batch_size=kw["batch_size"], seed=kw["seed"], fm_dim=kw["fm_dim"],
        device=CPU)
    best = dict(report["best_hyper"])
    fam = best.pop("family")
    common = dict(epochs=kw["refit_epochs"], batch_size=kw["batch_size"],
                  device=CPU)
    if fam == "fm":
        hy = dict(TS._FM_DEFAULTS, **best)
        params = TS.fit_sparse_fm_streaming(
            chunks, B, d, k=kw["fm_dim"], lr=hy["lr"], l2=hy["l2"],
            seed=kw["seed"], **common)
    elif fam == "ftrl":
        hy = dict(TS._FTRL_DEFAULTS, **best)
        params = TS.fit_sparse_ftrl_streaming(
            chunks, B, d, alpha=hy["alpha"], beta=hy["beta"], l1=hy["l1"],
            l2=hy["l2"], **common)
    else:
        params = TS.fit_sparse_lr_streaming(
            chunks, B, d, lr=best["lr"], l2=best["l2"], **common)
    return report, params


def _counted_selector_fit(idx, nums, y, grid, chunk_rows):
    """(model, chunks built, passes fed from a held chunk) of one
    selector fit."""
    S = TS.SparseModelSelector
    built, held = S.chunks_built, S.held_passes
    model, _, _ = _selector_fit("transmogrifai_tpu_torch", idx, nums, y,
                                grid=grid, chunk_rows=chunk_rows, **HELD_KW)
    return model, S.chunks_built - built, S.held_passes - held


def _same_fit(model, report, params):
    s = model.summary
    got = [r["logloss"] for r in s["validationResults"]]
    assert got == report["logloss"]
    assert int(np.nanargmin(got)) == report["best_index"]
    best = dict(report["best_hyper"])
    assert s["bestModel"]["family"] == TS.SPARSE_FAMILY_LABELS[
        best.pop("family")]
    assert s["bestModel"]["hyper"] == best
    assert sorted(model.model_params) == sorted(params)
    for k, v in params.items():
        assert np.array_equal(model.model_params[k].numpy(), v), k


@pytest.mark.parametrize("grid", [
    [{"family": "adagrad", "lr": 0.1, "l2": 0.0},
     {"family": "adagrad", "lr": 0.02, "l2": 1e-4}],
    [{"family": "ftrl", "alpha": 0.3, "l1": 0.0},
     {"family": "ftrl", "alpha": 0.1, "l1": 1e-3}],
    [{"family": "fm", "lr": 0.05}, {"family": "fm", "lr": 0.1,
                                    "l2": 1e-4}]],
    ids=["adagrad", "ftrl", "fm"])
def test_a_one_chunk_selector_holds_its_chunk_and_fits_bitwise(grid):
    """Training rows that fit in one chunk are built once and every pass
    reads the held chunk (a family's training epoch and evaluation pass,
    the refit's two epochs); the losses, the winner and the refit's
    parameters equal bitwise those of the sweep and the fit streamed on
    host chunks built anew at every pass."""
    idx, nums, y = _ctr_data(31, 1400, buckets=1 << 10)
    model, built, held = _counted_selector_fit(idx, nums, y, grid,
                                               chunk_rows=1 << 20)
    assert (built, held) == (1, 4)
    _same_fit(model, *_streamed_selector(idx, nums, y, grid, 1 << 20))


def test_a_default_shaped_fit_builds_one_chunk_for_eight_passes():
    """Three families at the default epochs (one, and a two-epoch
    refit): one chunk built, eight passes fed from it, where a stream
    built anew builds eight."""
    grid = [{"family": "adagrad", "lr": 0.05, "l2": 0.0},
            {"family": "ftrl", "alpha": 0.1, "l1": 0.0},
            {"family": "fm", "lr": 0.05}]
    idx, nums, y = _ctr_data(33, 1200, buckets=1 << 10)
    model, built, held = _counted_selector_fit(idx, nums, y, grid,
                                               chunk_rows=1 << 20)
    assert (built, held) == (1, 8)
    _same_fit(model, *_streamed_selector(idx, nums, y, grid, 1 << 20))


def test_a_longer_stream_builds_every_pass_as_before():
    """Training rows longer than one chunk stream as before: each pass
    builds its three chunks (a training epoch and an evaluation pass
    per family, two refit epochs), nothing is held, and the fit equals
    the streamed composition bitwise."""
    grid = [{"family": "adagrad", "lr": 0.1, "l2": 0.0},
            {"family": "ftrl", "alpha": 0.3, "l1": 0.0}]
    idx, nums, y = _ctr_data(35, 1400, buckets=1 << 10)
    model, built, held = _counted_selector_fit(idx, nums, y, grid,
                                               chunk_rows=500)
    assert (built, held) == (3 * (2 * 2 + 2), 0)
    _same_fit(model, *_streamed_selector(idx, nums, y, grid, 500))


def test_the_held_chunk_is_left_as_it_was_built(monkeypatch):
    """After a one-chunk fit the held chunk equals a fresh build of the
    same rows bitwise: no pass wrote into it."""
    from transmogrifai_tpu_torch.io.stream import _host_array
    from transmogrifai_tpu_torch.models.tuning import make_splitter
    kept = []
    real = TS._device_chunks

    def hold(*a, **k):
        kept.append(real(*a, **k))
        return kept[-1]
    monkeypatch.setattr(TS, "_device_chunks", hold)
    idx, nums, y = _ctr_data(37, 1300, buckets=1 << 10)
    _counted_selector_fit(idx, nums, y, [
        {"family": "fm", "lr": 0.05},
        {"family": "adagrad", "lr": 0.05, "l2": 1e-4}], chunk_rows=1 << 20)
    ((got,),) = kept
    splitter = make_splitter({"reserve_fraction": 0.1}, HELD_KW["seed"])
    train_i, _ = splitter.split(len(y))
    w, _ = splitter.prepare(y[train_i])
    (fresh,) = TS._prepared_chunks(
        _chunks(idx[train_i], nums[train_i], y[train_i], w,
                [len(train_i)]),
        HELD_KW["n_folds"], HELD_KW["seed"], HELD_KW["batch_size"])
    assert sorted(got) == sorted(fresh) == ["fold", "idx", "num", "w", "y"]
    assert len(fresh["y"]) % HELD_KW["batch_size"] == 0
    for k, v in fresh.items():
        assert torch.equal(got[k], torch.from_numpy(_host_array(v))), k


# ---------------------------------------------------------------------------
# LOCO
# ---------------------------------------------------------------------------

def _loco_setup(pkg):
    import importlib
    m = lambda x: importlib.import_module(pkg + x)
    ft = m(".features.types")
    FB = m(".features.feature").FeatureBuilder
    m(".features.feature").reset_uids()
    rng = np.random.default_rng(3)
    n = 1200
    strong, weak = rng.integers(0, 6, n), rng.integers(0, 50, n)
    nums = rng.normal(size=(n, 2)).astype(np.float64)
    y = (rng.random(n) < 1 / (1 + np.exp(
        -(np.where(strong % 2 == 0, 2.0, -2.0))))).astype(np.float64)
    D = m(".dataset").Dataset
    ds = D({"y": y, "s": np.array([f"v{v}" for v in strong], object),
            "w": np.array([None if v == 0 else f"u{v}" for v in weak],
                          object)},
           {"y": ft.RealNN, "s": ft.PickList, "w": ft.PickList})
    fs = FB.of(ft.PickList, "s").from_column().as_predictor()
    fw = FB.of(ft.PickList, "w").from_column().as_predictor()
    vec = m(".ops.sparse").SparseHashingVectorizer(
        num_buckets=1 << 12).set_input(fs, fw)
    ds2 = vec.transform(ds)
    ds2 = D(dict({k: ds2.column(k) for k in ds2.column_names},
                 nx=nums.astype(np.float32)), dict(ds2.schema,
                                                   nx=ft.OPVector))
    fy = FB.of(ft.RealNN, "y").from_column().as_response()
    fsx = FB.of(ft.SparseIndices, vec.output.name).from_column() \
        .as_predictor()
    fnx = FB.of(ft.OPVector, "nx").from_column().as_predictor()
    kw = {"device": CPU} if pkg.endswith("torch") else {}
    est = m(".models.sparse").SparseLogisticRegression(
        num_buckets=1 << 12, lr=0.1, epochs=3, batch_size=256,
        **kw).set_input(fy, fsx, fnx)
    model, _ = est.fit_transform(ds2)
    loco = m(".insights").SparseRecordInsightsLOCO.from_vectorizer(
        model, vec, dense_names=["n0", "n1"], top_k=4).set_input(fsx, fnx)
    return loco, ds2, vec, model


def test_sparse_loco_matches_numpy_and_jax():
    """Each (record, field) delta within 1e-5 of a numpy recomputation
    (the field's bucket replaced by its null-token bucket, a dense
    column zeroed) and of the JAX package's LOCO; the signal field
    tops most records; the row path and a JSON round trip agree."""
    from transmogrifai_tpu_torch.stages import stage_from_json, stage_to_json
    loco, ds, vec, model = _loco_setup("transmogrifai_tpu_torch")
    jloco, jds, _, _ = _loco_setup("transmogrifai_tpu")
    col = loco.transform(ds).column(loco.output.name)
    jcol = jloco.transform(jds).column(jloco.output.name)
    idx = ds.column(vec.output.name).astype(np.int64)
    X = ds.column("nx").astype(np.float64)
    P = {k: v.numpy().astype(np.float64) for k, v in
         model.model_params.items()}

    def p1(ix, x):
        z = P["table"][ix].sum(1) + x @ P["dense"] + P["bias"]
        return 1 / (1 + np.exp(-z))
    base = p1(idx, X)
    want = {}
    for k, name in enumerate(["s", "w"]):
        ix = idx.copy()
        ix[:, k] = loco.null_buckets[k]
        want[name] = base - p1(ix, X)
    for j, name in enumerate(["n0", "n1"]):
        x = X.copy()
        x[:, j] = 0.0
        want[name] = base - p1(idx, x)
    tops = 0
    for i in range(len(col)):
        got = {k: json.loads(v)[1] for k, v in col[i].items()}
        jgot = {k: json.loads(v)[1] for k, v in jcol[i].items()}
        assert set(got) == set(jgot) == {"s", "w", "n0", "n1"}
        for k, v in got.items():
            assert abs(v - want[k][i]) <= 1e-5 and abs(v - jgot[k]) <= 1e-5
        tops += max(got, key=lambda k: abs(got[k])) == "s"
    assert tops / len(col) > 0.8
    row = loco.transform_value(
        ds.ftype(vec.output.name)(tuple(ds.column(vec.output.name)[3])),
        ds.ftype("nx")(tuple(map(float, ds.column("nx")[3]))))
    assert row.value == col[3]
    loaded = stage_from_json(json.loads(json.dumps(stage_to_json(loco))))
    assert loaded.transform(ds).column(loaded.output.name)[3] == col[3]
    bad = TS.SparseLogisticModel(model_params={
        k: v.clone() for k, v in model.model_params.items()})
    bad.model_params["table"] = bad.model_params["table"][:8]
    loco.model = bad
    with pytest.raises(ValueError, match="num_buckets disagree"):
        loco.transform(ds)


# ---------------------------------------------------------------------------
# the front door
# ---------------------------------------------------------------------------

def test_transmogrify_sparse_routing_and_errors():
    from transmogrifai_tpu_torch.features import FeatureBuilder as FB
    from transmogrifai_tpu_torch.features import types as ft
    from transmogrifai_tpu_torch.ops import transmogrify_sparse
    num = FB.of(ft.Real, "x").from_column().as_predictor()
    cat = FB.of(ft.PickList, "c").from_column().as_predictor()
    resp = FB.of(ft.RealNN, "y").from_column().as_response()
    with pytest.raises(ValueError, match="no Text-typed"):
        transmogrify_sparse([num])
    with pytest.raises(ValueError, match="dense numeric block"):
        transmogrify_sparse([cat])
    with pytest.raises(ValueError, match="response"):
        transmogrify_sparse([cat, num, resp])
    with pytest.raises(ValueError, match="at least one"):
        transmogrify_sparse([])
    s, d = transmogrify_sparse([cat, num], num_buckets=256)
    assert issubclass(s.wtype, ft.SparseIndices)
    assert issubclass(d.wtype, ft.OPVector)
    assert type(s.origin_stage).__name__ == "SparseHashingVectorizer"
    assert s.origin_stage.params == {"num_buckets": 256, "seed": 42}


def _front_records(n, seed=0):
    rng = np.random.default_rng(seed)
    dev = rng.choice(["ios", "android", "web"], n, p=[.3, .5, .2])
    camp = rng.integers(0, 500, n)
    nums = rng.normal(size=(n, 2))
    logit = (np.where(dev == "ios", 2.2, -1.1)
             + np.where(camp % 3 == 0, 1.6, -0.9) + 1.0 * nums[:, 0])
    y = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(float)
    return [{"device": str(dev[i]), "campaign": f"c{camp[i]}",
             "num0": float(nums[i, 0]), "num1": float(nums[i, 1]),
             "click": float(y[i])} for i in range(n)]


def _front_workflow(pkg, buckets=1 << 12):
    import importlib
    m = lambda x: importlib.import_module(pkg + x)
    ft = m(".features.types")
    FB = m(".features.feature").FeatureBuilder
    m(".features.feature").reset_uids()
    click = FB.of(ft.RealNN, "click").from_column().as_response()
    cats = [FB.of(ft.PickList, c).from_column().as_predictor()
            for c in ("device", "campaign")]
    nums = [FB.of(ft.Real, f"num{j}").from_column().as_predictor()
            for j in range(2)]
    hashed, dense = m(".ops.transmogrifier").transmogrify_sparse(
        cats + nums, num_buckets=buckets)
    pred = m(".models.sparse").SparseModelSelector(
        num_buckets=buckets, n_folds=2, epochs=1, refit_epochs=2,
        batch_size=512, chunk_rows=700,
        grid=[{"lr": 0.05, "l2": 0.0}, {"lr": 0.1, "l2": 0.0},
              {"family": "ftrl", "alpha": 0.1, "l1": 0.0}],
    ).set_input(click, hashed, dense).output
    return m(".workflow").Workflow([pred]), m


def test_front_door_runner_e2e_matches_jax(tmp_path):
    """WorkflowRunner TRAIN and EVALUATE over the sparse front door in
    both packages: the same winner, CV losses within 1e-5, AUROC within
    1e-5; the loaded model's selected_model, insights and scores."""
    recs = _front_records(3000)
    out = {}
    for pkg in ("transmogrifai_tpu_torch", "transmogrifai_tpu"):
        wf, m = _front_workflow(pkg)
        reader = m(".readers").DataReaders.simple(recs)
        kw = {"device": CPU} if pkg.endswith("torch") else {}
        runner = m(".runner").WorkflowRunner(
            wf, train_reader=reader, score_reader=reader,
            evaluator=m(".evaluators").Evaluators.binary_classification(),
            **kw)
        params = m(".runner").OpParams(
            model_location=str(tmp_path / pkg / "model"),
            metrics_location=str(tmp_path / pkg / "metrics"),
            response="click")
        tr = runner.run(m(".runner").RunType.TRAIN, params)
        ev = runner.run(m(".runner").RunType.EVALUATE, params)
        out[pkg] = (tr, ev, m)
    (tt, te, tm), (jt, je, _) = out["transmogrifai_tpu_torch"], \
        out["transmogrifai_tpu"]
    assert tt["bestModel"] == jt["bestModel"]
    np.testing.assert_allclose(tt["fieldContributions"],
                               jt["fieldContributions"], rtol=RTOL)
    assert abs(te["metrics"]["AuROC"] - je["metrics"]["AuROC"]) <= 1e-5
    assert te["metrics"]["AuROC"] > 0.8
    model = tm(".workflow").WorkflowModel.load(
        str(tmp_path / "transmogrifai_tpu_torch" / "model"), device=CPU)
    sel = model.selected_model()
    assert type(sel).__name__ == "SparseSelectedModel"
    mi = model.model_insights()
    assert mi["selectedModelInfo"]["bestModel"]["family"] == \
        sel.summary["bestModel"]["family"]
    assert {"validationType", "splitterSummary", "validationResults",
            "bestModel", "trainEvaluation", "holdoutEvaluation",
            "dataCounts", "fieldContributions"} <= set(sel.summary)


@pytest.mark.parametrize("saver", ["transmogrifai_tpu",
                                   "transmogrifai_tpu_torch"])
def test_ctr_model_saved_by_one_package_scores_in_the_other(saver,
                                                            tmp_path):
    """A front-door CTR workflow saved by either package loads in the
    other and scores each row within 1e-6 of the saving package; the
    loader's scorer, score_stream and local scoring agree."""
    recs = _front_records(1500, seed=3)
    pkgs = {}
    for pkg in ("transmogrifai_tpu", "transmogrifai_tpu_torch"):
        wf, m = _front_workflow(pkg)
        pkgs[pkg] = (wf, m)
    wf, m = pkgs[saver]
    kw = {"device": CPU} if saver.endswith("torch") else {}
    model = wf.train(m(".readers").DataReaders.simple(recs), **kw)
    model.save(str(tmp_path / "m"))
    name = model.result_features[0].name
    want = np.asarray([r["probability_1"] for r in
                       model.score(recs).column(name)])
    other = ("transmogrifai_tpu_torch" if saver == "transmogrifai_tpu"
             else "transmogrifai_tpu")
    om = pkgs[other][1]
    okw = {"device": CPU} if other.endswith("torch") else {}
    loaded = om(".workflow").WorkflowModel.load(str(tmp_path / "m"), **okw)
    got = np.asarray([r["probability_1"] for r in
                      loaded.score(recs).column(name)])
    np.testing.assert_allclose(got, want, rtol=0, atol=CROSS_TOL)


def test_sparse_export_serves_and_keeps_ids_integer(tmp_path):
    """A sparse CTR export (hostPrefix recorded) loads in the port and
    serves from its integer boundary columns: each row within 1e-6 of
    the JAX package's numpy runtime, through the scorer and through a
    ServingEngine, which serves it on the classic plane (a sparse head
    is not stackable). On a 2^25-bucket table a bucket id at 2^24 + 1
    (which f32 would round to 2^24, whose weight is planted with the
    opposite sign) scores its own weight, as the int64 runtime does."""
    from transmogrifai_tpu import portable as jportable
    from transmogrifai_tpu_torch import portable as tportable
    from transmogrifai_tpu_torch.serving import (EngineConfig,
                                                 ModelRegistry, ServingEngine)
    recs = _front_records(1200, seed=5)
    wf, m = _front_workflow("transmogrifai_tpu_torch")
    model = wf.train(m(".readers").DataReaders.simple(recs), device=CPU)
    path = str(tmp_path / "ctr")
    model.export_portable(path)
    man = json.load(open(os.path.join(path, "manifest.json")))
    assert "SparseHashingVectorizer" in man["hostPrefix"]
    assert man["stages"][-1]["op"] == "sparse_predict"
    sc = model.compile_scoring(device=CPU)
    ds = sc._host_ds(recs[:64])
    cols = {n: np.asarray(ds.column(n)) for n in sc.boundary if n in ds}
    sparse_col, = sc.index_boundary
    assert cols[sparse_col].dtype == np.int32
    want = jportable.load(path).score_columns(cols)
    pm = tportable.load(path, device=CPU)
    name = pm.result_names[0]
    got = pm.compile_scoring().score_arrays(cols)[name]
    np.testing.assert_allclose(got, want[name], rtol=0, atol=CROSS_TOL)
    reg = ModelRegistry()
    reg.register("ctr", pm, buckets=(16, 64),
                 warm_sample={k: v[:1] for k, v in cols.items()})
    eng = ServingEngine(registry=reg, config=EngineConfig(
        max_batch_rows=64, fused_kernel=True)).start()
    try:
        futs = [eng.submit({k: v[i:i + 8] for k, v in cols.items()})
                for i in range(0, 64, 8)]
        res = [f.result(timeout=30) for f in futs]
    finally:
        eng.stop()
    np.testing.assert_allclose(np.concatenate([r[name] for r in res]), got,
                               rtol=0, atol=CROSS_TOL)
    stats = eng.stats.as_dict()
    assert stats["fused_batches"] == 0 and stats["failed"] == 0
    from transmogrifai_tpu_torch.serving.fusion import stack_spec_of
    from transmogrifai_tpu_torch.serving.registry import _FusedBackend
    assert stack_spec_of(_FusedBackend(pm.compile_scoring())) is None

    # the same chain over a 2^25-bucket table, ids as int64 columns
    last = str(len(man["stages"]) - 1)
    flat = dict(np.load(os.path.join(path, "params.npz")))
    per = {}
    for key, val in flat.items():
        sid, rest = key.split("/", 1)
        per.setdefault(sid, {})[rest] = val
    arrs = {sid: tportable.unflatten_tree(d) for sid, d in per.items()}
    big = np.zeros(1 << 25, np.float32)
    small = arrs[last]["params"]["table"]
    big[:len(small)] = small
    hi = (1 << 24) + 1
    big[hi], big[hi - 1] = 2.5, -2.5
    arrs[last]["params"]["table"] = big
    ids = cols[sparse_col].astype(np.int64)
    ids[::2, 0] = hi
    cols64 = dict(cols, **{sparse_col: ids})
    want = jportable.PortableModel(man, arrs).score_columns(cols64)[name]
    got = tportable.from_portable(man, arrs, CPU).compile_scoring() \
        .score_arrays(cols64)[name]
    np.testing.assert_allclose(got, want, rtol=0, atol=CROSS_TOL)
    # an id rounded through f32 would read big[2^24] = -2.5 instead
    assert np.abs(got[::2, 1] - got[1::2, 1]).max() > 0.5
