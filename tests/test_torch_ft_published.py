"""The port's published FT-Transformer (``models/ft_published.py``, the
``FTTransformerPublishedClassifier`` family) against the plain reference
(``tests/ft_reference.py``, a copy of ``portbench/reference/
ft_transformer.py``), on the CPU in f32, at a small size that keeps every
published ratio: d_token 16, 3 blocks, 4 heads, ReGLU hidden
int(16 * 4/3) = 21, 6 features, the published dropouts, batches of 32.

* The forward's logits and the loss with the rule's dropout masks, the
  CLS-only last block against the reference's full one, no dropout in
  eval; the gradient; three AdamW steps with rtdl's parameter groups.
* The rules: an epoch covers each item's rows once; an item's fit does
  not depend on the chunk around it.
* The sweep: a published batch of 6 items runs in one chunk with no
  padded copy and scores in blocks, a larger one in as few equal chunks
  as memory allows; a linear family keeps the validator's chunk and its
  metrics.
* Tracing: one ``ft.step`` region a step, the counters equal to the
  steps and rows the rule gives.
"""
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import ft_reference as R
from transmogrifai_tpu_torch.models import ft_published as FT
from transmogrifai_tpu_torch.models import tuning as TU
from transmogrifai_tpu_torch.models.base import (MODEL_FAMILIES, RowPlan,
                                                 tree_map)

#: the small recipe: every published ratio, the published dropouts, set
#: on the family's attributes
SMALL = {"d_token": 16, "n_blocks": 3, "n_heads": 4,
         "ffn_hidden": int(16 * 4 / 3), "attention_dropout": 0.2,
         "ffn_dropout": 0.1, "batch_size": 32, "epochs": 1}
CFG = SMALL
D_FEAT = 6
#: f32 logits and loss on the same parameters and masks: products of at
#: most 42 terms summed in another order (batched against plain) and
#: the last block over one query against all; measured 1e-7 or less
LOGIT_RTOL = 1e-5
#: the gradient, each leaf against its largest entry: autograd of two
#: differently ordered f32 graphs (measured under 1e-6)
GRAD_RTOL = 1e-4
#: three AdamW steps from the same draw, each leaf against its largest
#: entry; Adam divides by sqrt(v), which lifts the gradients' last bits
#: (measured under 1e-6)
STEP_RTOL = 1e-4
FAM = MODEL_FAMILIES["FTTransformerPublishedClassifier"]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def f32_small(monkeypatch):
    for k in ("TM_FT_BF16", "TM_KERNEL_EXACT", "TM_SWEEP_FUSION",
              "TM_SWEEP_EXACT", "TM_SWEEP_FOLD_SLICE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in SMALL.items():
        monkeypatch.setattr(FAM, k, v)


def _rec():
    return FAM.recipe()


def _data(n=200, seed=0):
    g = torch.Generator().manual_seed(seed)
    X = torch.randn(n, D_FEAT, generator=g)
    y = ((X[:, 0] * X[:, 1] + 0.5 * X[:, 2]
          + 0.3 * torch.randn(n, generator=g)) > 0).to(torch.float32)
    return X, y


def _net(seed=1):
    """Seeded random weights in the published layout: the family's draw
    with every leaf (norms and biases too) moved off its initial value."""
    net = FAM.published_params(D_FEAT, 2)
    g = torch.Generator().manual_seed(seed)
    return tree_map(lambda t: t + 0.2 * torch.randn(t.shape, generator=g),
                    net)


def _flat(net):
    lay = FT.FlatLayout(net)
    return lay, lay.flat(net)[None].clone()


def _at(rows, seed=42, fold=0, epoch=0, step=0, B=32):
    plan = RowPlan(seed, (fold,), (rows,))
    pos, ok, steps, _, bc = FT._epoch_rows(plan, epoch, B, "cpu")
    sl = slice(step * B, (step + 1) * B)
    return FT.StepAt(seed, epoch, step, (fold,), pos[:, sl], ok[:, sl],
                     (True,), (step + 1,), bc[step], 1)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_forward_and_loss_match_the_reference_with_the_rules_masks():
    X, y = _data()
    net = _net()
    mu, sd = R.standardize(X, torch.ones(len(y)))
    Xs = (X - mu) / sd
    rec = _rec()
    B, T = 32, D_FEAT + 1
    pos = torch.as_tensor(R.batch_positions(42, 0, 0, 2, len(y), B))
    keeps = FT._step_keeps(rec, 42, 0, 2, B, T, "cpu", torch.Generator())
    masks = R.dropout_masks(CFG, 42, 0, 2, B, T, "cpu")
    one = tree_map(lambda a: a[None], net)
    got = FT._pub_forward(one, one, Xs[pos][None], keeps, torch.float32)[0]
    want = R.forward(net, Xs[pos], masks)
    assert _rel(got, want) <= LOGIT_RTOL
    w = torch.ones(B)
    got_rows = FT._pub_loss(got[None], y[pos][None], w[None], 2)[0]
    want_rows = R.row_losses(net, Xs[pos], y[pos], w, 2, masks)
    assert _rel(got_rows, want_rows) <= LOGIT_RTOL
    assert abs(float(got_rows.sum() - want_rows.sum())) \
        <= LOGIT_RTOL * float(want_rows.sum())
    # the masks do act: the same rows without them give other logits
    assert _rel(R.forward(net, Xs[pos]), want) > 1e-3


def test_cls_only_last_block_equals_the_full_blocks_cls_row():
    X, _ = _data(n=40)
    net = _net(seed=3)
    one = tree_map(lambda a: a[None], net)
    got = FT._pub_forward(one, one, X[None], None, torch.float32)[0]
    assert _rel(got, R.forward(net, X)) <= LOGIT_RTOL


def test_eval_applies_no_dropout():
    X, _ = _data(n=50)
    net = _net(seed=4)
    mu, sd = torch.zeros(D_FEAT), torch.ones(D_FEAT)
    params = {"net": net, "mu": mu, "sd": sd}
    a = FAM.predict_kernel(params, X, 2)
    b = FAM.predict_kernel(params, X, 2)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    want = torch.sigmoid(R.forward(net, X)[:, 0])
    assert float((a[:, 1] - want).abs().max()) <= 1e-6
    torch.testing.assert_close(a.sum(1), torch.ones(len(X)))


def test_gradient_matches_the_reference():
    X, y = _data()
    net = _net(seed=5)
    lay, flat = _flat(net)
    flat.requires_grad_()
    w = torch.ones(1, len(y))
    at = _at(len(y), step=1)
    loss, g = FT._train_loss_grad(flat, lay, X[None], y[None], w, at,
                                  _rec(), 2, torch.float32,
                                  torch.Generator())
    pos = torch.as_tensor(R.batch_positions(42, 0, 0, 1, len(y), 32))
    masks = R.dropout_masks(CFG, 42, 0, 1, 32, D_FEAT + 1, "cpu")
    want_rows, want = R.loss_and_grad(net, X[pos], y[pos], torch.ones(32), 2,
                                      masks)
    assert _rel(loss[0], want_rows) <= LOGIT_RTOL
    got = FT._paths(lay.views(g))
    assert [p for p, _ in got] == [p for p, _ in R.leaves(net)]
    for (path, gg), gw in zip(got, want):
        assert _rel(gg[0], gw) <= GRAD_RTOL, path


def test_the_parameter_groups_are_rtdls():
    lay = FT.FlatLayout(FAM.published_params(D_FEAT, 2))
    groups = {p: FT.decays(p) for p in lay.paths}
    assert groups == {p: R.decays(p) for p in lay.paths}
    off = {p[-2] if len(p) > 1 and str(p[-2]).endswith("_ln") else p[-1]
           for p, on in groups.items() if not on}
    assert off == {"tok_w", "tok_b", "bqkv", "bo", "b1", "b2", "head_b",
                   "attn_ln", "ffn_ln", "head_ln"}
    assert {p[-1] for p, on in groups.items() if on} == {
        "cls", "wqkv", "wo", "w1", "w2", "head_w"}


def test_three_adamw_steps_match_the_reference():
    X, y = _data(n=96)                       # 3 batches of 32: 3 steps
    init = _net(seed=6)
    hyper = dict(learningRate=3e-3, weightDecay=0.5)
    w = torch.ones(len(y))
    got = FAM.fit_kernel(X, y, w, hyper, 2, init=init,
                         plan=RowPlan(7, (-1,), (len(y),)))
    mu, sd = R.standardize(X, w)
    Xs = (X - mu) / sd
    paths = [p for p, _ in R.leaves(init)]
    sizes = [t.numel() for _, t in R.leaves(init)]
    p = torch.cat([t.reshape(-1) for _, t in R.leaves(init)])
    decay = torch.cat([torch.full((t.numel(),), float(R.decays(q)))
                       for q, t in R.leaves(init)])
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    for step in range(3):
        pos = torch.as_tensor(R.batch_positions(7, -1, 0, step, len(y), 32))
        masks = R.dropout_masks(CFG, 7, 0, step, 32, D_FEAT + 1, "cpu")
        net = R.rebuild(init, iter([a.reshape(t.shape) for a, (_, t) in
                                    zip(torch.split(p, sizes),
                                        R.leaves(init))]))
        _, grads = R.loss_and_grad(net, Xs[pos], y[pos], torch.ones(32), 2,
                                   masks)
        g = torch.cat([t.reshape(-1) for t in grads])
        p, m, v = R.adamw(p, g, m, v, step + 1, 3e-3, 0.5, decay)
    torch.testing.assert_close(got["mu"], mu)
    D = CFG["d_token"]
    for path, want, (_, gl) in zip(paths, torch.split(p, sizes),
                                   FT._paths(got["net"])):
        gl = gl.reshape(-1)
        if path[-1] == "bqkv":
            # the key bias adds q.b_k to every logit of a query, which the
            # softmax cancels: its gradient is zero but for rounding, whose
            # sign Adam turns into steps of lr either way. It stays within
            # three steps of its start; Q's and V's biases compare
            start = dict(R.leaves(init))[path]
            assert float((gl[D:2 * D] - start[D:2 * D]).abs().max()) \
                <= 3 * 3e-3 * 1.001
            gl, want = (torch.cat([t[:D], t[2 * D:]]) for t in (gl, want))
        assert _rel(gl, want) <= STEP_RTOL, path


def test_an_epoch_steps_through_each_items_rows_once():
    plan = RowPlan(42, (0, 0, 1, -1), (100, 100, 90, 130))
    B = 32
    pos, ok, steps, S, bc = FT._epoch_rows(plan, 0, B, "cpu")
    assert steps == [4, 4, 3, 5] and S == 5
    for j, r in enumerate(plan.rows):
        seen = pos[j][ok[j] > 0]
        assert sorted(seen.tolist()) == list(range(r))
        assert int(ok[j].sum()) == r
        np.testing.assert_array_equal(
            seen.numpy(), R.epoch_order(42, plan.folds[j], 0, r))
    assert torch.equal(pos[0], pos[1])            # one fold, one order
    assert not torch.equal(pos[0, :90], pos[2, :90])
    nxt, _, _, _, _ = FT._epoch_rows(plan, 1, B, "cpu")
    assert not torch.equal(pos[0], nxt[0])
    # the fold of 90 rows sits the chunk's last two steps out
    assert bc[:, 2, 2].tolist() == [1, 1, 1, 0, 0]


def test_an_items_fit_does_not_depend_on_the_chunk_around_it():
    X, y = _data(n=120)
    X2, y2 = _data(n=120, seed=9)
    w = torch.ones(120)

    def fit(items, lrs, plan):
        hyper = dict(learningRate=torch.tensor(lrs), weightDecay=1e-5)
        Xb = torch.stack([a[0] for a in items])
        yb = torch.stack([a[1] for a in items])
        return FAM.fit_batch(Xb, yb, torch.stack([w] * len(items)), hyper,
                             2, plan=plan)

    a = fit([(X, y), (X2, y2)], [1e-3, 3e-3],
            RowPlan(42, (0, 1), (120, 100)))
    b = fit([(X2, y2), (X, y)], [1e-2, 1e-3],
            RowPlan(42, (2, 0), (80, 120)))
    for la, lb in zip(FT._paths(a), FT._paths(b)):
        torch.testing.assert_close(la[1][0], lb[1][1], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

def _cv_data(n=240, seed=2):
    X, y = _data(n=n, seed=seed)
    return X.numpy(), y.numpy(), np.ones(n, np.float32)


def _regions(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    names = [e.name for e in prof.events()]
    return out, {k: names.count(k) for k in ("ft.step", "ft.score",
                                             "sweep.chunk")}


def test_a_published_batch_runs_in_one_chunk_with_no_padding(monkeypatch):
    """Six items (3 folds x 2 grid points): one chunk, no padded copy,
    each item scored in blocks."""
    monkeypatch.setattr(FT, "SCORE_ROWS", 32)
    X, y, w = _cv_data()
    grid = FAM.make_grid({"learningRate": [1e-3, 3e-3],
                          "weightDecay": [1e-5]})
    cv = TU.OpCrossValidation(n_folds=3, metric="auroc")
    before = (FAM.padded_items, FAM.item_steps, FAM.chunk_steps)
    res, n = _regions(lambda: cv.collect(cv.dispatch_many(
        [("ft", FAM, grid)], X, y, w, 2, device="cpu")["ft"]))
    assert FAM.padded_items == before[0]
    train_m, val_m = TU.make_fold_masks(len(y), 3, cv.seed)
    steps = [math.ceil(r / 32) for r in train_m.sum(1)]
    assert n["sweep.chunk"] == 1
    assert FAM.chunk_steps - before[2] == n["ft.step"] == max(steps)
    assert FAM.item_steps - before[1] == 2 * sum(steps)
    # each item's validation rows, padded to the row alignment, in
    # blocks of SCORE_ROWS
    width = int(val_m.sum(1).max())
    width += (-width) % TU.ROW_ALIGN
    assert n["ft.score"] == 6 * math.ceil(width / 32)
    assert np.all(np.isfinite(res.grid_metrics))


def test_a_published_batch_chunks_by_its_items_and_a_linear_one_by_16(
        monkeypatch):
    """The cell's grid, 3 folds x 2 points, is one chunk of six; nine
    items where memory holds four steps run as three chunks of three; the
    toy FT and the linear families keep the validator's chunk."""
    X = torch.zeros(10, D_FEAT)
    pub = TU.stack_hyper_batch(FAM.make_grid(), 3)
    assert TU._family_chunk(FAM, pub, X) == 6
    monkeypatch.setattr(FT, "_free_bytes", lambda dev: int(
        4 * FT.step_bytes(FAM.recipe(), D_FEAT + 1)
        / FT.CHUNK_MEMORY_SHARE))
    nine = TU.stack_hyper_batch(FAM.make_grid(
        {"learningRate": [1e-4, 3e-4, 1e-3]}), 3)
    assert TU._family_chunk(FAM, nine, X) == 3
    toy = MODEL_FAMILIES["FTTransformerClassifier"]
    lin = MODEL_FAMILIES["LogisticRegression"]
    for fam in (toy, lin):
        hb = TU.stack_hyper_batch(fam.make_grid(), 3)
        assert TU._family_chunk(fam, hb, X) is None
    assert TU.SWEEP_CHUNK == {"cpu": 1, "cuda": 16}


def test_a_linear_sweep_keeps_its_chunk_and_metrics(monkeypatch):
    """A linear family's sweep at a chunk of 16 (the card's) runs as it
    did: one chunk, its metrics those of its runner with no row plan."""
    monkeypatch.setitem(TU.SWEEP_CHUNK, "cpu", 16)
    X, y, w = _cv_data(n=300)
    lin = MODEL_FAMILIES["LogisticRegression"]
    grid = lin.make_grid({"regParam": [0.01, 0.1], "elasticNetParam": [0.0]})
    cv = TU.OpCrossValidation(n_folds=3, metric="auroc")
    seen = []
    real = TU._sweep_runner

    def spy(*a, **k):
        seen.append((a[5], k.get("plan_seed", a[6] if len(a) > 6 else None)))
        return real(*a, **k)
    monkeypatch.setattr(TU, "_sweep_runner", spy)
    got, n = _regions(lambda: cv.collect(cv.dispatch_many(
        [("lr", lin, grid)], X, y, w, 2, device="cpu")["lr"]).grid_metrics)
    assert seen == [(True, None)] and n["sweep.chunk"] == 1
    train_m, val_m = TU.make_fold_masks(len(y), 3, cv.seed)
    tr, va = TU.fold_slice_batch(train_m, val_m, len(grid))
    hb = TU.stack_hyper_batch(grid, 3)
    traced, static = TU.split_static_hyper(lin, hb)
    repl = TU.OpValidator._device_data(X, y, w, "cpu")
    with torch.inference_mode():
        mets = real(lin, TU._METRIC_FNS["auroc"][0], 2, repl, static,
                    True)(tr, va, traced, 16)
    want = mets.numpy().reshape(3, len(grid)).mean(axis=0)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# tracing and the selector
# ---------------------------------------------------------------------------

def test_a_fit_opens_one_step_region_a_step_and_counts_them(monkeypatch):
    monkeypatch.setattr(FAM, "epochs", 2)
    X, y = _data(n=150)
    hyper = dict(learningRate=1e-3, weightDecay=1e-5)
    before = (FAM.chunk_steps, FAM.item_steps, FAM.rows_stepped)
    _, n = _regions(lambda: FAM.fit_kernel(
        X, y, torch.ones(150), hyper, 2,
        plan=RowPlan(42, (-1,), (150,))))
    steps = 2 * math.ceil(150 / 32)
    assert n["ft.step"] == steps
    assert FAM.chunk_steps - before[0] == steps
    assert FAM.item_steps - before[1] == steps
    assert FAM.rows_stepped - before[2] == 2 * 150


def test_the_selector_fits_the_published_recipe():
    from transmogrifai_tpu_torch import models as TM
    from transmogrifai_tpu_torch.dataset import Dataset
    from transmogrifai_tpu_torch.features import FeatureBuilder
    from transmogrifai_tpu_torch.features import types as ft
    X, y = _data(n=300, seed=11)
    ds = Dataset({"y": y.numpy().astype(np.float64), "x": X.numpy()},
                 {"y": ft.RealNN, "x": ft.OPVector})
    lbl = FeatureBuilder.of(ft.RealNN, "y").from_column().as_response()
    vec = FeatureBuilder.OPVector("x").from_column().as_predictor()
    grid = {"learningRate": [1e-3, 3e-3], "weightDecay": [1e-5]}
    sel = TM.BinaryClassificationModelSelector.with_cross_validation(
        n_folds=3, candidates=[["FTTransformerPublishedClassifier", grid]],
        device="cpu").set_input(lbl, vec)
    before = FAM.item_steps
    model = sel.fit(ds)
    summ = model.summary
    assert summ["bestModel"]["family"] == "FTTransformerPublishedClassifier"
    n_train = summ["dataCounts"]["train"]
    train_m, _ = TU.make_fold_masks(n_train, 3, sel.params["seed"])
    want = 2 * sum(math.ceil(r / 32) for r in train_m.sum(1)) \
        + math.ceil(n_train / 32)
    assert FAM.item_steps - before == want
    assert "blocks" in model.model_params["net"]
    assert 0.5 < summ["holdoutEvaluation"]["AuROC"] <= 1.0

