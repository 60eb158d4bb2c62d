"""The fit path's regions (``telemetry/spans.py``'s ``Tracer.region``):
on the torch profiler's timeline while it records, in the tracer's ring
under one trace while the tracer samples, and nowhere when neither is
on. Small fits on the CPU."""
import ast
import os
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from transmogrifai_tpu_torch.dataset import Dataset
from transmogrifai_tpu_torch.features import FeatureBuilder
from transmogrifai_tpu_torch.features import types as ft
from transmogrifai_tpu_torch.telemetry import spans

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "transmogrifai_tpu_torch")

CANDIDATES = [["DecisionTreeClassifier", {"maxDepth": [3]}],
              ["LogisticRegression", {"regParam": [0.1],
                                      "elasticNetParam": [0.0]}]]


@pytest.fixture(autouse=True)
def tracer_off():
    spans.configure(sample=0.0)
    yield
    spans.configure(sample=0.0)


def _dense(n=2000, d=4, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X[:, 0] + 0.5 * rng.normal(size=n) > 0).astype(np.float64)
    return Dataset({"y": y, "x": X}, {"y": ft.RealNN, "x": ft.OPVector})


def _selector(candidates=CANDIDATES):
    from transmogrifai_tpu_torch import models as TM
    lbl = FeatureBuilder.of(ft.RealNN, "y").from_column().as_response()
    vec = FeatureBuilder.OPVector("x").from_column().as_predictor()
    return TM.BinaryClassificationModelSelector.with_cross_validation(
        n_folds=2, candidates=candidates, device="cpu").set_input(lbl, vec)


def _sparse(n=3000, K=3, d=2, buckets=1 << 10, seed=1):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, buckets, size=(n, K)).astype(np.int32)
    num = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.random(n) < 0.3).astype(np.float64)
    return Dataset({"y": y, "sidx": idx, "dense": num},
                   {"y": ft.RealNN, "sidx": ft.SparseIndices,
                    "dense": ft.OPVector})


def _sparse_selector(grid, chunk_rows=1000):
    from transmogrifai_tpu_torch.models.sparse import SparseModelSelector
    lbl = FeatureBuilder.of(ft.RealNN, "y").from_column().as_response()
    sf = FeatureBuilder.of(ft.SparseIndices, "sidx").from_column() \
        .as_predictor()
    dn = FeatureBuilder.of(ft.OPVector, "dense").from_column().as_predictor()
    return SparseModelSelector(num_buckets=1 << 10, grid=grid, batch_size=256,
                               chunk_rows=chunk_rows, device="cpu").set_input(
                                   lbl, sf, dn)


def _profiled(fn):
    """(result, [(name, start_us, end_us, thread)] of the program's
    regions) of ``fn()`` under a CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    evs = [(e.name, e.time_range.start, e.time_range.end, e.thread)
           for e in prof.events() if e.name in spans.REGIONS]
    return out, evs


def _named(evs, name):
    return [e for e in evs if e[0] == name]


def _inside(child, parents):
    return any(p[1] <= child[1] and child[2] <= p[2] for p in parents)


def test_a_selector_fit_records_its_regions_nested(monkeypatch):
    from transmogrifai_tpu_torch.models import trees
    depths = []
    real = trees.grow_tree_grid

    def grow(*a, **k):
        depths.append(k["max_depth"])
        return real(*a, **k)
    monkeypatch.setattr(trees, "grow_tree_grid", grow)
    ds = _dense()
    _, evs = _profiled(lambda: _selector().fit(ds))
    fit = _named(evs, "selector.fit")
    assert len(fit) == 1
    for name in ("selector.split", "selector.stage", "selector.refit"):
        got = _named(evs, name)
        assert len(got) == 1, name
        assert _inside(got[0], fit), name
    # one dispatch and one collect a family batch, each inside the fit
    for name in ("selector.dispatch", "selector.collect"):
        got = _named(evs, name)
        assert len(got) == len(CANDIDATES), name
        assert all(_inside(e, fit) for e in got), name
    # every dispatch precedes every collect (fused mode)
    assert max(e[1] for e in _named(evs, "selector.dispatch")) < \
        min(e[1] for e in _named(evs, "selector.collect"))
    # as many tree levels as the grower ran, each inside a dispatch or
    # the refit
    levels = _named(evs, "trees.level")
    assert depths and len(levels) == sum(depths)
    outer = _named(evs, "selector.dispatch") + _named(evs, "selector.refit")
    assert all(_inside(e, outer) for e in levels)
    solves = _named(evs, "linear.solve")
    iters = _named(evs, "linear.iter")
    assert solves and iters
    assert all(_inside(e, solves) for e in iters)
    assert all(_inside(e, _named(evs, "sweep.chunk") + outer)
               for e in solves)


def test_a_sparse_fit_counts_its_steps_and_streams_on_one_thread(
        monkeypatch):
    from transmogrifai_tpu_torch.models import sparse
    steps = []
    for fn in ("_adagrad_apply", "_ftrl_step"):
        real = getattr(sparse, fn)

        def counted(*a, _real=real, **k):
            steps.append(threading.get_ident())
            return _real(*a, **k)
        monkeypatch.setattr(sparse, fn, counted)
    grid = [{"family": "adagrad", "lr": 0.05, "l2": 0.0},
            {"family": "ftrl", "alpha": 0.1, "l1": 0.0}]
    ds = _sparse()
    _, evs = _profiled(lambda: _sparse_selector(grid).fit(ds))
    fit = _named(evs, "selector.fit")
    assert len(fit) == 1
    assert len(_named(evs, "sparse.step")) == len(steps) > 0
    assert len(_named(evs, "sparse.family")) == 2
    assert len(_named(evs, "sparse.eval")) == 2
    assert len(_named(evs, "sparse.refit")) == 1
    assert _inside(_named(evs, "sparse.refit")[0],
                   _named(evs, "selector.refit"))
    stream = [e for e in evs if e[0].startswith("stream.")]
    assert _named(evs, "stream.stage") and _named(evs, "stream.wait")
    # the host-prefetch producer thread records nothing
    assert {e[3] for e in stream} == {fit[0][3]}


def test_a_one_chunk_sparse_fit_builds_and_copies_its_chunk_once():
    """Training rows that fit in one chunk: the stream is pulled once,
    before the sweep (two ``stream.produce`` regions, the chunk and the
    stream's end), and one ``stream.stage`` region copies it. The
    refit's epochs pass the held tensors through ``io/stream``'s staging
    without a copy (a stage region an epoch, inside the refit, holding
    no operation)."""
    grid = [{"family": "adagrad", "lr": 0.05, "l2": 0.0},
            {"family": "ftrl", "alpha": 0.1, "l1": 0.0}]
    ds = _sparse()
    sel = _sparse_selector(grid, chunk_rows=len(ds.column("y")))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sel.fit(ds)
    evs = [(e.name, e.time_range.start, e.time_range.end, e.thread)
           for e in prof.events()]
    produce = _named(evs, "stream.produce")
    first_family = min(e[1] for e in _named(evs, "sparse.family"))
    assert len(produce) == 2
    assert all(e[2] <= first_family for e in produce)
    refit = _named(evs, "sparse.refit")
    stage = _named(evs, "stream.stage")
    copies = [s for s in stage
              if any(e[0].startswith("aten::") and e[3] == s[3]
                     and _inside(e, [s]) for e in evs)]
    assert len(copies) == 1 and not _inside(copies[0], refit)
    assert len(stage) == 1 + sel.params["refit_epochs"]
    assert all(_inside(s, refit) for s in stage if s not in copies)


def test_with_both_recorders_off_no_fit_enters_record_function(
        monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no recorder on")
    monkeypatch.setattr(spans, "record_function", refuse)
    assert not spans.TRACER.enabled
    assert spans.TRACER.region("trees.level") is spans._NULL
    model = _selector().fit(_dense())
    assert model.summary["bestModel"]["family"]
    _sparse_selector([{"family": "adagrad", "lr": 0.05, "l2": 0.0}]).fit(
        _sparse())


def test_a_sampled_fit_lands_in_the_ring_under_one_trace():
    spans.configure(sample=1.0)
    _selector().fit(_dense())
    got = spans.TRACER.spans()
    assert got
    ids = {s["trace"] for s in got}
    assert len(ids) == 1 and ids.pop().startswith("fit-")
    names = {s["name"] for s in got}
    assert {"selector.fit", "selector.split", "selector.dispatch",
            "selector.collect", "selector.refit", "trees.level",
            "linear.iter"} <= names
    dispatch = [s for s in got if s["name"] == "selector.dispatch"]
    assert {s["attrs"]["family"] for s in dispatch} == {
        "DecisionTreeClassifier", "LogisticRegression"}


def test_a_workflow_train_shows_its_stages_and_its_fits_join_its_trace():
    from transmogrifai_tpu_torch.workflow import Workflow
    spans.configure(sample=1.0)
    wf = Workflow([_selector().output])
    ds = _dense()
    _, evs = _profiled(lambda: wf.train(ds, executor="serial",
                                        device="cpu"))
    stage = _named(evs, "workflow.stage")
    assert stage and _named(evs, "workflow.layer")
    assert all(_inside(e, stage) for e in _named(evs, "selector.fit"))
    got = spans.TRACER.spans()
    ids = {s["trace"] for s in got}
    assert len(ids) == 1 and ids.pop().startswith("train-")
    names = {s["name"] for s in got}
    assert "train" in names and "selector.fit" in names
    assert any(n.startswith("stage:") for n in names)


def _region_names():
    """The literal names of every ``TRACER.region(...)`` call in the
    package."""
    found = set()
    for root, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(root, f)) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "region" and node.args):
                    arg = node.args[0]
                    assert isinstance(arg, ast.Constant), (f, arg)
                    found.add(arg.value)
    return found


def test_every_region_is_in_the_table_and_the_table_is_used():
    assert _region_names() == set(spans.REGIONS)
    for name in spans.REGIONS:
        layer, what = name.split(".")
        assert layer and what
