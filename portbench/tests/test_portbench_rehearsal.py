"""A tiny rehearsal of each cell on the CPU through the port's building
blocks: the run after the look for a chip (set-up, window, readers, the
judged fit), its result shaped as on the card and judged correct; the
control judged not correct; and, with the timed path broken underneath,
``correct`` false for each fault a cell can have.

Every cell of ``BENCHMARK.json`` brings ``rehearsal/<cell>.json``: its
rows on the CPU and the faults its timed path can have, each named
``<module>.<function>`` under ``portbench.tests`` (a new cell's own in a
test file of its own)."""
import importlib
import json
import os

import pytest
import torch

from portbench import run
from portbench.control import readings

HERE = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
    CELLS = sorted(w["name"] for w in json.load(f)["workloads"])


def rehearsal(cell):
    """The cell's ``rehearsal/<cell>.json``."""
    with open(os.path.join(HERE, "rehearsal", cell + ".json")) as f:
        return json.load(f)


def fault(name):
    """A fault by its name, ``<module>.<function>`` under
    ``portbench.tests``."""
    mod, fn = name.rsplit(".", 1)
    return getattr(importlib.import_module("portbench.tests." + mod), fn)


def _faults(cell):
    """The cell's fault names, none where it brings no rehearsal (which
    ``test_each_cell_brings_its_rehearsal`` fails)."""
    try:
        return rehearsal(cell)["faults"]
    except (OSError, KeyError):
        return []


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_brings_its_rehearsal(cell):
    r = rehearsal(cell)
    assert r["rows"] > 0
    assert r["faults"], "every cell can have an altered answer at least"
    for name in r["faults"]:
        assert callable(fault(name)), name


def cell_fit_metric(cell):
    return run.load_cell(cell)["mix"]["fit_metric"]


def _run(cell, trace=False, seed=2 ** 31 + 7):
    return run.run_cell(run.load_cell(cell), seed, 0.0, trace,
                        device="cpu", rows=rehearsal(cell)["rows"],
                        warmup=False)


@pytest.mark.parametrize("cell", CELLS)
def test_a_rehearsal_is_judged_correct(cell):
    result, table = _run(cell)
    assert result["correct"], table
    assert list(result)[-1] == "checks"
    assert result["attempted"] == 1 and result["failed"] == 0
    assert set(result["metrics"]) == {cell_fit_metric(cell), "setup_s"}
    assert all(v["value"] > 0 for v in result["metrics"].values())


@pytest.mark.parametrize("cell", ["higgs.default"])
def test_a_traced_rehearsal_reads_the_host_side_metrics(cell):
    result, _ = _run(cell, trace=True)
    m = result["metrics"]
    # the CPU has no device trace: those readers find nothing to read
    assert {"sweep_s", "rest_s", "fit_mfu"} <= set(m)
    assert "hist_roofline" not in m and "blas_device_s" not in m
    assert 0 < m["fit_mfu"]["value"] < 100


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_judged_not_correct(cell):
    from portbench import check
    recs = readings(cell, [], [11], device="cpu",
                    rows=rehearsal(cell)["rows"], emit=lambda s: None)
    table = check.verdict(recs[0]["numbers"], run.load_cell(cell)["limits"])
    assert not check.all_ok(table), table


# ---------------------------------------------------------------------------
# faults planted under the timed path
# ---------------------------------------------------------------------------

def _half_histogram(monkeypatch):
    """The histogram over the first half of the rows, doubled: half of
    the batch left out, the mean taken over the rest."""
    from transmogrifai_tpu_torch.models import trees
    real = trees.histogram_grid

    def half(bins, stats, pos, m, B):
        keep = (torch.arange(stats.shape[1]) < stats.shape[1] // 2)
        return real(bins, stats * (2.0 * keep)[None, :, None], pos, m, B)
    monkeypatch.setattr(trees, "histogram_grid", half)


def _half_sweep_instances(monkeypatch):
    """Each histogram launch over a batch of fits (the cross-validation's
    folded sweep) leaves out the second half of its instances: their
    histograms read empty."""
    from transmogrifai_tpu_torch.models import trees
    real = trees.histogram_grid

    def half(bins, stats, pos, m, B):
        G = stats.shape[0]
        keep = (torch.arange(G) < max(1, G // 2)).to(stats.dtype)
        return real(bins, stats * keep[:, None, None], pos, m, B)
    monkeypatch.setattr(trees, "histogram_grid", half)


def _wrong_fold_mask(monkeypatch):
    """The cross-validation's folds drawn from another seed than the
    validator's."""
    from transmogrifai_tpu_torch.models import tuning
    real = tuning.make_fold_masks
    monkeypatch.setattr(tuning, "make_fold_masks",
                        lambda n, k, seed=0: real(n, k, seed + 1))


def _wrong_winner(monkeypatch):
    """The selector picks the family whose best grid point is worst."""
    from transmogrifai_tpu_torch.models import tuning
    real = tuning.ValidationResult.best_metric
    monkeypatch.setattr(tuning.ValidationResult, "best_metric",
                        property(lambda r: -real.fget(r)))


def _half_linear(monkeypatch):
    from transmogrifai_tpu_torch.models import linear
    real_mtv, real_gram = linear._mtv_part, linear._gram_part

    def cut(A):
        keep = torch.arange(A.shape[1], device=A.device) < A.shape[1] // 2
        return A * (2.0 * keep)[None, :, None]
    monkeypatch.setattr(linear, "_mtv_part",
                        lambda A, v: real_mtv(cut(A), v))
    monkeypatch.setattr(linear, "_gram_part",
                        lambda A, B: real_gram(cut(A), B))


def _unchanged_routing(monkeypatch):
    """Every level's step returns the rows' node state unchanged."""
    from transmogrifai_tpu_torch.models import trees
    real = trees._split_level

    def same(rk, *a, **k):
        pos = rk["pos"]
        real(rk, *a, **k)
        rk["pos"] = pos
    monkeypatch.setattr(trees, "_split_level", same)


def _unchanged_newton(monkeypatch):
    """Every Newton and solve step returns the coefficients unchanged."""
    from transmogrifai_tpu_torch.models import linear
    monkeypatch.setattr(linear, "_solve_pos",
                        lambda H, g: torch.zeros_like(g))
    real = linear._fista
    monkeypatch.setattr(linear, "_fista",
                        lambda grad, x0, *a, **k: x0)
    del real


def _altered_scores(monkeypatch):
    """Every family's answers altered where they are produced: every
    fifth row's two class probabilities swapped."""
    from transmogrifai_tpu_torch.models import MODEL_FAMILIES
    for fam in MODEL_FAMILIES.values():
        real = fam.predict_kernel

        def altered(params, X, k, real=real):
            p = real(params, X, k)
            swap = (torch.arange(p.shape[-2]) % 5 == 0)[:, None]
            return torch.where(swap, p.flip(-1), p)
        monkeypatch.setattr(fam, "predict_kernel", altered)


def _half_sparse_batch(monkeypatch):
    """Each sparse minibatch's gradient over its first half of rows, the
    mean taken over them."""
    from transmogrifai_tpu_torch.models import sparse
    real = sparse._lr_grads

    def half(P, idx, X, y, w, plan, flat, mean=True):
        keep = torch.arange(w.shape[1]) < w.shape[1] // 2
        return real(P, idx, X, y, w * keep[None], plan, flat, mean)
    monkeypatch.setattr(sparse, "_lr_grads", half)


def _unchanged_sparse_state(monkeypatch):
    """Every Adagrad step returns the tables unchanged."""
    from transmogrifai_tpu_torch.models import sparse
    monkeypatch.setattr(sparse, "_adagrad_apply", lambda *a, **k: None)


def _altered_sparse_scores(monkeypatch):
    """The sparse head's answers altered where they are produced: every
    fifth row's two probabilities swapped."""
    from transmogrifai_tpu_torch.models import sparse
    real = sparse.sparse_binary_probs

    def altered(params, idx, X):
        p = real(params, idx, X)
        swap = (torch.arange(p.shape[0]) % 5 == 0)[:, None]
        return torch.where(swap, p.flip(-1), p)
    monkeypatch.setattr(sparse, "sparse_binary_probs", altered)


@pytest.mark.parametrize("cell,name", [
    pytest.param(c, f, id=f"{c}-{f.rsplit('.', 1)[1]}")
    for c in CELLS for f in _faults(c)])
def test_a_broken_timed_path_is_judged_not_correct(cell, name, monkeypatch):
    fault(name)(monkeypatch)
    result, table = _run(cell, seed=2 ** 31 + 8)
    assert not result["correct"], table


def test_the_card_runs_a_cell(tmp_path):
    """On the card: one short run of the cheapest cell through the
    benchmark's command, its last line a correct result."""
    pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import json
    import subprocess
    import sys
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "higgs.linear", "--seed", "5", "--seconds", "1",
                          "--trace", "0"], cwd=run.ROOT, capture_output=True,
                         text=True, timeout=600, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"


test_the_card_runs_a_cell = pytest.mark.cuda(test_the_card_runs_a_cell)
