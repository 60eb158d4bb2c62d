"""The tree reference judges its own fits sound and the float8 control's
not, and its two ways of summing a histogram agree."""
import pytest
import torch

from portbench.reference import trees

FAMILIES = sorted(trees.FAMILY)


def _rows(n=1500, d=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    X = torch.randn((n, d), generator=g)
    y = ((X[:, 0] * X[:, 1] + 0.3 * torch.randn(n, generator=g)) > 0) \
        .to(torch.float32)
    w = torch.ones(n)
    fold = torch.randint(0, 3, (n,), generator=g)
    return X, y, w, fold


def _small(monkeypatch):
    """Shallow caps and few trees, as the rows are few."""
    for fam, (kind, _, cap) in list(trees.FAMILY.items()):
        monkeypatch.setitem(trees.FAMILY, fam, (kind, 3, min(cap, 4)))


def test_the_two_histogram_sums_agree():
    X, _, w, _ = _rows()
    edges = trees.edges_of(X, w, 8)
    scatter = trees._Rows(X, edges, torch.float64)
    products = trees._Rows(X, edges, torch.float64)
    products.products = True
    pos = torch.randint(0, 4, (3, X.shape[0]))
    stats = torch.randn((3, X.shape[0], 3), dtype=torch.float64)
    a, b = scatter.histogram(pos, stats, 4), products.histogram(pos, stats, 4)
    assert a.shape == (3, 4, 3, 4, 8)
    assert torch.allclose(a, b, rtol=0, atol=1e-12)


@pytest.mark.parametrize("family", FAMILIES)
def test_a_sweep_the_reference_grows_judges_sound(family, monkeypatch):
    _small(monkeypatch)
    X, y, w, fold = _rows()
    grid = [{"maxDepth": 2.0}, {"maxDepth": 3.0}]
    params, cv = trees.sweep(family, grid, X, y, w, fold, 3)
    assert params["feat"].shape[0] == 3 * len(grid)
    report, cv2 = trees.sweep(family, grid, X, y, w, fold, 3, params=params)
    assert report["split_loss"] < 1e-9 and report["leaf_gap"] < 1e-6
    assert max(abs(a - b) for a, b in zip(cv, cv2)) < 1e-6
    assert all(0.5 < a <= 1.0 for a in cv)


@pytest.mark.parametrize("family", ["GBTClassifier", "XGBoostClassifier"])
def test_a_float8_sweep_is_judged_unsound(family, monkeypatch):
    """(A forest's class counts are small whole numbers, which float8
    holds exactly: the boosted families' gradients are what it rounds.)"""
    _small(monkeypatch)
    X, y, w, fold = _rows(n=3000)
    grid = [{"maxDepth": 3.0}]
    params, _ = trees.sweep(family, grid, X, y, w, fold, 3, operand="fp8",
                            dtype=torch.float32)
    report, _ = trees.sweep(family, grid, X, y, w, fold, 3, params=params)
    assert report["split_loss"] > 0.005
